#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root; needs one CUDA
                                   # card, torch built for CUDA, and nvcc

Phases, each printing one JSON line (`{"phase": ...}`):

  device    the card's name and power limit (nvidia-smi) and
            torch.cuda.get_device_name
  build     compile the kernels of src/repro_torch/csrc with nvcc (sm_90a),
            timed, with ptxas' register counts
  golden    each kernel against tests/golden/fixed_golden.json, word for
            word, in all five STANDARD_CONFIGS; then, with the committed
            params fixture tests/golden/seeded_params.json, the frame_trunk
            route against frame_trunk_golden.json (Q16.16 and Q8.8, all four
            role maps) and both sweep routes against sweep_golden.json (maps
            and the stride-8 window scores)
  kernel    per kernel: the kernel against its plain PyTorch version on the
            card (torch.equal on int32 words) in all five configs, at the
            engine's shapes (B=64) and at large shapes (B=16384 images, a
            512x512 frame, odd extents, stride 2), with random words that
            include max_int, min_int and INT32_MIN; then its median time
            (CUDA events), its bound, the plain version's time and, where one
            PyTorch call computes the same function, that call's time.
            frame_trunk runs in the three wraparound configs (a saturating
            one must raise) at 112x112 (chosen and forced tiles), 104x132
            (H/4 even, W/4 odd), 512x512 and 1080x1920
  serve     VisionEngine(backend="fixed_cuda", batch_size=64, device="cuda"),
            threaded, over 1024 synth_mnist images in Q16.16 and in Q8.8:
            every score word equals the plain `fixed` backend's on the CPU,
            the ledger is accounted, and the launch counts rose by 2 conv,
            1 dense and 1 sigmoid launch per step; requests per second over
            the client's wall window and over the engine's busy time, and
            p50/p99 latency
  composed  the same engine over a backend whose stage is the composed
            conv+PLAN launch then the pool launch (the hooks the frame sweep
            composes): drives the max-pool kernel on a served path
  sweep     StreamingPipeline(SyntheticVideoSource(seed=7, 112x112, 64
            frames), VisionEngine(backend="fixed_cuda", device="cuda"),
            FcnSweep(stride=8)) in throughput mode, in Q16.16 and Q8.8: each
            frame's detections equal the plain `fixed` sweep's on the CPU,
            the first 4 frames' score words equal the CPU's (sweep and host
            tiler), the ledger holds, and each frame is 1 frame_trunk, 1
            dense and 1 sigmoid launch; frames/s over the client's wall
            window and p50/p99 frame latency.  Then the composed route
            (megakernel=False: 20 conv, 2 pool, 12 sigmoid, 1 dense per
            frame) beside it, and a 4-frame 1080x1920 clip through the
            frame_trunk route, word-checked against the CPU
  host      16 synchronous served steps: wall time per step against the
            engine's busy window per step, and the host time outside it
  profile   a torch.profiler trace of 16 served steps, then one of 16 sweep
            frames at 112x112: device busy share and device time by kernel
  kernels   one line listing every ported kernel (launches counted on the
            serve, composed and sweep paths, reset to 0 before each and read
            after)

The last line is {"ok": true, "device": {"platform": "gpu", ...}}.  Any
mismatch or failure raises; without CUDA, or outside a checkout of the
repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "fixed_golden.json"
SEEDED_PARAMS = ROOT / "tests" / "golden" / "seeded_params.json"
SWEEP_GOLDEN = ROOT / "tests" / "golden" / "sweep_golden.json"
TRUNK_GOLDEN = ROOT / "tests" / "golden" / "frame_trunk_golden.json"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
# int32 on the CUDA cores, not in the guide's table: 132 SMs x 64 INT32
# lanes x 1.98 GHz boost, the clocks behind the data sheet's 67 TFLOP/s fp32
INT32_OPS_PER_S = 132 * 64 * 1.98e9

ENGINE_BATCH = 64
LARGE_BATCH = 16384
N_REQUESTS = 1024
SWEEP_FRAMES = 64
SWEEP_STRIDE = 8
CAMERA = (1080, 1920)
CAMERA_FRAMES = 4

KERNELS = {
    "fixed_conv2d": ("src/repro_torch/csrc/fixed_conv.cu",
                     "src/repro/kernels/fixed_conv/kernel.py:85"),
    "fixed_maxpool2x2": ("src/repro_torch/csrc/fixed_conv.cu",
                         "src/repro/kernels/fixed_conv/kernel.py:115"),
    "fixed_sigmoid": ("src/repro_torch/csrc/fixed_conv.cu",
                      "src/repro/kernels/fixed_conv/kernel.py:133"),
    "fixed_dense": ("src/repro_torch/csrc/fixed_dense.cu",
                    "src/repro/kernels/quant_matmul/kernel.py:85"),
    "frame_trunk": ("src/repro_torch/csrc/frame_trunk.cu",
                    "src/repro/kernels/frame_trunk/kernel.py:172"),
}


class SmokeError(RuntimeError):
    """A phase found a mismatch."""


def emit(phase: str, **data) -> None:
    print(json.dumps({"phase": phase, **data}), flush=True)


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# -- inputs --------------------------------------------------------------------

def random_words(rng, shape, cfg):
    """Random Qm.n words with max_int, min_int and INT32_MIN injected."""
    import numpy as np
    x = rng.integers(cfg.min_int, cfg.max_int + 1, shape, dtype=np.int64)
    flat = x.reshape(-1)
    extremes = [cfg.max_int, cfg.min_int, -2 ** 31, 2 ** 31 - 1]
    idx = rng.choice(flat.size, size=min(len(extremes) * 2, flat.size), replace=False)
    for j, i in enumerate(idx):
        flat[i] = extremes[j % len(extremes)]
    return flat.reshape(shape).astype(np.int32)


def fixture_params() -> dict:
    """The reference's `smallnet.seeded_params()`, from the committed fixture
    (the params the sweep and frame_trunk goldens were made with)."""
    import numpy as np
    g = json.loads(SEEDED_PARAMS.read_text())["params"]
    return {layer: {leaf: np.asarray(v["values"], np.float32).reshape(v["shape"])
                    for leaf, v in leaves.items()}
            for layer, leaves in g.items()}


def seeded_params(seed: int = 0) -> dict:
    """Float smallNet params from numpy, every leaf nonzero."""
    import numpy as np
    rng = np.random.default_rng(seed)
    p = {"conv1": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "conv2": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "dense": {"w": rng.uniform(-0.6, 0.6, (49, 10)), "b": rng.normal(0, 0.5, (10,))}}
    p = {k: {n: a.astype(np.float32) for n, a in v.items()} for k, v in p.items()}
    expect(all((a != 0).all() for v in p.values() for a in v.values()),
           "seeded params have a zero leaf")
    return p


# -- timing --------------------------------------------------------------------

def device_ms(fn, reps: int) -> float:
    """Median device time of one call of `fn`, from CUDA events around `reps`
    back-to-back calls.  A spin kernel holds the stream while the calls are
    queued, so the events time the device's work and not the host's enqueue."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / 3
    spin_cycles = int(min(host_s * reps * 2 + 1e-3, 2.0) * 2e9)
    per_call = []
    for _ in range(5):
        torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- the kernels' cases ----------------------------------------------------------

def conv_work(B, H, W, pool, stride=1):
    Ho, Wo = (H // 2, W // 2) if pool else (-(-H // stride), -(-W // stride))
    words = B * (2 * Ho) * (2 * Wo) if pool else B * Ho * Wo    # conv words computed
    return 4 * (B * H * W + B * Ho * Wo + 5), 8 * words        # 4 taps x (mul + add)


def kernel_cases():
    """name -> list of (label, make(rng, cfg) -> args, kwargs, work(bytes, ops),
    timed-at-engine-shape?)."""
    E, L = ENGINE_BATCH, LARGE_BATCH

    def conv(B, H, W, *, act="plan", pool=True, stride=1):
        def make(rng, cfg):
            return ((random_words(rng, (B, H, W), cfg), random_words(rng, (4,), cfg),
                     random_words(rng, (1,), cfg)),
                    dict(activation=act, pool=pool, stride=stride))
        return make, conv_work(B, H, W, pool, stride)

    def pool(B, H, W):
        def make(rng, cfg):
            return (random_words(rng, (B, H, W), cfg),), {}
        Ho, Wo = H // 2, W // 2
        return make, (4 * (B * 2 * Ho * 2 * Wo + B * Ho * Wo), 3 * B * Ho * Wo)

    def sigmoid(*shape):
        import math
        n = math.prod(shape)

        def make(rng, cfg):
            return (random_words(rng, shape, cfg),), {}
        return make, (8 * n, n)

    def dense(M, K, N):
        def make(rng, cfg):
            return ((random_words(rng, (M, K), cfg), random_words(rng, (K, N), cfg),
                     random_words(rng, (N,), cfg)), {})
        return make, (4 * (M * K + K * N + N + M * N), 2 * M * K * N)

    return {
        "fixed_conv2d": [
            ("engine conv1 (64,28,28)->(64,14,14)", *conv(E, 28, 28), "engine"),
            ("engine conv2 (64,14,14)->(64,7,7)", *conv(E, 14, 14), "engine"),
            ("large conv1 (16384,28,28)->(16384,14,14)", *conv(L, 28, 28), "large"),
            ("large conv2 (16384,14,14)->(16384,7,7)", *conv(L, 14, 14), "large"),
            ("frame (1,512,512)->(1,256,256)", *conv(1, 512, 512), "large"),
            ("odd (2,37,53) pre-activation", *conv(2, 37, 53, act=None, pool=False), None),
            ("odd (2,37,53) plan", *conv(2, 37, 53, pool=False), None),
            ("odd (2,37,53) plan+pool", *conv(2, 37, 53), None),
            ("odd (2,37,53) plan stride 2", *conv(2, 37, 53, pool=False, stride=2), None),
        ],
        "fixed_maxpool2x2": [
            ("engine (64,28,28)->(64,14,14)", *pool(E, 28, 28), "engine"),
            ("large (16384,28,28)", *pool(L, 28, 28), "large"),
            ("frame (1,512,512)", *pool(1, 512, 512), "large"),
            ("odd (2,37,53)", *pool(2, 37, 53), None),
        ],
        "fixed_sigmoid": [
            ("engine (64,10)", *sigmoid(E, 10), "engine"),
            ("large (16384,10)", *sigmoid(L, 10), "large"),
            ("frame (512,512)", *sigmoid(512, 512), "large"),
        ],
        "fixed_dense": [
            ("engine (64,49)@(49,10)", *dense(E, 49, 10), "engine"),
            ("large (16384,49)@(49,10)", *dense(L, 49, 10), "large"),
            ("odd (3,7)@(7,5)", *dense(3, 7, 5), None),
        ],
    }


def library_call(name):
    """One PyTorch call computing the same function, where there is one."""
    import torch
    if name == "fixed_maxpool2x2":
        def amax(x):
            B, H, W = x.shape
            return torch.amax(x[:, :H - H % 2, :W - W % 2]
                              .reshape(B, H // 2, 2, W // 2, 2), dim=(2, 4))
        return amax
    return None       # no PyTorch call computes the Qm.n word functions


# -- phases --------------------------------------------------------------------

def phase_golden():
    import torch
    from repro_torch.core import fixed_point as fxp
    from repro_torch.kernels.fixed_conv import ops as C
    from repro_torch.kernels.quant_matmul import ops as D

    g = json.loads(GOLDEN.read_text())
    dev = torch.device("cuda")
    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    checked = 0
    for name, spec in g["configs"].items():
        cfg = fxp.FixedPointConfig(**spec)
        case = g["cases"][name]
        cv = case["conv"]
        x, w4, b = t(cv["x"]), t(cv["w4"]), t([cv["b"]])
        got = {
            "conv.out": C.fixed_conv2d(x, w4, b, cfg=cfg),
            "conv.out_fused_plan_pool": C.fixed_conv2d(x, w4, b, cfg=cfg,
                                                       activation="plan", pool=True),
            "pool": C.fixed_maxpool2x2(t(case["pool"]["x"])),
            "sigmoid": C.fixed_sigmoid(t(case["sigmoid"]["x"]), cfg=cfg),
            "dense": D.fixed_dense(t(case["dense"]["x"]), t(case["dense"]["w"]),
                                   t(case["dense"]["b"]), cfg=cfg),
        }
        want = {"conv.out": cv["out"], "conv.out_fused_plan_pool": cv["out_fused_plan_pool"],
                "pool": case["pool"]["out"], "sigmoid": case["sigmoid"]["out"],
                "dense": case["dense"]["out"]}
        torch.cuda.synchronize()
        for key, words in got.items():
            expect(torch.equal(words.cpu().to(torch.int64),
                               torch.tensor(want[key], dtype=torch.int64)),
                   f"golden {name} {key}: kernel words differ from fixed_golden.json")
            checked += 1
    emit("golden", configs=sorted(g["configs"]), entries_checked=checked, ok=True)


def phase_sweep_golden():
    """The frame_trunk route and both sweep routes on the card against the
    sweep and frame_trunk golden vectors (the 112x112 seed-7 frame, the
    committed seeded params)."""
    import numpy as np
    from repro_torch.core import backends as B
    from repro_torch.core import fixed_point as fxp
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.streaming import FcnSweep, SyntheticVideoSource
    from repro_torch.streaming.fcn_sweep import sweep_feature_maps

    params = fixture_params()
    frame = SyntheticVideoSource(n_frames=1, seed=7).frames()[0]
    trunk = json.loads(TRUNK_GOLDEN.read_text())["maps"]
    sweep = json.loads(SWEEP_GOLDEN.read_text())
    checked = 0
    reset_launches()
    for fmt, cfg in (("q16_16", fxp.Q16_16), ("q8_8", fxp.Q8_8)):
        maps = sweep_feature_maps(params, frame.pixels, backend=B.FixedCudaBackend(cfg=cfg),
                                  megakernel=True, device="cuda")
        for name, words in maps.items():
            expect(np.array_equal(words, np.asarray(trunk[fmt][name])),
                   f"golden frame_trunk {fmt}/{name}: kernel words differ from "
                   "frame_trunk_golden.json")
            checked += 1
    expect(launches() == {"frame_trunk": 2}, f"golden frame_trunk launches {launches()}")
    for megakernel in (True, False):
        maps = sweep_feature_maps(params, frame.pixels, backend="fixed_cuda",
                                  megakernel=megakernel, device="cuda")
        for name, words in maps.items():
            expect(np.array_equal(words, np.asarray(sweep["maps"][name])),
                   f"golden sweep megakernel={megakernel} {name}: map differs "
                   "from sweep_golden.json")
            checked += 1
        sw = FcnSweep(stride=sweep["stride"], megakernel=megakernel)
        fb, pos = sw.extract(frame)
        expect([list(q) for q in pos] == sweep["positions"], "golden sweep: positions differ")
        scores = sw.score(params, fb, backend="fixed_cuda", device="cuda")
        expect(np.array_equal(scores, np.asarray(sweep["scores"])),
               f"golden sweep megakernel={megakernel}: "
               f"{int((scores != np.asarray(sweep['scores'])).sum())} score words differ "
               "from sweep_golden.json")
        checked += 1
    emit("golden", set="frame_trunk_golden.json + sweep_golden.json",
         params="tests/golden/seeded_params.json", formats=["q16_16", "q8_8"],
         entries_checked=checked, ok=True)


def phase_kernels(card: str) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import fixed_point as fxp
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.kernels.fixed_conv import ops as C
    from repro_torch.kernels.quant_matmul import ops as D

    fns = {"fixed_conv2d": (C.fixed_conv2d, C.fixed_conv2d_plain, True),
           "fixed_maxpool2x2": (C.fixed_maxpool2x2, C.fixed_maxpool2x2_plain, False),
           "fixed_sigmoid": (C.fixed_sigmoid, C.fixed_sigmoid_plain, True),
           "fixed_dense": (D.fixed_dense, D.fixed_dense_plain, True)}
    rng = np.random.default_rng(2025)
    table = {}
    for name, cases in kernel_cases().items():
        kernel, plain, takes_cfg = fns[name]
        max_err, n_checked = 0, 0
        lib_fn = library_call(name)
        shapes = []
        reset_launches()
        for label, make, (nbytes, ops), timing in cases:
            for cname, cfg in fxp.STANDARD_CONFIGS.items():
                host_args, kw = make(rng, cfg)
                args = [torch.from_numpy(a).cuda() for a in host_args]
                if takes_cfg:
                    kw = dict(kw, cfg=cfg)
                got = kernel(*args, **kw)
                want = plain(*args, **kw)
                torch.cuda.synchronize()
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
                    if got.numel() else 0
                expect(got.shape == want.shape and torch.equal(got, want),
                       f"{name} {label} {cname}: kernel differs from plain "
                       f"(max |err| {err})")
                max_err = max(max_err, err)
                n_checked += 1
                if lib_fn is not None:
                    expect(torch.equal(lib_fn(*args), got),
                           f"{name} {label}: library call differs from kernel")
                if timing is None or cname != "q16_16":
                    continue
                reps = 200 if timing == "engine" else 20
                ms = device_ms(lambda: kernel(*args, **kw), reps)
                pms = device_ms(lambda: plain(*args, **kw), max(reps // 10, 5))
                b_ms, b_by = bound_ms(nbytes, ops)
                lms = (device_ms(lambda: lib_fn(*args), reps)
                       if lib_fn is not None else None)
                shapes.append({"case": label, "timing": timing, "ms": ms,
                               "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by,
                               "library_ms": lms, "bytes": nbytes, "ops": ops})

        def total(timing, key):
            return sum(r[key] for r in shapes if r["timing"] == timing)
        # the kernel's row is the work one served step asks of it: both
        # conv launches for fixed_conv2d, one launch for the others
        b_ms, b_by = bound_ms(total("engine", "bytes"), total("engine", "ops"))
        table[name] = {"name": name, "route": "cuda", "source": KERNELS[name][0],
                       "replaces": KERNELS[name][1], "launches": 0,
                       "max_abs_err": max_err, "ms": total("engine", "ms"),
                       "plain_ms": total("engine", "plain_ms"),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": (total("engine", "library_ms")
                                      if lib_fn is not None else None)}
        step_row = {k: v for k, v in table[name].items() if k != "launches"}
        emit("kernel", name=name, checked=n_checked, max_abs_err=max_err,
             launches_in_this_phase=launches().get(name, 0),
             card=card, engine_step=step_row, shapes=shapes,
             large_ms=total("large", "ms"), large_plain_ms=total("large", "plain_ms"),
             large_bound_ms=total("large", "bound_ms"))
    return table


def frame_trunk_work(H, W):
    """(bytes, integer operations) that the whole trunk of one (H, W) frame
    needs at the least.  Bytes: each input word read once (the H*W frame
    and the ten tap and bias words; the halo's zeros are made, not read),
    each output word written once.  Operations: only the words that the
    two pools read, counting one per product of a word and a tap (a
    product that several masked convs share, once), one per add (a tap sum
    that is a part of another at the same position, once), one per bias or
    recombination fixed_add (the zero word's not at all), one per PLAN
    word and one per max of two words.  Per level-2 position, i.e. per 4x4
    block of frame pixels:
      level 0: 64 products, 49 tap-sum adds, 25 words (a bias add and a
               PLAN each), 23 maxes (I at all four level-1 positions, B on
               the odd row, R on the odd column, C at odd/odd)     = 186
      level 1: 36 products, 46 adds, 16 PLAN words, 12 maxes      = 110
    So 18.5 operations per frame pixel against 5 bytes: bound by bytes."""
    blocks = (H // 4) * (W // 4)
    nbytes = 4 * H * W + 4 * 10 + 4 * 4 * blocks
    return nbytes, (186 + 110) * blocks


def phase_frame_trunk_kernel(card: str) -> dict:
    """frame_trunk against its untiled plain version on the card, word for
    word, in the three wraparound configs, at every listed frame and tile;
    a saturating config and a tile that does not divide the frame raise."""
    import numpy as np
    import torch
    from repro_torch.core import fixed_point as fxp
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.kernels.frame_trunk import ops as FT

    rng = np.random.default_rng(2026)
    max_err = 0
    cases = [((112, 112), (None, (4, 4), (8, 16), (28, 56))),
             ((104, 132), (None, (8, 12))),
             ((512, 512), (None,)),
             (CAMERA, (None,))]
    timed = {(112, 112): "sweep frame 112x112", (512, 512): "frame 512x512",
             CAMERA: "camera frame 1080x1920"}
    reset_launches()
    n_checked, shapes = 0, []
    for cname in ("q16_16", "q16_16_trunc", "q8_8"):
        cfg = fxp.STANDARD_CONFIGS[cname]
        for (H, W), tiles in cases:
            args = [torch.from_numpy(random_words(rng, shape, cfg)).cuda()
                    for shape in ((H, W), (4,), (1,), (4,), (1,))]
            want = FT.frame_trunk_quad_plain(*args, cfg=cfg)
            for tile in tiles:
                got = FT.frame_trunk_quad(*args, cfg=cfg, tile=tile)
                torch.cuda.synchronize()
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                expect(got.shape == want.shape and torch.equal(got, want),
                       f"frame_trunk {H}x{W} tile={tile or FT.choose_tile(H, W)} "
                       f"{cname}: kernel differs from plain (max |err| {err})")
                max_err = max(max_err, err)
                n_checked += 1
            if cname != "q16_16" or (H, W) not in timed:
                continue
            nbytes, ops = frame_trunk_work(H, W)
            b_ms, b_by = bound_ms(nbytes, ops)
            shapes.append({"case": timed[(H, W)], "tile": list(FT.choose_tile(H, W)),
                           "ms": device_ms(lambda: FT.frame_trunk_quad(*args, cfg=cfg), 50),
                           "plain_ms": device_ms(
                               lambda: FT.frame_trunk_quad_plain(*args, cfg=cfg), 5),
                           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                           "bytes": nbytes, "ops": ops})
    x = torch.zeros((112, 112), dtype=torch.int32, device="cuda")
    w, b = torch.ones(4, dtype=torch.int32, device="cuda"), torch.zeros(1, dtype=torch.int32,
                                                                        device="cuda")
    for bad, exc in (({"cfg": fxp.STANDARD_CONFIGS["q16_16_sat"]}, NotImplementedError),
                     ({"cfg": fxp.STANDARD_CONFIGS["q8_8_sat"]}, NotImplementedError),
                     ({"tile": (8, 12)}, ValueError)):    # 12 does not divide 112
        try:
            FT.frame_trunk_quad(x, w, b, w, b, **bad)
        except exc:
            continue
        raise SmokeError(f"frame_trunk {bad}: expected {exc.__name__}")
    row = dict(shapes[0])
    table = {"name": "frame_trunk", "route": "cuda", "source": KERNELS["frame_trunk"][0],
             "replaces": KERNELS["frame_trunk"][1], "launches": 0, "max_abs_err": max_err,
             "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": None}
    emit("kernel", name="frame_trunk", checked=n_checked, max_abs_err=max_err,
         launches_in_this_phase=launches().get("frame_trunk", 0), card=card,
         sweep_frame=table, shapes=shapes,
         library="none: no single PyTorch call computes the quad")
    return table


def serve_once(params, images, backend, label, card, want_per_step):
    """Serve `images` through a threaded engine built from the numpy
    `params`; check words, ledger and launch counts; return the counts."""
    import numpy as np
    import torch
    from repro_torch.core import backends as B
    from repro_torch.core import smallnet
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serving.vision_engine import VisionEngine

    eng = VisionEngine(params_on(params, "cuda"), backend=backend,
                       batch_size=ENGINE_BATCH, device="cuda")
    be = eng.backend
    images_in = list(images)
    reset_launches()
    eng.start()
    try:
        t0 = time.perf_counter()
        results = eng.serve(images_in)
        wall_s = time.perf_counter() - t0
    finally:
        eng.stop()
    counts = launches()
    st = eng.stats()
    expect(all(r is not None for r in results), f"{label}: a request was shed")
    scores = np.stack([r.scores for r in results])
    preds = np.asarray([r.pred for r in results])
    plain_be = B.FixedBackend(cfg=be.cfg)
    with torch.inference_mode():
        want = smallnet.apply(params_on(params, "cpu"), torch.from_numpy(images),
                              backend=plain_be)
    want_np = want.numpy()
    expect(scores.dtype == np.int32 and scores.shape == (len(images), 10),
           f"{label}: scores {scores.dtype} {scores.shape}")
    expect(np.array_equal(scores, want_np),
           f"{label}: {int((scores != want_np).sum())} served score words differ "
           "from the plain fixed backend on the CPU")
    expect(np.array_equal(preds, smallnet.predict(want).numpy()),
           f"{label}: Max Finder outputs differ")
    expect(st["accounted"] and st["n"] == len(images) and st["shed"] == 0,
           f"{label}: ledger {st}")
    steps = st["batches"]
    expected = {k: v * steps for k, v in want_per_step.items() if v}
    expect(counts == expected, f"{label}: launches {counts}, expected {expected}")
    emit("serve" if label.startswith("serve") else "composed", path=label,
         backend=be.name, fmt=f"Q{be.cfg.int_bits + 1}.{be.cfg.frac_bits}",
         requests=len(images), steps=steps, launches=counts,
         words_equal_cpu_plain=True, accounted=st["accounted"],
         # the client's window: first submit to the last result in hand
         wall_s=wall_s, served_per_wall_s=st["n"] / wall_s,
         # the engine's busy window: the sum of [t0, t_done] over the steps
         throughput_qps=st["throughput_qps"], busy_s=st["busy_s"],
         step_ms=st["busy_s"] / steps * 1e3,
         latency_p50_ms=st["latency_p50_ms"], latency_p99_ms=st["latency_p99_ms"],
         batch_occupancy=st["batch_occupancy"],
         distinct_preds=int(len(set(preds.tolist()))), card=card)
    return counts


def sweep_once(params, source, cfg, threshold, label, card, want_per_frame, *,
               megakernel=None, tiler_scores=None):
    """Drive StreamingPipeline(source, VisionEngine(fixed_cuda, cuda),
    FcnSweep) in throughput mode; check every frame's detections and the
    score words the pipeline itself produced against the plain `fixed`
    sweep on the CPU, the ledger and the launches per frame; return (launch
    counts, frames/s over the client's wall window).  `tiler_scores(frame)`,
    when given, are the host tiler's CPU score words for the frame, which
    the first frames' words must also equal."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import backends as B
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serving.vision_engine import VisionEngine
    from repro_torch.streaming import FcnSweep, StreamingPipeline

    @dataclasses.dataclass(frozen=True)
    class RecordingSweep(FcnSweep):
        """FcnSweep that keeps the words of every `score` call, in call order
        (the pipeline's infer stage scores one frame at a time, in order)."""
        words: list = dataclasses.field(default_factory=list, compare=False, repr=False)

        def score(self, *args, **kwargs):
            out = super().score(*args, **kwargs)
            self.words.append(out)
            return out

    frames = source.frames()
    sweep = RecordingSweep(stride=SWEEP_STRIDE, threshold=threshold, cfg=cfg,
                           megakernel=megakernel)
    plain = B.FixedBackend(cfg=cfg)
    cpu_params = params_on(params, "cpu")
    # the offline detect of the plain backend on the CPU, frame by frame
    cpu_scores, want = [], []
    for f in frames:
        fb, pos = sweep.extract(f)
        cpu_scores.append(sweep.score(cpu_params, fb, backend=plain, device="cpu"))
        want.append(sweep.aggregate(cpu_scores[-1], pos, fb))
    eng = VisionEngine(params_on(params, "cuda"), backend=B.FixedCudaBackend(cfg=cfg),
                       batch_size=ENGINE_BATCH, device="cuda")
    pipe = StreamingPipeline(source, eng, sweep)      # runs one warm-up sweep
    torch.cuda.synchronize()
    reset_launches()
    sweep.words.clear()
    t0 = time.perf_counter()
    results = pipe.run()
    wall_s = time.perf_counter() - t0
    counts = launches()
    st = pipe.stats()
    n = len(frames)
    expect(st["accounted"] and st["frames_served"] == n and st["frames_dropped"] == 0,
           f"{label}: ledger frames_in={st['frames_in']} served={st['frames_served']} "
           f"dropped={st['frames_dropped']}")
    expect([r.index for r in results] == list(range(n)), f"{label}: frames out of order")
    for r in results:
        expect(r.detections == want[r.index],
               f"{label}: frame {r.index} detections differ from the plain CPU sweep")
    expected = {k: v * n for k, v in want_per_frame.items() if v}
    expect(counts == expected, f"{label}: launches {counts}, expected {expected}")
    # the score words the pipeline produced, every frame's, against the
    # plain sweep on the CPU; the first frames' also against the host tiler
    expect(len(sweep.words) == n, f"{label}: {len(sweep.words)} sweep calls for {n} frames")
    words_checked = 0
    for f, got in zip(frames, sweep.words):
        expect(np.array_equal(got, cpu_scores[f.index]),
               f"{label}: frame {f.index} score words differ from the CPU sweep")
        if tiler_scores is not None and f.index < 4:
            expect(np.array_equal(got, tiler_scores(f)),
                   f"{label}: frame {f.index} score words differ from the CPU tiler")
        words_checked += got.size
    # the same sweep call outside the pipeline, timed on the first frames
    call_s = []
    for f in frames[:4]:
        fb, _ = sweep.extract(f)
        t0 = time.perf_counter()
        got = sweep.score(eng.params, fb, backend=eng.backend, device="cuda")
        call_s.append(time.perf_counter() - t0)
        expect(np.array_equal(got, cpu_scores[f.index]),
               f"{label}: frame {f.index} bare sweep call differs from the CPU sweep")
    emit("sweep", path=label, backend=eng.backend.name,
         fmt=f"Q{cfg.int_bits + 1}.{cfg.frac_bits}", frame_shape=list(source.frame_shape),
         frames=n, windows_per_frame=len(sweep.positions(source.frame_shape)),
         megakernel=megakernel, threshold=threshold, launches=counts,
         launches_per_frame={k: v / n for k, v in counts.items()},
         detections=st["detections_total"], detections_equal_cpu_plain=True,
         score_words_checked=words_checked, accounted=st["accounted"],
         wall_s=wall_s, frames_per_wall_s=n / wall_s, sustained_fps=st["sustained_fps"],
         latency_p50_ms=st["latency_p50_ms"], latency_p99_ms=st["latency_p99_ms"],
         stage_p50_ms={k: v["p50_ms"] for k, v in st["stage"].items()},
         # the same sweep call outside the pipeline, for its first frames
         score_call_wall_ms=statistics.median(call_s) * 1e3, card=card)
    return counts, n / wall_s


def calibrated_threshold(params, frame, cfg, scores=None) -> float:
    """The stream benchmarks' threshold: the 80th percentile of the first
    frame's per-window top confidence, from the plain `fixed` backend on the
    CPU (`scores`, when given, are that frame's CPU sweep scores)."""
    import numpy as np
    from repro_torch.core import backends as B
    from repro_torch.streaming import Tiler
    t0 = Tiler(stride=SWEEP_STRIDE, cfg=cfg)
    if scores is None:
        tiles, _ = t0.extract(frame)
        scores = t0.score(params_on(params, "cpu"), tiles, backend=B.FixedBackend(cfg=cfg),
                          device="cpu")
    return float(np.quantile(t0._confidences(scores).max(-1), 0.8))


def phase_sweep(card: str) -> list[dict]:
    """The frame sweep on the card: 112x112 clips in Q16.16 and Q8.8 through
    the frame_trunk route, the composed route beside it, then a 1080x1920
    clip through the frame_trunk route."""
    from repro_torch.core import backends as B
    from repro_torch.core import fixed_point as fxp
    from repro_torch.streaming import FcnSweep, SyntheticVideoSource, Tiler

    params = fixture_params()
    mega = {"frame_trunk": 1, "fixed_dense": 1, "fixed_sigmoid": 1}
    composed = {"fixed_conv2d": 20, "fixed_maxpool2x2": 2, "fixed_sigmoid": 12,
                "fixed_dense": 1}
    runs, rates = [], {}
    for fmt, cfg in (("q16_16", fxp.Q16_16), ("q8_8", fxp.Q8_8)):
        source = SyntheticVideoSource(seed=7, frame_shape=(112, 112), n_frames=SWEEP_FRAMES)
        thr = calibrated_threshold(params, source.frames()[0], cfg)
        tiler = Tiler(stride=SWEEP_STRIDE, cfg=cfg)

        def tiler_scores(frame, tiler=tiler, cfg=cfg):
            tiles, _ = tiler.extract(frame)
            return tiler.score(params_on(params, "cpu"), tiles,
                               backend=B.FixedBackend(cfg=cfg), device="cpu")
        counts, rates[fmt] = sweep_once(params, source, cfg, thr, f"sweep {fmt}", card, mega,
                                        tiler_scores=tiler_scores)
        runs.append(counts)
    source = SyntheticVideoSource(seed=7, frame_shape=(112, 112), n_frames=SWEEP_FRAMES)
    thr = calibrated_threshold(params, source.frames()[0], fxp.Q16_16)
    counts, rates["composed"] = sweep_once(params, source, fxp.Q16_16, thr,
                                           "sweep composed q16_16", card, composed,
                                           megakernel=False)
    runs.append(counts)
    emit("sweep", path="frame_trunk route vs composed route, Q16.16, 112x112",
         frames_per_wall_s_frame_trunk=rates["q16_16"],
         frames_per_wall_s_composed=rates["composed"],
         speedup=rates["q16_16"] / rates["composed"], card=card)

    camera = SyntheticVideoSource(seed=7, frame_shape=CAMERA, n_frames=CAMERA_FRAMES)
    first = camera.frames()[0]
    # the sweep's words equal the tiler's, so the CPU sweep stands in for
    # the 31,654-window host tiler when calibrating
    fb, _ = FcnSweep(stride=SWEEP_STRIDE).extract(first)
    first_scores = FcnSweep(stride=SWEEP_STRIDE).score(
        params_on(params, "cpu"), fb, backend="fixed", device="cpu")
    thr = calibrated_threshold(params, first, fxp.Q16_16, scores=first_scores)
    counts, _ = sweep_once(params, camera, fxp.Q16_16, thr, "sweep camera q16_16", card, mega)
    runs.append(counts)
    return runs


def phase_profile(params, images, card):
    """Where a served step's time goes.  First 16 synchronous engine steps
    without a profiler, the requests queued beforehand: their wall time per
    step against the engine's busy window per step ([t0, t_done]: batch
    assembly, upload, ingest, the four launches, the synchronize); the
    difference is the host work outside that window (forming the batch, the
    copy back, the Max Finder, the results and the histogram).  Then a
    torch.profiler trace of 16 more steps: device busy share and the device
    and host time by op (the profiler's own host cost lowers the share)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.vision_engine import VisionEngine

    n_steps = 16
    eng = VisionEngine(params_on(params, "cuda"), backend="fixed_cuda",
                       batch_size=ENGINE_BATCH, device="cuda")
    batch = list(images[:ENGINE_BATCH * n_steps])
    eng.submit_many(batch)
    t0 = time.perf_counter()
    served = eng.run()
    run_wall_s = time.perf_counter() - t0
    busy_s = eng.stats()["busy_s"]
    expect(served == len(batch), f"host breakdown: served {served}")
    emit("host", steps=n_steps, wall_ms=run_wall_s * 1e3, busy_ms=busy_s * 1e3,
         step_wall_ms=run_wall_s / n_steps * 1e3, step_busy_ms=busy_s / n_steps * 1e3,
         step_outside_busy_ms=(run_wall_s - busy_s) / n_steps * 1e3,
         served_per_wall_s=served / run_wall_s, card=card)

    eng.submit_many(batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        served = eng.run()
        wall_s = time.perf_counter() - t0
    expect(served == len(batch), f"profile: served {served}")
    dev, rows = device_profile(prof, wall_s)
    host = sorted(rows, key=lambda e: e.self_cpu_time_total, reverse=True)
    emit("profile", steps=n_steps, wall_ms=wall_s * 1e3, **dev,
         host_op_ms=sum(e.self_cpu_time_total for e in rows) / 1e3,
         top_host_ops=[{"name": e.key[:80], "calls": e.count,
                        "host_us": e.self_cpu_time_total} for e in host[:12]],
         card=card)


def device_profile(prof, wall_s):
    """Device busy time, its share of `wall_s`, and the top device ops of a
    torch.profiler run."""
    dev = lambda e: getattr(e, "self_device_time_total", 0) or 0
    rows = sorted(prof.key_averages(), key=dev, reverse=True)
    device_us = sum(dev(e) for e in rows)
    top = [{"name": e.key[:80], "calls": e.count, "device_us": dev(e)}
           for e in rows[:10] if dev(e) > 0]
    return {"device_busy_ms": device_us / 1e3 if device_us else "not measured",
            "device_busy_share": (device_us / 1e6 / wall_s) if device_us else "not measured",
            "top_device_ops": top}, rows


def phase_sweep_profile(card):
    """Where a swept frame's time goes (112x112, frame_trunk route, Q16.16).
    First 16 direct `FcnSweep.score` calls, one after another, without a
    profiler: the sweep call's wall time per frame, which the pipeline's
    frame time contains.  Then a torch.profiler trace of 16 frames through
    the pipeline: device busy share over the run's wall time, the device
    time by kernel and the host time by op (the profiler's own host cost
    lowers the share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.vision_engine import VisionEngine
    from repro_torch.streaming import FcnSweep, StreamingPipeline, SyntheticVideoSource

    params = fixture_params()
    n = 16
    source = SyntheticVideoSource(seed=7, frame_shape=(112, 112), n_frames=n)
    eng = VisionEngine(params_on(params, "cuda"), backend="fixed_cuda",
                       batch_size=ENGINE_BATCH, device="cuda")
    sweep = FcnSweep(stride=SWEEP_STRIDE)
    pipe = StreamingPipeline(source, eng, sweep)
    batches = [sweep.extract(f)[0] for f in source.frames()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fb in batches:
        sweep.score(eng.params, fb, backend=eng.backend, device="cuda")
    score_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.run()
        wall_s = time.perf_counter() - t0
    expect(pipe.stats()["frames_served"] == n, "sweep profile: frames served")
    dev, rows = device_profile(prof, wall_s)
    host = sorted(rows, key=lambda e: e.self_cpu_time_total, reverse=True)
    emit("profile", path="sweep 112x112 q16_16", frames=n,
         score_call_wall_ms=score_s / n * 1e3, wall_ms=wall_s * 1e3,
         frame_wall_ms=wall_s / n * 1e3, **dev,
         host_op_ms=sum(e.self_cpu_time_total for e in rows) / 1e3,
         top_host_ops=[{"name": e.key[:80], "calls": e.count,
                        "host_us": e.self_cpu_time_total} for e in host[:12]],
         card=card)


def params_on(params, device):
    from repro_torch.core.convert import params_from_jax
    return params_from_jax(params, device)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs "
              "only on a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir() or not all(
            f.is_file() for f in (GOLDEN, SEEDED_PARAMS, SWEEP_GOLDEN, TRUNK_GOLDEN)):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch and tests/golden are missing)", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    kind = torch.cuda.get_device_name(0)
    run(nvidia_smi_line(), kind, torch.cuda.device_count())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def run(card: str, kind: str, count: int) -> None:
    """Every phase; raises on the first failure."""
    import torch
    print(card, flush=True)
    emit("device", nvidia_smi=card, torch_device_name=kind, device_count=count,
         torch=torch.__version__, cuda=torch.version.cuda)

    from repro_torch.kernels import _build
    _build.build_all()
    regs = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln]
            for k, v in _build.build_report().items()}
    emit("build", seconds=_build.build_seconds, sources=list(_build.SOURCES),
         ptxas=regs)

    phase_golden()
    phase_sweep_golden()
    table = phase_kernels(card)
    table["frame_trunk"] = phase_frame_trunk_kernel(card)

    from repro_torch.core import backends as B
    from repro_torch.core import fixed_point as fxp
    from repro_torch.data import synth_mnist

    @dataclasses.dataclass(frozen=True)
    class ComposedStages(B.FixedCudaBackend):
        """fixed_cuda with the stage composed of two launches (conv+PLAN,
        then the max pool), as the frame sweep composes its stages."""
        name: str = "fixed_cuda_composed"

        def fused_conv_act_pool(self, x, w, b):
            return self.maxpool2x2(self.fused_conv_act(x, w, b))

    params = seeded_params(0)
    images, _ = synth_mnist.make_dataset(N_REQUESTS, seed=1)
    served = {"fixed_conv2d": 2, "fixed_dense": 1, "fixed_sigmoid": 1}
    runs = [
        serve_once(params, images, "fixed_cuda", "serve q16_16", card, served),
        serve_once(params, images, B.FixedCudaBackend(cfg=fxp.Q8_8),
                   "serve q8_8", card, served),
        serve_once(params, images[:256], ComposedStages(), "composed q16_16", card,
                   dict(served, fixed_maxpool2x2=2)),
    ]
    runs += phase_sweep(card)
    phase_profile(params, images, card)
    phase_sweep_profile(card)
    for name, row in table.items():
        row["launches"] = sum(c.get(name, 0) for c in runs)
        expect(row["launches"] > 0, f"{name}: no launch on the served and swept paths")
    print(card, flush=True)
    print(json.dumps({"kernels": list(table.values())}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
