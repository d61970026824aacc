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
            word, in all five STANDARD_CONFIGS
  kernel    per kernel: the kernel against its plain PyTorch version on the
            card (torch.equal on int32 words) in all five configs, at the
            engine's shapes (B=64) and at large shapes (B=16384 images, a
            512x512 frame, odd extents, stride 2), with random words that
            include max_int, min_int and INT32_MIN; then its median time
            (CUDA events), its bound, the plain version's time and, where one
            PyTorch call computes the same function, that call's time
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
  host      16 synchronous served steps: wall time per step against the
            engine's busy window per step, and the host time outside it
  profile   a torch.profiler trace of 16 served steps: device busy share and
            the device time by kernel
  kernels   one line listing every ported kernel (launches counted on the
            serve and composed paths, reset to 0 before each and read after)

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

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
# int32 on the CUDA cores, not in the guide's table: 132 SMs x 64 INT32
# lanes x 1.98 GHz boost, the clocks behind the data sheet's 67 TFLOP/s fp32
INT32_OPS_PER_S = 132 * 64 * 1.98e9

ENGINE_BATCH = 64
LARGE_BATCH = 16384
N_REQUESTS = 1024

KERNELS = {
    "fixed_conv2d": ("src/repro_torch/csrc/fixed_conv.cu",
                     "src/repro/kernels/fixed_conv/kernel.py:85"),
    "fixed_maxpool2x2": ("src/repro_torch/csrc/fixed_conv.cu",
                         "src/repro/kernels/fixed_conv/kernel.py:115"),
    "fixed_sigmoid": ("src/repro_torch/csrc/fixed_conv.cu",
                      "src/repro/kernels/fixed_conv/kernel.py:133"),
    "fixed_dense": ("src/repro_torch/csrc/fixed_dense.cu",
                    "src/repro/kernels/quant_matmul/kernel.py:85"),
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
    dev = lambda e: getattr(e, "self_device_time_total", 0) or 0
    rows = sorted(prof.key_averages(), key=dev, reverse=True)
    device_us = sum(dev(e) for e in rows)
    top = [{"name": e.key[:80], "calls": e.count, "device_us": dev(e)}
           for e in rows[:10] if dev(e) > 0]
    host = sorted(rows, key=lambda e: e.self_cpu_time_total, reverse=True)
    emit("profile", steps=n_steps, wall_ms=wall_s * 1e3,
         device_busy_ms=device_us / 1e3 if device_us else "not measured",
         device_busy_share=(device_us / 1e6 / wall_s) if device_us else "not measured",
         top_device_ops=top,
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
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.is_file():
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
    table = phase_kernels(card)

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
    phase_profile(params, images, card)
    for name, row in table.items():
        row["launches"] = sum(c.get(name, 0) for c in runs)
        expect(row["launches"] > 0, f"{name}: no launch on the served paths")
    print(card, flush=True)
    print(json.dumps({"kernels": list(table.values())}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
