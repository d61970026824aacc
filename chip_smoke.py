#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root; needs one CUDA
                                   # card, torch built for CUDA, and nvcc

Phases, each printing one JSON line (`{"phase": ...}`):

  device    the card's name and power limit (nvidia-smi),
            torch.cuda.get_device_name, and the entry `analysis/mfu.resolve()`
            takes for it, whose peaks (DEVICE_DB["h100"]) every bound below
            divides by
  build     compile the kernels of src/repro_torch/csrc with nvcc (sm_90a),
            timed, with ptxas' register counts
  ptxas     for the redesigned sources (quant_matmul.cu, frame_trunk.cu,
            fixed_dense.cu, fixed_net.cu, float_kernels.cu, float_net.cu):
            each kernel's registers, spills and static shared memory from
            `-Xptxas -v`, and its SASS instruction counts (cuobjdump); in
            float_kernels.cu conv2d_direct_kernel is the one-thread-per-
            output conv2d of PR 13 (kept for convs no tile fits) beside the
            tiled conv2d_tile_kernel<V,act,2x2>
  golden    each kernel against tests/golden/fixed_golden.json, word for
            word, in all five STANDARD_CONFIGS; then, with the committed
            params fixture tests/golden/seeded_params.json, the frame_trunk
            route against frame_trunk_golden.json (Q16.16 and Q8.8, all four
            role maps) and both sweep routes against sweep_golden.json (maps
            and the stride-8 window scores)
  kernel    per kernel: the kernel against its plain PyTorch version on the
            card (torch.equal on int32 words) in all five configs, at the
            engine's shapes (B=64) and at large shapes (B=16384 images, a
            512x512 frame, odd extents, stride 2; fixed_sigmoid at 2^24
            words, bytes-bound), with random words that
            include max_int, min_int and INT32_MIN; then its median time
            (CUDA events), its bound, the plain version's time and, where one
            PyTorch call computes the same function, that call's time.
            frame_trunk runs in the three wraparound configs and the generic
            kernel's Q12.4 (a saturating one must raise) at 112x112 (chosen
            and forced tiles), 104x132 (H/4 even, W/4 odd), 512x512 and
            1080x1920, with tiles past 48 KB of shared memory; times at the
            three frames in Q16.16, at 1080x1920 in each config and with
            forced tiles; fixed_dense also at the camera frame's window head
            (31,654 windows), on the rows route, and on the generic one
            where the launcher takes it (N > 16, rows past the shared
            memory), each shape's route named; the large case also in the
            saturating formats.  fixed_smallnet,
            the served step in one launch, at B = 1, 63, 64 and 16384 (and
            odd extents) in all five configs, timed in Q16.16 beside the
            composed four-launch step; fixed_window_head at 112x112, 56x84
            and 1080x1920 frames in all five configs, timed beside the
            four-op head (stack, gather, dense, PLAN).  float_smallnet,
            the served float step in one launch, within 2e-5 of its plain
            version with both activations at B = 1, 63, 64 and 16384 (and
            other extents, a NaN pixel), timed at 28x28 beside the composed
            float step's launches.  Then the float and
            int8 kernels: sigmoid_pla (torch.equal, shapes up to 2^24
            words, the breakpoints, +-0.0 and their float neighbours),
            maxpool2d (torch.equal in float32 and bfloat16, odd extents,
            NaN; timed at (16384,28,28,1) too, bytes-bound), conv2d (allclose 2e-5 and F.conv2d with TF32 off: the
            reference's six test shapes, each activation at the engine's
            shapes, a 512x512 stride-2 frame, the tiled kernel's edges
            (extents off the tile, Cout 1, 3, 16, 17, Cin 3, stride 3), a
            (16384,28,28,1) batch and a conv the direct kernel takes; the
            launcher's tile per case) and quant_matmul (an exact int32 sum at unit scales on
            both routes; rtol 1e-6 from (64,49,10) up to (4096,4096,4096),
            each shape's route named); library calls F.conv2d (TF32 off),
            F.max_pool2d and torch._int_mm where its shape rules allow (at
            4096^3 also with a column-major wq, and the transpose of wq
            alone)
  serve     VisionEngine(backend="fixed_cuda", batch_size=64, device="cuda"),
            threaded, over 1024 synth_mnist images in Q16.16 and in Q8.8:
            every score word equals the plain `fixed` backend's on the CPU,
            the ledger is accounted, and the launch counts rose by one
            fixed_smallnet launch per step; requests per second over the
            client's wall window and over the engine's busy time, and
            p50/p99 latency
  composed  the same engine over a backend that composes the net from its
            stages, each the conv+PLAN launch then the pool launch (the
            hooks the frame sweep composes): 2 conv, 2 pool, 1 dense and 1
            sigmoid launch per step, which drives the per-stage kernels on
            a served path
  serve     the float and int8 backends: VisionEngine over 1024 requests
            on cuda_plan and int8 and 256 on cuda, ref and plan; every
            score within 2e-5 of the same formed batch on the backend's
            plain counterpart on the CPU (ref for cuda, plan for cuda_plan,
            int8 on CPU tensors), int8's weight and activation words equal,
            and per step 1 float_smallnet on cuda and cuda_plan, 1
            quant_matmul on int8, none on ref and plan; a composed float
            engine (cuda_plan without its whole-net launch, 256 requests)
            keeps 2 conv2d + 2 maxpool2d + 1 sigmoid_pla a step on a served
            path
  train     deploy.train_smallnet(n_train=8000, n_test=2000, epochs=16,
            seed=0) on the card (autograd over the `ref` backend's plain ops,
            Adam; accuracy scored on `cuda`): wall seconds, steps/s, loss,
            train/test accuracy, test accuracy >= 0.80
  ladder    evaluate_all_paths(trained params, n_test=2000) through the
            kernel backends (1 float_smallnet, fixed_smallnet or
            quant_matmul launch a batch of 256), the same on the CPU (the
            plain versions): Q16.16 and int8 accuracies equal, the float
            keys' per-image Max Finder equal except at the CPU's near ties
            (top two within 2e-5, counted); Q16.16 and int8 within 0.06 of
            the float PLAN path; each path's distance below float32 printed
  latency   deploy.measure_latency of bake'd Q16.16 (fixed_cuda) and
            cuda_plan steps at batch 1 and 64
  router    ReplicaRouter.from_backends(trained params, [fixed_cuda,
            fixed_cuda, cuda_plan], batch_size=64, policy="slo",
            slo_ms=50): first its capacity (4096 requests submitted at
            once, drained closed loop), then LoadGen open loop: Poisson
            requests at 1/8, 1/4 and half that capacity (2048, 2048, 4096)
            and 4096 bursty ones at twice it (the serve phase's Q16.16 engine rate printed beside:
            the fleet's host work caps it far below); then a failover run (a replica whose first
            step raises, placed first) and an autoscale run (one replica, a
            spawn factory, the bursty schedule in 10 ms waves with
            autoscale() between them, then idle checks).  Each: fleet
            requests/s over the wall, p50/p99, goodput, sheds by reason; the
            fleet ledger accounted, every request served or shed, every
            served result equal to its replica backend's CPU counterpart
            (Q16.16 words exact, cuda_plan within 2e-5), launches equal to
            the replicas' steps
  sweep     StreamingPipeline(SyntheticVideoSource(seed=7, 112x112, 64
            frames), VisionEngine(backend="fixed_cuda", device="cuda"),
            FcnSweep(stride=8)) in throughput mode, in Q16.16 and Q8.8: each
            frame's detections equal the plain `fixed` sweep's on the CPU,
            the first 4 frames' score words equal the CPU's (sweep and host
            tiler), the ledger holds, and each frame is 1 frame_trunk and 1
            fixed_window_head launch; frames/s over the client's wall
            window and p50/p99 frame latency; each clip's launches a frame
            also read by the profiler (`analysis/launches.count_launches`)
            on one bare call.  Then the composed route
            (megakernel=False: 20 conv, 2 pool, 12 sigmoid, 1 dense per
            frame) beside it, and a 4-frame 1080x1920 clip through the
            frame_trunk route, word-checked against the CPU.  Then the same
            64-frame 112x112 clip on cuda_plan and int8 (the composed
            cascade: 20 conv2d, 2 maxpool2d, 12 sigmoid_pla a frame on
            cuda_plan, 1 quant_matmul on int8): window scores within 2e-5
            of the CPU sweep and tiler, detections equal (label and place;
            score within 2e-5), windows within 2e-5 of the threshold
            counted.  Then `analysis/mfu.roofline_terms` of the three trunk
            routes at 112x112 and 1080x1920, beside the composed cascade's
            and the frame_trunk launch's device times measured there
  disagg    `serving/disagg.DisaggServer` on fixed_cuda (`phase_disagg`):
            score words equal to FcnSweep.score on the card and to the CPU
            in Q16.16 and Q8.8 on both routes, at 112x112 and one
            1080x1920 frame (a miss, then hits); cuda_plan within 2e-5 and
            int8 equal; a cuda_plan hit launches only the head's share;
            RepeatedClipSource(16 frames, repeats=4) through
            StreamingPipeline: hit rate 0.75, 16 frame_trunk and 64
            fixed_window_head launches by LAUNCHES and by the profiler,
            every ledger accounted; frames/s of the monolithic loop and the
            disagg loops (repeated, distinct), best of 2, stage p50s,
            frame_digest's time; a started fleet (2 trunks, 2 heads):
            closed-loop capacity, then LoadGen Poisson at 1/8 and 1/2 of it
            with a 50 ms deadline; failover with trunk 0 faulted mid-run
  host      16 synchronous served steps: wall time per step against the
            engine's busy window per step, and the host time outside it
  profile   a torch.profiler trace of 16 served steps, then one of 16 sweep
            frames at 112x112: device busy share and device time by kernel
  kernels   one line listing every ported kernel (launches counted on the
            serve, composed, train, ladder, latency, router, sweep and disagg
            paths, reset to 0 before each and read after)

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

# the card's peaks, read from src/repro_torch/analysis/mfu.py's
# DEVICE_DB["h100"] (`load_peaks`, once the checkout is on the path): HBM
# bytes/s, int32 operations/s on the CUDA cores, fp32 FLOP/s, int8 tensor
# core operations/s
HBM_BYTES_PER_S = INT32_OPS_PER_S = F32_FLOPS_PER_S = INT8_OPS_PER_S = None
FLOAT_TOL = 2e-5            # float scores and conv outputs, rtol = atol

ENGINE_BATCH = 64
LARGE_BATCH = 16384
N_REQUESTS = 1024
SWEEP_FRAMES = 64
SWEEP_STRIDE = 8
CAMERA = (1080, 1920)
CAMERA_FRAMES = 4
# bursty traffic's on/off windows, scaled to a run of 4096 requests at
# tens of thousands a second (LoadGen's defaults, 0.25 s on and 0.75 s
# off, outlast such a run); duty 0.25 as the defaults
BURSTS = {"burst_on_s": 0.02, "burst_off_s": 0.06}
# the router phase's bars: the fleet's closed-loop rate as a share of one
# Q16.16 engine's wall rate, and goodput and p50 open loop at an eighth of
# the fleet's capacity
CAPACITY_FLOOR = 0.3
MIN_GOODPUT = 0.95
MAX_P50_MS = 10.0
# the disagg phase: frames word-checked a route and format; the repeated
# clip's distinct frames and repeats (a 0.75 hit rate); the open-loop
# query pool, its calibration passes, requests a Poisson run, the fleet's
# intake bound and deadline; passes of the pool in the failover run
DISAGG_WORD_FRAMES = 8
DISAGG_DISTINCT = 16
DISAGG_REPEATS = 4
DISAGG_POOL = 32
DISAGG_PASSES = 8
DISAGG_OPEN_LOOP_REQUESTS = 512
DISAGG_MAX_QUEUE = 128
DISAGG_SLO_MS = 50.0
DISAGG_FAILOVER_PASSES = 4
SATURATING = ("q16_16", "q16_16_sat", "q8_8_sat")   # a case timed in these formats too

KERNELS = {
    "fixed_conv2d": ("src/repro_torch/csrc/fixed_conv.cu",
                     "src/repro/kernels/fixed_conv/kernel.py:85"),
    "fixed_maxpool2x2": ("src/repro_torch/csrc/fixed_conv.cu",
                         "src/repro/kernels/fixed_conv/kernel.py:115"),
    "fixed_sigmoid": ("src/repro_torch/csrc/fixed_conv.cu",
                      "src/repro/kernels/fixed_conv/kernel.py:133"),
    "fixed_dense": ("src/repro_torch/csrc/fixed_dense.cu",
                    "src/repro/kernels/quant_matmul/kernel.py:85"),
    # the served step in one launch: rows 1, 3 and 4 fused, in row 1's place
    "fixed_smallnet": ("src/repro_torch/csrc/fixed_net.cu",
                       "src/repro/kernels/fixed_conv/kernel.py:85"),
    # the sweep's window head in one launch: row 4 with its gather and PLAN
    "fixed_window_head": ("src/repro_torch/csrc/fixed_dense.cu",
                          "src/repro/kernels/quant_matmul/kernel.py:85"),
    "frame_trunk": ("src/repro_torch/csrc/frame_trunk.cu",
                    "src/repro/kernels/frame_trunk/kernel.py:172"),
    "conv2d": ("src/repro_torch/csrc/float_kernels.cu",
               "src/repro/kernels/conv2d/kernel.py:58"),
    # the served float step in one launch: rows 6, 7 and 8 fused, in row 6's place
    "float_smallnet": ("src/repro_torch/csrc/float_net.cu",
                       "src/repro/kernels/conv2d/kernel.py:58"),
    "maxpool2d": ("src/repro_torch/csrc/float_kernels.cu",
                  "src/repro/kernels/maxpool2d/kernel.py:21"),
    "sigmoid_pla": ("src/repro_torch/csrc/float_kernels.cu",
                    "src/repro/kernels/sigmoid_pla/kernel.py:27"),
    "quant_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                     "src/repro/kernels/quant_matmul/kernel.py:42"),
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


def load_peaks() -> str:
    """Set the peak rates from the port's one definition of the card's
    peaks; returns the entry's derivation."""
    global HBM_BYTES_PER_S, INT32_OPS_PER_S, F32_FLOPS_PER_S, INT8_OPS_PER_S
    from repro_torch.analysis.mfu import DEVICE_DB
    h100 = DEVICE_DB["h100"]
    HBM_BYTES_PER_S = h100.mem_bw
    INT32_OPS_PER_S = h100.peak("int32")
    F32_FLOPS_PER_S = h100.peak("f32")
    INT8_OPS_PER_S = h100.peak("int8")
    return h100.source


def profiled_device_ms(fn, reps: int) -> float:
    """Device time of one call of `fn`: the durations of the device
    activity (kernels, copies, fills) that torch.profiler saw over `reps`
    calls, summed, over `reps`.  Gaps between launches are not counted, and
    a call that waits on the host is timed right."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    expect(us > 0, "profiled_device_ms: the profiler saw no device activity")
    return us / reps / 1e3


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float | None = None) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (ops_per_s or INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- the kernels' cases ----------------------------------------------------------

def conv_work(B, H, W, pool, stride=1):
    Ho, Wo = (H // 2, W // 2) if pool else (-(-H // stride), -(-W // stride))
    words = B * (2 * Ho) * (2 * Wo) if pool else B * Ho * Wo    # conv words computed
    return 4 * (B * H * W + B * Ho * Wo + 5), 8 * words        # 4 taps x (mul + add)


def camera_windows() -> int:
    """Windows of one camera frame at the sweep's stride (the window head's
    batch on the 1080x1920 sweep)."""
    from repro_torch.streaming import FcnSweep
    return len(FcnSweep(stride=SWEEP_STRIDE).positions(CAMERA))


def kernel_cases():
    """name -> list of (label, make(rng, cfg) -> args, kwargs, work(bytes, ops),
    timed-at-engine-shape?)."""
    E, L, C = ENGINE_BATCH, LARGE_BATCH, camera_windows()

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
            # 134 MB moved: a shape where the bytes, not the launch, set the bound
            ("bytes-bound (2^24,)", *sigmoid(1 << 24), "large"),
        ],
        # the launcher takes the rows route where N <= 16 and the rows fit
        # the shared memory, the generic route elsewhere
        "fixed_dense": [
            ("engine (64,49)@(49,10)", *dense(E, 49, 10), "engine"),
            ("large (16384,49)@(49,10)", *dense(L, 49, 10), "large", SATURATING),
            (f"camera window head ({C},49)@(49,10)", *dense(C, 49, 10), "large"),
            ("N > 16: (16384,49)@(49,20)", *dense(L, 49, 20), "generic"),
            ("long rows (100,900)@(900,10)", *dense(100, 900, 10), "generic"),
            ("N = 16 (130,49)@(49,16)", *dense(130, 49, 16), None),
            ("N = 11 (65,49)@(49,11)", *dense(65, 49, 11), None),
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
        for label, make, (nbytes, ops), timing, *timed_cfgs in cases:
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
                if timing is None or cname not in (timed_cfgs[0] if timed_cfgs
                                                   else ("q16_16",)):
                    continue
                reps = 200 if label.startswith("engine") else 20
                ms = device_ms(lambda: kernel(*args, **kw), reps)
                pms = device_ms(lambda: plain(*args, **kw), max(reps // 10, 5))
                b_ms, b_by = bound_ms(nbytes, ops)
                lms = (device_ms(lambda: lib_fn(*args), reps)
                       if lib_fn is not None else None)
                shapes.append({"case": label, "cfg": cname, "timing": timing, "ms": ms,
                               "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by,
                               "library_ms": lms, "bytes": nbytes, "ops": ops})
                if name == "fixed_dense":                  # the launcher's choice
                    shapes[-1]["route"] = D.fixed_dense_route(*args[1].shape)

        if name == "fixed_dense":
            routes = {kn: D.fixed_dense_route(*kn) for kn in ((49, 10), (49, 20), (900, 10))}
            expect(routes == {(49, 10): "rows", (49, 20): "generic", (900, 10): "generic"},
                   f"fixed_dense routes {routes}")

        def total(timing, key):
            return sum(r[key] for r in shapes if r["timing"] == timing and r["cfg"] == "q16_16")
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


def smallnet_work(B, H, W, N):
    """(bytes, integer operations) of the whole net over B (H, W) images,
    counted as conv_work and the dense case count them: each image word
    and each of the 10 + K*N + N parameter words read once, each score
    written once; 8 ops a conv word's four taps (four conv words a pooled
    word, at both levels), 2 a dense multiply-accumulate."""
    K = (H // 4) * (W // 4)
    nbytes = 4 * (B * H * W + 10 + K * N + N + B * N)
    return nbytes, B * (8 * 4 * ((H // 2) * (W // 2) + K) + 2 * K * N)


def phase_smallnet_kernel(card: str) -> dict:
    """fixed_smallnet, the served step in one launch, against its plain
    version (the stages composed) on the card, word for word, in all five
    configs at B = 1, 63, 64 and 16384 (and odd extents); its time, bound
    and plain time in Q16.16 at each B, beside the composed four-launch
    step (2 fixed_conv2d, fixed_dense, fixed_sigmoid) at the same B."""
    import numpy as np
    import torch
    from repro_torch.core import fixed_point as fxp
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.kernels.fixed_conv import ops as C
    from repro_torch.kernels.quant_matmul import ops as D

    rng = np.random.default_rng(2028)
    cases = [(1, 28, 28, 10), (63, 28, 28, 10), (ENGINE_BATCH, 28, 28, 10),
             (LARGE_BATCH, 28, 28, 10), (3, 37, 53, 10), (2, 9, 8, 16), (5, 64, 64, 3)]
    reset_launches()
    max_err, n_checked, shapes = 0, 0, []
    for cname, cfg in fxp.STANDARD_CONFIGS.items():
        for B, H, W, N in cases:
            K = (H // 4) * (W // 4)
            args = [torch.from_numpy(random_words(rng, shape, cfg)).cuda()
                    for shape in ((B, H, W), (4,), (1,), (4,), (1,), (K, N), (N,))]
            got = C.fixed_smallnet(*args, cfg=cfg)
            want = C.fixed_smallnet_plain(*args, cfg=cfg)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            expect(got.shape == want.shape and torch.equal(got, want),
                   f"fixed_smallnet B={B} {H}x{W} N={N} {cname}: kernel differs from plain "
                   f"(max |err| {err})")
            max_err, n_checked = max(max_err, err), n_checked + 1
            if cname != "q16_16" or (H, W) != (28, 28):
                continue
            x, c1w, c1b, c2w, c2b, dw, db = args

            def composed():
                y = C.fixed_conv2d(x, c1w, c1b, cfg=cfg, activation="plan", pool=True)
                y = C.fixed_conv2d(y, c2w, c2b, cfg=cfg, activation="plan", pool=True)
                return C.fixed_sigmoid(D.fixed_dense(y.reshape(B, -1), dw, db, cfg=cfg),
                                       cfg=cfg)
            expect(torch.equal(composed(), got), f"fixed_smallnet B={B}: the composed "
                   "step differs")
            reps = 200 if B <= ENGINE_BATCH else 20
            nbytes, ops = smallnet_work(B, H, W, N)
            b_ms, b_by = bound_ms(nbytes, ops)
            shapes.append({"case": f"B={B} (28,28) -> ({B},10)", "ms": device_ms(
                lambda: C.fixed_smallnet(*args, cfg=cfg), reps),
                "plain_ms": device_ms(lambda: C.fixed_smallnet_plain(*args, cfg=cfg),
                                      max(reps // 10, 5)),
                "composed_4_launch_ms": device_ms(composed, reps),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "bytes": nbytes, "ops": ops})
    # below 4x4; K != 49; past the shared memory (the launcher refuses it)
    for bad in ({"shape": (2, 3, 28)}, {"dw": (48, 10)},
                {"shape": (1, 200, 200), "dw": (2500, 10)}):
        shape = bad.get("shape", (2, 28, 28))
        args = [torch.zeros(sh, dtype=torch.int32, device="cuda")
                for sh in (shape, (4,), (1,), (4,), (1,), bad.get("dw", (49, 10)), (10,))]
        try:
            C.fixed_smallnet(*args)
        except ValueError:
            continue
        raise SmokeError(f"fixed_smallnet {bad}: expected ValueError")
    eng = next(r for r in shapes if r["case"].startswith(f"B={ENGINE_BATCH} "))
    table = {"name": "fixed_smallnet", "route": "cuda", "source": KERNELS["fixed_smallnet"][0],
             "replaces": KERNELS["fixed_smallnet"][1], "launches": 0, "max_abs_err": max_err,
             **{k: eng[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
    emit("kernel", name="fixed_smallnet", checked=n_checked, max_abs_err=max_err,
         launches_in_this_phase=launches().get("fixed_smallnet", 0), card=card,
         engine_step=table, shapes=shapes,
         library="none: no PyTorch call computes the Qm.n net")
    return table


def float_smallnet_work(B, H, W, N, act):
    """(bytes, float32 operations) of the whole float net over B (H, W)
    images, counted as conv_float_work counts: each image float and each of
    the 10 + K*N + N parameters read once, each score written once; per
    conv output 8 for its four taps, 1 for its bias and the activation's (4
    sigmoid, 3 PLAN), four conv outputs a pooled float at both levels and 3
    compares; per score 2 a dense multiply-accumulate, its bias and its
    activation."""
    K = (H // 4) * (W // 4)
    a = {"sigmoid": 4, "plan": 3}[act]
    pooled = (H // 2) * (W // 2) + K
    per_image = pooled * (4 * (8 + 1 + a) + 3) + N * (2 * K + 1 + a)
    return 4 * (B * H * W + 10 + K * N + N + B * N), B * per_image


def phase_float_smallnet_kernel(card: str) -> dict:
    """float_smallnet, the served float step in one launch, against its
    plain version (the stages composed) on the card within FLOAT_TOL, with
    both activations at B = 1, 63, 64 and 16384 (and other extents); at
    28x28 its time, bound and plain time beside the composed float step's
    launches (conv2d, maxpool2d, conv2d, maxpool2d, the matmul, the bias add
    and sigmoid_pla or torch.sigmoid) at the same B; a NaN pixel through
    both pools; the shapes the launcher refuses."""
    import numpy as np
    import torch
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.kernels.conv2d import conv2d, float_smallnet, float_smallnet_plain
    from repro_torch.kernels.maxpool2d import maxpool2d
    from repro_torch.kernels.sigmoid_pla import sigmoid_pla

    rng = np.random.default_rng(2030)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    cases = [(1, 28, 28, 10), (63, 28, 28, 10), (ENGINE_BATCH, 28, 28, 10),
             (LARGE_BATCH, 28, 28, 10), (3, 37, 53, 10), (2, 32, 24, 10), (5, 64, 64, 3)]
    reset_launches()
    max_err, n_checked, shapes = 0.0, 0, []
    for act in ("plan", "sigmoid"):
        for B, H, W, N in cases:
            K = (H // 4) * (W // 4)
            args = [f32(rng.normal(size=(B, H, W, 1))), f32(rng.uniform(-1.5, 1.5, (2, 2, 1, 1))),
                    f32(rng.normal(0, 0.5, (1,))), f32(rng.uniform(-1.5, 1.5, (2, 2, 1, 1))),
                    f32(rng.normal(0, 0.5, (1,))), f32(rng.uniform(-0.6, 0.6, (K, N))),
                    f32(rng.normal(0, 0.5, (N,)))]
            got = float_smallnet(*args, activation=act)
            want = float_smallnet_plain(*args, activation=act)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            expect(got.shape == want.shape
                   and torch.allclose(got, want, rtol=FLOAT_TOL, atol=FLOAT_TOL),
                   f"float_smallnet B={B} {H}x{W} N={N} {act}: kernel differs from plain "
                   f"(max |err| {err})")
            max_err, n_checked = max(max_err, err), n_checked + 1
            if (H, W) != (28, 28):
                continue
            x, c1w, c1b, c2w, c2b, dw, db = args

            def composed(x=x, c1w=c1w, c1b=c1b, c2w=c2w, c2b=c2b, dw=dw, db=db, B=B, act=act):
                y = maxpool2d(conv2d(x, c1w, c1b, activation=act))
                y = maxpool2d(conv2d(y, c2w, c2b, activation=act))
                s = y.reshape(B, -1) @ dw + db
                return sigmoid_pla(s) if act == "plan" else torch.sigmoid(s)
            expect(torch.allclose(composed(), got, rtol=FLOAT_TOL, atol=FLOAT_TOL),
                   f"float_smallnet B={B} {act}: the composed step differs")
            pre = torch.zeros((B, N), device="cuda")

            def composed_kernels(x=x, c1w=c1w, c1b=c1b, c2w=c2w, c2b=c2b, pre=pre, act=act):
                # the composed step's hand-written kernels alone, without the
                # matmul and the bias add
                y = maxpool2d(conv2d(maxpool2d(conv2d(x, c1w, c1b, activation=act)), c2w, c2b,
                                     activation=act))
                return sigmoid_pla(pre) if act == "plan" else y
            reps = 200 if B <= ENGINE_BATCH else 20
            nbytes, ops = float_smallnet_work(B, H, W, N, act)
            b_ms, b_by = bound_ms(nbytes, ops, F32_FLOPS_PER_S)
            shapes.append({"case": f"B={B} (28,28,1) -> ({B},10) {act}", "ms": device_ms(
                lambda: float_smallnet(*args, activation=act), reps),
                "plain_ms": device_ms(lambda: float_smallnet_plain(*args, activation=act),
                                      max(reps // 10, 5)),
                "composed_step_ms": device_ms(composed, reps),
                "composed_kernels_ms": device_ms(composed_kernels, reps),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "bytes": nbytes, "ops": ops})
    # a NaN pixel: its image's scores are NaN, through both pools
    x, *rest = args
    x = x.clone()
    x[1, 13, 6, 0] = float("nan")
    got = float_smallnet(x, *rest, activation="sigmoid")
    want = float_smallnet_plain(x, *rest, activation="sigmoid")
    expect(bool(torch.isnan(got[1]).all()) and torch.equal(torch.isnan(got), torch.isnan(want))
           and torch.allclose(torch.nan_to_num(got), torch.nan_to_num(want), rtol=FLOAT_TOL,
                              atol=FLOAT_TOL),
           "float_smallnet: a NaN pixel does not propagate as in torch.maximum")
    n_checked += 1
    # K != (H/4)(W/4) (the wrapper); past the shared memory (the launcher)
    for shape, dw_shape in (((2, 28, 28, 1), (48, 10)), ((1, 200, 200, 1), (2500, 10))):
        z = [torch.zeros(sh, device="cuda") for sh in
             (shape, (2, 2, 1, 1), (1,), (2, 2, 1, 1), (1,), dw_shape, (dw_shape[1],))]
        try:
            float_smallnet(*z)
        except ValueError:
            continue
        raise SmokeError(f"float_smallnet {shape} dw {dw_shape}: expected ValueError")
    eng = next(r for r in shapes if r["case"].startswith(f"B={ENGINE_BATCH} ")
               and r["case"].endswith("plan"))
    table = {"name": "float_smallnet", "route": "cuda", "source": KERNELS["float_smallnet"][0],
             "replaces": KERNELS["float_smallnet"][1], "launches": 0, "max_abs_err": max_err,
             **{k: eng[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
    emit("kernel", name="float_smallnet", checked=n_checked, max_abs_err=max_err,
         tolerance=FLOAT_TOL, launches_in_this_phase=launches().get("float_smallnet", 0),
         card=card, engine_step=table, shapes=shapes,
         library="none: no PyTorch call computes the float net")
    return table


def window_head_work(Nw, h, w, K, N):
    """(bytes, integer operations) of the window head: the four (h, w)
    maps, the offsets, w and b read once, the scores written once; 2 ops a
    dense multiply-accumulate."""
    return 4 * (4 * h * w + 2 * Nw + K * N + N + Nw * N), 2 * Nw * K * N


def phase_window_head_kernel(card: str) -> dict:
    """fixed_window_head against its plain version (stack, gather, dense,
    PLAN in torch ops) on the card, word for word, in all five configs at
    112x112, 56x84 and 1080x1920 frames, N = 10 and 16; in Q16.16 at
    112x112 and 1080x1920 its time, bound and plain time beside the
    four-op head the sweep took before (torch.stack, the index gather, the
    fixed_dense and fixed_sigmoid kernels)."""
    import numpy as np
    import torch
    from repro_torch.core import fixed_point as fxp
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.kernels.fixed_conv import ops as C
    from repro_torch.kernels.quant_matmul import ops as D
    from repro_torch.streaming import FcnSweep
    from repro_torch.streaming.fcn_sweep import _window_gather, _window_origins

    rng = np.random.default_rng(2029)
    dev = torch.device("cuda")
    timed = {(112, 112): "sweep frame 112x112", CAMERA: "camera frame 1080x1920"}
    reset_launches()
    max_err, n_checked, shapes = 0, 0, []
    for cname, cfg in fxp.STANDARD_CONFIGS.items():
        for H, W in ((112, 112), (56, 84), CAMERA):
            h, w = H // 4, W // 4
            pos = tuple(FcnSweep(stride=SWEEP_STRIDE).positions((H, W)))
            gy, gx = _window_origins(28, pos, (h, w), dev)
            quad = torch.from_numpy(random_words(rng, (4, h, w), cfg)).cuda()
            for N in (10, 16):
                wd = torch.from_numpy(random_words(rng, (49, N), cfg)).cuda()
                bd = torch.from_numpy(random_words(rng, (N,), cfg)).cuda()
                got = D.fixed_window_head(quad, gy, gx, wd, bd, cfg=cfg)
                want = D.fixed_window_head_plain(quad, gy, gx, wd, bd, cfg=cfg)
                torch.cuda.synchronize()
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                expect(got.shape == want.shape == (len(pos), N) and torch.equal(got, want),
                       f"fixed_window_head {H}x{W} N={N} {cname}: kernel differs from "
                       f"plain (max |err| {err})")
                max_err, n_checked = max(max_err, err), n_checked + 1
                if cname != "q16_16" or N != 10 or (H, W) not in timed:
                    continue
                maps = [quad[k] for k in range(4)]
                gather = _window_gather(28, pos, (h, w), dev)

                def four_op():
                    feats = torch.stack(maps).reshape(-1)[gather]
                    return C.fixed_sigmoid(D.fixed_dense(feats, wd, bd, cfg=cfg), cfg=cfg)
                expect(torch.equal(four_op(), got), f"fixed_window_head {H}x{W}: the four-op "
                       "head differs")
                nbytes, ops = window_head_work(len(pos), h, w, 49, N)
                b_ms, b_by = bound_ms(nbytes, ops)
                shapes.append({"case": timed[(H, W)], "windows": len(pos), "ms": device_ms(
                    lambda: D.fixed_window_head(maps, gy, gx, wd, bd, cfg=cfg), 50),
                    "plain_ms": device_ms(
                        lambda: D.fixed_window_head_plain(maps, gy, gx, wd, bd, cfg=cfg), 5),
                    "four_op_head_ms": device_ms(four_op, 50),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "bytes": nbytes, "ops": ops})
    try:                                       # N > 16 has no kernel: it raises
        D.fixed_window_head(quad, gy, gx, torch.zeros((49, 17), dtype=torch.int32, device=dev),
                            torch.zeros(17, dtype=torch.int32, device=dev))
        raise SmokeError("fixed_window_head N=17: expected ValueError")
    except ValueError:
        pass
    first = shapes[0]                                      # 112x112, Q16.16
    table = {"name": "fixed_window_head", "route": "cuda",
             "source": KERNELS["fixed_window_head"][0],
             "replaces": KERNELS["fixed_window_head"][1], "launches": 0, "max_abs_err": max_err,
             **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
    emit("kernel", name="fixed_window_head", checked=n_checked, max_abs_err=max_err,
         launches_in_this_phase=launches().get("fixed_window_head", 0), card=card,
         sweep_frame=table, shapes=shapes,
         library="none: no PyTorch call computes the Qm.n head")
    return table


def phase_frame_trunk_kernel(card: str) -> dict:
    """frame_trunk against its untiled plain version on the card, word for
    word, in the three wraparound configs, at every listed frame and tile;
    a saturating config and a tile that does not divide the frame raise."""
    import numpy as np
    import torch
    from repro_torch.analysis.mfu import frame_trunk_work
    from repro_torch.core import fixed_point as fxp
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.kernels.frame_trunk import ops as FT

    rng = np.random.default_rng(2026)
    max_err = 0
    # tiles past 48 KB of shared memory: (112,112), (56,112), (128,128),
    # (108,160); (108,48) is the chooser's pick before the redesign
    cases = [((112, 112), (None, (4, 4), (8, 16), (28, 56), (56, 112), (112, 112))),
             ((104, 132), (None, (8, 12))),
             ((512, 512), (None, (128, 128))),
             (CAMERA, (None, (108, 48), (108, 160)))]
    timed = {(112, 112): "sweep frame 112x112", (512, 512): "frame 512x512",
             CAMERA: "camera frame 1080x1920"}
    # the three wraparound STANDARD_CONFIGS take kernels specialised on
    # their format; Q12.4 takes the generic one
    configs = {name: fxp.STANDARD_CONFIGS[name] for name in ("q16_16", "q16_16_trunc", "q8_8")}
    configs["q12_4 (generic)"] = fxp.FixedPointConfig(16, 4)
    reset_launches()
    n_checked, shapes = 0, []

    def row(case, cname, H, W, tile, ms, plain_ms):
        nbytes, ops = frame_trunk_work(H, W)
        b_ms, b_by = bound_ms(nbytes, ops)
        return {"case": case, "cfg": cname, "tile": list(tile),
                "smem_bytes": FT.frame_trunk_smem_bytes(*tile), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, "bytes": nbytes, "ops": ops}

    for cname, cfg in configs.items():
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
            if (H, W) not in timed or (cname != "q16_16" and (H, W) != CAMERA):
                continue
            chosen = FT.choose_tile(H, W)
            shapes.append(row(
                timed[(H, W)], cname, H, W, chosen,
                device_ms(lambda: FT.frame_trunk_quad(*args, cfg=cfg), 50),
                device_ms(lambda: FT.frame_trunk_quad_plain(*args, cfg=cfg), 5)))
            if cname == "q16_16" and (H, W) == CAMERA:     # the chooser's alternatives
                for tile in ((108, 48), (72, 120), (108, 160)):
                    shapes.append(row(
                        f"{timed[(H, W)]}, forced tile", cname, H, W, tile,
                        device_ms(lambda: FT.frame_trunk_quad(*args, cfg=cfg, tile=tile), 50),
                        None))
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
    first = shapes[0]                                      # 112x112, Q16.16
    table = {"name": "frame_trunk", "route": "cuda", "source": KERNELS["frame_trunk"][0],
             "replaces": KERNELS["frame_trunk"][1], "launches": 0, "max_abs_err": max_err,
             "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
             "bound_by": first["bound_by"], "library_ms": None}
    emit("kernel", name="frame_trunk", checked=n_checked, max_abs_err=max_err,
         launches_in_this_phase=launches().get("frame_trunk", 0), card=card,
         sweep_frame=table, shapes=shapes,
         library="none: no single PyTorch call computes the quad")
    return table


def conv_float_work(B, H, W, cin, kh, kw, cout, Ho, Wo, act):
    """(bytes, float32 operations) of one float conv: each input and output
    float once; 2 per multiply-accumulate, 1 per bias add, 4 per sigmoid
    (negate, exp, add, divide), 3 per PLAN word (abs, multiply, add)."""
    nbytes = 4 * (B * H * W * cin + kh * kw * cin * cout + cout + B * Ho * Wo * cout)
    per_out = 2 * kh * kw * cin + 1 + {None: 0, "sigmoid": 4, "plan": 3}[act]
    return nbytes, B * Ho * Wo * cout * per_out


def int_mm_allowed(M, K, N) -> bool:
    """torch._int_mm's shape rules on CUDA: M > 16, K and N multiples of 8,
    and K > 16 (cuBLASLt refuses K = 16 on the H100)."""
    return M > 16 and K > 16 and K % 8 == 0 and N % 8 == 0


def phase_float_kernels(card: str) -> dict:
    """The float and int8 kernels against their plain versions on the card,
    then their times: median device time, bound, plain time and, where one
    PyTorch call computes the same function, that call's time.  Each
    kernel's row in the `kernels` line is the work one composed float step
    of 64 asks of it (on cuda_plan without its whole-net launch: both conv
    launches, both pool launches, the (64,10) PLAN; on int8: the
    (64,49)@(49,10) dense)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.kernels.conv2d import conv2d, conv2d_plain, conv2d_tile
    from repro_torch.kernels.maxpool2d import maxpool2d, maxpool2d_plain
    from repro_torch.kernels.quant_matmul import (quant_matmul, quant_matmul_plain,
                                                  quant_matmul_route)
    from repro_torch.kernels.quant_matmul.ops import transpose_wq
    from repro_torch.kernels.sigmoid_pla import sigmoid_pla, sigmoid_pla_plain

    expect(torch.backends.cuda.matmul.allow_tf32 is False,
           "torch.backends.cuda.matmul.allow_tf32 is on: the float dense would "
           "compute in TF32")
    rng = np.random.default_rng(2027)
    dev = torch.device("cuda")
    E = ENGINE_BATCH

    def normal(shape, scale=1.0, dtype=torch.float32):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(
            dev, dtype)

    def timed(case, fn, plain, lib, work, rate, reps, timing):
        nbytes, ops = work
        b_ms, b_by = bound_ms(nbytes, ops, rate)
        return {"case": case, "timing": timing, "ms": device_ms(fn, reps),
                "plain_ms": device_ms(plain, max(reps // 10, 3)), "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": device_ms(lib, reps) if lib else None,
                "bytes": nbytes, "ops": ops}

    def row(name, shapes, max_err, n_checked, library):
        eng = [r for r in shapes if r["timing"] == "engine"]
        nbytes, ops = sum(r["bytes"] for r in eng), sum(r["ops"] for r in eng)
        rate = INT8_OPS_PER_S if name == "quant_matmul" else F32_FLOPS_PER_S
        b_ms, b_by = bound_ms(nbytes, ops, rate)
        libs = [r["library_ms"] for r in eng]
        table = {"name": name, "route": "cuda", "source": KERNELS[name][0],
                 "replaces": KERNELS[name][1], "launches": 0, "max_abs_err": max_err,
                 "ms": sum(r["ms"] for r in eng), "plain_ms": sum(r["plain_ms"] for r in eng),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": sum(libs) if all(v is not None for v in libs) else None}
        emit("kernel", name=name, checked=n_checked, max_abs_err=max_err,
             launches_in_this_phase=launches().get(name, 0), card=card,
             engine_step={k: v for k, v in table.items() if k != "launches"},
             shapes=shapes, library=library)
        return table

    table = {}
    reset_launches()

    # -- sigmoid_pla: torch.equal, the breakpoints and their neighbours -------
    pts = np.float32([0.0, 1.0, 2.375, 5.0])
    near = np.concatenate([pts, np.nextafter(pts, np.float32(-np.inf)),
                           np.nextafter(pts, np.float32(np.inf))])
    specials = np.concatenate([near, -near]).astype(np.float32)      # +-0.0 included
    shapes, n_checked = [], 0
    for shape in ((7,), (33, 5), (2, 3, 4, 5), (1000,), (256, 128), (1 << 24,)):
        for scale in (0.1, 4.0, 20.0):
            x = (rng.normal(size=shape) * scale).astype(np.float32).reshape(-1)
            k = min(x.size, specials.size)
            x[:k] = specials[:k]
            x = torch.from_numpy(x.reshape(shape)).to(dev)
            got, want = sigmoid_pla(x), sigmoid_pla_plain(x)
            torch.cuda.synchronize()
            expect(torch.equal(got, want),
                   f"sigmoid_pla {shape} x{scale}: kernel differs from plain (max |err| "
                   f"{float((got - want).abs().max())})")
            n_checked += 1
    x = normal((E, 10), 4.0)
    shapes.append(timed("engine (64,10)", lambda: sigmoid_pla(x),
                        lambda: sigmoid_pla_plain(x), None, (8 * x.numel(), 3 * x.numel()),
                        F32_FLOPS_PER_S, 200, "engine"))
    xl = normal((1 << 24,), 4.0)
    shapes.append(timed("large (2^24,)", lambda: sigmoid_pla(xl),
                        lambda: sigmoid_pla_plain(xl), None,
                        (8 * xl.numel(), 3 * xl.numel()), F32_FLOPS_PER_S, 20, "large"))
    table["sigmoid_pla"] = row("sigmoid_pla", shapes, 0.0, n_checked,
                               "none: no single PyTorch call computes the PLAN")

    # -- maxpool2d: torch.equal in float32 and bfloat16 -----------------------
    def lib_pool(x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)

    shapes, n_checked = [], 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((E, 28, 28, 1), (E, 14, 14, 1), (2, 15, 9, 2), (3, 37, 53, 16),
                      (1, 512, 512, 1)):
            x = normal(shape, 1.0, dtype)
            got, want = maxpool2d(x), maxpool2d_plain(x)
            torch.cuda.synchronize()
            expect(got.dtype == dtype and torch.equal(got, want),
                   f"maxpool2d {shape} {dtype}: kernel differs from plain")
            expect(torch.equal(lib_pool(x), got), f"maxpool2d {shape}: F.max_pool2d differs")
            n_checked += 1
        x = normal((2, 15, 9, 2), 1.0, dtype)
        x[0, 1, 1, 0] = float("nan")
        got, want = maxpool2d(x), maxpool2d_plain(x)
        expect(torch.equal(torch.isnan(got), torch.isnan(want))
               and bool(torch.isnan(got[0, 0, 0, 0]))
               and torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)),
               f"maxpool2d {dtype}: NaN does not propagate as in torch.maximum")
        n_checked += 1
    for H in (28, 14):
        x = normal((E, H, H, 1))
        n_out = E * (H // 2) ** 2
        shapes.append(timed(f"engine (64,{H},{H},1)", lambda x=x: maxpool2d(x),
                            lambda x=x: maxpool2d_plain(x), lambda x=x: lib_pool(x),
                            (4 * (4 * n_out + n_out), 3 * n_out), F32_FLOPS_PER_S, 200,
                            "engine"))
    x = normal((1, 512, 512, 1))
    shapes.append(timed("frame (1,512,512,1)", lambda: maxpool2d(x),
                        lambda: maxpool2d_plain(x), lambda: lib_pool(x),
                        (4 * 5 * 256 * 256, 3 * 256 * 256), F32_FLOPS_PER_S, 50, "large"))
    # 64.2 MB moved: a shape where the bytes, not the launch, set the bound
    x = normal((LARGE_BATCH, 28, 28, 1))
    got = maxpool2d(x)
    expect(torch.equal(got, maxpool2d_plain(x)) and torch.equal(lib_pool(x), got),
           f"maxpool2d ({LARGE_BATCH},28,28,1): kernel, plain and F.max_pool2d differ")
    n_checked += 1
    n_out = LARGE_BATCH * 14 * 14
    shapes.append(timed(f"bytes-bound ({LARGE_BATCH},28,28,1)", lambda: maxpool2d(x),
                        lambda: maxpool2d_plain(x), lambda: lib_pool(x),
                        (4 * (4 * n_out + n_out), 3 * n_out), F32_FLOPS_PER_S, 50, "large"))
    table["maxpool2d"] = row("maxpool2d", shapes, 0.0, n_checked,
                             "F.max_pool2d(kernel 2) on the NCHW view")

    # -- conv2d: allclose 2e-5 --------------------------------------------------
    def lib_conv(x, w, b, padding="SAME", stride=1):
        """F.conv2d on the NCHW views, SAME's bottom/right zeros padded where
        the strided outputs read them."""
        kh, kw = w.shape[:2]
        xc = x.permute(0, 3, 1, 2)
        if padding == "SAME":
            ph = max(0, (-(-x.shape[1] // stride) - 1) * stride + kh - x.shape[1])
            pw = max(0, (-(-x.shape[2] // stride) - 1) * stride + kw - x.shape[2])
            xc = F.pad(xc, (0, pw, 0, ph)) if ph or pw else xc
        return F.conv2d(xc, w.permute(3, 2, 0, 1), b, stride=stride).permute(0, 2, 3, 1)

    # the reference's six test shapes, the served step's two, the 512x512
    # frame; then the tiled kernel's edges (extents that are not multiples
    # of a tile, Cout 1, 3, 16 and 17, Cin 3, stride 3), a batch of 16384
    # images, and a conv whose single-pixel tile does not fit (the direct
    # kernel)
    cases = [((2, 28, 28, 1), (2, 2, 1, 1), "SAME", 1), ((2, 14, 14, 1), (2, 2, 1, 1), "SAME", 1),
             ((1, 16, 16, 3), (3, 3, 3, 8), "SAME", 1), ((3, 16, 12, 4), (2, 2, 4, 4), "VALID", 1),
             ((1, 32, 32, 2), (5, 5, 2, 6), "SAME", 2), ((2, 8, 8, 8), (1, 1, 8, 16), "VALID", 1),
             ((E, 28, 28, 1), (2, 2, 1, 1), "SAME", 1), ((E, 14, 14, 1), (2, 2, 1, 1), "SAME", 1),
             ((1, 512, 512, 1), (2, 2, 1, 16), "SAME", 2),
             ((2, 37, 53, 3), (2, 2, 3, 17), "SAME", 1), ((1, 41, 35, 3), (3, 3, 3, 16), "SAME", 3),
             ((1, 41, 35, 3), (3, 3, 3, 3), "VALID", 3), ((3, 29, 31, 1), (2, 2, 1, 3), "SAME", 2),
             ((2, 37, 53, 1), (2, 2, 1, 1), "SAME", 1), ((LARGE_BATCH, 28, 28, 1), (2, 2, 1, 1),
                                                         "SAME", 1),
             ((1, 5, 6, 1100), (2, 2, 1100, 4), "SAME", 1)]
    shapes, n_checked, max_err, tiles = [], 0, 0.0, []
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False       # F.conv2d in full float32
    try:
        for xs, ws, pad, stride in cases:
            x, w, b = normal(xs, 3.0), normal(ws), normal(ws[3:])
            if xs[3] > 64:
                # a sum of thousands of products, which cuDNN adds in another
                # order: positive terms keep its rounding relative
                x, w = x.abs(), w.abs()
            for act in (None, "sigmoid", "plan"):
                kw = dict(padding=pad, stride=stride, activation=act)
                got, want = conv2d(x, w, b, **kw), conv2d_plain(x, w, b, **kw)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                expect(got.shape == want.shape
                       and torch.allclose(got, want, rtol=FLOAT_TOL, atol=FLOAT_TOL),
                       f"conv2d {xs} {ws} {pad} s{stride} {act}: kernel differs from "
                       f"plain (max |err| {err})")
                max_err = max(max_err, err)
                n_checked += 1
            expect(torch.allclose(lib_conv(x, w, b, pad, stride),
                                  conv2d(x, w, b, padding=pad, stride=stride),
                                  rtol=FLOAT_TOL, atol=FLOAT_TOL),
                   f"conv2d {xs} {ws} {pad} s{stride}: F.conv2d differs")
            tiles.append({"x": list(xs), "w": list(ws), "padding": pad, "stride": stride,
                          "tile": conv2d_tile(xs, ws, stride=stride, padding=pad) or "direct"})
            if xs[0] == LARGE_BATCH:
                for act in ("plan", None):
                    shapes.append(timed(
                        f"large {xs} {act or 'pre-activation'}",
                        lambda x=x, w=w, b=b, act=act: conv2d(x, w, b, activation=act),
                        lambda x=x, w=w, b=b, act=act: conv2d_plain(x, w, b, activation=act),
                        (lambda x=x, w=w, b=b: lib_conv(x, w, b)) if act is None else None,
                        conv_float_work(*xs, 2, 2, 1, 28, 28, act), F32_FLOPS_PER_S, 20,
                        "large" if act else "large, no activation"))
            if xs[0] == E:                           # the served step's two convs
                Ho = xs[1]
                for act in ("plan", None):
                    shapes.append(timed(
                        f"engine {xs} {act or 'pre-activation'}",
                        lambda x=x, w=w, b=b, act=act: conv2d(x, w, b, activation=act),
                        lambda x=x, w=w, b=b, act=act: conv2d_plain(x, w, b, activation=act),
                        (lambda x=x, w=w, b=b: lib_conv(x, w, b)) if act is None else None,
                        conv_float_work(E, Ho, Ho, 1, 2, 2, 1, Ho, Ho, act), F32_FLOPS_PER_S,
                        200, "engine" if act == "plan" else "engine, no activation"))
        emit("kernel", name="conv2d", tiles=tiles,
             note="the launcher's tile per case: output rows TH and columns TW a block, "
                  "rows PR and channels V a thread, channels CC a block, shared-memory bytes")
        x, w, b = normal((1, 512, 512, 1), 3.0), normal((2, 2, 1, 16)), normal((16,))
        shapes.append(timed("frame (1,512,512,1)x(2,2,1,16) stride 2 plan",
                            lambda: conv2d(x, w, b, stride=2, activation="plan"),
                            lambda: conv2d_plain(x, w, b, stride=2, activation="plan"), None,
                            conv_float_work(1, 512, 512, 1, 2, 2, 16, 256, 256, "plan"),
                            F32_FLOPS_PER_S, 50, "large"))

        # the same frame pre-activation, beside F.conv2d (SAME at stride 2
        # pads nothing here: (256 - 1) * 2 + 2 == 512)
        shapes.append(timed("frame (1,512,512,1)x(2,2,1,16) stride 2 pre-activation",
                            lambda: conv2d(x, w, b, stride=2),
                            lambda: conv2d_plain(x, w, b, stride=2),
                            lambda: lib_conv(x, w, b, stride=2),
                            conv_float_work(1, 512, 512, 1, 2, 2, 16, 256, 256, None),
                            F32_FLOPS_PER_S, 50, "large, no activation"))
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    conv_row = row("conv2d", shapes, max_err, n_checked,
                   "F.conv2d on the NCHW view (SAME's zeros padded where read) with bias, "
                   "no activation, TF32 off")
    # the library computes the pre-activation conv: its time sits beside the
    # kernel's pre-activation time of the same two convs
    conv_row["library_ms"] = sum(r["library_ms"] for r in shapes
                                 if r["timing"] == "engine, no activation")
    table["conv2d"] = conv_row

    # -- quant_matmul: an exact int32 sum; rtol 1e-6 after the dequant --------
    def i8(shape):
        return torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8)).to(dev)

    for M, K, N in ((32, 1024, 16), (32, 49, 16)):   # both routes: the int32 sum is exact
        xq, wq = i8((M, K)), i8((K, N))
        xq[0], wq[:, 0] = -128, -128                 # the largest products
        got = quant_matmul(xq, wq, 1.0, 1.0)
        exact = (xq.cpu().to(torch.int64) @ wq.cpu().to(torch.int64)).to(torch.float32)
        expect(torch.equal(got.cpu(), exact),
               f"quant_matmul ({M},{K},{N}) {quant_matmul_route(xq, wq)}: the int32 sum "
               "is not exact")
    shapes, n_checked, max_rel, max_abs = [], 2, 0.0, 0.0
    not_allowed = []
    for M, K, N in ((E, 49, 10), (100, 300, 70), (513, 257, 129), (16384, 49, 10),
                    (129, 65, 97), (96, 4096, 130), (130, 16, 200), (200, 4160, 136),
                    (512, 512, 512), (4096, 4096, 4096)):
        xq, wq = i8((M, K)), i8((K, N))
        sx = torch.rand(M, device=dev) * 0.1 + 1e-3
        sw = torch.rand(N, device=dev) * 0.1 + 1e-3
        route = quant_matmul_route(xq, wq)
        got, want = quant_matmul(xq, wq, sx, sw), quant_matmul_plain(xq, wq, sx, sw)
        torch.cuda.synchronize()
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        expect(torch.allclose(got, want, rtol=1e-6, atol=0),
               f"quant_matmul ({M},{K},{N}) {route}: kernel differs from plain "
               f"(max rel {rel})")
        max_rel = max(max_rel, rel)
        max_abs = max(max_abs, float((got - want).abs().max()))
        n_checked += 1
        lib = None
        if int_mm_allowed(M, K, N):
            lib_out = torch._int_mm(xq, wq).to(torch.float32) * sx[:, None] * sw[None, :]
            expect(torch.allclose(lib_out, got, rtol=1e-6, atol=0),
                   f"quant_matmul ({M},{K},{N}): torch._int_mm differs")
            lib = lambda xq=xq, wq=wq: torch._int_mm(xq, wq)       # noqa: E731
        else:
            not_allowed.append([M, K, N])
        if (M, K, N) in ((E, 49, 10), (16384, 49, 10), (512, 512, 512), (4096, 4096, 4096)):
            reps = 200 if M == E else (50 if K == 49 else (20 if M == 512 else 5))
            r = timed(
                f"({M},{K})@({K},{N})", lambda xq=xq, wq=wq, sx=sx, sw=sw:
                quant_matmul(xq, wq, sx, sw),
                lambda xq=xq, wq=wq, sx=sx, sw=sw: quant_matmul_plain(xq, wq, sx, sw), lib,
                (M * K + K * N + 4 * (M + N) + 4 * M * N, 2 * M * K * N), INT8_OPS_PER_S,
                reps, "engine" if M == E else "large")
            r["route"] = route
            if (M, K, N) == (4096, 4096, 4096):
                # torch._int_mm with a column-major wq (cuBLAS's int8 layout),
                # and the wgmma route's transpose of wq alone (inside `ms`)
                wcm = wq.t().contiguous().t()
                r["library_colmajor_ms"] = device_ms(lambda: torch._int_mm(xq, wcm), reps)
                r["transpose_ms"] = device_ms(lambda: transpose_wq(wq), reps)
            shapes.append(r)
    emit("kernel", name="quant_matmul", max_rel_err=max_rel)
    table["quant_matmul"] = row(
        "quant_matmul", shapes, max_abs, n_checked,
        "torch._int_mm (the int32 product alone, row-major wq as the call gets it) "
        "where its shape rules allow (M > 16, K > 16, K and N multiples of 8); not at "
        f"{not_allowed}")
    return table


def fmt_of(be) -> str:
    cfg = getattr(be, "cfg", None)
    return f"Q{cfg.int_bits + 1}.{cfg.frac_bits}" if cfg is not None else \
        ("int8" if be.name == "int8" else "float32")


def compare_scores(got, want, tol: float, what: str) -> float:
    """Raise unless `got` equals `want` (tol 0: int32 words) or is within
    `tol` of it (rtol = atol); return the max |difference|."""
    import numpy as np
    expect(got.shape == want.shape and got.dtype == want.dtype,
           f"{what}: scores {got.dtype} {got.shape}, expected {want.dtype} {want.shape}")
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max()) \
        if got.size else 0.0
    ok = np.array_equal(got, want) if tol == 0 else np.allclose(got, want, rtol=tol, atol=tol)
    expect(ok, f"{what}: max |err| {err} against the CPU (tolerance {tol})")
    return err


def serve_once(params, images, backend, label, card, want_per_step, *, plain=None,
               tol=0.0):
    """Serve `images` through a threaded engine built from the numpy
    `params`; check the scores against `plain` (default: the plain `fixed`
    backend in the engine's format) on the CPU over the same formed batches
    (int8 quantizes its activations per batch), equal words where `tol` is
    0; check the ledger and the launch counts; return the counts and the
    requests per second over the client's wall window."""
    import collections

    import numpy as np
    import torch
    from repro_torch.core import backends as B
    from repro_torch.core import ptq
    from repro_torch.core import smallnet
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serving.vision_engine import VisionEngine

    eng = VisionEngine(params_on(params, "cuda"), backend=backend,
                       batch_size=ENGINE_BATCH, device="cuda")
    be = eng.backend
    plain = B.FixedBackend(cfg=be.cfg) if plain is None else B.get_backend(plain)
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
    # the CPU reference over the batches the engine formed: a batch's slots
    # hold its requests in submission order, zero-padded to the batch size
    batches = collections.defaultdict(list)
    for i, r in enumerate(results):
        batches[r.batch_index].append(i)
    cpu_params = plain.prepare_params(params_on(params, "cpu"), "cpu")
    want, words_checked = np.empty_like(scores), 0
    with torch.inference_mode():
        for idx in batches.values():
            batch = np.zeros((ENGINE_BATCH,) + images.shape[1:], np.float32)
            batch[:len(idx)] = images[idx]
            x = torch.from_numpy(batch)
            want[idx] = smallnet.apply(cpu_params, x, backend=plain)[:len(idx)].numpy()
            if isinstance(be, B.Int8Backend):
                # the int8 words the dense MAC takes: weights and activations
                act = dataclasses.replace(be.qcfg, per_channel=False)
                q_dev, q_cpu = (ptq.quantize(smallnet.conv_trunk(
                    p, x.to(dev), backend=be).reshape(ENGINE_BATCH, -1), act).q.cpu()
                    for p, dev in ((eng.params, "cuda"), (cpu_params, "cpu")))
                expect(torch.equal(q_dev, q_cpu),
                       f"{label}: quantized activation words differ from the CPU's")
                words_checked += q_dev.numel()
    if isinstance(be, B.Int8Backend):
        for layer in ("conv1", "conv2", "dense"):
            w_dev, w_cpu = eng.params[layer]["w"], cpu_params[layer]["w"]
            expect(torch.equal(w_dev.q.cpu(), w_cpu.q)
                   and torch.equal(w_dev.scale.cpu(), w_cpu.scale),
                   f"{label}: {layer} int8 weight words differ from the CPU's")
            words_checked += w_dev.q.numel()
    max_err = compare_scores(scores, want, tol, f"{label}: served scores")
    # the Max Finder: equal, except where the CPU's two top scores lie within
    # the tolerance of each other (counted, never skipped silently)
    top2 = np.sort(want, axis=-1)[:, -2:]
    near_ties = (top2[:, 1] - top2[:, 0]) <= tol
    want_preds = smallnet.predict(torch.from_numpy(want)).numpy()
    differ = preds != want_preds
    expect(not differ.any() or (tol > 0 and near_ties[differ].all()),
           f"{label}: Max Finder outputs differ ({int(differ.sum())} requests)")
    expect(st["accounted"] and st["n"] == len(images) and st["shed"] == 0,
           f"{label}: ledger {st}")
    steps = st["batches"]
    expected = {k: v * steps for k, v in want_per_step.items() if v}
    expect(counts == expected, f"{label}: launches {counts}, expected {expected}")
    emit("serve" if label.startswith("serve") else "composed", path=label,
         backend=be.name, fmt=fmt_of(be), against_cpu=plain.name,
         requests=len(images), steps=steps, launches=counts, tolerance=tol,
         max_abs_err=max_err, preds_differing_at_near_ties=int(differ.sum()),
         near_ties=int(near_ties.sum()) if tol else 0,
         int8_words_equal=words_checked, accounted=st["accounted"],
         # the client's window: first submit to the last result in hand
         wall_s=wall_s, served_per_wall_s=st["n"] / wall_s,
         # the engine's busy window: the sum of [t0, t_done] over the steps
         throughput_qps=st["throughput_qps"], busy_s=st["busy_s"],
         step_ms=st["busy_s"] / steps * 1e3,
         latency_p50_ms=st["latency_p50_ms"], latency_p99_ms=st["latency_p99_ms"],
         batch_occupancy=st["batch_occupancy"],
         distinct_preds=int(len(set(preds.tolist()))), card=card)
    return counts, st["n"] / wall_s


# -- training, the accuracy ladder, the router ---------------------------------------

def train_params_numpy(params) -> dict:
    return {layer: {leaf: t.detach().cpu().numpy() for leaf, t in leaves.items()}
            for layer, leaves in params.items()}


def phase_train(card: str) -> tuple[dict, list[dict]]:
    """The paper's flow on the card: `deploy.train_smallnet` at the sizes of
    benchmarks/accuracy_table.py (autograd over the `ref` backend's plain
    ops, Adam; train and test accuracy scored on `cuda`), the four-path
    ladder of `evaluate_all_paths` through the kernel backends, the same
    ladder on the CPU (the plain versions) with the same params, and
    `measure_latency` of `bake`d Q16.16 and `cuda_plan` steps.  Returns the
    trained params (numpy) and the launch counts of each driven part."""
    import math

    import torch
    from repro_torch.core import deploy, smallnet
    from repro_torch.data import synth_mnist
    from repro_torch.kernels import launches, reset_launches

    n_train, n_test, epochs = 8000, 2000, 16
    runs = []
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained = deploy.train_smallnet(n_train=n_train, n_test=n_test, epochs=epochs, seed=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = launches()
    runs.append(counts)
    steps = len(trained.history)
    expect(steps == epochs * (n_train // 64) and all(map(math.isfinite, trained.history)),
           f"train: {steps} steps, history finite: {all(map(math.isfinite, trained.history))}")
    # train and test accuracy: ceil(8000/256) + ceil(2000/256) float_smallnet launches
    expect(counts == {"float_smallnet": 32 + 8}, f"train: launches {counts}")
    emit("train", n_train=n_train, n_test=n_test, epochs=epochs, steps=steps,
         wall_s=train_s, steps_per_s=steps / train_s, loss_first=trained.history[0],
         loss_final=trained.history[-1], train_acc=trained.train_acc,
         test_acc=trained.test_acc, launches=counts, card=card)
    expect(trained.test_acc >= 0.80, f"train: test accuracy {trained.test_acc} < 0.80")

    reset_launches()
    accs = deploy.evaluate_all_paths(trained.params, n_test=n_test)
    counts = launches()
    runs.append(counts)
    # 8 batches of at most 256: one launch a batch on each path's kernel backend
    expect(counts == {"float_smallnet": 16, "fixed_smallnet": 8, "quant_matmul": 8},
           f"ladder: launches {counts}")
    # the quantized paths against the float net with the same PLAN activation:
    # within 0.06 (the reference's ladder bar).  Against float32 the PLAN
    # step is reported, not held: its size is the init draw's.  From one
    # draw the two packages train to the same ladder (tests/test_torch_deploy.py::
    # test_training_from_one_init_gives_the_reference_ladder), and the
    # port draws its init with a torch.Generator, not jax.random
    for key in ("fixed_q16_16", "int8_ptq"):
        expect(accs[key] >= accs["float32_plan_sigmoid"] - 0.06,
               f"ladder: {key} {accs[key]} more than 0.06 below float32_plan_sigmoid "
               f"{accs['float32_plan_sigmoid']}")
    expect(min(accs.values()) >= 0.5, f"ladder: a path near chance {accs}")
    params_np = train_params_numpy(trained.params)
    cpu_params = params_on(params_np, "cpu")
    accs_cpu = deploy.evaluate_all_paths(cpu_params, n_test=n_test, device="cpu")
    for key in ("fixed_q16_16", "int8_ptq"):
        expect(accs[key] == accs_cpu[key],
               f"ladder: {key} {accs[key]} on the card, {accs_cpu[key]} on the CPU")
    # the float keys: per image, the card's Max Finder against the CPU's,
    # equal except where the CPU's top two scores lie within FLOAT_TOL
    xte, yte = synth_mnist.make_dataset(n_test, seed=1)
    float_keys = {}
    for key, be in (("float32", "cuda"), ("float32_plan_sigmoid", "cuda_plan")):
        with torch.inference_mode():
            dev_scores = torch.cat([smallnet.apply(trained.params, torch.from_numpy(
                xte[i:i + 256]).cuda(), backend=be).cpu() for i in range(0, n_test, 256)])
            cpu_scores = smallnet.apply(cpu_params, torch.from_numpy(xte), backend=be)
        compare_scores(dev_scores.numpy(), cpu_scores.numpy(), FLOAT_TOL, f"ladder {key}")
        dev_pred, cpu_pred = smallnet.predict(dev_scores), smallnet.predict(cpu_scores)
        expect(float((dev_pred.numpy() == yte).mean()) == accs[key],
               f"ladder {key}: per-image predictions disagree with evaluate_all_paths")
        top2 = cpu_scores.sort(dim=-1).values[:, -2:]
        near = (top2[:, 1] - top2[:, 0]) <= FLOAT_TOL
        differ = dev_pred != cpu_pred
        expect(bool(near[differ].all()),
               f"ladder {key}: {int((differ & ~near).sum())} images differ off a near tie")
        float_keys[key] = {"images_differing": int(differ.sum()),
                           "near_ties_on_cpu": int(near.sum())}
    emit("ladder", n_test=n_test, card_accuracy=accs, cpu_accuracy=accs_cpu,
         below_float32={k: accs["float32"] - v for k, v in accs.items() if k != "float32"},
         within_0_06_of_float32=all(v >= accs["float32"] - 0.06 for v in accs.values()),
         float_keys=float_keys, launches=counts, card=card)

    qfix = smallnet.quantize_params_fixed(trained.params)
    x64 = torch.from_numpy(xte[:64]).cuda()
    latency, iters = {}, 200
    for name, baked, be, p in (
            ("fixed_q16_16", deploy.bake(lambda q, x: smallnet.apply(q, x, backend="fixed_cuda"),
                                         qfix), "fixed_cuda", qfix),
            ("cuda_plan", deploy.bake(lambda q, x: smallnet.apply(q, x, backend="cuda_plan"),
                                      trained.params), "cuda_plan", trained.params)):
        with torch.inference_mode():
            expect(torch.equal(baked(x64), smallnet.apply(p, x64, backend=be)),
                   f"bake {name}: differs from apply")
        reset_launches()
        for batch in (1, 64):
            latency[f"{name} batch {batch}"] = deploy.measure_latency(
                lambda _, x, baked=baked: baked(x), None, batch=batch, iters=iters) * 1e3
        counts = launches()
        runs.append(counts)
        kernel = "fixed_smallnet" if be == "fixed_cuda" else "float_smallnet"
        expect(counts == {kernel: 2 * (iters + 1)}, f"bake {name}: launches {counts}")
    emit("latency", what="deploy.measure_latency of bake'd steps, ms a call (each waited for)",
         iters=iters, ms=latency, card=card)
    return params_np, runs


def phase_router(card: str, params_np: dict, q16_wall_qps: float) -> list[dict]:
    """`ReplicaRouter` over the port's engines on the card, with the trained
    params: two Q16.16 replicas and a `cuda_plan` one under the slo policy
    (slo_ms 50).  First the fleet's own capacity: 4096 requests submitted
    at once and drained closed loop; it must reach CAPACITY_FLOOR of the
    Q16.16 engine's wall rate from the serve phase.  Then `LoadGen` open
    loop: Poisson at 1/8 of the fleet's capacity, with goodput at least
    MIN_GOODPUT and p50 at most MAX_P50_MS; at 1/4 and half of it, at half the Q16.16 engine's rate,
    and bursty at twice that, printed, not held (the fleet's open-loop
    rate is host-bound below its closed-loop one, `PERF.md` §5); then a
    failover run (a replica whose first step raises) and
    an autoscale run (one replica, a spawn factory, the bursty schedule in
    waves with `autoscale()` between them, as the reference's harness
    drives it).  Every request ends served or shed, the fleet ledger holds,
    and every served result equals its replica backend's plain counterpart
    on the CPU (Q16.16 words exact, `cuda_plan` within FLOAT_TOL).  Returns
    the launch counts of each run."""
    import numpy as np
    import torch
    from repro_torch.core import backends as B
    from repro_torch.core import smallnet
    from repro_torch.data import synth_mnist
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serving.router import ReplicaRouter
    from repro_torch.serving.vision_engine import VisionEngine
    from repro_torch.streaming.loadgen import LoadGen

    kernel_of = {"fixed_cuda": "fixed_smallnet", "cuda_plan": "float_smallnet"}
    plain_of = {"fixed_cuda": "fixed", "cuda_plan": "plan"}
    params = params_on(params_np, "cuda")
    cpu_params = params_on(params_np, "cpu")
    fired = []

    @dataclasses.dataclass(frozen=True)
    class FaultyOnce(B.FixedCudaBackend):
        """fixed_cuda whose first whole-net step raises (an injected fault)."""
        name: str = "fixed_cuda"

        def net_scores(self, images, p):
            if not fired:
                fired.append(True)
                raise RuntimeError("injected fault: this replica's first step")
            return super().net_scores(images, p)

    def warm_up(router, images):
        """One batch a replica through the fleet, so the slo door starts
        from observed service rates (a cold fleet door-sheds any backlog
        past one batch a replica); returns the warm-up's uids."""
        uids = router.submit_many(list(images[:ENGINE_BATCH * len(router.replicas)]))
        router.run()
        return uids

    def check(label, router, gen, payload, uids, wall_s, counts, spawned=0, n_warm=0):
        """`payload[uid]` is the image the router's request `uid` carried;
        the first `n_warm` requests warmed the fleet before the timed run.
        Returns the launch counts, the timed requests served a wall second
        and the fleet's stats."""
        res, shed = router.pop_results(uids), router.pop_shed(uids)
        timed = uids[n_warm:]
        served_timed = sum(u in res for u in timed)
        expect(served_timed > 0, f"router {label}: nothing served")
        st = router.stats()
        expect(st["accounted"] and st["pending"] == 0, f"router {label}: ledger {st}")
        expect(len(res) + len(shed) == len(uids) == st["submitted"],
               f"router {label}: {len(res)} served + {len(shed)} shed of {len(uids)}")
        expect("fleet_exhausted" not in st["shed_by_reason"],
               f"router {label}: the fleet was exhausted")
        # each served result against its replica backend's CPU counterpart
        by_backend, max_err = {}, 0.0
        for uid, r in res.items():
            by_backend.setdefault(router.replicas[r.replica].backend.name, []).append(uid)
        for name, served in by_backend.items():
            served.sort()
            with torch.inference_mode():
                want = smallnet.apply(cpu_params, torch.from_numpy(payload[served]),
                                      backend=plain_of[name]).numpy()
            got = np.stack([res[u].scores for u in served])
            tol = 0.0 if name == "fixed_cuda" else FLOAT_TOL
            max_err = max(max_err, compare_scores(got, want, tol, f"router {label} {name}"))
            preds = np.asarray([res[u].pred for u in served])
            want_preds = smallnet.predict(torch.from_numpy(want)).numpy()
            top2 = np.sort(want, axis=-1)[:, -2:]
            near = (top2[:, 1] - top2[:, 0]) <= tol
            differ = preds != want_preds
            expect(not differ.any() or (tol > 0 and near[differ].all()),
                   f"router {label} {name}: {int(differ.sum())} Max Finder outputs differ")
        # one launch of the replica's kernel a step (+ the warm-up of a spawned one)
        want_counts = {}
        for eng, est in zip(router.replicas, st["per_replica"]):
            k = kernel_of[eng.backend.name]
            want_counts[k] = want_counts.get(k, 0) + est["batches"]
        want_counts["fixed_smallnet"] = want_counts.get("fixed_smallnet", 0) + spawned
        want_counts = {k: v for k, v in want_counts.items() if v}
        expect(counts == want_counts, f"router {label}: launches {counts}, expected {want_counts}")
        emit("router", run=label, process=gen.process if gen else "closed loop",
             rate_qps=gen.rate_qps if gen else None,
             offered_qps=gen.offered_qps if gen else None,
             warm_requests=n_warm, requests=len(timed),
             served=served_timed, shed=len(timed) - served_timed,
             shed_by_reason=st["shed_by_reason"], wall_s=wall_s,
             served_per_wall_s=served_timed / wall_s,
             latency_p50_ms=st.get("latency_p50_ms"), latency_p99_ms=st.get("latency_p99_ms"),
             goodput=st.get("goodput"), served_by=st["served_by"], failed=st["failed"],
             retired=st["retired"], replicas=[e.backend.name for e in router.replicas],
             # engine steps and their real share of slots, warm-up included:
             # small batches mean the fleet's fixed costs a step dominate
             steps=sum(e["batches"] for e in st["per_replica"]),
             batch_occupancy=[e["batch_occupancy"] for e in st["per_replica"]],
             launches=counts, max_abs_err=max_err, card=card)
        return counts, served_timed / wall_s, st

    def replay(label, router, gen, warm=True):
        """Replay `gen` open loop into the started router, after
        `warm_up` where `warm`."""
        images = gen.images()
        expect(len(images) > 0, f"router {label}: empty schedule")
        reset_launches()
        uids = warm_up(router, images) if warm else []
        n_warm = len(uids)
        router.start()
        try:
            t0 = time.perf_counter()
            gen.replay(lambda a, t: uids.append(router.submit(images[a.uid], t_submit=t)))
            router.wait(uids, timeout=300)
            wall_s = time.perf_counter() - t0
        finally:
            router.stop()
        # a fresh router numbers its requests from 0 in submission order
        counts, _, st = check(label, router, gen,
                              np.concatenate([images[:n_warm], images]), uids, wall_s,
                              launches(), n_warm=n_warm)
        return counts, st

    fleet = ["fixed_cuda", "fixed_cuda", "cuda_plan"]
    # the fleet's capacity: 4096 requests at once, drained closed loop (a
    # 60 s deadline, so none lapses while the burst is being queued)
    router = ReplicaRouter.from_backends(params, fleet, batch_size=ENGINE_BATCH,
                                         policy="slo", slo_ms=50)
    images, _ = synth_mnist.make_dataset(4096, seed=10)
    reset_launches()
    uids = warm_up(router, images)
    n_warm = len(uids)
    t0 = time.perf_counter()
    uids += router.submit_many(list(images), deadline_ms=60_000.0)
    router.wait(uids)
    wall_s = time.perf_counter() - t0
    counts, capacity_qps, _ = check("closed-loop capacity", router, None,
                                    np.concatenate([images[:n_warm], images]), uids, wall_s,
                                    launches(), n_warm=n_warm)
    runs = [counts]
    emit("router", run="rates", q16_engine_wall_qps=q16_wall_qps,
         fleet_capacity_qps=capacity_qps, capacity_floor=CAPACITY_FLOOR,
         min_goodput=MIN_GOODPUT, max_p50_ms=MAX_P50_MS, card=card)
    expect(capacity_qps >= CAPACITY_FLOOR * q16_wall_qps,
           f"router: the fleet drains {capacity_qps:.0f} requests/s closed loop, under "
           f"{CAPACITY_FLOOR} of one Q16.16 engine's {q16_wall_qps:.0f}")
    # open loop at fractions of the fleet's own capacity, the eighth held to
    # MIN_GOODPUT and MAX_P50_MS; then at half the Q16.16 engine's rate and
    # bursty at twice that
    for label, process, rate, n, held in (
            ("poisson at 1/8 of the fleet's capacity", "poisson", capacity_qps / 8, 2048, True),
            ("poisson at 1/4 of the fleet's capacity", "poisson", capacity_qps / 4, 2048, False),
            ("poisson at half the fleet's capacity", "poisson", capacity_qps / 2, 4096, False),
            ("poisson at half the Q16.16 engine's rate", "poisson", q16_wall_qps / 2, 4096,
             False),
            ("bursty at the Q16.16 engine's rate", "bursty", q16_wall_qps, 4096, False)):
        router = ReplicaRouter.from_backends(params, fleet, batch_size=ENGINE_BATCH,
                                             policy="slo", slo_ms=50)
        gen = LoadGen(process=process, rate_qps=rate, n_requests=n,
                      n_streams=8, seed=11, **BURSTS)
        counts, st = replay(label, router, gen)
        runs.append(counts)
        if held:
            expect(st["goodput"] >= MIN_GOODPUT and st["latency_p50_ms"] <= MAX_P50_MS,
                   f"router {label}: goodput {st['goodput']:.3f} (at least {MIN_GOODPUT}), "
                   f"p50 {st['latency_p50_ms']:.2f} ms (at most {MAX_P50_MS})")

    # failover: the faulty replica comes first, so a cold fleet's first
    # request (every projected wait 0, ties to the lowest index) lands on it
    faulty = VisionEngine(params, backend=FaultyOnce(), batch_size=ENGINE_BATCH,
                          device="cuda", warmup=False)
    router = ReplicaRouter([faulty] + [VisionEngine(params, backend=b, batch_size=ENGINE_BATCH,
                                                    device="cuda") for b in fleet],
                           policy="slo", slo_ms=50)
    gen = LoadGen(process="poisson", rate_qps=0.5 * capacity_qps, n_requests=1024,
                  n_streams=8, seed=12)
    runs.append(replay("failover", router, gen, warm=False)[0])
    st = router.stats()
    expect(fired and st["failed"] == [0] and st["healthy"] == len(fleet),
           f"router failover: the fault did not fire or was not failed over ({st['failed']})")

    # autoscale: one replica, a spawn factory, the bursty schedule in 10 ms
    # waves with autoscale() between them, then idle checks until it retires
    spawned = []

    def spawn():
        eng = VisionEngine(params, backend="fixed_cuda", batch_size=ENGINE_BATCH, device="cuda")
        spawned.append(eng)
        return eng

    # least_loaded, as the reference's autoscale test: no door sheds, so the
    # backlog an autoscale() call sees is the burst itself
    router = ReplicaRouter.from_backends(params, ["fixed_cuda"], batch_size=ENGINE_BATCH,
                                         policy="least_loaded", slo_ms=50, spawn=spawn,
                                         min_replicas=1, max_replicas=3,
                                         scale_up_depth=2.0, scale_down_idle=3)
    gen = LoadGen(process="bursty", rate_qps=2.0 * capacity_qps, n_requests=4096,
                  n_streams=8, seed=13, **BURSTS)
    images = gen.images()
    expect(len(images) > 0, "router autoscale: empty schedule")
    reset_launches()
    # one warm batch first, then the schedule in waves
    uids = router.submit_many(list(images[:ENGINE_BATCH]))
    router.run()
    payload = np.concatenate([images[:ENGINE_BATCH], images])
    decisions = []
    t0 = time.perf_counter()
    wave_s, sched, i = 0.010, gen.schedule(), 0
    while i < len(sched):
        end = sched[i].t + wave_s
        while i < len(sched) and sched[i].t < end:
            uids.append(router.submit(images[sched[i].uid]))
            i += 1
        decisions.append(router.autoscale())
        router.run()
    for _ in range(10):                                   # idle checks
        decisions.append(router.autoscale())
    wall_s = time.perf_counter() - t0
    spawns = [d for d in decisions if d and d.startswith("spawn")]
    retires = [d for d in decisions if d and d.startswith("retire")]
    expect(spawns and retires and router.stats()["healthy"] == 1,
           f"router autoscale: spawns {spawns}, retires {retires}, "
           f"healthy {router.stats()['healthy']}")
    runs.append(check("autoscale", router, gen, payload, uids, wall_s, launches(),
                      spawned=len(spawned), n_warm=ENGINE_BATCH)[0])
    emit("autoscale", decisions=[d for d in decisions if d], spawned=len(spawned), card=card)
    return runs


def ambiguity(sweep, scores, positions, tol: float) -> dict:
    """Where float detections can legitimately differ between two devices
    whose scores agree within `tol`, counted from one device's scores: a
    window's top confidence within `tol` of the threshold (it may pass on
    one device and not the other), a candidate window's two top classes
    within `tol` (its label may differ), and two candidate windows within
    the dedup distance whose confidences lie within `tol` (the greedy dedup
    may keep the other one)."""
    import numpy as np
    conf = sweep._confidences(scores)
    best = conf.max(-1)
    top2 = np.sort(conf, axis=-1)[:, -2:]
    cand = np.flatnonzero(best >= sweep.threshold - tol)
    pos = np.asarray(positions)
    pairs = sum(int(((np.abs(best[cand[i + 1:]] - best[c]) <= tol)
                     & (np.abs(pos[cand[i + 1:]] - pos[c]).max(-1) <= sweep.min_dist)).sum())
                for i, c in enumerate(cand))
    return {"near_threshold": int((np.abs(best - sweep.threshold) <= tol).sum()),
            "near_label_ties": int(((top2[cand, 1] - top2[cand, 0]) <= tol).sum()),
            "near_order_pairs": pairs}


def same_detections(got, want, tol: float) -> bool:
    """Equal detections; with a tolerance, equal label, place and size and a
    score within `tol`."""
    if tol == 0:
        return got == want
    return len(got) == len(want) and all(
        (g.label, g.y, g.x, g.size) == (w.label, w.y, w.x, w.size)
        and abs(g.score - w.score) <= tol for g, w in zip(got, want))


def sweep_once(params, source, backend, plain, threshold, label, card, want_per_frame, *,
               megakernel=None, tiler_scores=None, tol=0.0):
    """Drive StreamingPipeline(source, VisionEngine(backend, cuda), FcnSweep)
    in throughput mode; check every frame's detections and the scores the
    pipeline itself produced against the `plain` backend's sweep on the CPU
    (equal words where `tol` is 0, else within `tol`), the ledger and the
    launches per frame; return (launch counts, frames/s over the client's
    wall window).  `tiler_scores(frame)`, when given, are the host tiler's
    CPU scores for the frame, which the first frames' scores must also
    match."""
    import numpy as np
    import torch
    from repro_torch.core import backends as B
    from repro_torch.analysis.launches import count_launches
    from repro_torch.core import fixed_point as fxp
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
    backend, plain = B.get_backend(backend), B.get_backend(plain)
    cfg = getattr(backend, "cfg", fxp.Q16_16)        # the word format of int scores
    sweep = RecordingSweep(stride=SWEEP_STRIDE, threshold=threshold, cfg=cfg,
                           megakernel=megakernel)
    cpu_params = params_on(params, "cpu")
    # the offline detect of the plain backend on the CPU, frame by frame
    cpu_scores, want = [], []
    for f in frames:
        fb, pos = sweep.extract(f)
        cpu_scores.append(sweep.score(cpu_params, fb, backend=plain, device="cpu"))
        want.append(sweep.aggregate(cpu_scores[-1], pos, fb))
    # float scores: where the CPU's detections are ambiguous within the
    # tolerance (counted per frame, never skipped silently)
    amb = [ambiguity(sweep, sc, sweep.positions(source.frame_shape), tol)
           for sc in cpu_scores] if tol else []
    eng = VisionEngine(params_on(params, "cuda"), backend=backend,
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
    expect(len(sweep.words) == n, f"{label}: {len(sweep.words)} sweep calls for {n} frames")
    # every frame's detections equal the CPU's; with float scores a frame may
    # differ only where the CPU's own detections are ambiguous within the
    # tolerance, and then they must equal the aggregate of the card's scores
    differing = []
    for r in results:
        if same_detections(r.detections, want[r.index], tol):
            continue
        fb, pos = sweep.extract(frames[r.index])
        expect(tol > 0 and any(amb[r.index].values())
               and r.detections == sweep.aggregate(sweep.words[r.index], pos, fb),
               f"{label}: frame {r.index} detections differ from the plain CPU sweep "
               f"({amb[r.index] if tol else 'exact words'})")
        differing.append(r.index)
    expected = {k: v * n for k, v in want_per_frame.items() if v}
    expect(counts == expected, f"{label}: launches {counts}, expected {expected}")
    # the scores the pipeline produced, every frame's, against the plain
    # sweep on the CPU; the first frames' also against the host tiler
    words_checked, max_err = 0, 0.0
    for f, got in zip(frames, sweep.words):
        max_err = max(max_err, compare_scores(got, cpu_scores[f.index], tol,
                                              f"{label}: frame {f.index} sweep"))
        if tiler_scores is not None and f.index < 4:
            compare_scores(got, tiler_scores(f), tol, f"{label}: frame {f.index} vs tiler")
        words_checked += got.size
    # the same sweep call outside the pipeline, timed on the first frames
    call_s = []
    for f in frames[:4]:
        fb, _ = sweep.extract(f)
        t0 = time.perf_counter()
        got = sweep.score(eng.params, fb, backend=eng.backend, device="cuda")
        call_s.append(time.perf_counter() - t0)
        compare_scores(got, cpu_scores[f.index], tol, f"{label}: frame {f.index} bare call")
    # the same call's launches read by the profiler too, against the
    # wrappers' counts (count_launches raises where they differ)
    fb, _ = sweep.extract(frames[0])
    seen = count_launches(sweep.score, eng.params, fb, backend=eng.backend, device="cuda")
    expect(seen == {k: v for k, v in want_per_frame.items() if v},
           f"{label}: the profiler saw {seen} a frame, expected {want_per_frame}")
    emit("sweep", path=label, backend=eng.backend.name, fmt=fmt_of(eng.backend),
         against_cpu=plain.name, frame_shape=list(source.frame_shape),
         frames=n, windows_per_frame=len(sweep.positions(source.frame_shape)),
         megakernel=megakernel, threshold=threshold, launches=counts,
         launches_per_frame={k: v / n for k, v in counts.items()},
         detections=st["detections_total"], frames_detections_equal_cpu=n - len(differing),
         frames_differing_within_tolerance=differing,
         ambiguous_within_tolerance={k: sum(a[k] for a in amb) for k in amb[0]} if amb else {},
         tolerance=tol, max_abs_err=max_err,
         score_words_checked=words_checked, accounted=st["accounted"],
         wall_s=wall_s, frames_per_wall_s=n / wall_s, sustained_fps=st["sustained_fps"],
         latency_p50_ms=st["latency_p50_ms"], latency_p99_ms=st["latency_p99_ms"],
         stage_p50_ms={k: v["p50_ms"] for k, v in st["stage"].items()},
         # the same sweep call outside the pipeline, for its first frames
         score_call_wall_ms=statistics.median(call_s) * 1e3, profiler_launches_per_frame=seen,
         card=card)
    return counts, n / wall_s


def calibrated_threshold(params, frame, cfg, scores=None) -> float:
    """The stream benchmarks' threshold: the 80th percentile of the first
    frame's per-window top confidence, from the plain `fixed` backend on the
    CPU (`scores`, when given, are that frame's CPU sweep scores on any
    backend)."""
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
    clip through the frame_trunk route; then the 112x112 clip on cuda_plan
    and int8."""
    from repro_torch.core import backends as B
    from repro_torch.core import fixed_point as fxp
    from repro_torch.streaming import FcnSweep, SyntheticVideoSource, Tiler

    params = fixture_params()
    mega = {"frame_trunk": 1, "fixed_window_head": 1}
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
        counts, rates[fmt] = sweep_once(params, source, B.FixedCudaBackend(cfg=cfg),
                                        B.FixedBackend(cfg=cfg), thr, f"sweep {fmt}", card,
                                        mega, tiler_scores=tiler_scores)
        runs.append(counts)
    source = SyntheticVideoSource(seed=7, frame_shape=(112, 112), n_frames=SWEEP_FRAMES)
    thr = calibrated_threshold(params, source.frames()[0], fxp.Q16_16)
    counts, rates["composed"] = sweep_once(params, source, "fixed_cuda", "fixed", thr,
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
    counts, _ = sweep_once(params, camera, "fixed_cuda", "fixed", thr, "sweep camera q16_16",
                           card, mega)
    runs.append(counts)

    # the float and int8 backends: the composed cascade, held to the same
    # backend's sweep on the CPU within FLOAT_TOL, and to the CPU tiler
    per_frame = {"cuda_plan": {"conv2d": 20, "maxpool2d": 2, "sigmoid_pla": 12},
                 "int8": {"quant_matmul": 1}}
    for name, want_per_frame in per_frame.items():
        source = SyntheticVideoSource(seed=7, frame_shape=(112, 112), n_frames=SWEEP_FRAMES)
        first = source.frames()[0]
        fb, _ = FcnSweep(stride=SWEEP_STRIDE).extract(first)
        thr = calibrated_threshold(params, first, fxp.Q16_16, scores=FcnSweep(
            stride=SWEEP_STRIDE).score(params_on(params, "cpu"), fb, backend=name,
                                       device="cpu"))
        tiler = Tiler(stride=SWEEP_STRIDE)

        def tiler_scores(frame, tiler=tiler, name=name):
            tiles, _ = tiler.extract(frame)
            return tiler.score(params_on(params, "cpu"), tiles, backend=name, device="cpu")
        counts, rates[name] = sweep_once(params, source, name, name, thr, f"sweep {name}",
                                         card, want_per_frame, tiler_scores=tiler_scores,
                                         tol=FLOAT_TOL)
        runs.append(counts)
    emit("sweep", path="112x112 frames/s over the wall, every backend this run swept",
         frames_per_wall_s=rates, card=card)
    sweep_roofline(params, card)
    return runs


def sweep_roofline(params, card) -> None:
    """`analysis/mfu.roofline_terms` for the three trunk routes of
    `trunk_workload` at 112x112 and 1080x1920 on `fixed_cuda` (Q16.16),
    beside the device time measured here: the composed cascade
    (`_sweep_stage` twice on the ingested words) and the one frame_trunk
    launch, each the sum of the device activity (kernels and copies) the
    profiler saw in a call (`profiled_device_ms`: the cascade copies its tap
    masks to the card, which waits behind `device_ms`'s spin kernel); the
    frame_trunk launch also by CUDA events (`device_ms`).  "trunk", the
    fused ideal, has no kernel and no time.  Then the whole per-frame
    program of each route (`route_workload`, trunk and head): the two sweep
    routes as `make_trunk_fn` + `make_head_fn` on the card, profiled; the
    tiler (every window through the 28x28 net) is not run here and has no
    time."""
    import torch
    from repro_torch.analysis import mfu
    from repro_torch.core import backends as B
    from repro_torch.kernels.frame_trunk import ops as FT
    from repro_torch.streaming import SyntheticVideoSource
    from repro_torch.streaming import fcn_sweep as fs

    spec, plain = mfu.resolve()
    dtype, _ = mfu.backend_numerics("fixed_cuda")
    be = B.get_backend("fixed_cuda")
    p = be.prepare_params(params_on(params, "cuda"), "cuda")
    c1, c2 = p["conv1"], p["conv2"]
    rows, programs = [], []

    def roofline_row(wl, ms, **row):
        terms = mfu.roofline_terms(wl, device=spec, dtype=dtype)
        row.update({k: terms[k] for k in ("flops", "bytes", "intensity", "bound")},
                   floor_ms=mfu.modeled_seconds(wl, device=spec, dtype=dtype) * 1e3,
                   measured_ms=ms)
        if ms is not None:
            secs, basis = mfu.mfu_clock(wl, ms / 1e3, device=spec, dtype=dtype, plain=plain)
            row.update(basis=basis, mfu=mfu.mfu(wl, secs, device=spec, dtype=dtype),
                       **mfu.achieved(wl, secs))
        return row

    for shape in ((112, 112), CAMERA):
        px = SyntheticVideoSource(seed=7, frame_shape=shape, n_frames=1).frames()[0].pixels
        positions = tuple(fs.FcnSweep(stride=8).positions(shape))
        x = torch.from_numpy(px[None]).cuda()
        for route, mk in (("sweep_megakernel", None), ("sweep_composed", False)):
            trunk_fn, head_fn = fs.make_trunk_fn(be, mk), fs.make_head_fn(be, 28, positions, mk)
            ms = profiled_device_ms(lambda: head_fn(p, trunk_fn(p, x)), 10)
            programs.append(roofline_row(mfu.route_workload(route, *shape, len(positions)), ms,
                                         frame=list(shape), route=route))
        programs.append(roofline_row(mfu.route_workload("tiler", *shape, len(positions)), None,
                                     frame=list(shape), route="tiler"))
        with torch.inference_mode():
            words = be.ingest(torch.from_numpy(px[None]).cuda())
            composed = lambda: fs._sweep_stage(
                be, fs._sweep_stage(be, (words,) * 4, c1["w"], c1["b"]), c2["w"], c2["b"])
            trunk = lambda: FT.frame_trunk_quad(words[0], c1["w"], c1["b"], c2["w"], c2["b"],
                                                cfg=be.cfg)
            times = {"trunk": None, "sweep_composed": profiled_device_ms(composed, 10),
                     "sweep_megakernel": profiled_device_ms(trunk, 10)}
            events_ms = device_ms(trunk, 50)
        for route, ms in times.items():
            row = roofline_row(mfu.trunk_workload(*shape, route), ms,
                               frame=list(shape), route=route)
            if route == "sweep_megakernel":
                row["cuda_events_ms"] = events_ms
            rows.append(row)
    emit("sweep", path="roofline of the trunk routes (analysis/mfu.py), fixed_cuda Q16.16",
         device=spec.name, dtype=dtype, peak=spec.peak(dtype), mem_bw=spec.mem_bw, rows=rows,
         card=card)
    emit("sweep", path="roofline of each route's per-frame program (analysis/mfu.py "
         "route_workload), fixed_cuda Q16.16", device=spec.name, rows=programs, card=card)


def phase_disagg(card: str) -> list[dict]:
    """The disaggregated trunk/head server (`serving/disagg.py`) on the card,
    with the reference's `seeded_params()` fixture and 112x112
    `SyntheticVideoSource(seed=7)` frames at stride 8.  Words: Q16.16 and
    Q8.8 on `fixed_cuda`, the default route and `megakernel=False`, each
    frame's `score_frame` equal to `FcnSweep.score` on the card and to the
    plain `fixed` sweep on the CPU, `detect` to the sweep's; `cuda_plan`
    within FLOAT_TOL of its CPU scores (detections may differ only where the
    CPU's own are ambiguous), `int8` equal; one 1080x1920 frame a miss then
    hits, in both formats.  A `cuda_plan` hit launches only the head's
    share of the frame's launches.  Then `RepeatedClipSource(16 frames,
    repeats=4)` through `StreamingPipeline` + the server: hit rate 0.75,
    16 frame_trunk and 64 fixed_window_head launches by `LAUNCHES` and by
    the profiler (`analysis/launches.count_launches`), every ledger
    accounted, repeated frames' detections equal the CPU sweep's.  Rates,
    printed, not held: the monolithic loop and the disagg loop on the
    repeated clip and the disagg loop on the distinct clip, frames/s best
    of 2; each stage's p50; `frame_digest` at 112x112 and 1080x1920; the
    camera frame's miss, hit and monolithic call.  Open loop: a started
    fleet of 2 trunks and 2 heads, its closed-loop rate over 8 passes of 32
    frames, then `LoadGen` Poisson at 1/8 and 1/2 of it with a
    DISAGG_SLO_MS deadline (ledger and served scores held).  Failover:
    trunk 0 faulted mid-run by an injected fault; every query served or
    shed with a reason, served scores exact, no other replica faulted.
    Returns the launch counts of the runs on the server's main path."""
    import numpy as np
    import torch
    from repro_torch.analysis.launches import count_launches
    from repro_torch.core import backends as B
    from repro_torch.core import fixed_point as fxp
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serving.disagg import DisaggServer, frame_digest
    from repro_torch.streaming import (FcnSweep, RepeatedClipSource, StreamingPipeline,
                                       SyntheticVideoSource)
    from repro_torch.streaming import fcn_sweep as fs
    from repro_torch.streaming.loadgen import LoadGen

    params = fixture_params()
    dev_params, cpu_params = params_on(params, "cuda"), params_on(params, "cpu")
    runs = []

    def cpu_sweep(backend, px):
        return FcnSweep(stride=SWEEP_STRIDE).score(cpu_params, px, backend=backend,
                                                   device="cpu")

    # -- words: fixed_cuda in two formats and two routes, then float and int8
    clip = SyntheticVideoSource(seed=7, frame_shape=(112, 112),
                                n_frames=DISAGG_WORD_FRAMES).frames()
    n_words = 0
    for fmt, cfg in (("q16_16", fxp.Q16_16), ("q8_8", fxp.Q8_8)):
        be, plain = B.FixedCudaBackend(cfg=cfg), B.FixedBackend(cfg=cfg)
        thr = calibrated_threshold(params, clip[0], cfg)
        want = [cpu_sweep(plain, f.pixels[None]) for f in clip]
        for mk in (None, False):
            sweep = FcnSweep(stride=SWEEP_STRIDE, threshold=thr, cfg=cfg, megakernel=mk)
            srv = DisaggServer(params, backend=be, stride=SWEEP_STRIDE, megakernel=mk,
                               cache_capacity=len(clip))
            for f, w in zip(clip, want):
                px = f.pixels[None]
                got = srv.score_frame(px)
                mono = sweep.score(dev_params, px, backend=be, device="cuda")
                label = f"disagg {fmt} megakernel={mk} frame {f.index}"
                compare_scores(got, mono, 0.0, f"{label} vs the monolithic sweep")
                compare_scores(got, w, 0.0, label)
                expect(srv.detect(f, tiler=sweep) == sweep.aggregate(mono, list(srv.positions)),
                       f"{label}: detect differs from the monolithic sweep's")
                n_words += got.size
            st = srv.stats()
            expect(st["accounted"] and st["n"] == 2 * len(clip)
                   and st["cache"]["misses"] == len(clip) and st["cache"]["hits"] == len(clip),
                   f"disagg {fmt} megakernel={mk}: ledger or cache {st['cache']}")
    float_runs = {}
    for name, tol in (("cuda_plan", FLOAT_TOL), ("int8", 0.0)):
        want = [cpu_sweep(name, f.pixels[None]) for f in clip]
        sweep = FcnSweep(stride=SWEEP_STRIDE, threshold=calibrated_threshold(
            params, clip[0], fxp.Q16_16, scores=want[0]))
        srv = DisaggServer(params, backend=name, stride=SWEEP_STRIDE, cache_capacity=len(clip))
        pos = list(srv.positions)
        torch.cuda.synchronize()
        reset_launches()
        max_err, differing = 0.0, []
        for f, w in zip(clip, want):
            got = srv.score_frame(f.pixels[None])
            max_err = max(max_err, compare_scores(got, w, tol, f"disagg {name} frame {f.index}"))
            if not same_detections(sweep.aggregate(got, pos), sweep.aggregate(w, pos), tol):
                expect(tol > 0 and any(ambiguity(sweep, w, pos, tol).values()),
                       f"disagg {name} frame {f.index}: detections differ from the CPU's")
                differing.append(f.index)
        runs.append(launches())
        float_runs[name] = {"max_abs_err": max_err, "tolerance": tol, "launches": launches(),
                            "frames_differing_within_tolerance": differing}

    # a cuda_plan hit runs only the head: its launches are the head's share of
    # a miss, read from the two halves the server runs
    srv = DisaggServer(params, backend="cuda_plan", stride=SWEEP_STRIDE, cache_capacity=2)
    trunk_fn = fs.make_trunk_fn(srv.backend, srv.megakernel)
    head_fn = fs.make_head_fn(srv.backend, srv.patch, srv.positions, srv.megakernel)
    px = clip[0].pixels[None]
    shares = []
    for step in ("trunk", "head", "miss", "hit"):
        torch.cuda.synchronize()
        reset_launches()
        if step == "trunk":
            quad = trunk_fn(srv.params, torch.from_numpy(px).cuda())
        elif step == "head":
            head_fn(srv.params, quad)
        else:
            srv.score_frame(px)
        torch.cuda.synchronize()
        shares.append(launches())
    trunk_share, head_share, miss, hit = shares
    # the head composes (no window_head on cuda_plan): gather, dense product,
    # then the output PLAN, the only port kernel of the head
    expect(sum(miss.values()) == 34 and head_share == {"sigmoid_pla": 1}
           and {k: trunk_share.get(k, 0) + head_share.get(k, 0) for k in miss} == miss
           and hit == head_share,
           f"disagg cuda_plan launches: trunk {trunk_share}, head {head_share}, "
           f"miss {miss}, hit {hit}")
    emit("disagg", path="words", frames=len(clip), score_words_checked=n_words,
         fixed_cuda="Q16.16 and Q8.8, megakernel None and False: equal to FcnSweep.score "
                    "on the card and to the plain fixed sweep on the CPU",
         float_and_int8=float_runs,
         cuda_plan_launches={"trunk": trunk_share, "head": head_share, "miss": miss,
                             "hit": hit}, card=card)

    # -- one camera frame, a miss then hits, in both formats ------------------
    px = SyntheticVideoSource(seed=7, frame_shape=CAMERA, n_frames=1).frames()[0].pixels[None]
    camera = {}
    for fmt, cfg in (("q16_16", fxp.Q16_16), ("q8_8", fxp.Q8_8)):
        be = B.FixedCudaBackend(cfg=cfg)
        sweep = FcnSweep(stride=SWEEP_STRIDE, cfg=cfg)
        want = sweep.score(cpu_params, px, backend=B.FixedBackend(cfg=cfg), device="cpu")
        srv = DisaggServer(params, backend=be, frame_shape=CAMERA, stride=SWEEP_STRIDE,
                           cache_capacity=2)
        native = be.prepare_params(dev_params, "cuda")
        mono_s, hit_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            mono = sweep.score(native, px, backend=be, device="cuda")
            mono_s.append(time.perf_counter() - t0)
        compare_scores(mono, want, 0.0, f"disagg camera {fmt}: the monolithic sweep")
        t0 = time.perf_counter()
        got = srv.score_frame(px)
        miss_s = time.perf_counter() - t0
        compare_scores(got, mono, 0.0, f"disagg camera {fmt}: a miss")
        for _ in range(3):
            t0 = time.perf_counter()
            got = srv.score_frame(px)
            hit_s.append(time.perf_counter() - t0)
            compare_scores(got, mono, 0.0, f"disagg camera {fmt}: a hit")
        st = srv.stats()
        expect(st["cache"]["hits"] == 3 and st["cache"]["misses"] == 1,
               f"disagg camera {fmt}: cache {st['cache']}")
        camera[fmt] = {"miss_ms": miss_s * 1e3, "hit_ms": statistics.median(hit_s) * 1e3,
                       "monolithic_ms": statistics.median(mono_s) * 1e3}
    digest_ms = {}
    for shape, reps in (((1, 112, 112, 1), 200), ((1,) + CAMERA + (1,), 10)):
        x = np.random.default_rng(0).random(shape, dtype=np.float32)
        t0 = time.perf_counter()
        for _ in range(reps):
            frame_digest(x)
        digest_ms["x".join(map(str, shape[1:3]))] = (time.perf_counter() - t0) / reps * 1e3
    emit("disagg", path="camera frame 1080x1920, fixed_cuda", windows=len(srv.positions),
         wall_ms=camera, hit_over_monolithic={k: v["hit_ms"] / v["monolithic_ms"]
                                              for k, v in camera.items()},
         frame_digest_ms=digest_ms, card=card)

    # -- the repeated clip through the pipeline: hits and launches -----------
    base = SyntheticVideoSource(seed=7, frame_shape=(112, 112), n_frames=DISAGG_DISTINCT)
    source = RepeatedClipSource(base, repeats=DISAGG_REPEATS)
    frames = source.frames()
    sweep = FcnSweep(stride=SWEEP_STRIDE,
                     threshold=calibrated_threshold(params, frames[0], fxp.Q16_16))
    want = {}
    for f in base.frames():
        fb, pos = sweep.extract(f)
        want[frame_digest(f.pixels)] = sweep.aggregate(cpu_sweep("fixed", fb), pos, fb)
    srv = DisaggServer(params, backend="fixed_cuda", stride=SWEEP_STRIDE,
                       cache_capacity=2 * DISAGG_DISTINCT)
    pipe = StreamingPipeline(source, srv, sweep)
    torch.cuda.synchronize()
    reset_launches()
    seen = count_launches(pipe.run)
    counts = launches()
    n = len(frames)
    want_counts = {"frame_trunk": DISAGG_DISTINCT, "fixed_window_head": n}
    expect(counts == want_counts and seen == want_counts,
           f"disagg pipeline: launches {counts}, profiler {seen}, expected {want_counts}")
    runs.append(counts)
    ps, ss = pipe.stats(), srv.stats()
    expect(ps["accounted"] and ps["frames_served"] == n and ps["frames_dropped"] == 0,
           f"disagg pipeline: ledger {ps['frames_in']} in, {ps['frames_served']} served")
    expect(ss["accounted"] and ss["n"] == n and ss["shed"] == 0
           and all(st["accounted"] for st in ss["per_stage"].values()),
           f"disagg pipeline: server ledger {ss['submitted']} {ss['n']} {ss['shed']}")
    cache = ss["cache"]
    expect(cache["hits"] == n - DISAGG_DISTINCT and cache["misses"] == DISAGG_DISTINCT
           and cache["hit_rate"] == 1 - 1 / DISAGG_REPEATS, f"disagg pipeline: cache {cache}")
    for f, r in zip(frames, pipe.results):
        expect(r.index == f.index and r.detections == want[frame_digest(f.pixels)],
               f"disagg pipeline: frame {f.index} detections differ from the CPU sweep's")
    emit("disagg", path="RepeatedClipSource(16 frames, repeats=4) through StreamingPipeline, "
         "fixed_cuda, under the profiler", frames=n, launches=counts, profiler_launches=seen,
         hit_rate=cache["hit_rate"], cache=cache, detections=ps["detections_total"], card=card)
    disagg_export(source, sweep, params, want, card)

    # -- rates: the stream table's three lanes, best of 2 --------------------
    rep_px = [f.pixels[None] for f in frames]
    base_px = [f.pixels[None] for f in base.frames()]

    # the monolithic lane holds its params quantized on the card, as a
    # VisionEngine does (the server quantizes its own once, at construction)
    native = B.get_backend("fixed_cuda").prepare_params(dev_params, "cuda")

    def mono_run():
        t0 = time.perf_counter()
        for x in rep_px:
            sweep.score(native, x, backend="fixed_cuda", device="cuda")
        return len(rep_px) / (time.perf_counter() - t0), None

    def disagg_run(clip_px):
        srv = DisaggServer(params, backend="fixed_cuda", stride=SWEEP_STRIDE,
                           cache_capacity=2 * DISAGG_DISTINCT)   # a fresh cache a rep
        t0 = time.perf_counter()
        for x in clip_px:
            srv.score_frame(x)
        return len(clip_px) / (time.perf_counter() - t0), srv.stats()

    best = lambda run: max((run() for _ in range(2)), key=lambda r: r[0])
    lanes = {"monolithic_repeated": best(mono_run),
             "disagg_repeated": best(lambda: disagg_run(rep_px)),
             "disagg_distinct": best(lambda: disagg_run(base_px))}
    fps = {k: v[0] for k, v in lanes.items()}
    emit("disagg", path="frames/s over the wall, best of 2, 112x112 fixed_cuda", **fps,
         disagg_over_monolithic=fps["disagg_repeated"] / fps["monolithic_repeated"],
         hit_rate={k: v[1]["cache"]["hit_rate"] for k, v in lanes.items() if v[1]},
         stage_p50_ms={k: {name: st.get("latency_p50_ms") for name, st in
                           v[1]["per_stage"].items()} for k, v in lanes.items() if v[1]},
         card=card)

    # -- open loop: a started fleet, calibrated closed loop, then Poisson -----
    pool = [f.pixels for f in SyntheticVideoSource(seed=7, frame_shape=(112, 112),
                                                   n_frames=DISAGG_POOL).frames()]
    pool_want = [cpu_sweep("fixed", px[None]) for px in pool]

    def fleet(max_queue, cache_capacity=DISAGG_POOL + 4):
        return DisaggServer(params, backend="fixed_cuda", stride=SWEEP_STRIDE, n_trunk=2,
                            n_head=2, n_workers=4, cache_capacity=cache_capacity,
                            max_queue=max_queue)

    def settle(label, srv, uids, which, injected=None):
        """Every query served or shed with a reason, every ledger accounted,
        every served score equal to the CPU's; no replica faulted and no
        query or stage request shed as "fault", but the failover run's own
        fault (`injected`: the one replica's name and its fault's class),
        so a kernel that fails cannot pass as sheds; returns (stats,
        results)."""
        res, shed = srv.pop_results(uids), srv.pop_shed(uids)
        st = srv.stats()
        faults = {e.name: e.fault for e in srv.trunks + srv.heads if e.fault is not None}
        expect(all(injected is not None and name == injected[0]
                   and isinstance(f, injected[1]) for name, f in faults.items()),
               f"disagg {label}: replicas faulted: {faults}")
        expect("fault" not in st["shed_by_reason"]
               and all("fault" not in s["shed_by_reason"] for name, s in st["per_stage"].items()
                       if injected is None or name != injected[0]),
               f"disagg {label}: sheds as fault: {st['shed_by_reason']}, "
               f"{ {k: s['shed_by_reason'] for k, s in st['per_stage'].items()} }")
        expect(st["accounted"] and st["pending"] == 0 and len(res) + len(shed) == len(uids)
               and all(s["accounted"] for s in st["per_stage"].values()),
               f"disagg {label}: {len(res)} served + {len(shed)} shed of {len(uids)}, "
               f"ledger {st['submitted']} {st['n']} {st['shed']} {st['pending']}")
        expect(all(shed.values()), f"disagg {label}: a shed without a reason")
        for uid, r in res.items():
            compare_scores(r.scores, pool_want[which[uid]], 0.0, f"disagg {label} query {uid}")
        return st, res

    cal = fleet(None).start()
    try:
        uids = [cal.submit(px) for px in pool * DISAGG_PASSES]
        cal.wait(uids, timeout=300)
    finally:
        cal.stop(drain=True)
    st, _ = settle("calibration", cal, uids, {u: i % DISAGG_POOL for i, u in enumerate(uids)})
    expect(st["n"] == len(uids), f"disagg calibration: served {st['n']} of {len(uids)}")
    capacity = st["n"] / st["wall_s"]
    open_loop = []
    for frac in (1 / 8, 1 / 2):
        gen = LoadGen(process="poisson", rate_qps=capacity * frac,
                      n_requests=DISAGG_OPEN_LOOP_REQUESTS, n_streams=4, seed=7)
        srv = fleet(DISAGG_MAX_QUEUE).start()
        uids, which = [], {}

        def submit(a, t, srv=srv, uids=uids, which=which):
            uid = srv.submit(pool[a.uid % DISAGG_POOL], deadline_ms=DISAGG_SLO_MS, t_submit=t)
            uids.append(uid)
            which[uid] = a.uid % DISAGG_POOL
        t0 = time.perf_counter()
        try:
            gen.replay(submit)
            srv.wait(uids, timeout=300)
        finally:
            srv.stop(drain=True)
        wall_s = time.perf_counter() - t0
        st, res = settle(f"open loop {frac}", srv, uids, which)
        open_loop.append({"fraction": frac, "offered_qps": gen.offered_qps,
                          "requests": len(uids), "served_per_wall_s": len(res) / wall_s,
                          "goodput": st.get("goodput"),
                          "latency_p50_ms": st.get("latency_p50_ms"),
                          "latency_p99_ms": st.get("latency_p99_ms"),
                          "shed_by_reason": st["shed_by_reason"],
                          "hit_rate": st["cache"]["hit_rate"],
                          "stage_p50_ms": {k: s.get("latency_p50_ms")
                                           for k, s in st["per_stage"].items()}})
    emit("disagg", path="open loop: 2 trunks, 2 heads, started, fixed_cuda",
         capacity_qps=capacity, calibration_queries=DISAGG_POOL * DISAGG_PASSES,
         deadline_ms=DISAGG_SLO_MS, runs=open_loop, card=card)

    # -- failover: trunk 0 faulted mid-run by an injected fault ---------------
    class InjectedFault(RuntimeError):
        """The failover check's own fault, told apart from any other."""

    def faulty(payload):
        raise InjectedFault("injected fault: trunk 0")

    srv = fleet(None, cache_capacity=8).start()          # churn: the trunks keep working
    uids, which = [], {}
    try:
        for i, px in enumerate(pool * DISAGG_FAILOVER_PASSES):
            if i == len(pool):                # the first pass served, then the fault
                srv.wait(uids, timeout=300)
                srv.trunks[0]._compute = faulty
            uid = srv.submit(px)
            uids.append(uid)
            which[uid] = i % DISAGG_POOL
        srv.wait(uids, timeout=300)
    finally:
        srv.stop(drain=True)
    st, res = settle("failover", srv, uids, which, injected=("trunk0", InjectedFault))
    trunk0 = st["per_stage"]["trunk0"]
    expect(isinstance(srv.trunks[0].fault, InjectedFault)
           and trunk0["shed_by_reason"].get("fault", 0) >= 1,
           f"disagg failover: the injected fault did not fire ({srv.trunks[0].fault!r})")
    emit("disagg", path="failover: trunk 0 faulted after the first pass", queries=len(uids),
         served=len(res), shed_by_reason=st["shed_by_reason"],
         trunk0_shed_by_reason=trunk0["shed_by_reason"],
         per_trunk_served={e.name: st["per_stage"][e.name]["n"] for e in srv.trunks},
         hit_rate=st["cache"]["hit_rate"], card=card)
    return runs


def disagg_export(source, sweep, params, want, card) -> None:
    """The repeated clip once more, with tracing on, and the run read back
    through the obs export: the flight recorder's spans through
    `dump_jsonl` / `load_jsonl`, the registry's Prometheus text through
    `dump_prometheus` / `parse_prometheus` (both under build/obs/, beside
    the built kernels), each held against the run's own ledgers; no
    recorder trip; the first frame's waterfall printed.  The registry is
    cleared first, so the dump holds this run's instruments only."""
    import torch
    from repro_torch.obs import metrics as M
    from repro_torch.obs import recorder as R
    from repro_torch.obs import trace as T
    from repro_torch.serving.disagg import DisaggServer, frame_digest
    from repro_torch.streaming import StreamingPipeline

    out = ROOT / "build" / "obs"
    M.REGISTRY.clear()
    tr = T.enable()
    try:
        with tr.span("server", "disagg-export"):           # construction and warm-up
            srv = DisaggServer(params, backend="fixed_cuda", stride=SWEEP_STRIDE,
                               cache_capacity=2 * DISAGG_DISTINCT)
        for inst in M.REGISTRY.instruments():               # the clip's own marks
            if isinstance(inst, M.Gauge):
                inst.reset_hwm()
        pipe = StreamingPipeline(source, srv, sweep)
        clip = tr.start("clip", "disagg-export")
        pipe.run()
        torch.cuda.synchronize()
        tr.end_at(clip, time.perf_counter())
    finally:
        T.disable()
    rec = tr.recorder
    spans = sorted(rec.spans(), key=lambda s: s.t_start)
    frames, n = source.frames(), len(pipe.results)
    ps, ss = pipe.stats(), srv.stats()
    expect(rec.trip_counts() == {} and rec.evicted == 0 and len(rec) == len(spans),
           f"disagg export: recorder trips {rec.trip_counts()}, evicted {rec.evicted}")
    failures = R.reconcile(spans, frames_served=ps["frames_served"],
                           frames_dropped=ps["frames_dropped"])
    infer = [s for s in spans if s.name == "infer"]
    expect(not failures and ps["frames_served"] == n and len(infer) == n
           and all(s.tags.get("route") == "disagg" and s.status == "ok" for s in infer),
           f"disagg export: spans against the ledger: {failures[:3]}, "
           f"{len(infer)} infer spans for {n} frames")
    for f, r in zip(frames, pipe.results):
        expect(r.index == f.index and r.detections == want[frame_digest(f.pixels)],
               f"disagg export: frame {f.index} detections differ from the CPU sweep's")
    header, back = R.load_jsonl(rec.dump_jsonl(str(out / "disagg_spans.jsonl")))
    expect(header["n_spans"] == len(spans)
           and [b.to_dict() for b in back] == [s.to_dict() for s in spans],
           "disagg export: the span dump does not read back as recorded")
    prom = M.parse_prometheus(pathlib.Path(R.dump_prometheus(
        str(out / "disagg_metrics.prom"))).read_text())

    def total(prefix):
        vals = [v for k, v in prom.items() if k.startswith(prefix + "{")]
        return sum(vals), len(vals)

    served = total("disagg_served_total")
    per_stage = {name: st["n"] for name, st in ss["per_stage"].items()}
    stage_served = sum(per_stage.values()), len(per_stage)
    expect(served == (ss["n"], 1) and ss["n"] == n
           and total("stage_served_total") == stage_served,
           f"disagg export: Prometheus served {served}, stages {total('stage_served_total')}; "
           f"the ledgers {ss['n']}, {stage_served}")
    emit("disagg", path="obs export: the repeated clip traced, spans and Prometheus text "
         "read back", spans=len(spans), frames=n,
         infer_p50_ms=sorted(s.duration_s for s in infer)[n // 2] * 1e3,
         clip_ms=clip.duration_s * 1e3, prometheus_series=len(prom),
         stage_queue_hwm={k.split('"')[1]: v for k, v in prom.items()
                          if k.startswith("stage_queue_depth_hwm{")},
         waterfall=R.waterfall(spans, "frame-0", max_spans=12).splitlines(), card=card)


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


def ptxas_kernels(log: str) -> list[dict]:
    """Per kernel of one source, what `nvcc -Xptxas -v` printed: registers,
    spill stores and loads (bytes), static shared memory (bytes)."""
    import re
    kernels = []
    for block in log.split("Compiling entry function")[1:]:
        mangled = block.split("'")[1]
        # the kernel's source name follows its length in the mangled name
        name, rest = next((mangled[m.end():m.end() + int(m.group())],
                           mangled[m.end() + int(m.group()):])
                          for m in re.finditer(r"\d+", mangled)
                          if mangled[m.end():m.end() + int(m.group())].endswith("_kernel"))
        targs = re.match(r"I((?:L[^E]*E)+)E", rest)
        args = [a.replace("n", "-") for a in re.findall(r"L[ib](n?\d+)E", targs.group(1))] \
            if targs else []
        num = lambda pat: int(re.search(pat, block).group(1)) if re.search(pat, block) else 0
        kernels.append({"kernel": name + (f"<{','.join(args)}>" if args else ""),
                        "registers": num(r"Used (\d+) registers"),
                        "spill_stores": num(r"(\d+) bytes spill stores"),
                        "spill_loads": num(r"(\d+) bytes spill loads"),
                        "static_smem": num(r"(\d+) bytes smem")})
    return kernels


def sass_counts(so: pathlib.Path) -> dict | str:
    """Per kernel of a built library, how often `cuobjdump -sass` shows the
    instructions the redesigns are about: wide and high multiplies, funnel
    shifts, local-memory traffic (a spill), wgmma, and calls (a 64-bit
    integer division is a called routine), the fp32 FMAs and the
    shared-memory loads."""
    import os
    import re
    tool = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    if not tool.exists():
        return "not measured: no cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    ops = ("IMAD.WIDE", "IMAD.HI", "SHF.R", "LEA.HI", "LDL", "STL", "HGMMA", "UTMALDG", "CALL",
           "FFMA", "LDS")
    out = {}
    for block in text.split("Function : ")[1:]:
        name = ptxas_kernels("Compiling entry function '" + block.split()[0] + "'")[0]["kernel"]
        code = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", block)
        out[name] = {"instructions": len(code),
                     **{op: sum(c.startswith(op) for c in code) for op in ops}}
    return out


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
    load_peaks()
    kind = torch.cuda.get_device_name(0)
    run(nvidia_smi_line(), kind, torch.cuda.device_count())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def run(card: str, kind: str, count: int) -> None:
    """Every phase; raises on the first failure."""
    import torch
    from repro_torch.analysis import mfu
    print(card, flush=True)
    spec, plain = mfu.resolve()
    expect(spec.name == "h100" and not plain,
           f"mfu.resolve() gave {spec.name!r} (plain {plain}) for {kind!r}")
    emit("device", nvidia_smi=card, torch_device_name=kind, device_count=count,
         torch=torch.__version__, cuda=torch.version.cuda, mfu_device=spec.name,
         peaks={"mem_bw": spec.mem_bw, **spec.peak_flops}, peaks_source=spec.source)

    from repro_torch.kernels import _build
    _build.build_all()
    report = _build.build_report()
    regs = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln]
            for k, v in report.items()}
    emit("build", seconds=_build.build_seconds, sources=list(_build.SOURCES),
         ptxas=regs)
    for name in ("quant_matmul", "frame_trunk", "fixed_dense", "fixed_net", "float_kernels",
                 "float_net"):                                                  # redesigned
        emit("ptxas", source=f"csrc/{name}.cu", kernels=ptxas_kernels(report[name]),
             sass=sass_counts(_build.library_path(name)))

    phase_golden()
    phase_sweep_golden()
    table = phase_kernels(card)
    table["fixed_smallnet"] = phase_smallnet_kernel(card)
    table["float_smallnet"] = phase_float_smallnet_kernel(card)
    table["fixed_window_head"] = phase_window_head_kernel(card)
    table["frame_trunk"] = phase_frame_trunk_kernel(card)
    table.update(phase_float_kernels(card))

    from repro_torch.core import backends as B
    from repro_torch.core import fixed_point as fxp
    from repro_torch.data import synth_mnist

    @dataclasses.dataclass(frozen=True)
    class ComposedStages(B.FixedCudaBackend):
        """fixed_cuda with the net composed of its stages (no whole-net
        launch) and each stage of two launches (conv+PLAN, then the max
        pool), as the frame sweep composes its stages."""
        name: str = "fixed_cuda_composed"

        def net_scores(self, images, p):
            return None

        def fused_conv_act_pool(self, x, w, b):
            return self.maxpool2x2(self.fused_conv_act(x, w, b))

    @dataclasses.dataclass(frozen=True)
    class ComposedFloat(B.CudaFloatBackend):
        """cuda_plan with the net composed of its stages (no whole-net
        launch): the conv+PLAN launch, the pool launch, twice, then the
        dense product and the sigmoid_pla launch."""
        name: str = "cuda_plan_composed"
        activation: str = "plan"

        def net_scores(self, images, p):
            return None

    params = seeded_params(0)
    images, _ = synth_mnist.make_dataset(N_REQUESTS, seed=1)
    served = {"fixed_smallnet": 1}
    composed = {"fixed_conv2d": 2, "fixed_maxpool2x2": 2, "fixed_dense": 1, "fixed_sigmoid": 1}
    q16_counts, q16_wall_qps = serve_once(params, images, "fixed_cuda", "serve q16_16", card,
                                          served)
    runs = [
        q16_counts,
        serve_once(params, images, B.FixedCudaBackend(cfg=fxp.Q8_8),
                   "serve q8_8", card, served)[0],
        serve_once(params, images[:256], ComposedStages(), "composed q16_16", card,
                   composed)[0],
    ]
    # the float and int8 backends, each held to its plain counterpart on the
    # CPU; the composed float engine keeps the per-stage float kernels on a
    # served path
    float_step = {"float_smallnet": 1}
    for backend, plain, n, per_step in (
            ("cuda_plan", "plan", N_REQUESTS, float_step),
            (ComposedFloat(), "plan", 256, {"conv2d": 2, "maxpool2d": 2, "sigmoid_pla": 1}),
            ("int8", "int8", N_REQUESTS, {"quant_matmul": 1}),
            ("cuda", "ref", 256, float_step),
            ("ref", "ref", 256, {}),
            ("plan", "plan", 256, {})):
        label = "composed cuda_plan" if isinstance(backend, ComposedFloat) else f"serve {backend}"
        runs.append(serve_once(params, images[:n], backend, label, card, per_step, plain=plain,
                               tol=FLOAT_TOL)[0])
    # training, the ladder and the router come before the sweep, so a time
    # cut cannot drop them
    trained_np, train_runs = phase_train(card)
    runs += train_runs
    runs += phase_router(card, trained_np, q16_wall_qps)
    runs += phase_sweep(card)
    runs += phase_disagg(card)
    phase_profile(params, images, card)
    phase_sweep_profile(card)
    for name, row in table.items():
        row["launches"] = sum(c.get(name, 0) for c in runs)
        expect(row["launches"] > 0, f"{name}: no launch on the served and swept paths")
    print(card, flush=True)
    print(json.dumps({"kernels": list(table.values())}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
