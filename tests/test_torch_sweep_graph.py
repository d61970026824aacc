"""The float window head kernel and the swept frame's CUDA graph, on the card.

These tests need a CUDA card (a kernel and a CUDA graph have no CPU mode)
and skip without one.  They import no JAX:
    PYTHONPATH=src python -m pytest -q tests/test_torch_sweep_graph.py
`float_window_head` is held to its plain version and to the composed head
within 1e-6 (it sums a score in k order, cuBLAS in its own); the graph
route of `FcnSweep.score` to the eager sweep bit for bit, on `cuda_plan`,
`cuda` and `fixed_cuda` with native params, at 28x28, 112x112 and
720x1280.  Through `StreamingPipeline`, the captured frame graph replays
on the event loop's thread with the detections of the composed route.
The CPU side of the head and of the eligibility rule is in
`tests/test_torch_fcn_sweep.py` and `tests/test_torch_float_backends.py`,
that of the pipeline's threads in `tests/test_torch_streaming.py`.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import backends as TB  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.kernels.conv2d import float_window_head, float_window_head_plain  # noqa: E402
from repro_torch.obs import metrics as M  # noqa: E402
from repro_torch.serving.vision_engine import VisionEngine  # noqa: E402
from repro_torch.streaming import FcnSweep, StreamingPipeline, SyntheticVideoSource  # noqa: E402
from repro_torch.streaming import fcn_sweep as fs  # noqa: E402

SHAPES = [(28, 28), (112, 112), (720, 1280)]
HEAD_ATOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and CUDA graphs have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _params(seed, device):
    """Float params as tensors on `device`, every leaf nonzero."""
    rng = np.random.default_rng(seed)
    p = {"conv1": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, .5, (1,))},
         "conv2": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, .5, (1,))},
         "dense": {"w": rng.uniform(-.6, .6, (49, 10)), "b": rng.normal(0, .5, (10,))}}
    return {k: {n: torch.from_numpy(a.astype(np.float32)).to(device) for n, a in v.items()}
            for k, v in p.items()}


def _graph_events() -> dict[str, int]:
    return {e: M.REGISTRY.counter("fcn_sweep_graph", event=e).value
            for e in ("capture", "replay", "eager")}


def _delta(before: dict[str, int]) -> dict[str, int]:
    return {k: v - before[k] for k, v in _graph_events().items()}


def _frame(shape, seed=7):
    frame = SyntheticVideoSource(n_frames=1, seed=seed, frame_shape=shape).frames()[0]
    return FcnSweep(stride=8).extract(frame)


@pytest.mark.parametrize("activation,backend", [("plan", "cuda_plan"), ("sigmoid", "cuda")])
@pytest.mark.parametrize("shape", SHAPES)
def test_float_window_head_matches_plain_and_composed_head_on_card(cuda, shape, activation,
                                                                     backend):
    """One launch; within 1e-6 of its plain version on the card and on the
    CPU, and of the composed head (stack, gather, cuBLAS, activation)."""
    rng = np.random.default_rng(shape[0] + shape[1])
    p = _params(11, cuda)
    h, w = shape[0] // 4, shape[1] // 4
    maps = [torch.from_numpy(rng.uniform(0, 1, (h, w)).astype(np.float32)).to(cuda)
            for _ in range(4)]
    pos = tuple(FcnSweep(stride=8).positions(shape))
    gy, gx = fs._window_origins(28, pos, (h, w), cuda)
    wd, bd = p["dense"]["w"], p["dense"]["b"]
    reset_launches()
    got = float_window_head(maps, gy, gx, wd, bd, activation=activation)
    torch.cuda.synchronize()
    assert launches() == {"float_window_head": 1}
    assert got.shape == (len(pos), 10) and got.dtype == torch.float32
    plain = float_window_head_plain(maps, gy, gx, wd, bd, activation=activation)
    torch.testing.assert_close(got, plain, rtol=0, atol=HEAD_ATOL)
    on_cpu = float_window_head_plain([m.cpu() for m in maps], gy.cpu(), gx.cpu(), wd.cpu(),
                                     bd.cpu(), activation=activation)
    torch.testing.assert_close(got.cpu(), on_cpu, rtol=0, atol=HEAD_ATOL)
    be = TB.get_backend(backend)
    quad = tuple(m[None, ..., None] for m in maps)
    composed = fs._head_scores(be, p, quad, 28, pos, fused=False)
    torch.testing.assert_close(got, composed, rtol=0, atol=HEAD_ATOL)
    assert torch.equal(fs._head_scores(be, p, quad, 28, pos), got)


def _native(backend, device):
    be = TB.get_backend(backend)
    return be, be.prepare_params(_params(7, device), device)


@pytest.mark.parametrize("backend,per_frame", [
    ("cuda_plan", {"float_sweep_stage": 2, "float_window_head": 1}),
    ("cuda", {"float_sweep_stage": 2, "float_window_head": 1}),
    ("fixed_cuda", {"frame_trunk": 1, "fixed_window_head": 1}),
])
@pytest.mark.parametrize("shape", SHAPES)
def test_graph_route_equals_eager_sweep_on_card(cuda, shape, backend, per_frame):
    """The first call captures, the next replays; both give the eager
    `_sweep`'s scores bit for bit (word for word on `fixed_cuda`, whose
    native params stay on the card), with the eager route's launches."""
    be, p = _native(backend, cuda)
    fb, pos = _frame(shape)
    with torch.inference_mode():
        want = fs._sweep(be, p, torch.from_numpy(fb).to(cuda), 28, tuple(pos), None)
    want = want.cpu().numpy()
    sweep = FcnSweep(stride=8)
    before = _graph_events()
    for event in ("capture", "replay"):
        reset_launches()
        got = sweep.score(p, fb, backend=be, device=cuda)
        assert launches() == per_frame, event
        np.testing.assert_array_equal(got, want, err_msg=event)
        assert got.dtype == want.dtype
    assert _delta(before) == {"capture": 1, "replay": 1, "eager": 0}
    # a frame already on the card replays too
    got = sweep.score(p, torch.from_numpy(fb).to(cuda), backend=be)
    np.testing.assert_array_equal(got, want)
    assert _delta(before) == {"capture": 1, "replay": 2, "eager": 0}
    # megakernel=True is another key: it raises where there is no trunk
    # hook, and captures its own graph where there is
    if backend == "fixed_cuda":
        got = FcnSweep(stride=8, megakernel=True).score(p, fb, backend=be, device=cuda)
        np.testing.assert_array_equal(got, want)
        assert _delta(before) == {"capture": 2, "replay": 2, "eager": 0}
    else:
        with pytest.raises(NotImplementedError, match="no frame_trunk"):
            FcnSweep(stride=8, megakernel=True).score(p, fb, backend=be, device=cuda)


def test_clip_captures_once_and_replays_each_frame_on_card(cuda):
    """100 frames of a 64-frame clip: 1 capture, 99 replays, 3 launches a
    frame; every frame's scores the eager sweep's."""
    be, p = _native("cuda_plan", cuda)
    clip = SyntheticVideoSource(n_frames=64, seed=3).frames()
    sweep = FcnSweep(stride=8)
    pos = tuple(sweep.positions((112, 112)))
    before = _graph_events()
    reset_launches()
    outs = []
    for i in range(100):
        fb, _ = sweep.extract(clip[i % 64])
        outs.append(sweep.score(p, fb, backend=be, device=cuda))
    assert launches() == {"float_sweep_stage": 200, "float_window_head": 100}
    assert _delta(before) == {"capture": 1, "replay": 99, "eager": 0}
    with torch.inference_mode():
        for i in (0, 1, 63, 64, 99):
            fb, _ = sweep.extract(clip[i % 64])
            want = fs._sweep(be, p, torch.from_numpy(fb).to(cuda), 28, pos, None)
            np.testing.assert_array_equal(outs[i], want.cpu().numpy(), err_msg=str(i))
    np.testing.assert_array_equal(outs[0], outs[64])


def test_params_written_in_place_show_in_the_replay_on_card(cuda):
    """The graph reads the caller's param storage: a value written in place
    shows in the next replay; new param tensors capture again."""
    be, p = _native("cuda_plan", cuda)
    fb, pos = _frame((112, 112))
    sweep = FcnSweep(stride=8)
    before = _graph_events()
    first = sweep.score(p, fb, backend=be, device=cuda)
    with torch.no_grad():
        p["dense"]["b"].add_(0.75)
        p["conv1"]["w"].mul_(-1.0)
    got = sweep.score(p, fb, backend=be, device=cuda)
    assert _delta(before) == {"capture": 1, "replay": 1, "eager": 0}
    with torch.inference_mode():
        want = fs._sweep(be, p, torch.from_numpy(fb).to(cuda), 28, tuple(pos), None)
    np.testing.assert_array_equal(got, want.cpu().numpy())
    assert not np.array_equal(got, first)
    fresh = {k: {n: t.clone() for n, t in v.items()} for k, v in p.items()}
    np.testing.assert_array_equal(sweep.score(fresh, fb, backend=be, device=cuda), got)
    assert _delta(before) == {"capture": 2, "replay": 1, "eager": 0}


def test_returned_scores_never_share_memory_on_card(cuda):
    be, p = _native("cuda_plan", cuda)
    sweep = FcnSweep(stride=8)
    clip = SyntheticVideoSource(n_frames=3, seed=5).frames()
    outs = [sweep.score(p, sweep.extract(f)[0], backend=be, device=cuda) for f in clip]
    for i, a in enumerate(outs):
        for b in outs[i + 1:]:
            assert not np.shares_memory(a, b)
    assert not np.array_equal(outs[1], outs[2])
    outs[1][:] = -1.0                      # the caller owns what it got
    again = sweep.score(p, sweep.extract(clip[2])[0], backend=be, device=cuda)
    np.testing.assert_array_equal(again, outs[2])


def test_ineligible_calls_stay_eager_on_card(cuda):
    """The composed route, int8, and `fixed_cuda` with float params (which
    `prepare_params` quantizes on each call) run eagerly every time."""
    fb, _ = _frame((112, 112))
    p = _params(7, cuda)
    before = _graph_events()
    for backend, mk in (("cuda_plan", False), ("int8", None), ("fixed_cuda", None)):
        for _ in range(2):
            FcnSweep(stride=8, megakernel=mk).score(p, fb, backend=backend, device=cuda)
    assert _delta(before) == {"capture": 0, "replay": 0, "eager": 6}


def test_float_window_head_refusals_on_card(cuda):
    """N above 128 has no kernel and raises; a window past the maps stops
    the kernel with a CUDA error (a trap poisons the process's CUDA
    context, so it runs in a child)."""
    import os
    import pathlib
    import subprocess
    import sys
    z = torch.zeros((28, 28), device=cuda)
    g = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        float_window_head([z] * 4, g, g, torch.zeros((49, 129), device=cuda),
                          torch.zeros(129, device=cuda))
    probe = (
        "import torch\n"
        "from repro_torch.kernels.conv2d import float_window_head\n"
        "z = torch.zeros((28, 28), device='cuda')\n"
        "g = torch.tensor([0, 22], dtype=torch.int32, device='cuda')\n"
        "float_window_head([z] * 4, g, g, torch.zeros((49, 10), device='cuda'),\n"
        "                  torch.zeros(10, device='cuda'))\n"
        "torch.cuda.synchronize()\n"
        "print('no error')\n")
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "no error" not in out.stdout, out.stdout


def test_concurrent_replays_keep_each_frame_on_card(cuda):
    """More threads than cores replay one frame graph at once, under a
    short switch interval: each call gets its own frame's scores (the
    entry's lock covers the staging buffers from the copy in to the copy
    out)."""
    import os
    import sys
    import threading
    be, p = _native("cuda_plan", cuda)
    sweep = FcnSweep(stride=8)
    pos = tuple(sweep.positions((112, 112)))
    fbs = [sweep.extract(f)[0] for f in SyntheticVideoSource(n_frames=8, seed=11).frames()]
    with torch.inference_mode():
        want = [fs._sweep(be, p, torch.from_numpy(fb).to(cuda), 28, pos, None).cpu().numpy()
                for fb in fbs]
    sweep.score(p, fbs[0], backend=be, device=cuda)               # the capture
    before = _graph_events()
    errors, n_threads, n_calls = [], 2 * (os.cpu_count() or 4), 40

    def work(t):
        try:
            for i in range(n_calls):
                k = (t + i) % len(fbs)
                if not np.array_equal(sweep.score(p, fbs[k], backend=be, device=cuda),
                                      want[k]):
                    errors.append((t, i))
        except Exception as e:  # noqa: BLE001 -- reported by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and errors == []
    assert _delta(before) == {"capture": 0, "replay": n_threads * n_calls, "eager": 0}


@dataclasses.dataclass(frozen=True)
class _Recorded(FcnSweep):
    """FcnSweep that records the scores its aggregate receives (frame order)
    and the thread of each replay."""
    got: list = dataclasses.field(default_factory=list, compare=False)
    replay_threads: list = dataclasses.field(default_factory=list, compare=False)

    def replay(self, *args, **kwargs):
        out = super().replay(*args, **kwargs)
        if out is not None:
            self.replay_threads.append(threading.get_ident())
        return out

    def aggregate(self, scores, positions, tiles=None):
        self.got.append(scores)
        return super().aggregate(scores, positions, tiles)


def _ambiguous(sweep, scores, positions, tol) -> bool:
    """Whether detections from scores within `tol` of these may differ: a
    window's top confidence within `tol` of the threshold, a candidate's two
    top classes within `tol`, or two candidates within the dedup distance
    whose confidences lie within `tol`."""
    conf = sweep._confidences(scores)
    best, top2 = conf.max(-1), np.sort(conf, axis=-1)[:, -2:]
    cand = np.flatnonzero(best >= sweep.threshold - tol)
    pos = np.asarray(positions)
    near_order = any(((np.abs(best[cand[i + 1:]] - best[c]) <= tol)
                      & (np.abs(pos[cand[i + 1:]] - pos[c]).max(-1) <= sweep.min_dist)).any()
                     for i, c in enumerate(cand))
    return bool((np.abs(best - sweep.threshold) <= tol).any()
                or ((top2[cand, 1] - top2[cand, 0]) <= tol).any() or near_order)


def _same_detections(got, want, tol) -> bool:
    """Equal label, place and size, and a score within `tol`."""
    return len(got) == len(want) and all(
        (g.label, g.y, g.x, g.size) == (w.label, w.y, w.x, w.size)
        and abs(g.score - w.score) <= tol for g, w in zip(got, want))


def test_pipeline_replays_each_frame_on_the_loop_thread_on_card(cuda):
    """100 112x112 frames on `cuda_plan` through `StreamingPipeline`: the
    constructor captures once, and every frame replays on the event loop's
    thread.  Detections equal the offline `detect` (the same graph) and the
    same clip's run on the composed route (`megakernel=False`, eager, on a
    worker): label and place, and the score within the head's 1e-6, where
    that run's scores leave no tie within 1e-6."""
    p = _params(7, cuda)
    frames = SyntheticVideoSource(n_frames=100, seed=3).frames()
    composed = FcnSweep(stride=8, megakernel=False)
    fb, pos = composed.extract(frames[0])
    conf = composed._confidences(composed.score(p, fb, backend="cuda_plan", device=cuda))
    threshold = float(np.quantile(conf.max(-1), 0.8))
    runs = {}
    for mk in (None, False):
        sweep = _Recorded(stride=8, threshold=threshold, megakernel=mk)
        eng = VisionEngine(p, backend="cuda_plan", device=cuda, warmup=False)
        before = _graph_events()
        pipe = StreamingPipeline(SyntheticVideoSource(n_frames=100, seed=3), eng, sweep)
        warm = _delta(before)
        before = _graph_events()
        res = pipe.run()
        runs[mk] = (sweep, res, pipe.stats(), warm, _delta(before), eng.params)
    sweep, res, st, warm, run, native = runs[None]
    assert warm == {"capture": 1, "replay": 0, "eager": 0}
    assert run == {"capture": 0, "replay": 100, "eager": 0}
    assert st["infer_thread"] == {"loop": 100, "worker": 0}
    assert sweep.replay_threads == [threading.get_ident()] * 100
    assert st["accounted"] and st["frames_served"] == 100 and st["frames_dropped"] == 0
    assert [r.index for r in res] == list(range(100))
    offline = FcnSweep(stride=8, threshold=threshold)
    assert [r.detections for r in res] == [
        offline.detect(native, f, backend="cuda_plan", device=cuda) for f in frames]
    c_sweep, c_res, c_st, c_warm, c_run, _ = runs[False]
    assert c_warm == {"capture": 0, "replay": 0, "eager": 1}
    assert c_run == {"capture": 0, "replay": 0, "eager": 100}
    assert c_st["infer_thread"] == {"loop": 0, "worker": 100} and c_sweep.replay_threads == []
    assert [r.index for r in c_res] == list(range(100))
    ties = []
    for i, (a, b) in enumerate(zip(res, c_res)):
        np.testing.assert_allclose(sweep.got[i], c_sweep.got[i], rtol=0, atol=HEAD_ATOL)
        if not _same_detections(a.detections, b.detections, HEAD_ATOL):
            ties.append(i)
            assert _ambiguous(c_sweep, c_sweep.got[i], pos, HEAD_ATOL), i
    assert len(ties) <= 10, ties
    assert sum(len(r.detections) for r in res) > 0
