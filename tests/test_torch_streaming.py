"""The port's streaming layer against the JAX reference.

Sources replay the reference's clips pixel for pixel and truth for truth;
the tiler's window lattice and aggregation equal the reference's; and the
port's `StreamingPipeline`, in tiler mode (waves through `VisionEngine`)
and in sweep mode (one `FcnSweep` per frame), serves exactly its offline
detections, which equal the reference's offline detections on the same
clip and params.  The ledger `frames_in == served + dropped` holds under
deadline misses and both drop policies.  A sweep whose frame graph is
captured is replayed on the event loop's thread; the capture, an eager
sweep, the engine's waves and `score_frame` run on workers, and the
detections are the all-worker run's.  Everything runs on the CPU
(`VisionEngine(device="cpu")`, plain versions of the kernels).
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.streaming import fcn_sweep as jfs  # noqa: E402
from repro.streaming import sources as jsrc  # noqa: E402
from repro.streaming import tiler as jtiler  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.obs import metrics as M  # noqa: E402
from repro_torch.obs import trace as T  # noqa: E402
from repro_torch.serving.vision_engine import VisionEngine  # noqa: E402
from repro_torch.streaming import (FcnSweep, PacedPlayer, RepeatedClipSource,  # noqa: E402
                                   StreamConfig, StreamingPipeline, SyntheticVideoSource,
                                   Tiler)
from repro_torch.streaming.tiler import tile_positions  # noqa: E402


def numpy_params(seed=0):
    """Float params from numpy with every leaf nonzero."""
    rng = np.random.default_rng(seed)
    p = {"conv1": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "conv2": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "dense": {"w": rng.uniform(-0.6, 0.6, (49, 10)),
                   "b": rng.normal(0, 0.5, (10,))}}
    return {k: {n: a.astype(np.float32) for n, a in v.items()} for k, v in p.items()}


@pytest.fixture(scope="module")
def params():
    return numpy_params()


@pytest.fixture(scope="module")
def clip():
    return SyntheticVideoSource(n_frames=6, seed=3)


@pytest.fixture(scope="module")
def threshold(params, clip):
    """The stream benchmarks' calibration: the 80th percentile of the first
    frame's per-window top confidence on the plain `fixed` backend."""
    t0 = Tiler(stride=8)
    tiles, _ = t0.extract(clip.frames()[0])
    conf = t0._confidences(t0.score(params, tiles, backend="fixed", device="cpu")).max(-1)
    return float(np.quantile(conf, 0.8))


# ---------------------------------------------------------------------------
# sources and the tiler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(seed=3, n_frames=8),
                                dict(seed=7, n_frames=3, frame_shape=(104, 132)),
                                dict(seed=11, n_frames=2, frame_shape=(200, 60), n_objects=4,
                                     noise=0.1, max_speed=9.0)])
def test_source_replays_the_reference_clip(kw):
    ours, ref = SyntheticVideoSource(**kw), jsrc.SyntheticVideoSource(**kw)
    assert len(ours) == len(ref) and ours.frame_shape == ref.frame_shape
    for a, b in zip(ours.frames(), ref.frames()):
        assert a.index == b.index
        assert a.pixels.dtype == b.pixels.dtype == np.float32
        assert a.pixels.tobytes() == b.pixels.tobytes()
        assert [dataclasses.astuple(t) for t in a.truth] == \
            [dataclasses.astuple(t) for t in b.truth]
    # a replayable clip: a second pass gives the same frames
    assert all(np.array_equal(a.pixels, b.pixels)
               for a, b in zip(ours.frames(), ours.frames()))
    with pytest.raises(ValueError, match="cannot hold"):
        SyntheticVideoSource(frame_shape=(20, 112))


@pytest.mark.parametrize("shape,patch,stride", [((112, 112), 28, 14), ((112, 112), 28, 8),
                                                ((104, 132), 28, 12), ((28, 50), 28, 5)])
def test_tile_positions_and_extract_match_the_reference(shape, patch, stride):
    assert tile_positions(shape, patch, stride) == jtiler.tile_positions(shape, patch, stride)
    frame = np.random.default_rng(1).random(shape + (1,)).astype(np.float32)
    ours, pos = Tiler(patch=patch, stride=stride).extract(frame)
    ref, pos_ref = jtiler.Tiler(patch=patch, stride=stride).extract(frame)
    assert pos == pos_ref and np.array_equal(ours, ref)
    with pytest.raises(ValueError, match="smaller than patch"):
        tile_positions((20, 40), 28, 4)


def test_aggregate_matches_the_reference_ties_included():
    rng = np.random.default_rng(4)
    pos = tile_positions((112, 112), 28, 4)
    for trial in range(4):
        # integer words with many ties (PLAN saturates to `one`), and floats
        words = rng.integers(40000, 65537, (len(pos), 10)).astype(np.int32)
        words[rng.random(len(pos)) < 0.3] = 65536
        floats = rng.random((len(pos), 10)).astype(np.float32)
        tiles = rng.random((len(pos), 28, 28, 1)).astype(np.float32)
        for scores in (words, floats):
            for kw in (dict(threshold=0.9, min_dist=14), dict(threshold=0.7, min_dist=4),
                       dict(threshold=0.95, min_dist=14, min_mass=0.5)):
                ours = Tiler(stride=4, **kw).aggregate(scores, pos, tiles)
                ref = jtiler.Tiler(stride=4, **kw).aggregate(scores, pos, tiles)
                assert [dataclasses.astuple(d) for d in ours] == \
                    [dataclasses.astuple(d) for d in ref]
                assert ours, "the case must detect something"
    grid = Tiler(stride=4).confidence_grid(words, pos)
    np.testing.assert_array_equal(grid, jtiler.Tiler(stride=4).confidence_grid(words, pos))
    with pytest.raises(ValueError, match="rectangular"):
        Tiler().confidence_grid(words[:3], [(0, 0), (0, 4), (4, 0)])


def test_confidences_are_float32_like_from_fixed():
    # a float64 division would move words that sit on a threshold
    words = np.asarray([[1, 65535, 65536, 2 ** 31 - 1, -2 ** 31, 12345, 7, 3, 99, 0]], np.int32)
    ours = Tiler()._confidences(words)
    ref = jtiler.Tiler()._confidences(words)
    assert ours.dtype == ref.dtype == np.float32
    assert ours.tobytes() == ref.tobytes()


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _ref_detections(params, clip, tiler):
    return [[dataclasses.astuple(d) for d in tiler.detect(params, f.pixels, backend="fixed")]
            for f in clip.frames()]


@pytest.mark.parametrize("mode", ["tiler", "sweep", "sweep_composed"])
def test_pipeline_serves_the_offline_detections_which_equal_jax(params, clip, threshold, mode):
    tp = params_from_jax(params, "cpu")
    if mode == "tiler":
        tiler, jt = Tiler(stride=8, threshold=threshold), \
            jtiler.Tiler(stride=8, threshold=threshold)
    else:
        mk = None if mode == "sweep" else False
        tiler = FcnSweep(stride=8, threshold=threshold, megakernel=mk)
        jt = jfs.FcnSweep(stride=8, threshold=threshold, megakernel=False)
    eng = VisionEngine(tp, backend="fixed_cuda", batch_size=64, device="cpu")
    pipe = StreamingPipeline(clip, eng, tiler)
    reset_launches()
    res = pipe.run()
    s = pipe.stats()
    assert s["mode"] == "throughput" and s["accounted"]
    assert s["frames_in"] == s["frames_served"] == len(clip) and s["frames_dropped"] == 0
    assert launches() == {}                     # CPU tensors: plain versions only
    offline = [tiler.detect(tp, f, backend="fixed_cuda", device="cpu")
               for f in clip.frames()]
    assert [r.detections for r in res] == offline
    assert [r.index for r in res] == list(range(len(clip)))
    assert s["detections_total"] == sum(len(d) for d in offline) > 0
    assert [[dataclasses.astuple(d) for d in ds] for ds in offline] == \
        _ref_detections(params, clip, jt)
    assert set(s["stage"]) == {"tile", "infer", "aggregate"}
    assert s["latency_p50_ms"] > 0 and s["sustained_fps"] > 0
    if mode == "tiler":
        assert 0.0 < s["batch_occupancy"] <= 1.0


def test_sweep_mode_needs_an_engine_with_a_model(threshold):
    with pytest.raises(TypeError, match="params/backend"):
        StreamingPipeline(SyntheticVideoSource(n_frames=1), _SlowEngine(0.0),
                          FcnSweep(threshold=threshold))


@dataclasses.dataclass
class _FakeResult:
    scores: np.ndarray


class _SlowEngine:
    """Stub inference: fixed per-wave delay, constant scores."""

    def __init__(self, delay_s: float):
        self.delay_s = delay_s
        self.waves = 0

    def serve(self, tiles):
        self.waves += 1
        time.sleep(self.delay_s)
        return [_FakeResult(scores=np.zeros(10, np.float32)) for _ in tiles]


def test_deadline_misses_are_counted_not_lost():
    clip = SyntheticVideoSource(n_frames=6, seed=1)
    eng = _SlowEngine(0.01)
    pipe = StreamingPipeline(PacedPlayer(clip, fps=200), eng, Tiler(),
                             config=StreamConfig(deadline_ms=5.0, queue_size=8))
    res = pipe.run()
    s = pipe.stats()
    assert s["mode"] == "realtime" and s["accounted"]
    assert s["frames_in"] == len(clip) == s["frames_served"] + s["frames_dropped"]
    # every wave outlasts the deadline, so no frame reaches aggregate in time
    assert res == [] and s["frames_dropped"] == len(clip)
    assert s["drops_by_reason"].get("deadline", 0) > 0
    assert sum(s["drops_by_reason"].values()) == len(clip)
    assert set(k.split("/")[0] for k in s["drops_by_stage"]) <= {"ingest", "tile", "infer",
                                                                 "aggregate"}


def test_drop_policy_oldest_keeps_the_freshest_frames():
    clip = SyntheticVideoSource(n_frames=20, seed=1)
    pipe = StreamingPipeline(PacedPlayer(clip, fps=500), _SlowEngine(0.02), Tiler(),
                             config=StreamConfig(queue_size=2, drop_policy="oldest"))
    res = pipe.run()
    s = pipe.stats()
    assert s["accounted"] and s["drops_by_reason"].get("queue_full", 0) > 0
    assert max(s["queue_hwm"].values()) <= 2
    assert s["frames_served"] + s["frames_dropped"] == 20
    # evicting the stalest queued frame means the clip's LAST frame is
    # always admitted and served
    assert res and res[-1].index == 19
    with pytest.raises(ValueError, match="drop_policy"):
        StreamConfig(drop_policy="random")


# ---------------------------------------------------------------------------
# where the infer stage runs a wave: the loop's thread or a worker
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _GraphStub(FcnSweep):
    """`FcnSweep` whose "graph cache" is the set of frames it has scored:
    `score` (the eager call, which captures where `capture`) adds the
    frame after `delay_s`; `replay` serves a frame of the set and returns
    None for the others.  Each call records (thread, start, end)."""
    capture: bool = True
    delay_s: float = 0.0
    captured: set = dataclasses.field(default_factory=set, compare=False)
    scores: list = dataclasses.field(default_factory=list, compare=False)
    replays: list = dataclasses.field(default_factory=list, compare=False)

    def score(self, params, frames, **kw):
        t0 = time.perf_counter()
        time.sleep(self.delay_s)
        out = super().score(params, frames, **kw)
        if self.capture:
            self.captured.add(np.asarray(frames).tobytes())
        self.scores.append((threading.get_ident(), t0, time.perf_counter()))
        return out

    def replay(self, params, frames, **kw):
        if np.asarray(frames).tobytes() not in self.captured:
            return None
        t0 = time.perf_counter()
        out = super().score(params, frames, **kw)
        self.replays.append((threading.get_ident(), t0, time.perf_counter()))
        return out


def _thread_counts(pipe) -> dict[str, int]:
    return {t: M.REGISTRY.counter("stream_infer_thread", pipe=pipe._id, thread=t).value
            for t in ("loop", "worker")}


def _infer_run(source, engine, tiler, **kw):
    """Run the clip on this thread (the event loop's); -> (results, stats,
    the infer spans by frame, the pipeline)."""
    pipe = StreamingPipeline(source, engine, tiler, **kw)
    tr = T.enable(capacity=4096)
    try:
        res = pipe.run()
        spans = tr.recorder.spans()
    finally:
        T.disable()
    infer = {int(s.trace_id.split("-")[1]): s for s in spans if s.name == "infer"}
    return res, pipe.stats(), infer, pipe


@pytest.mark.parametrize("distinct,repeats", [(3, 3), (2, 4)])
def test_captured_frames_replay_on_the_loop_thread_and_the_rest_on_workers(
        params, threshold, distinct, repeats):
    """Each frame of a clip shown `repeats` times: its first showing
    captures on a worker, the repeats replay on the loop's thread.  The
    registry counter (each pipeline under its own label), the stats and the
    infer spans' `thread` tag count both; detections, frame order and the
    ledger are those of the same clip run all on workers (the real
    `FcnSweep` on CPU tensors, which has no graph to replay)."""
    tp = params_from_jax(params, "cpu")
    clip = RepeatedClipSource(SyntheticVideoSource(n_frames=distinct, seed=3), repeats=repeats)
    n = distinct * repeats
    eng = VisionEngine(tp, backend="fixed_cuda", batch_size=64, device="cpu")
    stub = _GraphStub(stride=8, threshold=threshold)
    loop_thread = threading.get_ident()
    res, s, infer, pipe = _infer_run(clip, eng, stub)
    warm, *run = stub.scores                           # the constructor's warm-up first
    assert warm[0] == loop_thread
    assert [t for t, _, _ in stub.replays] == [loop_thread] * (n - distinct)
    assert len(run) == distinct and all(t != loop_thread for t, _, _ in run)
    want = (["worker"] + ["loop"] * (repeats - 1)) * distinct
    assert [infer[i].tags["thread"] for i in range(n)] == want
    assert all(infer[i].tags["route"] == "sweep" and infer[i].status == "ok" for i in range(n))
    threads = {"loop": n - distinct, "worker": distinct}
    assert s["infer_thread"] == _thread_counts(pipe) == threads
    base_res, base, _, base_pipe = _infer_run(clip, eng, FcnSweep(stride=8, threshold=threshold))
    assert base["infer_thread"] == _thread_counts(base_pipe) == {"loop": 0, "worker": n}
    assert _thread_counts(pipe) == threads
    assert s["accounted"] and base["accounted"]
    assert s["frames_served"] == base["frames_served"] == n and s["frames_dropped"] == 0
    assert [r.index for r in res] == [r.index for r in base_res] == list(range(n))
    assert [r.detections for r in res] == [r.detections for r in base_res]
    assert s["detections_total"] == base["detections_total"] > 0


class _ListSource:
    """A frozen clip whose Frame objects the caller keeps (PacedPlayer
    stamps each one's `t_source` as it emits it)."""

    def __init__(self, frames):
        self.frames = frames
        self.frame_shape = frames[0].pixels.shape[:2]

    def __iter__(self):
        return iter(self.frames)

    def __len__(self):
        return len(self.frames)


def test_realtime_slow_eager_sweep_scores_off_the_loop_thread(params, threshold):
    """An eager sweep (no graph: `replay` returns None) that takes 20 ms a
    frame under a 200 fps camera runs on workers, and the loop keeps
    ingesting while it does: frames are stamped inside the sweeps' calls,
    and the full queue's drops are counted, not lost."""
    tp = params_from_jax(params, "cpu")
    frames = SyntheticVideoSource(n_frames=12, seed=1).frames()
    eng = VisionEngine(tp, backend="fixed_cuda", batch_size=64, device="cpu")
    stub = _GraphStub(stride=8, threshold=threshold, capture=False, delay_s=0.02)
    res, s, infer, _ = _infer_run(PacedPlayer(_ListSource(frames), fps=200), eng, stub,
                                  config=StreamConfig(queue_size=1))
    loop_thread = threading.get_ident()
    run = stub.scores[1:]                              # after the constructor's warm-up
    assert stub.replays == [] and run and all(t != loop_thread for t, _, _ in run)
    assert s["mode"] == "realtime" and s["accounted"] and s["frames_in"] == 12
    assert s["drops_by_reason"].get("queue_full", 0) > 0
    assert s["infer_thread"] == {"loop": 0, "worker": len(run)}
    assert {sp.tags["thread"] for sp in infer.values()} == {"worker"}
    assert any(a < f.t_source < b for f in frames for _, a, b in run)
    assert len(res) == s["frames_served"] > 0


class _ThreadEngine:
    """Stub engine: constant scores, the thread of each wave recorded."""

    def __init__(self):
        self.threads = []

    def serve(self, tiles):
        self.threads.append(threading.get_ident())
        return [_FakeResult(scores=np.zeros(10, np.float32)) for _ in tiles]


class _ThreadServer:
    """Stub disaggregated server: a model (`params`, `backend`) and a
    `score_frame` that sweeps eagerly, the thread of each call recorded."""

    def __init__(self, params):
        self.params, self.backend, self.threads = params, "fixed_cuda", []

    def score_frame(self, frames, parent_span=None):
        self.threads.append(threading.get_ident())
        return FcnSweep(stride=8).score(self.params, frames, backend=self.backend,
                                        device="cpu")


@pytest.mark.parametrize("route", ["engine", "disagg"])
def test_engine_and_score_frame_routes_never_take_the_loop_thread(params, threshold, route):
    """The engine's waves (`Tiler` + `serve`) and a disaggregated server's
    `score_frame` run on workers, even with a sweep whose every frame has a
    graph: the pipeline asks no tiler to replay on those routes."""
    tp = params_from_jax(params, "cpu")
    clip = SyntheticVideoSource(n_frames=4, seed=2)
    if route == "engine":
        eng = _ThreadEngine()
        tiler = Tiler(stride=8, threshold=threshold)
    else:
        eng = _ThreadServer(tp)
        tiler = _GraphStub(stride=8, threshold=threshold)
        tiler.captured.update(tiler.extract(f)[0].tobytes() for f in clip.frames())
    res, s, infer, _ = _infer_run(clip, eng, tiler)
    loop_thread = threading.get_ident()
    assert len(eng.threads) == 4 and loop_thread not in eng.threads
    assert s["infer_thread"] == {"loop": 0, "worker": 4}
    assert [infer[i].tags["thread"] for i in range(4)] == ["worker"] * 4
    assert [infer[i].tags["route"] for i in range(4)] == [route] * 4
    assert s["accounted"] and [r.index for r in res] == list(range(4))
    if route == "disagg":
        assert tiler.replays == [] and tiler.scores == []


def test_replay_runs_nothing_without_a_captured_graph(params):
    """On CPU tensors a sweep has no frame graph: `replay` returns None and
    counts no `fcn_sweep_graph` event and opens no span; `score` still
    sweeps (eagerly)."""
    tp = params_from_jax(params, "cpu")
    sw = FcnSweep(stride=8)
    fb, _ = sw.extract(SyntheticVideoSource(n_frames=1, seed=4).frames()[0])
    events = {e: M.REGISTRY.counter("fcn_sweep_graph", event=e) for e in
              ("capture", "replay", "eager")}
    before = {e: c.value for e, c in events.items()}
    tr = T.enable(capacity=64)
    try:
        got = sw.replay(tp, fb, backend="fixed_cuda", device="cpu")
        n_spans = len(tr.recorder)
    finally:
        T.disable()
    assert got is None and n_spans == 0
    assert {e: c.value for e, c in events.items()} == before
    assert sw.score(tp, fb, backend="fixed_cuda", device="cpu").shape == (144, 10)
    assert events["eager"].value == before["eager"] + 1
