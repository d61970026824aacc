"""The port's disaggregated trunk/head server against the JAX reference.

Every test of the reference's `tests/test_disagg.py` is mirrored here on the
port (`repro_torch.serving.disagg`), on CPU tensors (`device="cpu"`: the
plain versions of the kernels), with the same numpy params given to both
packages (the committed `seeded_params.json` fixture):

  * `FeatureMapCache`: exact hit/miss/coalesced accounting, capacity and TTL
    evictions by reason, one trunk pass per thundering herd, leader-failure
    re-election, follower timeouts, the bytes gauge over tensor quads.
  * keying: every word axis of the reference's key, plus the port's device
    axis; `frame_digest` equal to the reference's.
  * `DisaggServer`: window scores word-exact against the port's monolithic
    `FcnSweep` and against the reference's `DisaggServer(backend="fixed")`
    (and, for one frame, its `fixed_pallas` in interpret mode), detection
    parity, the ledger, trunk failover, all-faulted, deadline and
    queue-depth sheds, the open-loop interface, the `StreamingPipeline`
    seam, and a soak with a mid-run fault and cache churn.

Also: `RepeatedClipSource` byte-identical to the reference's, and
`make_trunk_fn`/`make_head_fn` against the reference's quad and scores and
against the port's own monolithic sweep on every route.  Tolerance: exact
int32 words on the fixed backends; the float and int8 halves equal the
port's own monolithic call exactly (the same ops in the same order).
"""
import dataclasses
import json
import pathlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import disagg as jdis  # noqa: E402
from repro.streaming import fcn_sweep as jfs  # noqa: E402
from repro.streaming import sources as jsrc  # noqa: E402
from repro_torch.core import backends as TB  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.obs import trace as T  # noqa: E402
from repro_torch.serving.disagg import (DisaggServer, DisaggShedError,  # noqa: E402
                                        FeatureMapCache, FeatureMapKey,
                                        feature_key, frame_digest)
from repro_torch.streaming import fcn_sweep as tfs  # noqa: E402
from repro_torch.streaming import (FcnSweep, RepeatedClipSource,  # noqa: E402
                                   StreamingPipeline, SyntheticVideoSource)

GOLDEN = pathlib.Path(__file__).parent / "golden"
BACKENDS = ("fixed", "fixed_cuda")          # both run their plain versions on the CPU


def fixture_params():
    g = json.loads((GOLDEN / "seeded_params.json").read_text())["params"]
    return {layer: {leaf: np.asarray(v["values"], np.float32).reshape(v["shape"])
                    for leaf, v in leaves.items()} for layer, leaves in g.items()}


@pytest.fixture(scope="module")
def params():
    return fixture_params()


@pytest.fixture(scope="module")
def clip():
    return SyntheticVideoSource(n_frames=6, seed=7).frames()


def server(params, **kw):
    kw.setdefault("backend", "fixed")
    return DisaggServer(params, stride=8, device="cpu", **kw)


def _key(i: int) -> FeatureMapKey:
    return FeatureMapKey(digest=f"k{i}", backend="fixed", cfg="q16.16",
                         megakernel=None, device="cpu")


def _quad(i: int):
    return tuple(torch.full((2, 2), i + j, dtype=torch.int32) for j in range(4))


# ---------------------------------------------------------------------------
# FeatureMapCache
# ---------------------------------------------------------------------------

class TestFeatureMapCache:
    def test_lru_capacity_eviction(self):
        c = FeatureMapCache(capacity=2)
        c.put(_key(0), _quad(0))
        c.put(_key(1), _quad(1))
        assert c.get(_key(0)) is not None       # 0 now most-recent
        c.put(_key(2), _quad(2))                # evicts 1 (LRU), not 0
        assert c.get(_key(1)) is None
        assert c.get(_key(0)) is not None
        assert len(c) == 2
        assert c.stats()["evictions"]["capacity"] == 1

    def test_ttl_expiry_is_lazy_and_counted(self):
        c = FeatureMapCache(capacity=4, ttl_s=0.02)
        c.put(_key(0), _quad(0))
        assert c.get(_key(0)) is not None
        time.sleep(0.03)
        assert c.get(_key(0)) is None
        s = c.stats()
        assert s["evictions"]["ttl"] == 1
        assert s["entries"] == 0

    def test_each_call_counts_exactly_one_outcome(self):
        c = FeatureMapCache(capacity=4)
        calls = []
        for _ in range(5):
            c.get_or_compute(_key(0), lambda: calls.append(1) or _quad(0))
        s = c.stats()
        assert len(calls) == 1
        assert s["misses"] == 1 and s["hits"] == 4 and s["coalesced"] == 0
        assert s["hit_rate"] == pytest.approx(0.8)

    def test_single_flight_one_trunk_pass_per_herd(self):
        c = FeatureMapCache(capacity=4)
        computes, gate = [], threading.Event()

        def compute():
            gate.wait(timeout=5.0)
            computes.append(1)
            return _quad(0)

        results = []
        threads = [threading.Thread(
            target=lambda: results.append(c.get_or_compute(_key(0), compute)))
            for _ in range(8)]
        for t in threads:
            t.start()
        time.sleep(0.05)          # let every follower park on the leader
        gate.set()
        for t in threads:
            t.join(timeout=10.0)
        s = c.stats()
        assert len(computes) == 1
        assert len(results) == 8
        assert s["misses"] == 1
        assert s["hits"] + s["coalesced"] == 7

    def test_leader_failure_wakes_followers_to_reelect(self):
        c = FeatureMapCache(capacity=4)
        attempts = []

        def flaky():
            attempts.append(1)
            if len(attempts) == 1:
                raise RuntimeError("leader died")
            return _quad(0)

        errors, values = [], []

        def call():
            try:
                values.append(c.get_or_compute(_key(0), flaky))
            except RuntimeError as e:
                errors.append(e)

        threads = [threading.Thread(target=call) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
        # exactly one caller saw the crash; the rest re-elected and served
        assert len(errors) == 1
        assert len(values) == 3
        assert len(attempts) == 2

    def test_follower_timeout_raises(self):
        c = FeatureMapCache(capacity=4)
        started = threading.Event()

        def slow():
            started.set()
            time.sleep(0.5)
            return _quad(0)

        leader = threading.Thread(
            target=lambda: c.get_or_compute(_key(0), slow))
        leader.start()
        assert started.wait(timeout=5.0)
        with pytest.raises(TimeoutError):
            c.get_or_compute(_key(0), slow, timeout=0.02)
        leader.join(timeout=10.0)

    def test_bytes_gauge_tracks_resident_quads(self):
        c = FeatureMapCache(capacity=2)
        c.put(_key(0), _quad(0))
        per_entry = c.stats()["resident_bytes"]
        assert per_entry == sum(m.element_size() * m.numel() for m in _quad(0)) == 64
        # numpy quads count the same bytes as the reference counts them
        assert FeatureMapCache._nbytes(tuple(m.numpy() for m in _quad(0))) == \
            jdis.FeatureMapCache._nbytes(tuple(m.numpy() for m in _quad(0))) == per_entry
        c.put(_key(1), _quad(1))
        c.put(_key(2), _quad(2))      # capacity eviction keeps bytes flat
        s = c.stats()
        assert s["resident_bytes"] == 2 * per_entry
        assert s["resident_bytes_hwm"] <= 2 * per_entry


# ---------------------------------------------------------------------------
# Cache keying
# ---------------------------------------------------------------------------

def test_feature_key_separates_every_word_axis(clip):
    px = clip[0].pixels[None]
    fixed, ref = TB.get_backend("fixed"), TB.get_backend("ref")
    k = feature_key(px, fixed, None, "cpu")
    assert k != feature_key(px, ref, None, "cpu")                   # backend axis
    assert k != feature_key(px, fixed, True, "cpu")                 # megakernel route
    assert k != feature_key(px, fixed, None, "cuda")                # device axis
    assert k != feature_key(clip[1].pixels[None], fixed, None, "cpu")   # pixels
    assert k != feature_key(px, TB.FixedBackend(cfg=TB.fxp.Q8_8), None, "cpu")  # cfg axis
    assert k == feature_key(np.array(px), fixed, None, "cpu")       # content, not id
    # the same axes as the reference's key, the interpret switch replaced
    jk = jdis.feature_key(px, jdis.B.get_backend("fixed"), None)
    assert (k.digest, k.backend, k.cfg, k.megakernel) == \
        (jk.digest, jk.backend, jk.cfg, jk.megakernel)


def test_frame_digest_covers_shape_and_dtype():
    a = np.zeros((1, 8, 8, 1), np.float32)
    assert frame_digest(a) == frame_digest(a.copy())
    assert frame_digest(a) != frame_digest(a.reshape(1, 4, 16, 1))
    assert frame_digest(a) != frame_digest(a.astype(np.float64))
    b = np.random.default_rng(0).random((1, 24, 16, 1), dtype=np.float32)
    for x in (a, b, b.astype(np.float64)):
        assert frame_digest(x) == jdis.frame_digest(x)


# ---------------------------------------------------------------------------
# DisaggServer: word-exactness + ledger
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_scores_word_exact_vs_monolithic_sweep(params, clip, backend):
    sweep = FcnSweep(stride=8)
    tp = params_from_jax(params, "cpu")
    srv = server(params, backend=backend, cache_capacity=8)
    ref = jdis.DisaggServer(params, backend="fixed", stride=8, cache_capacity=8)
    reset_launches()
    for f in clip[:3]:
        mono = sweep.score(tp, f.pixels[None], backend=backend, device="cpu")
        dis = srv.score_frame(f.pixels[None])
        assert dis.dtype == mono.dtype == np.int32
        assert np.array_equal(dis, mono)
        assert np.array_equal(dis, np.asarray(ref.score_frame(f.pixels[None])))
        assert sweep.aggregate(mono, list(srv.positions)) == srv.detect(f, tiler=sweep)
    assert launches() == {}                     # CPU tensors: plain versions only
    assert srv.positions == ref.positions


def test_scores_equal_the_reference_pallas_server_in_interpret_mode(params, clip):
    """The reference's kernel substrate, in interpret mode, for one frame."""
    px = clip[0].pixels[None]
    ref = jdis.DisaggServer(params, backend="fixed_pallas", stride=8, warmup=False)
    want = np.asarray(ref.score_frame(px))
    assert np.array_equal(server(params, backend="fixed_cuda").score_frame(px), want)


def test_disagg_server_defaults_to_the_card(params):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        DisaggServer(params)


def test_repeat_queries_hit_the_cache_and_ledger_reconciles(params, clip):
    srv = server(params, cache_capacity=8)
    first = srv.score_frame(clip[0].pixels[None])
    again = srv.score_frame(clip[0].pixels[None])
    assert np.array_equal(first, again)
    s = srv.stats()
    assert s["accounted"] and s["n"] == 2 and s["shed"] == 0
    assert s["cache"]["hits"] == 1 and s["cache"]["misses"] == 1
    # the hit ran NO trunk pass: only one stage request reached the pool
    trunk_served = sum(s["per_stage"][e.name]["n"] for e in srv.trunks)
    assert trunk_served == 1


def test_trunk_failover_to_healthy_sibling(params, clip):
    srv = server(params, n_trunk=2)
    boom = RuntimeError("injected trunk fault")
    srv.trunks[0]._compute = lambda payload: (_ for _ in ()).throw(boom)
    for f in clip[:4]:
        scores = srv.score_frame(f.pixels[None])
        assert scores.shape[0] == len(srv.positions)
    s = srv.stats()
    assert s["accounted"] and s["n"] == 4 and s["shed"] == 0
    faults = sum(st["shed_by_reason"].get("fault", 0)
                 for st in s["per_stage"].values())
    assert faults >= 1, "the faulty trunk was never exercised"


def test_all_trunks_faulted_sheds_with_reason(params, clip):
    srv = server(params, n_trunk=2)
    for eng in srv.trunks:
        eng._compute = lambda payload: (_ for _ in ()).throw(
            RuntimeError("boom"))
    with pytest.raises(DisaggShedError) as ei:
        srv.score_frame(clip[0].pixels[None])
    assert ei.value.reason == "fault"
    s = srv.stats()
    assert s["accounted"] and s["shed_by_reason"] == {"fault": 1}


def test_deadline_shed_under_trunk_backpressure(params, clip):
    srv = server(params, n_trunk=1, trunk_floor_s=0.2)
    with pytest.raises(DisaggShedError) as ei:
        srv.score_frame(clip[0].pixels[None], deadline_ms=1.0)
    assert ei.value.reason == "deadline"
    assert srv.stats()["shed_by_reason"] == {"deadline": 1}


def test_open_loop_intake_bound_sheds_queue_depth(params, clip):
    srv = server(params, max_queue=2)
    uids = [srv.submit(clip[i % len(clip)].pixels) for i in range(5)]
    shed = srv.pop_shed(uids)
    assert list(shed.values()) == ["queue_depth"] * 3
    srv.start()
    try:
        srv.wait([u for u in uids if u not in shed], timeout=30.0)
    finally:
        srv.stop(drain=True)
    s = srv.stats()
    assert s["accounted"] and s["n"] == 2


def test_open_loop_matches_sync_scores(params, clip):
    srv = server(params)
    srv.start()
    try:
        uids = [srv.submit(f.pixels) for f in clip[:3]]
        srv.wait(uids, timeout=30.0)
        res = srv.pop_results(uids)
    finally:
        srv.stop(drain=True)
    ref = server(params)
    for uid, f in zip(uids, clip[:3]):
        assert np.array_equal(res[uid].scores, ref.score_frame(f.pixels[None]))


def test_streaming_pipeline_drives_the_disagg_server(params):
    base = SyntheticVideoSource(n_frames=4, seed=7)
    source = RepeatedClipSource(base, repeats=3)
    sweep = FcnSweep(stride=8, threshold=0.5)
    srv = server(params, cache_capacity=8)
    tr = T.enable(capacity=1 << 12)
    try:
        pipe = StreamingPipeline(source, srv, sweep)
        results = pipe.run()
        spans = tr.recorder.spans()
    finally:
        T.disable()
    ps, ss = pipe.stats(), srv.stats()
    assert len(results) == len(source)
    assert ps["accounted"] and ps["frames_served"] == len(source)
    assert ss["accounted"] and ss["n"] == len(source)
    assert ss["cache"]["hit_rate"] == pytest.approx(2 / 3)
    # the infer span names the route
    assert {s.tags.get("route") for s in spans if s.name == "infer"} == {"disagg"}
    # repeated frames must produce identical detections, the reference's
    by_px = {}
    for f, r in zip(source, results):
        key = frame_digest(f.pixels)
        by_px.setdefault(key, r.detections)
        assert by_px[key] == r.detections
    jsweep = jfs.FcnSweep(stride=8, threshold=0.5, megakernel=False)
    for f in base.frames():
        want = [(d.label, d.y, d.x, d.size, d.score)
                for d in jsweep.detect(params, f.pixels, backend="fixed")]
        got = [(d.label, d.y, d.x, d.size, d.score) for d in by_px[frame_digest(f.pixels)]]
        assert got == want


def test_pipeline_drops_a_shed_query_as_a_frame(params):
    """A query the server sheds is a dropped frame, counted, not an error."""
    source = SyntheticVideoSource(n_frames=3, seed=7)
    srv = server(params, n_trunk=1)
    srv.trunks[0]._compute = lambda payload: (_ for _ in ()).throw(RuntimeError("boom"))
    pipe = StreamingPipeline(source, srv, FcnSweep(stride=8))
    assert pipe.run() == []
    s = pipe.stats()
    assert s["accounted"] and s["frames_dropped"] == 3
    assert s["drops_by_stage"] == {"infer/shed": 3}


# ---------------------------------------------------------------------------
# The soak: streams + failover + cache churn, every ledger tight
# ---------------------------------------------------------------------------

def test_disagg_soak_streams_failover_and_cache_churn(params):
    n_streams, per_stream = 4, 60
    pool = [f.pixels[None]
            for f in SyntheticVideoSource(n_frames=12, seed=7).frames()]
    capacity = 6            # BELOW the distinct pool: constant churn
    tr = T.enable(capacity=1 << 16)
    try:
        srv = server(params, n_trunk=2, n_head=2, cache_capacity=capacity)
        per_entry = srv.cache._nbytes(srv._run_trunk(pool[0]))
        for eng in srv.trunks + srv.heads:
            eng.start()
        client_shed = [0] * n_streams

        def stream(sid: int):
            rng = np.random.default_rng(sid)
            for i in range(per_stream):
                px = pool[int(rng.integers(0, len(pool)))]
                try:
                    srv.score_frame(px)
                except DisaggShedError:
                    client_shed[sid] += 1
                if sid == 0 and i == per_stream // 3:
                    # mid-run fault: one trunk replica dies; the fleet
                    # fails over and keeps serving
                    srv.trunks[0]._compute = lambda p: (_ for _ in ()).throw(
                        RuntimeError("injected soak fault"))

        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(n_streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
        assert not any(t.is_alive() for t in threads)
        srv.stop(drain=True)

        s = srv.stats()
        # the fleet ledger reconciles exactly, client-side view included
        assert s["accounted"]
        assert s["submitted"] == n_streams * per_stream
        assert s["n"] + s["shed"] == s["submitted"] and s["pending"] == 0
        assert s["shed"] == sum(client_shed)
        assert s["n"] >= 0.9 * s["submitted"], s["shed_by_reason"]
        for name, st in s["per_stage"].items():
            assert st["accounted"], (name, st)
        # cache memory bounded by construction, with real churn observed
        cs = s["cache"]
        assert cs["entries"] <= capacity
        assert cs["resident_bytes_hwm"] <= capacity * per_entry
        assert cs["evictions"]["capacity"] > 0
        assert cs["hits"] > 0
        # the flight recorder held the whole run
        assert tr.recorder.evicted == 0
    finally:
        T.disable()


# ---------------------------------------------------------------------------
# RepeatedClipSource and the sweep's two halves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{"n_frames": 3, "seed": 7, "repeats": 4},
                                {"n_frames": 2, "seed": 3, "repeats": 1,
                                 "frame_shape": (56, 84)}])
def test_repeated_clip_is_the_reference_clip(kw):
    kw = dict(kw)
    repeats = kw.pop("repeats")
    got = RepeatedClipSource(SyntheticVideoSource(**kw), repeats=repeats)
    want = jsrc.RepeatedClipSource(jsrc.SyntheticVideoSource(**kw), repeats=repeats)
    assert len(got) == len(want) == kw["n_frames"] * repeats
    assert got.frame_shape == want.frame_shape
    g, w = got.frames(), want.frames()
    for a, b in zip(g, w):
        assert a.index == b.index and a.t_source == b.t_source
        assert a.pixels.dtype == b.pixels.dtype and a.pixels.tobytes() == b.pixels.tobytes()
        assert [dataclasses.astuple(t) for t in a.truth] == \
            [dataclasses.astuple(t) for t in b.truth]
    # the repeats share their base frame's pixel array
    assert all(g[i].pixels is g[i - i % repeats].pixels for i in range(len(g)))
    with pytest.raises(ValueError, match="repeats"):
        RepeatedClipSource(SyntheticVideoSource(**kw), repeats=0)


def test_trunk_and_head_halves_equal_the_reference(params, clip):
    px = clip[1].pixels[None]
    tp = params_from_jax(params, "cpu")
    positions = tuple(FcnSweep(stride=8).positions((112, 112)))
    quad = tfs.make_trunk_fn("fixed", None)(tp, torch.from_numpy(px))
    jquad = jfs.make_trunk_fn("fixed", False)(params, px)
    for got, want in zip(quad, jquad):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))
    scores = tfs.make_head_fn("fixed", 28, positions)(tp, quad)
    want = jfs.make_head_fn("fixed", 28, positions)(params, jquad)
    assert np.array_equal(scores.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["fixed", "fixed_cuda", "plan", "cuda_plan", "int8"])
@pytest.mark.parametrize("megakernel", [None, True, False])
def test_trunk_and_head_halves_equal_the_monolithic_sweep(params, clip, backend, megakernel):
    be = TB.get_backend(backend)
    x = torch.from_numpy(clip[2].pixels[None])
    sweep = FcnSweep(stride=8, megakernel=megakernel)
    positions = tuple(sweep.positions((112, 112)))
    trunk = tfs.make_trunk_fn(be, megakernel)
    head = tfs.make_head_fn(be, 28, positions, megakernel)
    assert tfs.make_trunk_fn(be, megakernel) is trunk        # cached per argument tuple
    if megakernel and be.name not in ("fixed", "fixed_cuda"):
        with pytest.raises(NotImplementedError, match="frame_trunk"):
            trunk(params, x)
        return
    quad = trunk(params, x)
    assert all(t.is_inference() for t in quad)
    got = head(params, quad).numpy()
    want = sweep.score(params, x, backend=be, device="cpu")
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_the_halves_run_in_inference_mode_on_any_thread(params, clip):
    """Inference mode is thread-local: a replica's thread gets it from the
    halves themselves."""
    x = torch.from_numpy(clip[0].pixels[None])
    out = []
    t = threading.Thread(target=lambda: out.append(
        tfs.make_trunk_fn("fixed", None)(params, x)))
    t.start()
    t.join(timeout=30)
    assert out and all(m.is_inference() for m in out[0])


def test_saturating_configs_are_refused_by_both_halves():
    be = TB.FixedBackend(cfg=TB.fxp.STANDARD_CONFIGS["q16_16_sat"])
    with pytest.raises(NotImplementedError, match="wraparound"):
        tfs.make_trunk_fn(be, None)
    with pytest.raises(NotImplementedError, match="wraparound"):
        tfs.make_head_fn(be, 28, ((0, 0),))
