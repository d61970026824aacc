"""The port's frame sweep against the JAX reference, word for word.

On the 112x112 seed-7 frame, `repro_torch.streaming.fcn_sweep` (both trunk
routes, on the `fixed` and `fixed_cuda` backends with CPU tensors, so the
plain versions run) gives the same role-map words and window-score words
as the reference's composed sweep (`megakernel=False`, as the JAX tests
run it on the CPU), the port's host `Tiler`, the frozen golden vectors
(through the committed seeded-params fixture) and, for the trunk, the
reference's `conv_trunk`.  The one-launch window head's plain route equals
the reference's `_head_scores` on any role-map words.  The edge contract raises as the reference's
does.  Tolerance: exact int32 words.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import backends as JB  # noqa: E402
from repro.core import fixed_point as jfxp  # noqa: E402
from repro.core import smallnet as jsn  # noqa: E402
from repro.streaming import fcn_sweep as jfs  # noqa: E402
from repro.streaming.sources import SyntheticVideoSource as JSource  # noqa: E402
from repro_torch.core import backends as TB  # noqa: E402
from repro_torch.core import fixed_point as tfxp  # noqa: E402
from repro_torch.core import smallnet as tsn  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.kernels.quant_matmul import ops as D  # noqa: E402
from repro_torch.obs import metrics as M  # noqa: E402
from repro_torch.obs import recorder as R  # noqa: E402
from repro_torch.obs import trace as T  # noqa: E402
from repro_torch.streaming import fcn_sweep as tfs  # noqa: E402
from repro_torch.streaming import FcnSweep, SyntheticVideoSource, Tiler  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden"
FORMATS = ("q16_16", "q8_8")
ROUTES = (None, False)            # the frame_trunk route and the composed cascade


def numpy_params(seed=0):
    """Float params from numpy with every leaf nonzero."""
    rng = np.random.default_rng(seed)
    p = {"conv1": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "conv2": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "dense": {"w": rng.uniform(-0.6, 0.6, (49, 10)),
                   "b": rng.normal(0, 0.5, (10,))}}
    return {k: {n: a.astype(np.float32) for n, a in v.items()} for k, v in p.items()}


def fixture_params():
    g = json.loads((GOLDEN / "seeded_params.json").read_text())["params"]
    return {layer: {leaf: np.asarray(v["values"], np.float32).reshape(v["shape"])
                    for leaf, v in leaves.items()} for layer, leaves in g.items()}


@pytest.fixture(scope="module")
def frame112():
    return SyntheticVideoSource(n_frames=1, seed=7).frames()[0]


def _backends(fmt):
    cfg = tfxp.STANDARD_CONFIGS[fmt]
    return TB.FixedBackend(cfg=cfg), TB.FixedCudaBackend(cfg=cfg)


@pytest.fixture(scope="module")
def jax_reference():
    """The reference's composed sweep on the numpy params, per format:
    (role maps, stride-8 window scores)."""
    params = numpy_params()
    pixels = JSource(n_frames=1, seed=7).frames()[0].pixels
    out = {}
    for fmt in FORMATS:
        be = JB.FixedBackend(name=f"fixed_{fmt}", cfg=jfxp.STANDARD_CONFIGS[fmt])
        maps = jfs.sweep_feature_maps(params, pixels, backend=be, megakernel=False)
        sw = jfs.FcnSweep(stride=8, megakernel=False)
        fb, _ = sw.extract(pixels)
        out[fmt] = (maps, np.asarray(sw.score(params, fb, backend=be)))
    return out


@pytest.mark.parametrize("megakernel", ROUTES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_maps_and_scores_match_jax_sweep(jax_reference, frame112, fmt, megakernel):
    want_maps, want_scores = jax_reference[fmt]
    params = params_from_jax(numpy_params(), "cpu")
    for be in _backends(fmt):
        maps = tfs.sweep_feature_maps(params, frame112.pixels, backend=be,
                                      megakernel=megakernel, device="cpu")
        assert sorted(maps) == sorted(want_maps)
        for name, words in maps.items():
            assert words.dtype == np.int32 and words.shape == (28, 28)
            np.testing.assert_array_equal(words, want_maps[name], err_msg=name)
        sw = FcnSweep(stride=8, megakernel=megakernel, cfg=be.cfg)
        fb, pos = sw.extract(frame112)
        scores = sw.score(params, fb, backend=be, device="cpu")
        assert scores.dtype == np.int32 and scores.shape == (144, 10) == want_scores.shape
        np.testing.assert_array_equal(scores, want_scores)


def test_fixture_is_the_reference_seeded_params():
    with jax.threefry_partitionable(False):
        live = jsn.seeded_params()
    fixed = fixture_params()
    assert sorted(fixed) == sorted(live)
    for layer in live:
        assert sorted(fixed[layer]) == sorted(live[layer])
        for leaf, a in live[layer].items():
            a = np.asarray(a)
            assert fixed[layer][leaf].dtype == a.dtype == np.float32
            assert fixed[layer][leaf].tobytes() == a.tobytes(), (layer, leaf)


@pytest.mark.parametrize("megakernel", ROUTES)
def test_plain_sweep_matches_sweep_golden(frame112, megakernel):
    g = json.loads((GOLDEN / "sweep_golden.json").read_text())
    params = fixture_params()
    for backend in ("fixed", "fixed_cuda"):
        maps = tfs.sweep_feature_maps(params, frame112.pixels, backend=backend,
                                      megakernel=megakernel, device="cpu")
        for name, words in maps.items():
            np.testing.assert_array_equal(words, np.asarray(g["maps"][name]), err_msg=name)
        sw = FcnSweep(stride=g["stride"], megakernel=megakernel)
        fb, pos = sw.extract(frame112)
        assert [list(p) for p in pos] == g["positions"]
        np.testing.assert_array_equal(sw.score(params, fb, backend=backend, device="cpu"),
                                      np.asarray(g["scores"]))


@pytest.mark.parametrize("fmt", FORMATS)
def test_frame_trunk_route_matches_frame_trunk_golden(frame112, fmt):
    g = json.loads((GOLDEN / "frame_trunk_golden.json").read_text())["maps"][fmt]
    for be in _backends(fmt):
        maps = tfs.sweep_feature_maps(fixture_params(), frame112.pixels, backend=be,
                                      megakernel=True, device="cpu")
        for name, words in maps.items():
            np.testing.assert_array_equal(words, np.asarray(g[name]), err_msg=name)


@pytest.mark.parametrize("fmt", FORMATS)
def test_sweep_scores_equal_tiler_per_window(frame112, fmt):
    """The exactness contract: each window's sweep words are the host
    tiler's patch words, interior and border windows alike."""
    params = params_from_jax(numpy_params(seed=1), "cpu")
    fixed, cuda = _backends(fmt)
    rng = np.random.default_rng(5)
    small = rng.random((36, 44, 1)).astype(np.float32)
    for frame in (frame112, small):
        for stride in (4, 8, 12):
            tiler = Tiler(stride=stride, cfg=fixed.cfg)
            tiles, pos = tiler.extract(frame)
            want = tiler.score(params, tiles, backend=fixed, device="cpu")
            sw = FcnSweep(stride=stride, cfg=fixed.cfg)
            fb, pos_s = sw.extract(frame)
            assert pos_s == pos
            np.testing.assert_array_equal(sw.score(params, fb, backend=cuda, device="cpu"),
                                          want)


@pytest.mark.parametrize("shape", [(112, 112), (104, 132)])
def test_corner_map_last_columns_pinned(shape):
    """The reference needed an `optimization_barrier` because interpret
    mode corrupted the corner map's last W/4 % 8 columns; here those
    columns of the frame_trunk route must equal the composed cascade's and
    the reference's words."""
    H, W = shape
    k = (W // 4) % 8
    assert k
    rng = np.random.default_rng(H + W)
    frame = rng.random((H, W, 1)).astype(np.float32)
    params = numpy_params(seed=3)
    tp = params_from_jax(params, "cpu")
    composed = tfs.sweep_feature_maps(tp, frame, backend="fixed", megakernel=False,
                                      device="cpu")
    want = jfs.sweep_feature_maps(params, frame, backend="fixed", megakernel=False)
    np.testing.assert_array_equal(composed["corner"], want["corner"])
    for backend in ("fixed", "fixed_cuda"):
        mega = tfs.sweep_feature_maps(tp, frame, backend=backend, megakernel=True,
                                      device="cpu")
        np.testing.assert_array_equal(mega["corner"][:, -k:], want["corner"][:, -k:])
        for name in tfs.MAPS:
            np.testing.assert_array_equal(mega[name], composed[name], err_msg=name)


def test_edge_contract_fails_loudly(frame112):
    params = numpy_params()
    for kw in ({"stride": 6}, {"patch": 30}):
        with pytest.raises(ValueError, match="multiple of 4"):
            FcnSweep(**kw)
        with pytest.raises(ValueError, match="multiple of 4"):
            jfs.FcnSweep(**kw)
    for shape in ((30, 32), (32, 30), (20, 40)):
        with pytest.raises(ValueError) as got:
            FcnSweep().positions(shape)
        with pytest.raises(ValueError) as want:
            jfs.FcnSweep().positions(shape)
        assert str(got.value) == str(want.value)
    sat = TB.FixedBackend(cfg=tfxp.STANDARD_CONFIGS["q16_16_sat"])
    fb, _ = FcnSweep().extract(frame112)
    with pytest.raises(NotImplementedError, match="wraparound"):
        FcnSweep().score(params, fb, backend=sat, device="cpu")
    with pytest.raises(NotImplementedError, match="wraparound"):
        tfs.sweep_feature_maps(params, frame112.pixels, backend=sat, device="cpu")
    with pytest.raises(ValueError, match="one frame per call"):
        FcnSweep().score(params, np.concatenate([fb, fb]), backend="fixed", device="cpu")
    # input the trunk cannot tile has no one-launch route, as in the reference
    with pytest.raises(NotImplementedError, match="no frame_trunk"):
        tfs.sweep_feature_maps(params, np.zeros((30, 30), np.float32), backend="fixed",
                               megakernel=True, device="cpu")
    be = TB.get_backend("fixed")
    two = torch.zeros((2, 28, 28, 1))
    with pytest.raises(NotImplementedError, match="no frame_trunk"):
        tfs._trunk_quad(be, be.prepare_params(params, "cpu"), two, megakernel=True)
    with pytest.raises(NotImplementedError, match="no frame_trunk"):
        jfs._trunk_quad(JB.get_backend("fixed"), JB.get_backend("fixed").prepare_params(
            params), jnp.zeros((2, 28, 28, 1)), megakernel=True)


@pytest.mark.parametrize("fmt", FORMATS)
def test_conv_trunk_fast_path_equals_composed_and_reference(frame112, fmt):
    params = numpy_params(seed=2)
    tp = params_from_jax(params, "cpu")
    frame = torch.from_numpy(frame112.pixels[None])
    jbe = JB.FixedBackend(name=f"fixed_{fmt}", cfg=jfxp.STANDARD_CONFIGS[fmt])
    # two frames take the reference's composed stages, row by row
    want = np.asarray(jax.jit(lambda p, x: jsn.conv_trunk(p, x, backend=jbe))(
        params, jnp.asarray(np.concatenate([frame112.pixels[None]] * 2))))[0]
    for be in _backends(fmt):
        p = be.prepare_params(tp, "cpu")
        quad = be.frame_trunk(frame, p)
        assert quad is not None and len(quad) == 4
        fast = tsn.conv_trunk(tp, frame, backend=be)
        composed = tsn._conv_stages(be, p, frame)
        assert torch.equal(fast, composed) and torch.equal(fast, quad[0])
        np.testing.assert_array_equal(fast[0].numpy(), want)


def test_frame_trunk_hook_routes_only_tileable_single_frames():
    params = params_from_jax(numpy_params(), "cpu")
    for be in (TB.get_backend("fixed"), TB.get_backend("fixed_cuda")):
        p = be.prepare_params(params, "cpu")
        for shape in ((2, 28, 28, 1), (1, 30, 28, 1), (1, 28, 26, 1), (1, 0, 28, 1)):
            assert be.frame_trunk(torch.zeros(shape), p) is None
        sat = TB.FixedCudaBackend(cfg=tfxp.STANDARD_CONFIGS["q8_8_sat"])
        assert sat.frame_trunk(torch.zeros((1, 28, 28, 1)), sat.prepare_params(params, "cpu")) \
            is None
        reset_launches()
        assert be.frame_trunk(torch.zeros((1, 28, 28, 1)), p)[3].shape == (1, 7, 7)
        assert launches() == {}          # CPU tensors run the plain version


@pytest.mark.parametrize("fmt", ["q16_16", "q16_16_trunc", "q8_8"])
@pytest.mark.parametrize("shape", [(112, 112), (56, 84)])
def test_window_head_plain_route_matches_jax_head(fmt, shape):
    """The head alone, on random role-map words (the format's extremes
    included): the reference's `_head_scores` against the window head's
    plain version, its wrapper on CPU tensors and the port's
    `_head_scores` on both routes."""
    H, W = shape
    h, w = H // 4, W // 4
    cfg = tfxp.STANDARD_CONFIGS[fmt]
    rng = np.random.default_rng(H * W)
    words = rng.integers(cfg.min_int, cfg.max_int + 1, (4, h, w)).astype(np.int32)
    words.reshape(-1)[:4] = (cfg.max_int, cfg.min_int, cfg.max_int, cfg.min_int)
    params = numpy_params(seed=4)
    jbe = JB.FixedBackend(name=f"fixed_{fmt}", cfg=jfxp.STANDARD_CONFIGS[fmt])
    pos = tuple(jfs.FcnSweep(stride=8).positions((H, W)))
    assert pos == tuple(FcnSweep(stride=8).positions((H, W)))
    jquad = tuple(jnp.asarray(words[k][None]) for k in range(4))
    want = np.asarray(jfs._head_scores(jbe, jbe.prepare_params(params), jquad,
                                       jfs._window_gather(28, pos), len(pos)))
    tbe = TB.FixedCudaBackend(cfg=cfg)
    tp = tbe.prepare_params(params_from_jax(params, "cpu"), "cpu")
    maps = [torch.from_numpy(words[k]) for k in range(4)]
    gy, gx = tfs._window_origins(28, pos, (h, w), torch.device("cpu"))
    dw, db = tp["dense"]["w"], tp["dense"]["b"]
    for got in (D.fixed_window_head_plain(maps, gy, gx, dw, db, cfg=cfg),
                D.fixed_window_head(torch.from_numpy(words), gy, gx, dw, db, cfg=cfg),
                tfs._head_scores(tbe, tp, tuple(m[None] for m in maps), 28, pos),
                tfs._head_scores(tbe, tp, tuple(m[None] for m in maps), 28, pos,
                                 fused=False)):
        assert got.dtype == torch.int32 and got.shape == (len(pos), 10) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_sweep_head_route_follows_megakernel(frame112):
    """The one-launch head is taken on the default and the frame_trunk
    routes and never on the composed one; the words are the same."""
    calls = []

    @dataclasses.dataclass(frozen=True)
    class Recording(TB.FixedCudaBackend):
        name: str = "fixed_cuda_recording"

        def window_head(self, maps, gy, gx, p):
            calls.append(int(gy.shape[0]))
            return super().window_head(maps, gy, gx, p)

    params = params_from_jax(numpy_params(), "cpu")
    fb, pos = FcnSweep(stride=8).extract(frame112)
    want = FcnSweep(stride=8).score(params, fb, backend="fixed", device="cpu")
    for megakernel, n_calls in ((None, 1), (True, 1), (False, 0)):
        calls.clear()
        got = FcnSweep(stride=8, megakernel=megakernel).score(params, fb, backend=Recording(),
                                                              device="cpu")
        assert calls == [len(pos)] * n_calls
        np.testing.assert_array_equal(got, want)
    for name in ("fixed", "ref", "plan", "int8"):
        be = TB.get_backend(name)
        z = torch.zeros((7, 7), dtype=torch.int32)
        assert be.window_head([z] * 4, torch.zeros(1, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32),
                              be.prepare_params(params, "cpu")) is None
    for name in ("cuda", "cuda_plan"):       # the float head in one launch
        be = TB.get_backend(name)
        z = torch.zeros((7, 7), dtype=torch.float32)
        got = be.window_head([z] * 4, torch.zeros(1, dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32),
                             be.prepare_params(params, "cpu"))
        assert got.shape == (1, 10) and got.dtype == torch.float32
    with pytest.raises(ValueError, match="outside"):
        tfs._window_origins(28, ((0, 0), (88, 4)), (28, 28), torch.device("cpu"))
    z = torch.zeros((28, 28), dtype=torch.int32)
    w, b = torch.zeros((49, 10), dtype=torch.int32), torch.zeros(10, dtype=torch.int32)
    for y, x in ((22, 0), (0, 22), (-1, 0)):     # past the maps' last row, column, first row
        with pytest.raises(ValueError, match="outside"):
            D.fixed_window_head([z] * 4, torch.tensor([0, y], dtype=torch.int32),
                                torch.tensor([0, x], dtype=torch.int32), w, b)


@pytest.mark.parametrize("megakernel, phases", [
    (False, ["trunk", "masks", "trunk", "masks", "trunk", "masks", "trunk", "head",
             "device_wait"]),
    (None, ["trunk", "masks", "trunk", "head", "device_wait"])])
def test_traced_score_spans_split_the_call(frame112, megakernel, phases):
    """A traced sweep is one score span under the caller's, tagged with its
    launches, whose children follow one another and cover it; the words
    are the untraced call's."""
    params = params_from_jax(numpy_params(), "cpu")
    sw = FcnSweep(stride=8, megakernel=megakernel)
    fb, _ = sw.extract(frame112)
    want = sw.score(params, fb, backend="fixed", device="cpu")
    tr = T.enable(capacity=1024)
    try:
        frame = tr.start("frame", "frame-0")
        got = sw.score(params, fb, backend="fixed", device="cpu", parent_span=frame)
        tr.end(frame, "served")
        spans = tr.recorder.spans()
    finally:
        T.disable()
    np.testing.assert_array_equal(got, want)
    assert R.reconcile(spans, frames_served=1, frames_dropped=0) == []
    (score,) = [s for s in spans if s.name == "score"]
    assert score.parent_id == frame.span_id and score.trace_id == "frame-0"
    assert score.tags["launches"] == 0                 # plain versions on the CPU launch nothing
    kids = sorted((s for s in spans if s.parent_id == score.span_id), key=lambda s: s.t_start)
    assert [k.name for k in kids] == phases
    assert kids[0].t_start == score.t_start and kids[-1].t_end == score.t_end
    assert all(a.t_end == b.t_start for a, b in zip(kids, kids[1:]))


@pytest.mark.parametrize("megakernel, phases", [
    (False, ["trunk", "masks", "trunk", "masks", "trunk", "masks", "trunk", "head",
             "device_wait"]),
    (None, ["trunk", "masks", "trunk", "head", "device_wait"])])
def test_traced_float_sweep_masks_only_where_it_composes(frame112, megakernel, phases):
    """On `cuda_plan` the default route takes each stage through the stage
    hook, so its "masks" phase is the params' preparation alone; the
    composed route still makes each stage's masked weights."""
    params = params_from_jax(numpy_params(), "cpu")
    sw = FcnSweep(stride=8, megakernel=megakernel)
    fb, _ = sw.extract(frame112)
    want = sw.score(params, fb, backend="cuda_plan", device="cpu")
    tr = T.enable(capacity=1024)
    try:
        got = sw.score(params, fb, backend="cuda_plan", device="cpu")
        spans = tr.recorder.spans()
    finally:
        T.disable()
    np.testing.assert_array_equal(got, want)
    (score,) = [s for s in spans if s.name == "score"]
    kids = sorted((s for s in spans if s.parent_id == score.span_id), key=lambda s: s.t_start)
    assert [k.name for k in kids] == phases


def test_untraced_score_records_nothing(frame112):
    tr = T.enable(capacity=64)
    T.disable()
    sw = FcnSweep(stride=8, megakernel=False)
    fb, _ = sw.extract(frame112)
    sw.score(params_from_jax(numpy_params(), "cpu"), fb, backend="fixed", device="cpu")
    assert len(tr.recorder) == 0


_OWN = ["sweep_stage", "sweep_stage", "window_head"]


@pytest.mark.parametrize("backend,native,megakernel,route,graphed", [
    ("cuda_plan", True, None, _OWN, True),
    ("cuda", True, None, _OWN, True),
    ("fixed_cuda", True, None, ["frame_trunk", "window_head"], True),
    ("fixed_cuda", True, True, ["frame_trunk", "window_head"], True),
    ("fixed_cuda", False, None, ["new_params", "frame_trunk", "window_head"], False),
    ("fixed", True, None, ["frame_trunk", "composed"], False),
    ("cuda_plan", True, False, ["composed"] * 3, False),
    ("fixed_cuda", True, False, ["composed"] * 3, False),
    ("int8", False, None, ["new_params"] + ["composed"] * 3, False),
    ("plan", True, None, ["composed"] * 3, False),
])
def test_graph_rule_reads_the_route(frame112, backend, native, megakernel, route, graphed):
    """The frame graph's rule reads the route the eager sweep took: all
    one-launch hooks with the caller's own params engage it (on a CUDA
    device); the composed route, `int8`, `plan` and `fixed_cuda` with float
    params (quantized on every call) do not.  On CPU tensors every call is
    eager, and the `fcn_sweep_graph` counter and the span's `graph` tag
    say so."""
    be = TB.get_backend(backend)
    params = params_from_jax(numpy_params(), "cpu")
    if native:
        params = be.prepare_params(params, "cpu")
    sw = FcnSweep(stride=8, megakernel=megakernel)
    fb, pos = sw.extract(frame112)
    got = []
    with torch.inference_mode():
        tfs._sweep(be, params, torch.from_numpy(fb), 28, tuple(pos), megakernel, route=got)
    assert got == route and (got in tfs._GRAPH_ROUTES) == graphed
    # the CPU is never graphed: no key, and every call counts as eager
    assert tfs._graph_key(be, params, (112, 112), 28, tuple(pos), megakernel,
                          torch.device("cpu")) is not None
    counter = M.REGISTRY.counter("fcn_sweep_graph", event="eager")
    n0 = counter.value
    tr = T.enable(capacity=64)
    try:
        sw.score(params, fb, backend=be, device="cpu")
        spans = tr.recorder.spans()
    finally:
        T.disable()
    sw.score(params, fb, backend=be, device="cpu")
    assert counter.value == n0 + 2
    (score,) = [s for s in spans if s.name == "score"]
    assert score.tags["graph"] == "eager"


def test_graph_key_needs_tensors_on_the_sweeps_device(frame112):
    """A param leaf that is not a tensor on the sweep's device gives no key:
    `prepare_params` would make new tensors of it."""
    be = TB.get_backend("cuda_plan")
    pos = tuple(FcnSweep(stride=8).positions((112, 112)))
    cpu = torch.device("cpu")
    params = params_from_jax(numpy_params(), "cpu")
    key = tfs._graph_key(be, params, (112, 112), 28, pos, None, cpu)
    assert key == tfs._graph_key(be, params, (112, 112), 28, pos, None, cpu)
    assert tfs._graph_key(be, numpy_params(), (112, 112), 28, pos, None, cpu) is None
    assert tfs._graph_key(be, params, (112, 112), 28, pos, None,
                          torch.device("meta")) is None
    other = {k: {n: t.clone() for n, t in v.items()} for k, v in params.items()}
    assert tfs._graph_key(be, other, (112, 112), 28, pos, None, cpu) != key
    assert tfs._graph_key(TB.get_backend("cuda"), params, (112, 112), 28, pos, None,
                          cpu) != key
    # megakernel=True raises on the float backends where None takes the hooks
    assert tfs._graph_key(be, params, (112, 112), 28, pos, True, cpu) != key
    assert tfs._sweep_device(torch.zeros(1), None) == cpu
    assert tfs._sweep_device(np.zeros(1), "cpu") == cpu
