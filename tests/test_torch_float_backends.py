"""The port's float and int8 smallNet backends against the JAX reference.

The same numpy params and images go through `repro.core.smallnet` and
through `repro_torch.core.smallnet` on the CPU, where the `cuda`,
`cuda_plan` and `int8` backends' kernel wrappers run their plain versions:

    port        reference
    ref         ref
    plan        plan
    cuda        pallas        (Pallas in interpret mode, as the JAX tests run it)
    cuda_plan   pallas_plan
    int8        int8

Scores are held within 1e-5 (rtol and atol: the float convs and the dense
product sum in other orders than XLA's); the int8 weight and activation
words must be equal.  Then `VisionEngine` on `cuda_plan` and `int8`
against the reference's `smallnet.apply`, and `FcnSweep` on `plan` and
`int8` against the port's own tiler and the reference's sweep, within
2e-5 (the sweep reassociates the float conv sums of the edge maps).  The
one-launch sweep stage's plain version (`float_sweep_stage_plain`) equals
the composed `_sweep_stage` on `plan` and `ref` float for float, and the
`cuda_plan` sweep on CPU tensors gives `plan`'s scores on both routes.
The one-launch float head's plain version (`float_window_head_plain`)
equals the composed head exactly, and the reference's sweep within 2e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fixed_point as jfxp  # noqa: E402
from repro.core import ptq as jptq  # noqa: E402
from repro.core import smallnet as jsn  # noqa: E402
from repro.data import synth_mnist as j_synth  # noqa: E402
from repro.streaming import fcn_sweep as jfs  # noqa: E402
from repro_torch.core import backends as TB  # noqa: E402
from repro_torch.core import fixed_point as tfxp  # noqa: E402
from repro_torch.core import ptq  # noqa: E402
from repro_torch.core import smallnet as tsn  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.kernels.conv2d import float_sweep_stage, float_sweep_stage_plain  # noqa: E402
from repro_torch.kernels.conv2d import float_window_head, float_window_head_plain  # noqa: E402
from repro_torch.serving.vision_engine import VisionEngine  # noqa: E402
from repro_torch.streaming import FcnSweep, SyntheticVideoSource, Tiler  # noqa: E402
from repro_torch.streaming import fcn_sweep as tfs  # noqa: E402

PAIRS = {"ref": "ref", "plan": "plan", "cuda": "pallas", "cuda_plan": "pallas_plan",
         "int8": "int8"}
TOL = dict(rtol=1e-5, atol=1e-5)
SWEEP_TOL = dict(rtol=2e-5, atol=2e-5)


def numpy_params(seed=0):
    """Float params from numpy with every leaf nonzero."""
    rng = np.random.default_rng(seed)
    p = {"conv1": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "conv2": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "dense": {"w": rng.uniform(-0.6, 0.6, (49, 10)),
                   "b": rng.normal(0, 0.5, (10,))}}
    return {k: {n: a.astype(np.float32) for n, a in v.items()} for k, v in p.items()}


@pytest.fixture(scope="module")
def data():
    images, labels = j_synth.make_dataset(6, seed=3)
    return numpy_params(), images, labels


def _jax_apply(params, images, backend):
    return np.asarray(jax.jit(lambda p, x: jsn.apply(p, x, backend=backend))(
        params, jnp.asarray(images)))


@pytest.mark.parametrize("port,ref", sorted(PAIRS.items()))
def test_apply_matches_jax(data, port, ref):
    params, images, _ = data
    want = _jax_apply(params, images, ref)
    got = tsn.apply(params_from_jax(params, "cpu"), torch.from_numpy(images), backend=port)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (6, 10)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cuda_backends_match_their_plain_counterparts(data):
    params, images, _ = data
    tp = params_from_jax(params, "cpu")
    x = torch.from_numpy(images)
    for kernel, plain in (("cuda", "ref"), ("cuda_plan", "plan")):
        np.testing.assert_allclose(tsn.apply(tp, x, backend=kernel).numpy(),
                                   tsn.apply(tp, x, backend=plain).numpy(), **TOL)


def test_int8_prequantized_params_and_activation_words_match_jax(data):
    params, images, _ = data
    jq = jsn.quantize_params_int8(params)
    tq = params_from_jax(jq, "cpu")
    # the weight words: carried across, and made by the port from float
    own = tsn.quantize_params_int8(params, device="cpu")
    for layer in ("conv1", "conv2", "dense"):
        assert torch.equal(tq[layer]["w"].q, own[layer]["w"].q)
        assert torch.equal(tq[layer]["w"].scale, own[layer]["w"].scale)
    want = _jax_apply(jq, images, "int8")
    np.testing.assert_allclose(tsn.apply(tq, images, backend="int8", device="cpu").numpy(),
                               want, **TOL)
    np.testing.assert_allclose(tsn.forward_int8(tq, images, device="cpu").numpy(),
                               np.asarray(jsn.forward_int8(jq, jnp.asarray(images))), **TOL)
    # the activation words the dense MAC takes: the pooled features, quantized
    # per tensor
    feats = tsn.conv_trunk(tq, images, backend="int8", device="cpu").reshape(len(images), -1)
    jfeats = np.asarray(jsn.conv_trunk(jq, jnp.asarray(images), backend="int8")
                        ).reshape(len(images), -1)
    np.testing.assert_allclose(feats.numpy(), jfeats, **TOL)
    xq = ptq.quantize(feats, ptq.QuantConfig(per_channel=False))
    jxq = jptq.quantize(jnp.asarray(jfeats), jptq.QuantConfig(per_channel=False))
    np.testing.assert_array_equal(xq.q.numpy(), np.asarray(jxq.q))


def test_forward_wrappers_and_accuracy_match_jax(data):
    params, images, labels = data
    tp = params_from_jax(params, "cpu")
    x = jnp.asarray(images)
    np.testing.assert_allclose(tsn.forward(tp, images, device="cpu").numpy(),
                               np.asarray(jsn.forward(params, x)), **TOL)
    np.testing.assert_allclose(
        tsn.forward(tp, images, sigmoid=tfxp.sigmoid_plan_f32, device="cpu").numpy(),
        np.asarray(jsn.forward(params, x, sigmoid=jfxp.sigmoid_plan_f32)), **TOL)
    np.testing.assert_allclose(tsn.forward_plan(tp, images, device="cpu").numpy(),
                               np.asarray(jsn.forward_plan(params, x)), **TOL)
    custom = tsn.forward(tp, images, sigmoid=torch.tanh, device="cpu")
    np.testing.assert_allclose(custom.numpy(),
                               np.asarray(jsn.forward(params, x, sigmoid=jnp.tanh)), **TOL)
    for port, ref in (("ref", "ref"), ("int8", "int8")):
        got = tsn.accuracy(lambda p, xs: tsn.apply(p, xs, backend=port, device="cpu"),
                           tp, images, labels, batch=4)
        want = jsn.accuracy(lambda p, xs: jsn.apply(p, xs, backend=ref), params,
                            x, jnp.asarray(labels), batch=4)
        assert got == want


@pytest.mark.parametrize("backend", ["cuda_plan", "int8"])
def test_vision_engine_matches_jax_apply(data, backend):
    params, _, _ = data
    images, _ = j_synth.make_dataset(8, seed=5)
    eng = VisionEngine(params_from_jax(params, "cpu"), backend=backend, batch_size=8,
                       device="cpu")
    uids = eng.submit_many(list(images))
    assert eng.run() == len(images)
    res = eng.pop_results(uids)
    scores = np.stack([res[u].scores for u in uids])
    want = _jax_apply(params, images, PAIRS[backend])     # one full batch, no padding
    assert scores.dtype == np.float32
    np.testing.assert_allclose(scores, want, **TOL)
    np.testing.assert_array_equal([res[u].pred for u in uids],
                                  np.asarray(jsn.predict(jnp.asarray(want))))
    assert eng.stats()["accounted"]


@pytest.fixture(scope="module")
def frame112():
    return SyntheticVideoSource(n_frames=1, seed=7).frames()[0]


def test_float_sweep_head_gathers_nhwc_maps_like_the_tiler(data, frame112):
    """The sweep's head squeezes each (1,h,w,1) float map before it gathers
    a window's features, so it scores the windows the tiler scores."""
    params, _, _ = data
    tp = params_from_jax(params, "cpu")
    sw, tiler = FcnSweep(stride=8), Tiler(stride=8)
    fb, pos = sw.extract(frame112)
    tiles, tpos = tiler.extract(frame112)
    assert pos == tpos
    got = sw.score(tp, fb, backend="ref", device="cpu")
    np.testing.assert_allclose(got, tiler.score(tp, tiles, backend="ref", device="cpu"),
                               **SWEEP_TOL)
    maps = tfs.sweep_feature_maps(tp, frame112.pixels, backend="ref", device="cpu")
    assert all(m.shape == (28, 28) and m.dtype == np.float32 for m in maps.values())


@pytest.mark.parametrize("backend", ["plan", "int8"])
def test_sweep_matches_tiler_and_jax_sweep(data, frame112, backend):
    params, _, _ = data
    tp = params_from_jax(params, "cpu")
    sw, tiler = FcnSweep(stride=8), Tiler(stride=8)
    fb, _ = sw.extract(frame112)
    tiles, _ = tiler.extract(frame112)
    got = sw.score(tp, fb, backend=backend, device="cpu")
    assert got.dtype == np.float32 and got.shape == (144, 10)
    np.testing.assert_allclose(got, tiler.score(tp, tiles, backend=backend, device="cpu"),
                               **SWEEP_TOL)
    jscores = jfs.FcnSweep(stride=8).score(params, fb, backend=backend)
    np.testing.assert_allclose(got, jscores, **SWEEP_TOL)
    maps = tfs.sweep_feature_maps(tp, frame112.pixels, backend=backend, device="cpu")
    jmaps = jfs.sweep_feature_maps(params, frame112.pixels, backend=backend)
    for name in tfs.MAPS:
        np.testing.assert_allclose(maps[name], jmaps[name], **SWEEP_TOL)
    # float confidences pass through the tiler's aggregate: same detections
    thr = float(np.quantile(got.max(-1), 0.8))
    pos = sw.positions((112, 112))
    dets = FcnSweep(stride=8, threshold=thr).aggregate(got, pos, fb)
    jdets = jfs.FcnSweep(stride=8, threshold=thr).aggregate(jscores, pos, fb)
    assert dets and [(d.label, d.y, d.x) for d in dets] == \
        [(d.label, d.y, d.x) for d in jdets]


def test_float_backends_have_no_frame_trunk(data, frame112):
    params, _, _ = data
    tp = params_from_jax(params, "cpu")
    fb, _ = FcnSweep().extract(frame112)
    for name in ("ref", "plan", "cuda", "cuda_plan", "int8"):
        assert TB.get_backend(name).frame_trunk(torch.from_numpy(fb), tp) is None
        with pytest.raises(NotImplementedError, match="no frame_trunk"):
            FcnSweep(megakernel=True).score(tp, fb, backend=name, device="cpu")


def _stage_frame(shape, frame112):
    """A (1,H,W,1) float frame: the seed-7 112x112 frame, or seeded pixels."""
    if shape == (112, 112):
        return torch.from_numpy(np.ascontiguousarray(frame112.pixels[None], np.float32))
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    return torch.from_numpy(rng.uniform(0, 1, (1, *shape, 1)).astype(np.float32))


@pytest.mark.parametrize("shape", [(112, 112), (28, 28), (60, 44)])
@pytest.mark.parametrize("backend,activation", [("plan", "plan"), ("ref", "sigmoid")])
def test_float_sweep_stage_plain_equals_composed_stage(data, frame112, shape, backend,
                                                       activation):
    """Both levels: the one-launch stage's plain version gives the composed
    stage's floats exactly (the same plain ops in the same order on the
    CPU), the level-0 collapse included; the wrapper takes it on CPU
    tensors."""
    tp = params_from_jax(data[0], "cpu")
    be = TB.get_backend(backend)
    x = _stage_frame(shape, frame112)
    quad = (x, x, x, x)
    for layer in ("conv1", "conv2"):
        w, b = tp[layer]["w"], tp[layer]["b"]
        want = tfs._sweep_stage(be, quad, w, b)
        got = float_sweep_stage_plain(quad, w, b, activation=activation)
        assert got.shape == (4, want[0].shape[1], want[0].shape[2])
        for k in range(4):
            assert torch.equal(got[k], want[k][0, ..., 0]), (layer, tfs.MAPS[k])
        assert torch.equal(float_sweep_stage(quad, w, b, activation=activation), got)
        quad = want                  # level 1 reads the composed level-0 quad


@pytest.mark.parametrize("megakernel", [None, False])
def test_cuda_plan_sweep_on_cpu_tensors_gives_plan_scores(data, frame112, megakernel):
    """`cuda_plan` with CPU tensors: the default route (one stage hook a
    stage, the kernel's plain version) and the composed cascade both give
    the `plan` sweep's scores.  The match is exact, not only within
    SWEEP_TOL: on the CPU every wrapper runs the plain ops `plan` runs."""
    tp = params_from_jax(data[0], "cpu")
    fb, _ = FcnSweep(stride=8).extract(frame112)
    want = FcnSweep(stride=8).score(tp, fb, backend="plan", device="cpu")
    reset_launches()
    got = FcnSweep(stride=8, megakernel=megakernel).score(tp, fb, backend="cuda_plan",
                                                          device="cpu")
    assert launches() == {}                   # plain versions launch nothing
    np.testing.assert_allclose(got, want, **SWEEP_TOL)
    np.testing.assert_array_equal(got, want)
    maps = tfs.sweep_feature_maps(tp, frame112.pixels, backend="cuda_plan",
                                  megakernel=megakernel, device="cpu")
    want_maps = tfs.sweep_feature_maps(tp, frame112.pixels, backend="plan", device="cpu")
    for name in tfs.MAPS:
        np.testing.assert_array_equal(maps[name], want_maps[name])


def test_sweep_stage_hook_only_on_the_float_kernel_backends(data, frame112):
    """`sweep_stage` is None on every backend without the kernel, and on the
    float kernel backends None where the maps do not pool evenly or hold
    more than one frame; the wrapper raises on such maps."""
    tp = params_from_jax(data[0], "cpu")
    x = _stage_frame((112, 112), frame112)
    w, b = tp["conv1"]["w"], tp["conv1"]["b"]
    for name in ("ref", "plan", "int8", "fixed", "fixed_cuda"):
        be = TB.get_backend(name)
        p = be.prepare_params(tp, "cpu")
        xi = be.ingest(x)
        assert be.sweep_stage((xi,) * 4, p["conv1"]["w"], p["conv1"]["b"]) is None, name
    for name in ("cuda", "cuda_plan"):
        be = TB.get_backend(name)
        quad = be.sweep_stage((x,) * 4, w, b)
        assert [tuple(m.shape) for m in quad] == [(1, 56, 56, 1)] * 4
        for bad in (x[:, :111], x[:, :, :111], torch.cat([x, x]), x[:, :1, :1]):
            bad = bad.contiguous()
            assert be.sweep_stage((bad,) * 4, w, b) is None, tuple(bad.shape)
    for bad in (x[:, :111], x[:, :1, :2], x[:, :0]):
        bad = bad.contiguous()
        with pytest.raises(ValueError, match="even extents"):
            float_sweep_stage((bad,) * 4, w, b)
    with pytest.raises(ValueError, match="one \\(1,h,w,1\\) shape"):
        float_sweep_stage((x, x, x, x[:, :56].contiguous()), w, b)
    with pytest.raises(TypeError, match="float32"):
        float_sweep_stage((x.double(),) * 4, w, b)
    with pytest.raises(ValueError, match="activation"):
        float_sweep_stage((x,) * 4, w, b, activation=None)


@pytest.mark.parametrize("shape", [(112, 112), (60, 44)])
@pytest.mark.parametrize("backend,activation", [("plan", "plan"), ("ref", "sigmoid")])
def test_float_window_head_plain_equals_composed_head(data, frame112, shape, backend,
                                                      activation):
    """The one-launch float head's plain version gives the composed head's
    scores exactly (`_head_scores(fused=False)`: the same stack, gather,
    product and activation on the CPU), and the reference's float sweep
    scores within SWEEP_TOL; the wrapper takes it on CPU tensors, and so
    does the `cuda`/`cuda_plan` sweep's head hook."""
    params, _, _ = data
    tp = params_from_jax(params, "cpu")
    be = TB.get_backend(backend)
    fb = _stage_frame(shape, frame112)
    sw = FcnSweep(stride=8)
    pos = tuple(sw.positions(shape))
    quad = tfs._trunk_quad(be, tp, fb)
    maps = [m[0, ..., 0] for m in quad]
    gy, gx = tfs._window_origins(28, pos, tuple(maps[0].shape), torch.device("cpu"))
    w, b = tp["dense"]["w"], tp["dense"]["b"]
    got = float_window_head_plain(maps, gy, gx, w, b, activation=activation)
    want = tfs._head_scores(be, tp, quad, 28, pos, fused=False)
    assert got.shape == (len(pos), 10) and torch.equal(got, want)
    reset_launches()
    assert torch.equal(float_window_head(maps, gy, gx, w, b, activation=activation), got)
    cuda_be = TB.get_backend("cuda_plan" if activation == "plan" else "cuda")
    assert torch.equal(tfs._head_scores(cuda_be, tp, quad, 28, pos), got)
    assert launches() == {}                   # plain versions launch nothing
    jscores = jfs.FcnSweep(stride=8).score(params, fb.numpy(), backend=backend)
    np.testing.assert_allclose(got.numpy(), jscores, **SWEEP_TOL)


def test_float_window_head_checks_its_arguments(data):
    """Bad shapes, dtypes and activations raise, and so does a window past
    the maps (the plain version's check; the kernel traps)."""
    tp = params_from_jax(data[0], "cpu")
    w, b = tp["dense"]["w"], tp["dense"]["b"]
    z = torch.zeros((28, 28), dtype=torch.float32)
    g = torch.zeros(2, dtype=torch.int32)
    assert float_window_head([z] * 4, g, g, w, b).shape == (2, 10)
    bad = [
        (ValueError, "expected 4 role maps", ([z] * 3, g, g, w, b)),
        (ValueError, "map B", ([z, z[:27].contiguous(), z, z], g, g, w, b)),
        (TypeError, "float32", ([z.double()] * 4, g, g, w, b)),
        (ValueError, "expected 2 dims", ([z[None]] * 4, g, g, w, b)),
        (TypeError, "int32", ([z] * 4, g.long(), g, w, b)),
        (ValueError, "expected 2 words", ([z] * 4, g, g[:1], w, b)),
        (ValueError, "is not \\(k\\*k, N\\)", ([z] * 4, g, g, w[:48].contiguous(), b)),
        (ValueError, "expected 10 words", ([z] * 4, g, g, w, b[:9])),
        (ValueError, "contiguous", ([z.t()] * 4, g, g, w, b)),
    ]
    for err, match, args in bad:
        with pytest.raises(err, match=match):
            float_window_head(*args)
    with pytest.raises(ValueError, match="activation"):
        float_window_head([z] * 4, g, g, w, b, activation=None)
    for y, x in ((22, 0), (0, 22), (-1, 0), (0, -1)):
        with pytest.raises(ValueError, match="outside"):
            float_window_head([z] * 4, torch.tensor([0, y], dtype=torch.int32),
                              torch.tensor([0, x], dtype=torch.int32), w, b)
