"""The served float step in one launch (`float_smallnet`) and the tiled
`conv2d`'s shapes, held to the JAX reference on the CPU.

The same numpy params (every leaf nonzero) and images go through the
reference's `repro.core.smallnet.apply` on its `pallas` and `pallas_plan`
backends (Pallas in interpret mode, as the JAX tests run it) and through
the port: `float_smallnet_plain`, the port's composed `ref`/`plan`
backends, and `smallnet.apply(..., backend="cuda"/"cuda_plan",
device="cpu")`, whose `net_scores` hook takes `float_smallnet` (its plain
version on CPU tensors).  Batches 1, 63 and 64, at 28x28 and at 32x24 (a
(48, 10) dense layer), on `synth_mnist` images and on images whose level-1
pre-activations sit exactly on PLAN's breakpoints (dyadic weights and
pixels, so both frameworks compute those conv outputs exactly).
Tolerance 1e-5 (rtol and atol): the dense product sums in another order
than XLA's.  The kernels themselves run only on the card
(tests/test_torch_cuda_kernels.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import smallnet as jsn  # noqa: E402
from repro.data import synth_mnist as j_synth  # noqa: E402
from repro.kernels.conv2d import conv2d as j_conv2d  # noqa: E402
from repro_torch.core import backends as TB  # noqa: E402
from repro_torch.core import smallnet as tsn  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.kernels.conv2d import ops as K  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# port backend -> (reference backend, the port's plain counterpart, activation)
PAIRS = {"cuda": ("pallas", "ref", "sigmoid"), "cuda_plan": ("pallas_plan", "plan", "plan")}
# level-1 pre-activations of a constant region: c * (1/2 + 1/4 + 1/8 + 1/8) + 1/2
# = c + 1/2, so these pixels land on +-1, +-2.375, +-5 and 0
BREAKPOINT_PIXELS = np.float32([0.5, 1.875, 4.5, -1.5, -2.875, -5.5, -0.5])


def numpy_params(K=49, seed=0):
    """Float params from numpy with every leaf nonzero."""
    rng = np.random.default_rng(seed)
    p = {"conv1": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "conv2": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "dense": {"w": rng.uniform(-0.6, 0.6, (K, 10)), "b": rng.normal(0, 0.5, (10,))}}
    p = {k: {n: a.astype(np.float32) for n, a in v.items()} for k, v in p.items()}
    assert all((a != 0).all() for v in p.values() for a in v.values())
    return p


def breakpoint_params(K=49, seed=0):
    """Dyadic conv weights summing to 1 (level 1 bias 1/2, level 2 bias 1/4,
    so a level-1 map of PLAN(1) = 0.75 puts level 2 on a breakpoint too),
    random dense weights; every leaf nonzero."""
    p = numpy_params(K, seed)
    taps = np.float32([0.5, 0.25, 0.125, 0.125]).reshape(2, 2, 1, 1)
    p["conv1"] = {"w": taps, "b": np.float32([0.5])}
    p["conv2"] = {"w": taps.copy(), "b": np.float32([0.25])}
    return p


def breakpoint_images(B, H, W, seed=1):
    """Images of 4x4 blocks, each one of BREAKPOINT_PIXELS: inside a block
    every level-1 conv output is exactly a PLAN breakpoint (or 0)."""
    rng = np.random.default_rng(seed)
    blocks = rng.choice(BREAKPOINT_PIXELS, size=(B, -(-H // 4), -(-W // 4)))
    x = np.repeat(np.repeat(blocks, 4, axis=1), 4, axis=2)[:, :H, :W]
    return x[..., None].astype(np.float32)


def images_of(kind, B, H, W):
    if kind == "breakpoints":
        return breakpoint_images(B, H, W)
    if (H, W) == (28, 28):
        return j_synth.make_dataset(B, seed=3)[0]
    return np.random.default_rng(B + H).random((B, H, W, 1), dtype=np.float32)


def _jax_apply(params, images, backend):
    return np.asarray(jax.jit(lambda p, x: jsn.apply(p, x, backend=backend))(
        params, jnp.asarray(images)))


def _torch(params):
    """numpy params as CPU tensors, of any dense extent (`params_from_jax`
    checks the served (49, 10) layer)."""
    return {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in params.items()}


def _net_args(tp, x):
    return (x, tp["conv1"]["w"], tp["conv1"]["b"], tp["conv2"]["w"], tp["conv2"]["b"],
            tp["dense"]["w"], tp["dense"]["b"])


@pytest.mark.parametrize("images", ["synth", "breakpoints"])
@pytest.mark.parametrize("H,W", [(28, 28), (32, 24)])
@pytest.mark.parametrize("B", [1, 63, 64])
@pytest.mark.parametrize("port", sorted(PAIRS))
def test_float_smallnet_matches_jax_apply(port, B, H, W, images):
    ref, plain, activation = PAIRS[port]
    k_in = (H // 4) * (W // 4)
    params = breakpoint_params(k_in) if images == "breakpoints" else numpy_params(k_in)
    x = images_of(images, B, H, W)
    want = _jax_apply(params, x, ref)
    tp = _torch(params)
    tx = torch.from_numpy(x)
    scores = K.float_smallnet_plain(*_net_args(tp, tx), activation=activation)
    assert scores.dtype == torch.float32 and tuple(scores.shape) == want.shape == (B, 10)
    np.testing.assert_allclose(scores.numpy(), want, **TOL)
    # the port's composed stages give the plain version's floats
    composed = tsn.apply(tp, tx, backend=plain, device="cpu")
    assert torch.equal(composed, scores)
    reset_launches()
    got = tsn.apply(tp, tx, backend=port, device="cpu")   # net_scores: the plain version
    assert torch.equal(got, scores)
    assert torch.equal(K.float_smallnet(*_net_args(tp, tx), activation=activation), scores)
    assert launches() == {}                                # CPU tensors: no launch


def test_breakpoint_images_reach_the_breakpoints():
    """The level-1 pre-activations of the breakpoint images hit 1, 2.375
    and 5 (and their negatives) exactly."""
    p = params_from_jax(breakpoint_params(), "cpu")
    x = torch.from_numpy(breakpoint_images(8, 28, 28))
    pre = K.conv2d_plain(x, p["conv1"]["w"], p["conv1"]["b"])
    values = set(np.unique(pre.numpy()).tolist())
    assert {1.0, 2.375, 5.0, -1.0, -2.375, -5.0} <= values


@pytest.mark.parametrize("port", sorted(PAIRS))
def test_apply_takes_the_net_scores_route(port, monkeypatch):
    """On CPU tensors `apply` on `cuda`/`cuda_plan` goes through
    `float_smallnet` once (its plain version), not through the stages."""
    _, plain, activation = PAIRS[port]
    calls = []
    real = K.float_smallnet_plain

    def spy(*args, **kwargs):
        calls.append(kwargs["activation"])
        return real(*args, **kwargs)

    def no_stage(*args, **kwargs):
        raise AssertionError("a stage ran: the whole-net route was not taken")

    monkeypatch.setattr(K, "float_smallnet_plain", spy)
    be = TB.get_backend(port)
    monkeypatch.setattr(type(be), "fused_conv_act_pool", no_stage)
    tp = params_from_jax(numpy_params(), "cpu")
    x = torch.from_numpy(j_synth.make_dataset(5, seed=4)[0])
    got = tsn.apply(tp, x, backend=port, device="cpu")
    assert calls == [activation]
    monkeypatch.undo()
    assert torch.equal(got, tsn.apply(tp, x, backend=plain, device="cpu"))


def test_refused_batches_compose_the_stages():
    """`net_scores` gives None for what the kernel does not compute (conv
    weights other than 2x2 single-channel, images that are not (B,H,W,1),
    a dense layer that does not take the pooled map); `apply` then composes
    the stages, with the plain backends' floats."""
    for port, (_, plain, _) in sorted(PAIRS.items()):
        be = TB.get_backend(port)
        p = be.prepare_params(params_from_jax(numpy_params(), "cpu"), "cpu")
        x = torch.from_numpy(j_synth.make_dataset(3, seed=4)[0])
        assert be.net_scores(x, p) is not None
        for shape in ((2, 32, 32, 1), (2, 28, 28), (2, 27, 28, 1), (2, 28, 28, 2)):
            assert be.net_scores(torch.zeros(shape), p) is None
        rng = np.random.default_rng(9)
        p3 = dict(p, conv1={"w": torch.from_numpy(rng.uniform(-1, 1, (3, 3, 1, 1))
                                                  .astype(np.float32)),
                            "b": p["conv1"]["b"]})
        assert be.net_scores(x, p3) is None
        got = tsn.apply(p3, x, backend=port, device="cpu")
        assert torch.equal(got, tsn.apply(p3, x, backend=plain, device="cpu"))


@pytest.mark.parametrize("port", sorted(PAIRS))
def test_nan_propagates_through_both_pools(port):
    """A NaN pixel makes its image's scores NaN, through the level-1 and
    level-2 max pools (torch.maximum's rule), as in the reference."""
    ref, _, activation = PAIRS[port]
    params = numpy_params()
    x = j_synth.make_dataset(4, seed=6)[0].copy()
    x[1, 13, 6, 0] = np.nan
    want = _jax_apply(params, x, ref)
    tp = params_from_jax(params, "cpu")
    got = K.float_smallnet_plain(*_net_args(tp, torch.from_numpy(x)), activation=activation)
    assert np.isnan(want[1]).all() and torch.isnan(got[1]).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)     # NaN where the reference's is


def test_float_smallnet_rejects_bad_arguments():
    z = lambda *s: torch.zeros(s)                            # noqa: E731
    ok = [z(2, 28, 28, 1), z(2, 2, 1, 1), z(1), z(2, 2, 1, 1), z(1), z(49, 10), z(10)]
    assert K.float_smallnet(*ok).shape == (2, 10)
    with pytest.raises(ValueError, match="activation"):
        K.float_smallnet(*ok, activation=None)
    for i, bad in ((0, z(2, 28, 28)), (0, z(2, 28, 28, 2)), (5, z(48, 10)), (6, z(9)),
                   (1, z(3)), (2, z(2)), (0, torch.zeros((2, 28, 28, 1), dtype=torch.int32)),
                   (0, z(2, 28, 28, 1).double())):
        args = list(ok)
        args[i] = bad
        with pytest.raises((ValueError, TypeError)):
            K.float_smallnet(*args)


@dataclasses.dataclass(frozen=True)
class _Case:
    x: tuple
    w: tuple
    padding: str
    stride: int


# shapes past the tiled kernel's edges: extents that are not multiples of a
# tile, Cout in {1, 3, 16, 17}, Cin = 3, stride 3
TILE_EDGE_CASES = [_Case((2, 37, 53, 3), (2, 2, 3, 17), "SAME", 1),
                   _Case((1, 41, 35, 3), (3, 3, 3, 16), "SAME", 3),
                   _Case((1, 41, 35, 3), (3, 3, 3, 3), "VALID", 3),
                   _Case((3, 29, 31, 1), (2, 2, 1, 3), "SAME", 2),
                   _Case((2, 37, 53, 1), (2, 2, 1, 1), "SAME", 1)]


@pytest.mark.parametrize("case", TILE_EDGE_CASES,
                         ids=lambda c: f"{c.x}x{c.w}-{c.padding}-s{c.stride}")
def test_conv2d_at_tile_edge_shapes_matches_jax(case):
    rng = np.random.default_rng(sum(case.x) + sum(case.w))
    x = (rng.normal(size=case.x) * 3).astype(np.float32)
    w = rng.normal(size=case.w).astype(np.float32)
    b = rng.normal(size=case.w[3:]).astype(np.float32)
    for activation in (None, "sigmoid", "plan"):
        kw = dict(padding=case.padding, stride=case.stride, activation=activation)
        want = np.asarray(j_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw))
        got = K.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), **kw)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)
