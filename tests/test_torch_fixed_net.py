"""The served step in one launch (`fixed_smallnet`) and the dense-layer
routes, held to the JAX reference on the CPU.

The same numpy params (every leaf nonzero) and images go through the
reference's `repro.core.smallnet.apply` on its `fixed` backend and through
the port: `fixed_smallnet_plain` on the ingested words and quantized
params, and `smallnet.apply(..., backend="fixed_cuda", device="cpu")`,
whose `net_scores` hook takes `fixed_smallnet` (its plain version on CPU
tensors).  All five STANDARD_CONFIGS, on `synth_mnist` images and on
images whose words sit at the format's edges (INT32_MIN/MAX in Q16.16,
the 16-bit extremes in Q8.8) with weights large enough to saturate
products.  Tolerance: exact int32 words.  The kernel itself runs only on
the card (tests/test_torch_cuda_kernels.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import backends as JB  # noqa: E402
from repro.core import fixed_point as jfxp  # noqa: E402
from repro.core import smallnet as jsn  # noqa: E402
from repro.data import synth_mnist as j_synth  # noqa: E402
from repro_torch.core import backends as TB  # noqa: E402
from repro_torch.core import fixed_point as tfxp  # noqa: E402
from repro_torch.core import smallnet as tsn  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.kernels.fixed_conv import ops as C  # noqa: E402
from repro_torch.kernels.quant_matmul import ops as D  # noqa: E402

CONFIGS = sorted(tfxp.STANDARD_CONFIGS)
BATCH = 8


def numpy_params(seed=0, scale=1.0):
    """Float params from numpy with every leaf nonzero."""
    rng = np.random.default_rng(seed)
    p = {"conv1": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "conv2": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "dense": {"w": rng.uniform(-0.6, 0.6, (49, 10)), "b": rng.normal(0, 0.5, (10,))}}
    p = {k: {n: (a * scale).astype(np.float32) for n, a in v.items()} for k, v in p.items()}
    assert all((a != 0).all() for v in p.values() for a in v.values())
    return p


def edge_images(seed=1):
    """Images whose ingested words include each format's extremes (values
    far past the range clamp to max_int / min_int, INT32_MAX / INT32_MIN
    in Q16.16) beside ordinary pixels."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (BATCH, 28, 28, 1)).astype(np.float32)
    flat = x.reshape(BATCH, -1)
    for i in range(BATCH):
        idx = rng.choice(784, size=200, replace=False)
        flat[i, idx[:100]] = 1e6
        flat[i, idx[100:]] = -1e6
    flat[0, :] = 1e6                     # an all-max image
    flat[1, :] = -1e6                    # an all-min image
    return x


def _jax_scores(params, images, cfg_name):
    be = JB.FixedBackend(cfg=jfxp.STANDARD_CONFIGS[cfg_name])
    out = jax.jit(lambda p, x: jsn.apply(p, x, backend=be))(params, jnp.asarray(images))
    return np.asarray(out)


def _words_args(params, images, cfg):
    """The kernel's arguments: ingested words and quantized params."""
    be = TB.FixedBackend(cfg=cfg)
    p = be.prepare_params(params_from_jax(params, "cpu"), "cpu")
    x = be.ingest(torch.from_numpy(images))
    return (x, p["conv1"]["w"], p["conv1"]["b"], p["conv2"]["w"], p["conv2"]["b"],
            p["dense"]["w"], p["dense"]["b"])


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def mnist():
    return j_synth.make_dataset(BATCH, seed=3)[0]


@pytest.mark.parametrize("cfg_name", CONFIGS)
@pytest.mark.parametrize("images", ["synth_mnist", "edge_words"])
def test_whole_net_matches_jax_apply(mnist, cfg_name, images):
    cfg = tfxp.STANDARD_CONFIGS[cfg_name]
    if images == "synth_mnist":
        params, x = numpy_params(), mnist
    else:                                # products past the range saturate
        params, x = numpy_params(seed=5, scale=40.0), edge_images()
    want = _jax_scores(params, x, cfg_name)
    args = _words_args(params, x, cfg)
    if images == "edge_words":
        words = args[0]
        assert int(words.max()) == cfg.max_int and int(words.min()) == cfg.min_int
    _eq(C.fixed_smallnet_plain(*args, cfg=cfg), want)
    reset_launches()
    _eq(C.fixed_smallnet(*args, cfg=cfg), want)
    be = TB.FixedCudaBackend(cfg=cfg)
    _eq(tsn.apply(params_from_jax(params, "cpu"), torch.from_numpy(x), backend=be,
                  device="cpu"), want)
    assert launches() == {}              # CPU tensors: the plain version


def test_net_scores_hook_takes_only_the_served_shape():
    """The hook takes a (B,H,W,1) batch whose (H/4)(W/4) pooled map is the
    dense layer's 49 inputs (28x28 served images, and 28x30 or 31x29 ones
    too), with the composed stages' words; None for any other batch.  Of
    the other backends only the float kernels' (`cuda`, `cuda_plan`) have
    a whole-net route."""
    params = params_from_jax(numpy_params(), "cpu")
    cuda = TB.get_backend("fixed_cuda")
    p = cuda.prepare_params(params, "cpu")
    rng = np.random.default_rng(4)
    for x in (torch.from_numpy(j_synth.make_dataset(3, seed=4)[0]),
              torch.from_numpy(rng.random((2, 28, 30, 1), dtype=np.float32)),
              torch.from_numpy(rng.random((2, 31, 29, 1), dtype=np.float32))):
        got = cuda.net_scores(x, p)
        assert got is not None and got.shape == (x.shape[0], 10)
        assert torch.equal(got, tsn.apply(params, x, backend="fixed", device="cpu"))
    for shape in ((2, 32, 32, 1), (2, 28, 28), (2, 27, 28, 1), (2, 28, 28, 2)):
        assert cuda.net_scores(torch.zeros(shape), p) is None
    x = torch.from_numpy(j_synth.make_dataset(3, seed=4)[0])
    for name in ("fixed", "ref", "plan", "int8"):
        be = TB.get_backend(name)
        assert be.net_scores(x, be.prepare_params(params, "cpu")) is None
    for name in ("cuda", "cuda_plan"):       # the float whole-net route: float scores
        be = TB.get_backend(name)
        got = be.net_scores(x, be.prepare_params(params, "cpu"))
        assert got.dtype == torch.float32 and got.shape == (3, 10)


@pytest.mark.parametrize("B,H,W,N", [(3, 37, 53, 10), (2, 9, 8, 16), (1, 4, 4, 1),
                                     (4, 30, 26, 7)])
def test_whole_net_plain_matches_composed_stages_at_odd_extents(B, H, W, N):
    cfg = tfxp.Q8_8
    rng = np.random.default_rng(B + H + W + N)
    K = (H // 4) * (W // 4)
    words = [torch.from_numpy(rng.integers(cfg.min_int, cfg.max_int + 1, s).astype(np.int32))
             for s in ((B, H, W), (4,), (1,), (4,), (1,), (K, N), (N,))]
    x, c1w, c1b, c2w, c2b, dw, db = words
    y = C.fixed_maxpool2x2_plain(C.fixed_conv2d_plain(x, c1w, c1b, cfg=cfg, activation="plan"))
    y = C.fixed_maxpool2x2_plain(C.fixed_conv2d_plain(y, c2w, c2b, cfg=cfg, activation="plan"))
    want = C.fixed_sigmoid_plain(D.fixed_dense_plain(y.reshape(B, -1), dw, db, cfg=cfg),
                                 cfg=cfg)
    assert torch.equal(C.fixed_smallnet(*words, cfg=cfg), want)


def test_whole_net_rejects_what_the_kernel_cannot_take():
    z = lambda *s: torch.zeros(s, dtype=torch.int32)       # noqa: E731
    ok = [z(2, 28, 28), z(4), z(1), z(4), z(1), z(49, 10), z(10)]
    assert C.fixed_smallnet(*ok).shape == (2, 10)
    for i, bad in ((0, z(2, 3, 28)), (5, z(48, 10)), (6, z(9)), (1, z(3)),
                   (0, torch.zeros((2, 28, 28)))):
        args = list(ok)
        args[i] = bad
        with pytest.raises((ValueError, TypeError)):
            C.fixed_smallnet(*args)


# (K, N, the kernel the card takes for them: checked by
# tests/test_torch_cuda_kernels.py test_fixed_dense_route_on_card)
DENSE_ROUTES = [(49, 10, "rows"), (49, 16, "rows"), (49, 1, "rows"), (49, 17, "generic"),
                (900, 10, "generic"), (7, 5, "rows")]


@pytest.mark.parametrize("K,N,route", DENSE_ROUTES)
def test_dense_route_and_its_words_match_jax(K, N, route):
    """fixed_dense at the shapes of each route, against the JAX fixed_dense
    (on CPU tensors: the plain version, whatever the route)."""
    from repro.kernels.quant_matmul import fixed_dense as j_fixed_dense
    cfg_name = "q16_16_sat"
    tc, jc = tfxp.STANDARD_CONFIGS[cfg_name], jfxp.STANDARD_CONFIGS[cfg_name]
    rng = np.random.default_rng(K * N)
    x, w, b = (rng.integers(tc.min_int, tc.max_int + 1, s).astype(np.int32)
               for s in ((5, K), (K, N), (N,)))
    want = np.asarray(j_fixed_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), cfg=jc))
    t = torch.from_numpy
    _eq(D.fixed_dense(t(x), t(w), t(b), cfg=tc), want)
    _eq(D.fixed_dense_plain(t(x), t(w), t(b), cfg=tc), want)
