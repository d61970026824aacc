"""The port's fixed-point kernel wrappers, held to the reference three ways.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernels
run only on the card; tests/test_torch_cuda_kernels.py holds them to the
plain versions there).  Every plain version must give, word for word
(tolerance 0, every path is integer):

  * the frozen vectors of tests/golden/fixed_golden.json, all 5 configs;
  * the numpy int64 oracle `repro/kernels/fixed_conv/ref.py`, including odd
    extents, stride 2 and INT32_MIN into PLAN;
  * the JAX Pallas wrappers in their default interpret mode.
"""
import json
import pathlib
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fixed_point as jfxp  # noqa: E402
from repro.kernels import fixed_conv as jfc  # noqa: E402
from repro.kernels.fixed_conv import ref as oracle  # noqa: E402
from repro.kernels.quant_matmul import fixed_dense as j_fixed_dense  # noqa: E402
from repro_torch.core import fixed_point as tfxp  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.kernels.fixed_conv import ops as C  # noqa: E402
from repro_torch.kernels.quant_matmul import ops as D  # noqa: E402

_GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden" / "fixed_golden.json").read_text())
CONFIGS = sorted(tfxp.STANDARD_CONFIGS)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.int32)


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64),
                                  err_msg=what)


def _words(rng, shape, cfg):
    """Oracle words with max_int/min_int, plus INT32_MIN and INT32_MAX."""
    x = oracle.random_words(rng, shape, cfg)
    flat = x.reshape(-1)
    if flat.size >= 8:
        flat[-1], flat[-2] = -2 ** 31, 2 ** 31 - 1
    return x.astype(np.int32)


@pytest.fixture(params=CONFIGS)
def cfg_name(request):
    return request.param


# -- golden vectors -------------------------------------------------------------

@pytest.mark.parametrize("entry", ["conv.out", "conv.out_fused_plan_pool", "pool",
                                   "sigmoid", "dense"])
def test_plain_versions_match_golden(cfg_name, entry):
    cfg = tfxp.FixedPointConfig(**_GOLDEN["configs"][cfg_name])
    g = _GOLDEN["cases"][cfg_name]
    cv = g["conv"]
    x, w4, b = _t(cv["x"]), _t(cv["w4"]), _t([cv["b"]])
    if entry == "conv.out":
        got, want = C.fixed_conv2d(x, w4, b, cfg=cfg), cv["out"]
    elif entry == "conv.out_fused_plan_pool":
        got = C.fixed_conv2d(x, w4, b, cfg=cfg, activation="plan", pool=True)
        want = cv["out_fused_plan_pool"]
    elif entry == "pool":
        got, want = C.fixed_maxpool2x2(_t(g["pool"]["x"])), g["pool"]["out"]
    elif entry == "sigmoid":
        got, want = C.fixed_sigmoid(_t(g["sigmoid"]["x"]), cfg=cfg), g["sigmoid"]["out"]
    else:
        d = g["dense"]
        got = D.fixed_dense(_t(d["x"]), _t(d["w"]), _t(d["b"]), cfg=cfg)
        want = d["out"]
    _eq(got, want, f"{cfg_name} {entry}")


# -- numpy int64 oracle -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 6, 6), (3, 7, 9), (1, 1, 5), (2, 28, 28)],
                         ids=["even", "odd", "one-row", "mnist"])
@pytest.mark.parametrize("mode", ["pre", "plan", "plan_pool", "plan_stride2",
                                  "pool_only"])
def test_conv_matches_oracle(cfg_name, shape, mode):
    cfg = tfxp.STANDARD_CONFIGS[cfg_name]
    rng = np.random.default_rng(zlib.crc32(repr((cfg_name, shape, mode)).encode()))
    x = _words(rng, shape, cfg)
    w4 = _words(rng, (4,), cfg)
    b = int(oracle.random_words(rng, (1,), cfg, 0)[0])
    act = None if mode in ("pre", "pool_only") else "plan"
    pool = mode in ("plan_pool", "pool_only")
    stride = 2 if mode == "plan_stride2" else 1
    want = oracle.fixed_conv2d_ref(x, w4, b, cfg, activation=act, pool=pool,
                                   stride=stride)
    got = C.fixed_conv2d(_t(x), _t(w4), _t([b]), cfg=cfg, activation=act,
                         pool=pool, stride=stride)
    _eq(got, want, f"{cfg_name} {shape} {mode}")


def test_maxpool_matches_oracle_on_odd_extents():
    rng = np.random.default_rng(11)
    for shape in [(2, 4, 4), (2, 5, 7), (1, 1, 3), (3, 9, 2)]:
        x = _words(rng, shape, tfxp.Q16_16)
        _eq(C.fixed_maxpool2x2(_t(x)), oracle.fixed_maxpool2x2_ref(x), str(shape))


def test_sigmoid_matches_oracle_with_int32_min(cfg_name):
    cfg = tfxp.STANDARD_CONFIGS[cfg_name]
    x = _words(np.random.default_rng(12), (5, 7, 3), cfg)
    x.reshape(-1)[:3] = [-2 ** 31, -2 ** 31 + 1, 0]
    _eq(C.fixed_sigmoid(_t(x), cfg=cfg), oracle.fixed_sigmoid_plan_ref(x, cfg))


def test_dense_matches_oracle(cfg_name):
    cfg = tfxp.STANDARD_CONFIGS[cfg_name]
    rng = np.random.default_rng(13)
    for m, k, n in [(64, 49, 10), (3, 8, 5), (1, 1, 1)]:
        x, w, b = _words(rng, (m, k), cfg), _words(rng, (k, n), cfg), _words(rng, (n,), cfg)
        _eq(D.fixed_dense(_t(x), _t(w), _t(b), cfg=cfg),
            oracle.fixed_dense_ref(x, w, b, cfg), f"({m},{k})@({k},{n})")


def test_dense_without_bias_is_zero_bias():
    rng = np.random.default_rng(14)
    x, w = _t(_words(rng, (4, 6), tfxp.Q8_8)), _t(_words(rng, (6, 3), tfxp.Q8_8))
    _eq(D.fixed_dense(x, w, cfg=tfxp.Q8_8),
        D.fixed_dense(x, w, torch.zeros(3, dtype=torch.int32), cfg=tfxp.Q8_8))


# -- the JAX Pallas wrappers (interpret mode) ---------------------------------------

def test_plain_versions_match_pallas_wrappers(cfg_name):
    tc, jc = tfxp.STANDARD_CONFIGS[cfg_name], jfxp.STANDARD_CONFIGS[cfg_name]
    rng = np.random.default_rng(15)
    x = _words(rng, (2, 7, 9), tc)
    w4, b = _words(rng, (4,), tc), _words(rng, (1,), tc)
    j = lambda a: jnp.asarray(a, jnp.int32)
    _eq(C.fixed_conv2d(_t(x), _t(w4), _t(b), cfg=tc, activation="plan", pool=True),
        jfc.fixed_conv2d(j(x), j(w4), j(b), cfg=jc, activation="plan", pool=True),
        "fused conv")
    _eq(C.fixed_conv2d(_t(x), _t(w4), _t(b), cfg=tc, activation="plan", stride=2),
        jfc.fixed_conv2d(j(x), j(w4), j(b), cfg=jc, activation="plan", stride=2),
        "strided conv")
    _eq(C.fixed_sigmoid(_t(x), cfg=tc), jfc.fixed_sigmoid(j(x), cfg=jc), "sigmoid")
    xd, wd, bd = _words(rng, (5, 49), tc), _words(rng, (49, 10), tc), _words(rng, (10,), tc)
    _eq(D.fixed_dense(_t(xd), _t(wd), _t(bd), cfg=tc),
        j_fixed_dense(j(xd), j(wd), j(bd), cfg=jc), "dense")


def test_maxpool_matches_pallas_wrapper():
    x = _words(np.random.default_rng(16), (2, 7, 10), tfxp.Q16_16)
    _eq(C.fixed_maxpool2x2(_t(x)), jfc.fixed_maxpool2x2(jnp.asarray(x, jnp.int32)))


# -- wrapper contract ------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    reset_launches()
    x = torch.zeros((1, 4, 4), dtype=torch.int32)
    w4, b = torch.ones(4, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    C.fixed_conv2d(x, w4, b, activation="plan", pool=True)
    C.fixed_maxpool2x2(x)
    C.fixed_sigmoid(x)
    D.fixed_dense(x.reshape(1, 16), torch.zeros((16, 2), dtype=torch.int32))
    assert launches() == {}


def test_wrappers_check_their_inputs():
    x = torch.zeros((1, 4, 4), dtype=torch.int32)
    w4, b = torch.zeros(4, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        C.fixed_conv2d(x.float(), w4, b)
    with pytest.raises(ValueError):
        C.fixed_conv2d(x[0], w4, b)                            # rank
    with pytest.raises(ValueError):
        C.fixed_conv2d(x, torch.zeros(3, dtype=torch.int32), b)
    with pytest.raises(ValueError):
        C.fixed_maxpool2x2(torch.zeros((1, 4, 6), dtype=torch.int32)[:, :, ::2])
    with pytest.raises(ValueError):
        C.fixed_conv2d(x, w4, b, activation="relu")
    with pytest.raises(ValueError):
        C.fixed_conv2d(x, w4, b, pool=True, stride=2)
    with pytest.raises(ValueError):
        D.fixed_dense(torch.zeros((2, 3), dtype=torch.int32),
                      torch.zeros((4, 2), dtype=torch.int32))
    with pytest.raises(ValueError):                            # no kernel for meta
        C.fixed_sigmoid(torch.empty((2, 2), dtype=torch.int32, device="meta"))
