"""The port's Qm.n word arithmetic against the JAX reference, word for word.

Every `repro_torch.core.fixed_point` function is run on the same numpy
inputs as its `repro.core.fixed_point` counterpart, in all five
STANDARD_CONFIGS, and the int32 words must be equal (tolerance 0: every
path is integer).  Inputs carry max_int, min_int, INT32_MIN and INT32_MAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fixed_point as jfxp  # noqa: E402
from repro_torch.core import fixed_point as tfxp  # noqa: E402

CONFIGS = sorted(tfxp.STANDARD_CONFIGS)


def _words(rng, shape, cfg):
    x = rng.integers(cfg.min_int, cfg.max_int + 1, shape, dtype=np.int64)
    flat = x.reshape(-1)
    for j, v in enumerate((cfg.max_int, cfg.min_int, -2 ** 31, 2 ** 31 - 1, 0, 1, -1)):
        flat[j] = v
    return x.astype(np.int32)


def _eq(port, ref):
    got = np.asarray(port.numpy() if isinstance(port, torch.Tensor) else port)
    want = np.asarray(ref)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


@pytest.fixture(params=CONFIGS)
def cfgs(request):
    return tfxp.STANDARD_CONFIGS[request.param], jfxp.STANDARD_CONFIGS[request.param]


def test_config_matrix_matches_reference():
    assert sorted(jfxp.STANDARD_CONFIGS) == CONFIGS
    for name in CONFIGS:
        t, j = tfxp.STANDARD_CONFIGS[name], jfxp.STANDARD_CONFIGS[name]
        assert (t.total_bits, t.frac_bits, t.saturate, t.round_nearest) == \
            (j.total_bits, j.frac_bits, j.saturate, j.round_nearest)
        assert (t.int_bits, t.scale, t.max_int, t.min_int) == \
            (j.int_bits, j.scale, j.max_int, j.min_int)


def test_to_fixed_matches_reference(cfgs):
    tc, jc = cfgs
    rng = np.random.default_rng(1)
    x = np.concatenate([
        np.asarray([1e10, -1e10, 2147483647.0, -2147483648.0, 32767.99, -32768.5,
                    np.inf, -np.inf, np.nan, 0.5 / tc.scale, 1.5 / tc.scale,
                    -0.5 / tc.scale, 127.996, -128.0], np.float32),
        rng.uniform(-300, 300, 64).astype(np.float32),
        rng.uniform(-1, 1, 64).astype(np.float32)])
    _eq(tfxp.to_fixed(torch.from_numpy(x), tc), jfxp.to_fixed(jnp.asarray(x), jc))


def test_to_fixed_saturates_where_a_plain_cast_wraps():
    # torch's float->int32 cast wraps on CPU; the port must clamp like XLA
    got = tfxp.to_fixed(torch.tensor([1e10, -1e10]), tfxp.Q16_16)
    assert got.tolist() == [2 ** 31 - 1, -2 ** 31]
    assert tfxp.to_fixed(torch.tensor([1e10]), tfxp.Q8_8).tolist() == [32767]


def test_from_fixed_matches_reference(cfgs):
    tc, jc = cfgs
    w = _words(np.random.default_rng(2), (50,), tc)
    np.testing.assert_array_equal(tfxp.from_fixed(torch.from_numpy(w), tc).numpy(),
                                  np.asarray(jfxp.from_fixed(jnp.asarray(w), jc)))


def test_fixed_add_matches_reference(cfgs):
    tc, jc = cfgs
    rng = np.random.default_rng(3)
    a, b = _words(rng, (40, 40), tc), _words(rng, (40, 40), tc)
    b[0, :7] = a[0, :7]                               # same-sign overflow pairs
    _eq(tfxp.fixed_add(torch.from_numpy(a), torch.from_numpy(b), tc),
        jfxp.fixed_add(jnp.asarray(a), jnp.asarray(b), jc))


def test_fixed_mul_matches_reference(cfgs):
    tc, jc = cfgs
    rng = np.random.default_rng(4)
    a, b = _words(rng, (40, 40), tc), _words(rng, (40, 40), tc)
    a_all = np.repeat(a[0, :7], 7)                    # every extreme x extreme
    b_all = np.tile(a[0, :7], 7)
    for x, y in ((a, b), (a_all, b_all)):
        _eq(tfxp.fixed_mul(torch.from_numpy(x), torch.from_numpy(y), tc),
            jfxp.fixed_mul(jnp.asarray(x), jnp.asarray(y), jc))


def test_fixed_matmul_matches_reference(cfgs):
    tc, jc = cfgs
    rng = np.random.default_rng(5)
    x, w = _words(rng, (6, 49), tc), _words(rng, (49, 10), tc)
    _eq(tfxp.fixed_matmul(torch.from_numpy(x), torch.from_numpy(w), tc),
        jfxp.fixed_matmul(jnp.asarray(x), jnp.asarray(w), jc))


@pytest.mark.parametrize("k", [0, 1, 2, 3, 5, 16])
@pytest.mark.parametrize("round_nearest", [True, False])
def test_shift_right_round_matches_reference(k, round_nearest):
    x = _words(np.random.default_rng(6), (64,), tfxp.Q16_16)
    _eq(tfxp.shift_right_round(torch.from_numpy(x), k, round_nearest),
        jfxp.shift_right_round(jnp.asarray(x), k, round_nearest))


def test_fixed_sigmoid_plan_matches_reference(cfgs):
    tc, jc = cfgs
    rng = np.random.default_rng(7)
    seg = np.asarray([0.0, 0.5, -0.5, 1.0, -1.0, 1.7, -1.7, 2.375, -2.375, 3.3,
                      -3.3, 5.0, -5.0, 9.9, -9.9], np.float32)
    x = np.concatenate([np.asarray(jfxp.to_fixed(jnp.asarray(seg), jc)),
                        _words(rng, (200,), tc)]).astype(np.int32)
    _eq(tfxp.fixed_sigmoid_plan(torch.from_numpy(x), tc),
        jfxp.fixed_sigmoid_plan(jnp.asarray(x), jc))


def test_plan_of_int32_min_wraps_like_jnp_abs(cfgs):
    tc, jc = cfgs
    x = np.asarray([-2 ** 31, -2 ** 31 + 1, 2 ** 31 - 1], np.int32)
    _eq(tfxp.fixed_sigmoid_plan(torch.from_numpy(x), tc),
        jfxp.fixed_sigmoid_plan(jnp.asarray(x), jc))
