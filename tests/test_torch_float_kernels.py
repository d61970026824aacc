"""The port's four float/int8 kernel wrappers against the JAX reference.

On CPU tensors each wrapper (`conv2d`, `maxpool2d`, `sigmoid_pla`,
`quant_matmul` of `repro_torch.kernels`) runs its plain version; the same
numpy inputs go through the reference's Pallas wrappers in interpret mode
(as `tests/test_kernels.py` runs them) and its `ref.py` oracles, at the
shapes of `tests/test_kernels.py`.  Tolerances: conv rtol = atol = 2e-5
(the reference's own: XLA's conv sums in another order); max pool exact in
float32 and bfloat16; PLAN rtol = atol = 1e-6 (as the reference's test);
quant_matmul's int32 sum exact and its dequantized floats rtol 1e-6.  The
CUDA kernels themselves are held to these plain versions on the card
(`tests/test_torch_cuda_kernels.py`, `chip_smoke.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.conv2d import conv2d as j_conv2d  # noqa: E402
from repro.kernels.conv2d import conv2d_ref as j_conv2d_ref  # noqa: E402
from repro.kernels.maxpool2d import maxpool2d as j_maxpool2d  # noqa: E402
from repro.kernels.maxpool2d import maxpool2d_ref as j_maxpool2d_ref  # noqa: E402
from repro.kernels.quant_matmul import quant_matmul as j_qmm  # noqa: E402
from repro.kernels.quant_matmul import quant_matmul_ref as j_qmm_ref  # noqa: E402
from repro.kernels.sigmoid_pla import sigmoid_pla as j_pla  # noqa: E402
from repro.kernels.sigmoid_pla import sigmoid_pla_ref as j_pla_ref  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.kernels.conv2d import conv2d, conv2d_plain  # noqa: E402
from repro_torch.kernels.maxpool2d import maxpool2d, maxpool2d_plain  # noqa: E402
from repro_torch.kernels.quant_matmul import (quant_matmul, quant_matmul_plain,  # noqa: E402
                                              quant_matmul_route)
from repro_torch.kernels.sigmoid_pla import sigmoid_pla, sigmoid_pla_plain  # noqa: E402

CONV_TOL = dict(rtol=2e-5, atol=2e-5)
PLAN_TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("B,H,W,ci,co,kh,kw,pad,sig,stride", [
    (2, 28, 28, 1, 1, 2, 2, "SAME", True, 1),     # smallNet conv1
    (2, 14, 14, 1, 1, 2, 2, "SAME", True, 1),     # smallNet conv2
    (1, 16, 16, 3, 8, 3, 3, "SAME", False, 1),
    (3, 16, 12, 4, 4, 2, 2, "VALID", False, 1),
    (1, 32, 32, 2, 6, 5, 5, "SAME", False, 2),
    (2, 8, 8, 8, 16, 1, 1, "VALID", False, 1),
])
def test_conv2d_matches_jax_pallas_and_ref(B, H, W, ci, co, kh, kw, pad, sig, stride):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, H, W, ci)).astype(np.float32)
    w = rng.normal(size=(kh, kw, ci, co)).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    kw_ = dict(padding=pad, apply_sigmoid=sig, stride=stride)
    want = np.asarray(j_conv2d_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw_))
    pallas = np.asarray(j_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw_))
    got = conv2d(_t(x), _t(w), _t(b), **kw_)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **CONV_TOL)


@pytest.mark.parametrize("activation", [None, "sigmoid", "plan"])
def test_conv2d_fused_activation_matches_jax(activation):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 28, 28, 1)).astype(np.float32) * 3
    w = rng.normal(size=(2, 2, 1, 1)).astype(np.float32)
    b = rng.normal(size=(1,)).astype(np.float32)
    want = np.asarray(j_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               activation=activation))
    got = conv2d(_t(x), _t(w), _t(b), activation=activation)
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)


def test_conv2d_stride2_frame_and_no_bias_match_ref():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(1, 96, 72, 1)).astype(np.float32)
    w = rng.normal(size=(2, 2, 1, 4)).astype(np.float32)
    want = np.asarray(j_conv2d_ref(jnp.asarray(x), jnp.asarray(w), stride=2))
    got = conv2d(_t(x), _t(w), stride=2)
    assert tuple(got.shape) == want.shape == (1, 48, 36, 4)
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)


def test_conv2d_rejects_bad_arguments():
    x, w = torch.zeros(1, 8, 8, 1), torch.zeros(2, 2, 1, 1)
    with pytest.raises(ValueError, match="activation"):
        conv2d(x, w, activation="relu")
    with pytest.raises(ValueError, match="padding"):
        conv2d(x, w, padding="FULL")
    with pytest.raises(ValueError, match="channels"):
        conv2d(torch.zeros(1, 8, 8, 2), w)
    with pytest.raises(TypeError, match="float32"):
        conv2d(x.double(), w)
    with pytest.raises(ValueError, match="stride"):
        conv2d(x, w, stride=0)


@pytest.mark.parametrize("M,K,N", [
    (64, 49, 10),        # smallNet dense
    (256, 512, 256),
    (100, 300, 70),
    (8, 128, 8),
    (513, 257, 129),
])
def test_quant_matmul_matches_jax_pallas_and_ref(M, K, N):
    rng = np.random.default_rng(14)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    sx = rng.uniform(0.01, 0.1, (M,)).astype(np.float32)
    sw = rng.uniform(0.01, 0.1, (N,)).astype(np.float32)
    args = [jnp.asarray(a) for a in (xq, wq, sx, sw)]
    want = np.asarray(j_qmm_ref(*args))
    got = quant_matmul(_t(xq), _t(wq), _t(sx), _t(sw))
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_qmm(*args)), rtol=1e-6)


def test_quant_matmul_int32_sum_is_exact():
    rng = np.random.default_rng(15)
    xq = rng.integers(-128, 128, (32, 1024)).astype(np.int8)
    wq = rng.integers(-128, 128, (1024, 16)).astype(np.int8)
    xq[0], wq[:, 0] = -128, -128                      # the largest products
    want = xq.astype(np.int64) @ wq.astype(np.int64)
    got = quant_matmul(_t(xq), _t(wq), 1.0, 1.0)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    jax_got = np.asarray(j_qmm(jnp.asarray(xq), jnp.asarray(wq), 1.0, 1.0))
    np.testing.assert_array_equal(jax_got.astype(np.int64), want)


def test_quant_matmul_scalar_scales_and_bad_arguments():
    rng = np.random.default_rng(16)
    xq = _t(rng.integers(-127, 128, (5, 7)).astype(np.int8))
    wq = _t(rng.integers(-127, 128, (7, 3)).astype(np.int8))
    got = quant_matmul(xq, wq, torch.tensor(0.5), 0.25)
    want = quant_matmul_plain(xq, wq, torch.full((5,), 0.5), torch.full((3,), 0.25))
    assert torch.equal(got, want)
    with pytest.raises(TypeError, match="int8"):
        quant_matmul(xq.to(torch.int32), wq)
    with pytest.raises(ValueError, match="@"):
        quant_matmul(xq, wq.T.contiguous())
    with pytest.raises(ValueError, match="scales"):
        quant_matmul(xq, wq, torch.ones(4))


@pytest.mark.parametrize("K,N,route", [(49, 10, "dp4a"), (16, 8, "wgmma"),
                                       (4096, 4096, "wgmma"), (4104, 64, "dp4a"),
                                       (97, 64, "dp4a"), (4160, 136, "wgmma"),
                                       (4096, 130, "dp4a")])
def test_quant_matmul_route_follows_the_tma_stride_rule(K, N, route):
    xq, wq = torch.zeros((3, K), dtype=torch.int8), torch.zeros((K, N), dtype=torch.int8)
    assert quant_matmul_route(xq, wq) == route
    if route == "wgmma":                    # an unaligned view takes dp4a
        flat = torch.zeros(3 * K + 1, dtype=torch.int8)
        assert quant_matmul_route(flat[1:].view(3, K), wq) == "dp4a"


@pytest.mark.parametrize("shape", [(7,), (33, 5), (2, 3, 4, 5), (1000,), (256, 128)])
@pytest.mark.parametrize("scale", [0.1, 4.0, 20.0])
def test_sigmoid_pla_matches_jax(shape, scale):
    rng = np.random.default_rng(17)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    got = sigmoid_pla(_t(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(j_pla(jnp.asarray(x))), **PLAN_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_pla_ref(jnp.asarray(x))),
                               **PLAN_TOL)


def test_sigmoid_pla_breakpoints_and_signed_zero():
    pts = np.float32([0.0, 1.0, 2.375, 5.0])
    near = np.concatenate([pts, np.nextafter(pts, np.float32(-np.inf)),
                           np.nextafter(pts, np.float32(np.inf)), [1e-30, 88.0, 1e30]])
    x = np.concatenate([near, -near]).astype(np.float32)
    got = sigmoid_pla(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_pla_ref(jnp.asarray(x))), **PLAN_TOL)
    assert got[0] == 0.5 and got[len(near)] == 0.5            # +0.0 and -0.0
    assert np.isnan(sigmoid_pla(torch.tensor([float("nan")])).numpy()).all()


@pytest.mark.parametrize("B,H,W,C", [(2, 28, 28, 1), (1, 14, 14, 1),
                                     (2, 15, 9, 2), (3, 8, 8, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool2d_matches_jax_exactly(B, H, W, C, dtype):
    rng = np.random.default_rng(18)
    x32 = rng.normal(size=(B, H, W, C)).astype(np.float32)
    jx = jnp.asarray(x32, getattr(jnp, dtype))
    tx = _t(x32).to(getattr(torch, dtype))
    want = np.asarray(j_maxpool2d_ref(jx).astype(jnp.float32))
    got = maxpool2d(tx)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(j_maxpool2d(jx).astype(jnp.float32)))


def test_maxpool2d_propagates_nan_and_rejects_bad_input():
    x = torch.zeros(1, 4, 4, 1)
    x[0, 1, 1, 0] = float("nan")
    got = maxpool2d(x)
    assert torch.isnan(got[0, 0, 0, 0]) and not torch.isnan(got[0, 1, 1, 0])
    with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
        maxpool2d(x.to(torch.int32))
    with pytest.raises(ValueError, match="4 dims"):
        maxpool2d(x[0])


def test_cpu_tensors_run_the_plain_versions_and_launch_nothing():
    rng = np.random.default_rng(19)
    x = _t(rng.normal(size=(2, 9, 9, 1)).astype(np.float32))
    w = _t(rng.normal(size=(2, 2, 1, 1)).astype(np.float32))
    xq = _t(rng.integers(-127, 128, (4, 9)).astype(np.int8))
    wq = _t(rng.integers(-127, 128, (9, 3)).astype(np.int8))
    reset_launches()
    assert torch.equal(conv2d(x, w, activation="plan"),
                       conv2d_plain(x, w, activation="plan"))
    assert torch.equal(maxpool2d(x), maxpool2d_plain(x))
    assert torch.equal(sigmoid_pla(x), sigmoid_pla_plain(x))
    assert torch.equal(quant_matmul(xq, wq, 0.5, 2.0), quant_matmul_plain(xq, wq, 0.5, 2.0))
    assert launches() == {}
