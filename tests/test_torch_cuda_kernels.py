"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one.  They import no JAX, so they run on the GPU machine as they
are:  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
Tolerances: Qm.n words, max-pooled floats, PLAN floats and quant_matmul's
int32 sums must be equal (0); the float conv within rtol = atol = 2e-5
(nvcc contracts its multiply-adds into FMAs, and its sigmoid is
`1/(1+expf(-x))`, not torch's); quant_matmul's dequantized floats within
rtol 1e-6; served float scores within 2e-5 of the plain backends on the
CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import backends as TB  # noqa: E402
from repro_torch.core import fixed_point as tfxp  # noqa: E402
from repro_torch.core import smallnet  # noqa: E402
from repro_torch.data import synth_mnist  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.kernels.conv2d import conv2d, conv2d_plain  # noqa: E402
from repro_torch.kernels.fixed_conv import ops as C  # noqa: E402
from repro_torch.kernels.maxpool2d import maxpool2d, maxpool2d_plain  # noqa: E402
from repro_torch.kernels.quant_matmul import ops as D  # noqa: E402
from repro_torch.kernels.sigmoid_pla import sigmoid_pla, sigmoid_pla_plain  # noqa: E402

CONFIGS = sorted(tfxp.STANDARD_CONFIGS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _words(rng, shape, cfg, device):
    x = rng.integers(cfg.min_int, cfg.max_int + 1, shape, dtype=np.int64)
    flat = x.reshape(-1)
    extremes = (cfg.max_int, cfg.min_int, -2 ** 31, 2 ** 31 - 1)
    flat[:min(4, flat.size)] = extremes[:min(4, flat.size)]
    return torch.from_numpy(x.astype(np.int32)).to(device)


@pytest.mark.parametrize("cfg_name", CONFIGS)
def test_kernels_match_plain_on_card(cuda, cfg_name):
    cfg = tfxp.STANDARD_CONFIGS[cfg_name]
    rng = np.random.default_rng(17)
    x = _words(rng, (3, 29, 31), cfg, cuda)
    w4, b = _words(rng, (4,), cfg, cuda), _words(rng, (1,), cfg, cuda)
    for kw in (dict(), dict(activation="plan"), dict(activation="plan", pool=True),
               dict(activation="plan", stride=2)):
        assert torch.equal(C.fixed_conv2d(x, w4, b, cfg=cfg, **kw),
                           C.fixed_conv2d_plain(x, w4, b, cfg=cfg, **kw)), kw
    assert torch.equal(C.fixed_maxpool2x2(x), C.fixed_maxpool2x2_plain(x))
    assert torch.equal(C.fixed_sigmoid(x, cfg=cfg), C.fixed_sigmoid_plain(x, cfg=cfg))
    xd, wd = _words(rng, (64, 49), cfg, cuda), _words(rng, (49, 10), cfg, cuda)
    bd = _words(rng, (10,), cfg, cuda)
    assert torch.equal(D.fixed_dense(xd, wd, bd, cfg=cfg),
                       D.fixed_dense_plain(xd, wd, bd, cfg=cfg))


@pytest.mark.parametrize("cfg_name", ["q16_16", "q8_8"])
def test_fixed_cuda_apply_matches_fixed_on_card(cuda, cfg_name):
    cfg = tfxp.STANDARD_CONFIGS[cfg_name]
    rng = np.random.default_rng(3)
    params = {"conv1": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, .5, (1,))},
              "conv2": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, .5, (1,))},
              "dense": {"w": rng.uniform(-.6, .6, (49, 10)), "b": rng.normal(0, .5, (10,))}}
    params = {k: {n: torch.tensor(a, dtype=torch.float32, device=cuda) for n, a in v.items()}
              for k, v in params.items()}
    images = torch.from_numpy(synth_mnist.make_dataset(64, seed=4)[0]).to(cuda)
    reset_launches()
    got = smallnet.apply(params, images, backend=TB.FixedCudaBackend(cfg=cfg))
    assert launches() == {"fixed_conv2d": 2, "fixed_dense": 1, "fixed_sigmoid": 1}
    want = smallnet.apply(params, images.cpu(), backend=TB.FixedBackend(cfg=cfg))
    assert torch.equal(got.cpu(), want)


def _numpy_params(seed):
    rng = np.random.default_rng(seed)
    return {"conv1": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, .5, (1,))},
            "conv2": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, .5, (1,))},
            "dense": {"w": rng.uniform(-.6, .6, (49, 10)), "b": rng.normal(0, .5, (10,))}}


@pytest.mark.parametrize("B,H,W,ci,co,kh,kw,pad,stride", [
    (64, 28, 28, 1, 1, 2, 2, "SAME", 1), (64, 14, 14, 1, 1, 2, 2, "SAME", 1),
    (1, 16, 16, 3, 8, 3, 3, "SAME", 1), (3, 16, 12, 4, 4, 2, 2, "VALID", 1),
    (1, 32, 32, 2, 6, 5, 5, "SAME", 2), (2, 8, 8, 8, 16, 1, 1, "VALID", 1),
])
def test_float_conv2d_matches_plain_on_card(cuda, B, H, W, ci, co, kh, kw, pad, stride):
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.normal(size=(B, H, W, ci)).astype(np.float32) * 3).to(cuda)
    w = torch.from_numpy(rng.normal(size=(kh, kw, ci, co)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.normal(size=(co,)).astype(np.float32)).to(cuda)
    for act in (None, "sigmoid", "plan"):
        kw_ = dict(padding=pad, stride=stride, activation=act)
        torch.testing.assert_close(conv2d(x, w, b, **kw_), conv2d_plain(x, w, b, **kw_),
                                   rtol=2e-5, atol=2e-5)


def test_float_pool_plan_and_quant_matmul_match_plain_on_card(cuda):
    rng = np.random.default_rng(32)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.normal(size=(3, 15, 9, 2)).astype(np.float32)).to(cuda, dtype)
        got = maxpool2d(x)
        assert got.dtype == dtype and torch.equal(got, maxpool2d_plain(x))
    x = torch.from_numpy(np.concatenate([rng.normal(size=4099) * 4,
                                         [0.0, -0.0, 1.0, -1.0, 2.375, -2.375, 5.0, -5.0]])
                         .astype(np.float32)).to(cuda)
    assert torch.equal(sigmoid_pla(x), sigmoid_pla_plain(x))
    xq = torch.from_numpy(rng.integers(-128, 128, (33, 1027)).astype(np.int8)).to(cuda)
    wq = torch.from_numpy(rng.integers(-128, 128, (1027, 70)).astype(np.int8)).to(cuda)
    exact = (xq.cpu().to(torch.int64) @ wq.cpu().to(torch.int64)).to(torch.float32)
    assert torch.equal(D.quant_matmul(xq, wq).cpu(), exact)
    sx = torch.rand(33, device=cuda) + 0.01
    sw = torch.rand(70, device=cuda) + 0.01
    torch.testing.assert_close(D.quant_matmul(xq, wq, sx, sw),
                               D.quant_matmul_plain(xq, wq, sx, sw), rtol=1e-6, atol=0)


@pytest.mark.parametrize("M,K,N,route", [
    (129, 65, 97, "dp4a"),            # ragged M, N and K
    (200, 4160, 136, "wgmma"),        # ragged M, N and K past a 128-byte K step
    (200, 136, 4160, "dp4a"),         # K % 16 == 8
    (96, 4096, 130, "dp4a"),          # N % 4 == 2
    (512, 512, 512, "wgmma"),         # whole 128-row tiles and 128-byte K steps
    (64, 49, 10, "dp4a"),             # the served dense layer, K = 49
    (16384, 49, 10, "dp4a"),
    (130, 16, 200, "wgmma"),          # one K step, mostly past K
])
def test_quant_matmul_is_exact_on_every_route_on_card(cuda, M, K, N, route):
    rng = np.random.default_rng(M + K + N)
    xq = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).to(cuda)
    wq = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8)).to(cuda)
    xq[M // 2], wq[:, N // 2] = -128, -128          # the largest products
    assert D.quant_matmul_route(xq, wq) == route
    reset_launches()
    got = D.quant_matmul(xq, wq, 1.0, 1.0)
    assert launches() == {"quant_matmul": 1}
    exact = xq.cpu().to(torch.int64) @ wq.cpu().to(torch.int64)
    assert torch.equal(got.cpu(), exact.to(torch.float32))
    assert float(got[M // 2, N // 2]) == 128 * 128 * K
    sx = torch.from_numpy(rng.uniform(1e-3, 0.1, M).astype(np.float32)).to(cuda)
    sw = torch.from_numpy(rng.uniform(1e-3, 0.1, N).astype(np.float32)).to(cuda)
    torch.testing.assert_close(D.quant_matmul(xq, wq, sx, sw),
                               D.quant_matmul_plain(xq, wq, sx, sw), rtol=1e-6, atol=0)


@pytest.mark.parametrize("backend,plain,per_step", [
    ("cuda", "ref", {"conv2d": 2, "maxpool2d": 2}),
    ("cuda_plan", "plan", {"conv2d": 2, "maxpool2d": 2, "sigmoid_pla": 1}),
    ("int8", "int8", {"quant_matmul": 1}),
])
def test_float_and_int8_apply_match_cpu_on_card(cuda, backend, plain, per_step):
    params = {k: {n: torch.tensor(a, dtype=torch.float32, device=cuda) for n, a in v.items()}
              for k, v in _numpy_params(5).items()}
    images = torch.from_numpy(synth_mnist.make_dataset(64, seed=6)[0]).to(cuda)
    reset_launches()
    got = smallnet.apply(params, images, backend=backend)
    assert launches() == per_step
    want = smallnet.apply(params, images.cpu(), backend=plain)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    if backend == "int8":           # the int8 words are the same on both devices
        be = TB.get_backend("int8")
        on_card = be.prepare_params(params)
        on_cpu = be.prepare_params({k: {n: a.cpu() for n, a in v.items()}
                                    for k, v in params.items()})
        for layer in ("conv1", "conv2", "dense"):
            assert torch.equal(on_card[layer]["w"].q.cpu(), on_cpu[layer]["w"].q)
            assert torch.equal(on_card[layer]["w"].scale.cpu(), on_cpu[layer]["w"].scale)
        assert torch.equal(got.cpu(), want)
