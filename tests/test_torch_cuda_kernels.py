"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one.  They import no JAX, so they run on the GPU machine as they
are:  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
The whole-net routes: `fixed_smallnet` at B = 1, 63, 64 and 16384 in all
five formats and `float_smallnet` at the same batches with both
activations; `fixed_dense` on its rows and generic routes;
`fixed_window_head` at 112x112, 56x84 and 1080x1920 frames; the tiled
`conv2d` at its tile edges, and the direct kernel it keeps for convs no
tile fits; `float_sweep_stage`, the float sweep's stage in one launch,
against its plain version, and the float sweep's default route (its
window head in one `float_window_head` launch) against its composed
cascade at 28x28, 112x112 and 720x1280 with both activations.
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
from repro_torch.kernels.conv2d import float_sweep_stage, float_sweep_stage_plain  # noqa: E402
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
    assert launches() == {"fixed_smallnet": 1}             # the served step, one launch
    want = smallnet.apply(params, images.cpu(), backend=TB.FixedBackend(cfg=cfg))
    assert torch.equal(got.cpu(), want)


def test_net_scores_routes_on_what_the_kernel_takes_on_card(cuda):
    """31x29 images pool to the dense layer's 7x7: one whole-net launch; a
    batch past the kernel's shared memory (200x200 images, a (2500, 10)
    dense layer) composes the stages."""
    be = TB.get_backend("fixed_cuda")
    params = {k: {n: torch.tensor(a, dtype=torch.float32) for n, a in v.items()}
              for k, v in _numpy_params(5).items()}
    images = torch.rand((6, 31, 29, 1), generator=torch.Generator().manual_seed(5))
    reset_launches()
    got = smallnet.apply(params, images.to(cuda), backend=be)
    assert launches() == {"fixed_smallnet": 1}
    assert torch.equal(got.cpu(), smallnet.apply(params, images, backend="fixed", device="cpu"))
    big = be.prepare_params(dict(params, dense={"w": torch.zeros((2500, 10)),
                                                "b": torch.zeros(10)}), cuda)
    assert be.net_scores(torch.zeros((1, 200, 200, 1), device=cuda), big) is None


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
    ("cuda", "ref", {"float_smallnet": 1}),              # the served step, one launch
    ("cuda_plan", "plan", {"float_smallnet": 1}),
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


def _smallnet_args(rng, B, H, W, N, cfg, device):
    K = (H // 4) * (W // 4)
    return [_words(rng, shape, cfg, device)
            for shape in ((B, H, W), (4,), (1,), (4,), (1,), (K, N), (N,))]


@pytest.mark.parametrize("cfg_name", CONFIGS)
@pytest.mark.parametrize("B,H,W,N", [(1, 28, 28, 10), (63, 28, 28, 10), (64, 28, 28, 10),
                                     (16384, 28, 28, 10), (3, 37, 53, 10), (2, 9, 8, 16)])
def test_fixed_smallnet_matches_plain_on_card(cuda, cfg_name, B, H, W, N):
    cfg = tfxp.STANDARD_CONFIGS[cfg_name]
    args = _smallnet_args(np.random.default_rng(B + H), B, H, W, N, cfg, cuda)
    reset_launches()
    got = C.fixed_smallnet(*args, cfg=cfg)
    assert launches() == {"fixed_smallnet": 1}
    assert torch.equal(got, C.fixed_smallnet_plain(*args, cfg=cfg))


@pytest.mark.parametrize("cfg_name", CONFIGS)
@pytest.mark.parametrize("M,K,N", [(64, 49, 10), (16384, 49, 10), (31654, 49, 10), (130, 49, 16),
                                   (65, 49, 11), (64, 49, 20), (100, 900, 10), (3, 7, 5)])
def test_fixed_dense_routes_match_plain_on_card(cuda, cfg_name, M, K, N):
    """Each shape on the route its launcher picks (rows for N <= 16 and K
    within the shared memory, generic for (64,49,20) and (100,900,10))."""
    cfg = tfxp.STANDARD_CONFIGS[cfg_name]
    rng = np.random.default_rng(M + K + N)
    x, w, b = _words(rng, (M, K), cfg, cuda), _words(rng, (K, N), cfg, cuda), \
        _words(rng, (N,), cfg, cuda)
    reset_launches()
    assert torch.equal(D.fixed_dense(x, w, b, cfg=cfg), D.fixed_dense_plain(x, w, b, cfg=cfg))
    assert launches() == {"fixed_dense": 1}
    xo = _words(rng, (M * K + 1,), cfg, cuda)[1:].reshape(M, K)    # not 16-byte aligned
    assert torch.equal(D.fixed_dense(xo, w, b, cfg=cfg), D.fixed_dense_plain(xo, w, b, cfg=cfg))


@pytest.mark.parametrize("K,N,route", [(49, 10, "rows"), (49, 16, "rows"), (49, 1, "rows"),
                                       (49, 17, "generic"), (900, 10, "generic"),
                                       (7, 5, "rows"), (700, 10, "rows"), (49, 20, "generic")])
def test_fixed_dense_route_on_card(cuda, K, N, route):
    assert D.fixed_dense_route(K, N) == route


def test_whole_net_fits_on_card(cuda):
    """`smallnet_fits` is the launcher's own rule, and the wrapper raises
    ValueError where it says no."""
    assert C.smallnet_fits(28, 28, 10) and C.smallnet_fits(4, 4, 1)
    assert C.smallnet_fits(160, 160, 10)
    assert not C.smallnet_fits(200, 200, 10) and not C.smallnet_fits(3, 28, 10)
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=cuda)      # noqa: E731
    with pytest.raises(ValueError, match="cannot take"):
        C.fixed_smallnet(z(1, 200, 200), z(4), z(1), z(4), z(1), z(2500, 10), z(10))


@pytest.mark.parametrize("cfg_name", CONFIGS)
@pytest.mark.parametrize("H,W", [(112, 112), (56, 84), (1080, 1920)])
def test_fixed_window_head_matches_plain_on_card(cuda, cfg_name, H, W):
    from repro_torch.streaming import FcnSweep
    from repro_torch.streaming.fcn_sweep import _window_origins
    cfg = tfxp.STANDARD_CONFIGS[cfg_name]
    rng = np.random.default_rng(H + W)
    pos = tuple(FcnSweep(stride=8).positions((H, W)))
    gy, gx = _window_origins(28, pos, (H // 4, W // 4), cuda)
    quad = _words(rng, (4, H // 4, W // 4), cfg, cuda)
    for N in (10, 16):
        w, b = _words(rng, (49, N), cfg, cuda), _words(rng, (N,), cfg, cuda)
        reset_launches()
        got = D.fixed_window_head(quad, gy, gx, w, b, cfg=cfg)
        assert launches() == {"fixed_window_head": 1}
        assert torch.equal(got, D.fixed_window_head_plain(quad, gy, gx, w, b, cfg=cfg)), N
    with pytest.raises(ValueError, match="cannot take"):
        D.fixed_window_head(quad, gy, gx, _words(rng, (49, 17), cfg, cuda),
                            _words(rng, (17,), cfg, cuda), cfg=cfg)


@pytest.mark.parametrize("megakernel,per_frame", [
    (None, {"frame_trunk": 1, "fixed_window_head": 1}),
    (False, {"fixed_conv2d": 20, "fixed_maxpool2x2": 2, "fixed_sigmoid": 12, "fixed_dense": 1}),
])
def test_swept_frame_launches_on_card(cuda, megakernel, per_frame):
    from repro_torch.streaming import FcnSweep, SyntheticVideoSource
    params = _numpy_params(7)
    frame = SyntheticVideoSource(n_frames=1, seed=7).frames()[0]
    sweep = FcnSweep(stride=8, megakernel=megakernel)
    fb, _ = sweep.extract(frame)
    want = sweep.score(params, fb, backend="fixed", device="cpu")
    reset_launches()
    got = sweep.score(params, fb, backend="fixed_cuda", device="cuda")
    assert launches() == per_frame
    np.testing.assert_array_equal(got, want)


def test_window_past_the_maps_traps_on_card(cuda):
    """A window past the maps stops the head kernel with a CUDA error (a
    trap poisons the process's CUDA context, so it runs in a child)."""
    import os
    import pathlib
    import subprocess
    import sys
    probe = (
        "import torch\n"
        "from repro_torch.kernels.quant_matmul import ops as D\n"
        "z = torch.zeros((4, 28, 28), dtype=torch.int32, device='cuda')\n"
        "g = torch.tensor([0, 22], dtype=torch.int32, device='cuda')\n"
        "w = torch.zeros((49, 10), dtype=torch.int32, device='cuda')\n"
        "b = torch.zeros(10, dtype=torch.int32, device='cuda')\n"
        "D.fixed_window_head(z, g, g, w, b)\n"
        "torch.cuda.synchronize()\n"
        "print('no error')\n")
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "no error" not in out.stdout, out.stdout


@pytest.mark.parametrize("activation,per_step", [
    ("sigmoid", {"conv2d": 2, "maxpool2d": 2}),
    ("plan", {"conv2d": 2, "maxpool2d": 2, "sigmoid_pla": 1}),
])
def test_composed_float_step_launches_on_card(cuda, activation, per_step):
    """Without its whole-net launch a float step composes the per-stage
    kernels, with the same scores within 2e-5."""
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class Composed(TB.CudaFloatBackend):
        name: str = "cuda_composed"

        def net_scores(self, images, p):
            return None

    params = {k: {n: torch.tensor(a, dtype=torch.float32, device=cuda) for n, a in v.items()}
              for k, v in _numpy_params(5).items()}
    images = torch.from_numpy(synth_mnist.make_dataset(64, seed=6)[0]).to(cuda)
    be = Composed(activation=activation)
    reset_launches()
    got = smallnet.apply(params, images, backend=be)
    assert launches() == per_step
    whole = smallnet.apply(params, images, backend=TB.CudaFloatBackend(activation=activation))
    torch.testing.assert_close(got, whole, rtol=2e-5, atol=2e-5)


def _float_net_args(rng, B, H, W, N, device):
    K = (H // 4) * (W // 4)
    shapes = ((B, H, W, 1), (2, 2, 1, 1), (1,), (2, 2, 1, 1), (1,), (K, N), (N,))
    scales = (1.0, 0.8, 0.5, 0.8, 0.5, 0.3, 0.5)
    return [torch.from_numpy((rng.normal(size=s) * c).astype(np.float32)).to(device)
            for s, c in zip(shapes, scales)]


@pytest.mark.parametrize("activation", ["sigmoid", "plan"])
@pytest.mark.parametrize("B,H,W,N", [(1, 28, 28, 10), (63, 28, 28, 10), (64, 28, 28, 10),
                                     (16384, 28, 28, 10), (3, 37, 53, 10), (2, 32, 24, 10)])
def test_float_smallnet_matches_plain_on_card(cuda, activation, B, H, W, N):
    from repro_torch.kernels.conv2d import float_smallnet, float_smallnet_plain
    args = _float_net_args(np.random.default_rng(B + H), B, H, W, N, cuda)
    reset_launches()
    got = float_smallnet(*args, activation=activation)
    assert launches() == {"float_smallnet": 1}
    torch.testing.assert_close(got, float_smallnet_plain(*args, activation=activation),
                               rtol=2e-5, atol=2e-5)


def test_float_smallnet_fits_on_card(cuda):
    """`float_smallnet_fits` is the launcher's own rule, and the wrapper
    raises ValueError where it says no; `net_scores` then composes."""
    from repro_torch.kernels.conv2d import float_smallnet, float_smallnet_fits
    assert float_smallnet_fits(28, 28, 10) and float_smallnet_fits(4, 4, 1)
    assert not float_smallnet_fits(200, 200, 10) and not float_smallnet_fits(3, 28, 10)
    z = lambda *s: torch.zeros(s, device=cuda)          # noqa: E731
    with pytest.raises(ValueError, match="cannot take"):
        float_smallnet(z(1, 200, 200, 1), z(2, 2, 1, 1), z(1), z(2, 2, 1, 1), z(1), z(2500, 10),
                       z(10))
    be = TB.get_backend("cuda_plan")
    big = be.prepare_params({"conv1": {"w": z(2, 2, 1, 1), "b": z(1)},
                             "conv2": {"w": z(2, 2, 1, 1), "b": z(1)},
                             "dense": {"w": z(2500, 10), "b": z(10)}}, cuda)
    assert be.net_scores(z(1, 200, 200, 1), big) is None


@pytest.mark.parametrize("B,H,W,ci,co,kh,kw,pad,stride", [
    (2, 37, 53, 3, 17, 2, 2, "SAME", 1),       # extents off the tile, Cin 3, Cout 17
    (1, 41, 35, 3, 16, 3, 3, "SAME", 3),       # stride 3, Cout 16 (four a thread)
    (1, 41, 35, 3, 3, 3, 3, "VALID", 3),       # Cout 3
    (3, 29, 31, 1, 3, 2, 2, "SAME", 2),
    (2, 37, 53, 1, 1, 2, 2, "SAME", 1),        # Cout 1, 4-byte copies
    (16384, 28, 28, 1, 1, 2, 2, "SAME", 1),    # a large batch of served images
    (1, 512, 512, 1, 16, 2, 2, "SAME", 2),
    (1, 5, 6, 1100, 4, 2, 2, "SAME", 1),       # no tile fits: the direct kernel
])
def test_tiled_conv2d_matches_plain_on_card(cuda, B, H, W, ci, co, kh, kw, pad, stride):
    import torch.nn.functional as F
    from repro_torch.kernels.conv2d import conv2d_tile
    rng = np.random.default_rng(H + W + co)
    x = torch.from_numpy(rng.normal(size=(B, H, W, ci)).astype(np.float32) * 3).to(cuda)
    w = torch.from_numpy(rng.normal(size=(kh, kw, ci, co)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.normal(size=(co,)).astype(np.float32)).to(cuda)
    if ci > 64:     # thousands of products a sum, in cuDNN's own order: positive terms
        x, w = x.abs(), w.abs()
    assert (conv2d_tile(x.shape, w.shape, stride=stride, padding=pad) is None) == (ci == 1100)
    for act in (None, "sigmoid", "plan"):
        kw_ = dict(padding=pad, stride=stride, activation=act)
        reset_launches()
        got = conv2d(x, w, b, **kw_)
        assert launches() == {"conv2d": 1}
        torch.testing.assert_close(got, conv2d_plain(x, w, b, **kw_), rtol=2e-5, atol=2e-5)
    # F.conv2d in full float32, SAME's bottom/right zeros padded explicitly
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        xc = x.permute(0, 3, 1, 2)
        if pad == "SAME":
            xc = F.pad(xc, (0, kw - 1, 0, kh - 1))
        lib = F.conv2d(xc, w.permute(3, 2, 0, 1), b, stride=stride).permute(0, 2, 3, 1)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    torch.testing.assert_close(conv2d(x, w, b, padding=pad, stride=stride), lib,
                               rtol=2e-5, atol=2e-5)


def _float_params(seed):
    return {k: {n: a.astype(np.float32) for n, a in v.items()}
            for k, v in _numpy_params(seed).items()}


@pytest.mark.parametrize("activation", ["plan", "sigmoid"])
@pytest.mark.parametrize("h,w", [(2, 2), (28, 28), (60, 44), (18, 130), (720, 1280)])
def test_float_sweep_stage_matches_plain_on_card(cuda, activation, h, w):
    """Both levels, one launch a stage: within 2e-5 of the plain version on
    the card and on the CPU (the kernel's taps chain in FMAs, as the tiled
    conv2d's do; the plain version rounds each product); the shapes cross
    the kernel's 8x32 blocks of pooled positions."""
    rng = np.random.default_rng(h * 7 + w)
    p = _float_params(11)["conv2"]
    wt, bt = (torch.from_numpy(p[n]).to(cuda) for n in ("w", "b"))
    maps = [torch.from_numpy(rng.uniform(0, 1, (1, h, w, 1)).astype(np.float32)).to(cuda)
            for _ in range(4)]
    for quad in ((maps[0],) * 4, tuple(maps)):
        reset_launches()
        got = float_sweep_stage(quad, wt, bt, activation=activation)
        torch.cuda.synchronize()
        assert launches() == {"float_sweep_stage": 1}
        assert got.shape == (4, h // 2, w // 2)
        want = float_sweep_stage_plain(quad, wt, bt, activation=activation)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        on_cpu = float_sweep_stage_plain(tuple(m.cpu() for m in quad), wt.cpu(), bt.cpu(),
                                         activation=activation)
        torch.testing.assert_close(got.cpu(), on_cpu, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(28, 28), (112, 112), (720, 1280)])
@pytest.mark.parametrize("backend,plain,default,composed", [
    ("cuda_plan", "plan", {"float_sweep_stage": 2, "float_window_head": 1},
     {"conv2d": 20, "maxpool2d": 2, "sigmoid_pla": 12}),
    ("cuda", "ref", {"float_sweep_stage": 2, "float_window_head": 1},
     {"conv2d": 20, "maxpool2d": 2}),
])
def test_float_sweep_routes_match_on_card(cuda, shape, backend, plain, default, composed):
    """The float sweep's default route (one `float_sweep_stage` launch a
    stage, one `float_window_head`) against the composed cascade
    (`megakernel=False`) on the card: role maps and window scores within
    SWEEP_TOL, 2e-5 (the stage kernel rounds as the cascade does, the head
    sums in another order than cuBLAS); both within 2e-5 of the plain
    sweep on the CPU; 3 launches a frame on the default route on both
    backends, and 34 on the composed one on `cuda_plan` (22 on `cuda`,
    whose composed head's sigmoid is torch's)."""
    from repro_torch.streaming import FcnSweep, SyntheticVideoSource
    from repro_torch.streaming import fcn_sweep as fs
    params = _float_params(7)
    frame = SyntheticVideoSource(n_frames=1, seed=7, frame_shape=shape).frames()[0]
    maps = {mk: fs.sweep_feature_maps(params, frame.pixels, backend=backend, megakernel=mk,
                                      device=cuda) for mk in (None, False)}
    gaps = {name: float(np.abs(maps[None][name] - maps[False][name]).max()) for name in fs.MAPS}
    assert max(gaps.values()) <= 2e-5, gaps
    fb, _ = FcnSweep(stride=8).extract(frame)
    want = FcnSweep(stride=8).score(params, fb, backend=plain, device="cpu")
    scores = {}
    for mk, per_frame in ((None, default), (False, composed)):
        reset_launches()
        scores[mk] = FcnSweep(stride=8, megakernel=mk).score(params, fb, backend=backend,
                                                             device=cuda)
        assert launches() == per_frame, mk
        np.testing.assert_allclose(scores[mk], want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(scores[None], scores[False], rtol=2e-5, atol=2e-5)
    with pytest.raises(NotImplementedError, match="no frame_trunk"):
        FcnSweep(stride=8, megakernel=True).score(params, fb, backend=backend, device=cuda)
