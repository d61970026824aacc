"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one.  They import no JAX, so they run on the GPU machine as they
are:  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
Words must be equal (tolerance 0).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import backends as TB  # noqa: E402
from repro_torch.core import fixed_point as tfxp  # noqa: E402
from repro_torch.core import smallnet  # noqa: E402
from repro_torch.data import synth_mnist  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.kernels.fixed_conv import ops as C  # noqa: E402
from repro_torch.kernels.quant_matmul import ops as D  # noqa: E402

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
