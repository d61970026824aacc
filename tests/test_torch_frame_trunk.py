"""The port's whole-frame trunk against the JAX reference, word for word.

`repro_torch.kernels.frame_trunk.frame_trunk_quad_plain` (the untiled
PyTorch version of the CUDA kernel) is held against the reference's numpy
int64 oracle `frame_trunk/ref.py` and its Pallas kernel `frame_trunk_quad`
in interpret mode with forced tilings, on small frames of random words in
the three wraparound STANDARD_CONFIGS.  The port's wrapper on CPU tensors,
its geometry and saturation errors, and the Hopper tile chooser are
checked too.  Tolerance: exact int32 words.  The CUDA kernel itself is
checked by the card tests at the end (skipped without a card) and by
`chip_smoke.py`.  The JAX package is imported inside the tests that use
it, so that the card tests also run on a GPU machine without JAX:
`PYTHONPATH=src python -m pytest -q tests/test_torch_frame_trunk.py -k card`.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import fixed_point as tfxp  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.kernels.frame_trunk import ops as FT  # noqa: E402

WRAP = ("q16_16", "q16_16_trunc", "q8_8")
# the tiles choose_tile picks (named in kernels/frame_trunk/ops.py)
CHOSEN = {(112, 112): (4, 8), (512, 512): (32, 32), (1080, 1920): (40, 80)}
# wraparound configs that no specialised kernel covers: the generic one
GENERIC = {"q12_4": tfxp.FixedPointConfig(16, 4),
           "q8_8_trunc": tfxp.FixedPointConfig(16, 8, round_nearest=False)}
SHAPES = ((8, 8), (16, 12), (24, 16))
# the reference kernel in interpret mode costs seconds per call, so each
# shape meets it once, in its own config and forced tiling: together they
# cover the three configs, one tile, the minimal 4x4 tiling and a column
# split; the numpy oracle covers every (shape, config) pair
JAX_CASES = (((8, 8), "q16_16", (4, 4)),
             ((16, 12), "q16_16_trunc", (16, 4)),
             ((24, 16), "q8_8", None))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's frame_trunk wrapper, oracle and word formats."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import fixed_point as jfxp
    from repro.kernels.frame_trunk import frame_trunk_quad
    from repro.kernels.frame_trunk.ref import frame_trunk_quad_ref
    return types.SimpleNamespace(jnp=jnp, cfgs=jfxp.STANDARD_CONFIGS,
                                 quad=frame_trunk_quad, oracle=frame_trunk_quad_ref)


def _inputs(seed, shape, cfg):
    """Random words of the format for x, w1, b1, w2, b2, with max_int,
    min_int, INT32_MIN and INT32_MAX among the frame's words."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(cfg.min_int, cfg.max_int + 1, s, dtype=np.int64)
           for s in (shape, (4,), (1,), (4,), (1,))]
    out[0].reshape(-1)[:4] = (cfg.max_int, cfg.min_int, -2 ** 31, 2 ** 31 - 1)
    return [a.astype(np.int32) for a in out]


def _t(arrays):
    return [torch.from_numpy(np.asarray(a, np.int32)) for a in arrays]


@pytest.mark.parametrize("cfg_name", WRAP)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_quad_matches_numpy_oracle(ref, cfg_name, shape):
    cfg = tfxp.STANDARD_CONFIGS[cfg_name]
    args = _inputs(WRAP.index(cfg_name) * 10 + SHAPES.index(shape), shape, cfg)
    got = FT.frame_trunk_quad_plain(*_t(args), cfg=cfg)
    assert got.dtype == torch.int32 and got.shape == (4, shape[0] // 4, shape[1] // 4)
    np.testing.assert_array_equal(got.numpy(), ref.oracle(*args, ref.cfgs[cfg_name]))


@pytest.mark.parametrize("shape,cfg_name,tile", JAX_CASES)
def test_plain_quad_matches_jax_kernel(ref, shape, cfg_name, tile):
    cfg = tfxp.STANDARD_CONFIGS[cfg_name]
    args = _inputs(WRAP.index(cfg_name) * 10 + SHAPES.index(shape), shape, cfg)
    got = FT.frame_trunk_quad_plain(*_t(args), cfg=cfg)
    want = ref.quad(ref.jnp.asarray(args[0]), *args[1:], cfg=ref.cfgs[cfg_name],
                    tile=tile, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cfg_name", WRAP)
def test_wrapper_on_cpu_tensors_is_the_plain_version_for_every_tile(cfg_name):
    cfg = tfxp.STANDARD_CONFIGS[cfg_name]
    args = _t(_inputs(7, (24, 20), cfg))
    want = FT.frame_trunk_quad_plain(*args, cfg=cfg)
    reset_launches()
    for tile in (None, (4, 4), (24, 20), (8, 4), (12, 20)):
        assert torch.equal(FT.frame_trunk_quad(*args, cfg=cfg, tile=tile), want)
    # (2,2,1,1) taps as the backends hold them give the same words
    w1, w2 = args[1].reshape(2, 2, 1, 1), args[3].reshape(2, 2, 1, 1)
    assert torch.equal(FT.frame_trunk_quad(args[0], w1, args[2], w2, args[4], cfg=cfg), want)
    assert launches() == {}                     # no kernel on CPU tensors


def test_rejects_bad_geometry_tiles_and_saturation_like_the_reference(ref):
    cfg = tfxp.Q16_16
    w = torch.ones(4, dtype=torch.int32)
    b = torch.zeros(1, dtype=torch.int32)
    for shape in ((15, 16), (16, 18), (2, 16), (16, 2)):
        x = torch.zeros(shape, dtype=torch.int32)
        with pytest.raises(ValueError, match="frame") as got:
            FT.frame_trunk_quad(x, w, b, w, b, cfg=cfg)
        with pytest.raises(ValueError, match="frame") as want:
            ref.quad(ref.jnp.zeros(shape, ref.jnp.int32), w.numpy(), b.numpy(),
                     w.numpy(), b.numpy(), cfg=ref.cfgs["q16_16"], interpret=True)
        assert str(got.value) == str(want.value)
    x = torch.zeros((16, 16), dtype=torch.int32)
    for tile in ((5, 4), (4, 6), (12, 4), (4, 12), (2, 2)):
        with pytest.raises(ValueError, match="tile"):
            FT.frame_trunk_quad(x, w, b, w, b, cfg=cfg, tile=tile)
    big = torch.zeros((480, 480), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        FT.frame_trunk_quad(big, w, b, w, b, cfg=cfg, tile=(240, 240))
    with pytest.raises(ValueError, match="shared memory"):   # ~228 KB > 227 KB
        FT.frame_trunk_quad(torch.zeros((168, 168), dtype=torch.int32), w, b, w, b,
                            cfg=cfg, tile=(168, 168))
    for sat in ("q16_16_sat", "q8_8_sat"):
        with pytest.raises(NotImplementedError, match="wraparound"):
            FT.frame_trunk_quad(x, w, b, w, b, cfg=tfxp.STANDARD_CONFIGS[sat])
        with pytest.raises(NotImplementedError, match="wraparound"):
            FT.frame_trunk_quad_plain(x, w, b, w, b, cfg=tfxp.STANDARD_CONFIGS[sat])
    with pytest.raises(TypeError, match="int32"):
        FT.frame_trunk_quad(x.to(torch.int64), w, b, w, b, cfg=cfg)
    with pytest.raises(ValueError, match="4 words"):
        FT.frame_trunk_quad(x, torch.ones(3, dtype=torch.int32), b, w, b, cfg=cfg)


@pytest.mark.parametrize("frame", [(112, 112), (512, 512), (1080, 1920), (104, 132),
                                   (28, 28), (8, 8), (720, 1280), (36, 1000)])
def test_choose_tile_is_deterministic_and_fits_shared_memory(frame):
    H, W = frame
    th, tw = FT.choose_tile(H, W)
    FT.choose_tile.cache_clear()
    assert FT.choose_tile(H, W) == (th, tw)
    assert th % 4 == 0 and tw % 4 == 0 and H % th == 0 and W % tw == 0
    assert FT.frame_trunk_smem_bytes(th, tw) <= FT.SMEM_MAX
    want = min(FT.N_SM, (H // 4) * (W // 4))
    assert (H // th) * (W // tw) >= want
    # no other tile within the opt-in limit and the block count has a lower
    # estimated cost
    best = FT._tile_cost(H, W, th, tw)
    for a in range(4, H + 1, 4):
        for c in range(4, W + 1, 4):
            if (H % a or W % c or FT.frame_trunk_smem_bytes(a, c) > FT.SMEM_MAX
                    or (H // a) * (W // c) < want):
                continue
            assert FT._tile_cost(H, W, a, c) >= best


def test_choose_tile_values_named_in_the_module_note():
    assert FT.choose_tile(112, 112) == CHOSEN[(112, 112)]
    assert FT.choose_tile(512, 512) == CHOSEN[(512, 512)]
    assert FT.choose_tile(1080, 1920) == CHOSEN[(1080, 1920)]
    assert FT.frame_trunk_smem_bytes(4, 4) == 368
    assert FT.frame_trunk_smem_bytes(112, 112) == 105344       # opts in: > 48 KB
    assert FT.frame_trunk_smem_bytes(168, 168) == 233248       # > SMEM_MAX


@pytest.mark.parametrize("tile,fits", [((112, 112), True), ((164, 164), True),
                                       ((168, 168), False), ((4, 1000), True)])
def test_check_tile_takes_tiles_up_to_the_opt_in_limit(tile, fits):
    H, W = tile[0] * 2, tile[1] * 2
    assert (FT.frame_trunk_smem_bytes(*tile) <= FT.SMEM_MAX) == fits
    if fits:
        assert FT._check_tile(tile, H, W) == tile
    else:
        with pytest.raises(ValueError, match="at most 232448 B"):
            FT._check_tile(tile, H, W)


def test_wrapper_takes_a_tile_above_48kb_on_cpu_tensors():
    cfg = tfxp.Q16_16
    args = _t(_inputs(11, (112, 112), cfg))
    assert FT.frame_trunk_smem_bytes(112, 112) > 48 * 1024
    assert torch.equal(FT.frame_trunk_quad(*args, cfg=cfg, tile=(112, 112)),
                       FT.frame_trunk_quad_plain(*args, cfg=cfg))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the frame_trunk kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("cfg_name", WRAP)
def test_frame_trunk_kernel_matches_plain_on_card(cuda, cfg_name):
    cfg = tfxp.STANDARD_CONFIGS[cfg_name]
    for (H, W), tiles in (((112, 112), (None, (4, 4), (28, 56))),
                          ((104, 132), (None, (8, 12))), ((16, 12), (None, (16, 4)))):
        args = [t.to(cuda) for t in _t(_inputs(H + W, (H, W), cfg))]
        want = FT.frame_trunk_quad_plain(*args, cfg=cfg)
        for tile in tiles:
            reset_launches()
            got = FT.frame_trunk_quad(*args, cfg=cfg, tile=tile)
            assert launches() == {"frame_trunk": 1}
            assert torch.equal(got, want), (H, W, tile)


@pytest.mark.parametrize("cfg_name", WRAP + tuple(GENERIC))
def test_frame_trunk_kernel_matches_plain_above_48kb_on_card(cuda, cfg_name):
    cfg = tfxp.STANDARD_CONFIGS.get(cfg_name) or GENERIC[cfg_name]
    for (H, W), tiles in (((112, 112), (None, (112, 112), (56, 112))),
                          ((336, 328), (None, (168, 164), (112, 164)))):
        args = [t.to(cuda) for t in _t(_inputs(H * W % 97, (H, W), cfg))]
        want = FT.frame_trunk_quad_plain(*args, cfg=cfg)
        for tile in tiles:
            if tile is not None:
                assert FT.frame_trunk_smem_bytes(*tile) > 48 * 1024
            got = FT.frame_trunk_quad(*args, cfg=cfg, tile=tile)
            assert torch.equal(got, want), (cfg_name, H, W, tile)
