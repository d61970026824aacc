"""The port's config registry against the JAX reference's.

Every field of the ten full configs and of their `.smoke()` reductions
equals the reference's (the dtypes by name: `torch.bfloat16` for
`jnp.bfloat16`); the assigned table, the long-context skip rule, the
shape sets and `cells()` are the reference's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import smallnet as jsmallnet  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import smallnet as tsmallnet  # noqa: E402


def fields(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, torch.dtype):
            v = ("dtype", str(v).removeprefix("torch."))
        elif f.name in ("dtype", "param_dtype"):
            v = ("dtype", jnp.dtype(v).name)
        out[f.name] = v
    return out


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_every_field_equals_the_reference(arch, smoke):
    cfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    if smoke:
        cfg, jcfg = cfg.smoke(), jcfg.smoke()
    assert fields(cfg) == fields(jcfg)
    assert isinstance(cfg.dtype, torch.dtype) and isinstance(cfg.param_dtype, torch.dtype)
    assert (cfg.hd, cfg.vocab_padded) == (jcfg.hd, jcfg.vocab_padded)


def test_exact_assigned_configs():
    """The full (non-smoke) configs match the assignment table."""
    spec = {
        "llama3-405b": (126, 16384, 128, 8, 53248, 128256),
        "granite-3-2b": (40, 2048, 32, 8, 8192, 49155),
        "command-r-plus-104b": (64, 12288, 96, 8, 33792, 256000),
        "qwen2.5-14b": (48, 5120, 40, 8, 13824, 152064),
        "rwkv6-3b": (32, 2560, 40, 40, 8960, 65536),
        "qwen3-moe-235b-a22b": (94, 4096, 64, 4, 1536, 151936),
        "moonshot-v1-16b-a3b": (48, 2048, 16, 16, 1408, 163840),
        "whisper-tiny": (4, 384, 6, 6, 1536, 51865),
        "internvl2-2b": (24, 2048, 16, 8, 8192, 92553),
        "jamba-1.5-large-398b": (72, 8192, 64, 8, 24576, 65536),
    }
    for arch, (L, d, H, K, ff, V) in spec.items():
        cfg = tbase.get_config(arch)
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.d_ff, cfg.vocab) == (L, d, H, K, ff, V), arch
    moe = tbase.get_config("qwen3-moe-235b-a22b")
    assert (moe.n_experts, moe.top_k) == (128, 8)
    moon = tbase.get_config("moonshot-v1-16b-a3b")
    assert (moon.n_experts, moon.top_k) == (64, 6)
    jam = tbase.get_config("jamba-1.5-large-398b")
    assert (jam.n_experts, jam.top_k, jam.attn_period) == (16, 2, 8)


def test_long_context_skip_rule():
    """long_500k runs only for the sub-quadratic families."""
    expect = {"rwkv6-3b": True, "jamba-1.5-large-398b": True}
    for arch in tbase.ARCH_IDS:
        assert tbase.get_config(arch).supports_long_context() == expect.get(arch, False), arch


def test_shapes_cells_and_registry_equal_the_reference():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS and tbase.list_archs() == jbase.list_archs()
    assert {k: dataclasses.astuple(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}
    assert tbase.cells() == jbase.cells()
    assert len(tbase.cells()) == 32
    assert tsmallnet.SMALLNET == jsmallnet.SMALLNET
    with pytest.raises(ModuleNotFoundError):
        tbase.get_config("no-such-arch")
