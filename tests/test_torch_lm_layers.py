"""The port's LM layers against the JAX reference, on the CPU, in float32.

Both packages get the same numpy arrays; every output must agree within
rtol = atol = 1e-5 (float32, reduced in different orders), unless a test
says otherwise.  Covers the norms, RoPE, `linear` (float and QuantTensor),
both MLPs (the tanh GELU pinned), `embed` (float and int8), chunked and
unchunked attention, decode attention at a position inside the cache, at
its last slot and past it (no write), cross attention, MoE with tokens
dropped past capacity, the mamba and rwkv blocks with and without carried
state, and `chunked_scan` where T is not a multiple of the chunk.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import ptq as jptq  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import scan_utils as jscan  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import ptq as tptq  # noqa: E402
from repro_torch.core.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models import scan_utils as tscan  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from test_torch_lm_models import numpy_params  # noqa: E402

TOL = 1e-5


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def cfgs(arch):
    return tbase.get_config(arch).smoke(), jbase.get_config(arch).smoke()


def block(arch, key):
    """Layer 0's params of `key` under "blocks", both packages' copies."""
    cfg, jcfg = cfgs(arch)
    one = _index(numpy_params(cfg)["blocks"][key], 0)
    return cfg, jcfg, lm_params_from_jax(one, "cpu"), _jnp(one)


def _index(tree, i):
    return {k: _index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _jnp(tree):
    return {k: _jnp(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def t(a):
    return torch.from_numpy(np.asarray(a))


def test_norms():
    rng = np.random.default_rng(0)
    x, w, b = normal(rng, 3, 5, 64, scale=3.0), normal(rng, 64), normal(rng, 64)
    close(tlayers.rmsnorm(t(x), t(w)), jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    close(tlayers.layernorm(t(x), t(w), t(b)),
          jlayers.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    for kind, p in (("rmsnorm", {"w": w}), ("layernorm", {"w": w, "b": b})):
        close(tlayers.apply_norm(t(x), {k: t(v) for k, v in p.items()}, kind),
              jlayers.apply_norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                                 kind))


@pytest.mark.parametrize("pos_shape", ["S", "BS"])
def test_rope(pos_shape):
    rng = np.random.default_rng(1)
    x = normal(rng, 2, 12, 4, 16)
    pos = np.arange(12, dtype=np.int32) + 5
    if pos_shape == "BS":
        pos = np.stack([pos, pos * 3])
    close(tlayers.apply_rope(t(x), t(pos), 10000.0),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    close(tlayers.rope_freqs(16, 500000.0), jlayers.rope_freqs(16, 500000.0))


@pytest.mark.parametrize("quant", [False, True])
def test_linear(quant):
    rng = np.random.default_rng(2)
    x, w, b = normal(rng, 3, 4, 64), normal(rng, 64, 32, scale=0.1), normal(rng, 32)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    if quant:
        jp["w"] = jptq.quantize_tree({"w": jp["w"]})["w"]
    tp = lm_params_from_jax(jp, "cpu")
    assert isinstance(tp["w"], tptq.QuantTensor) == quant
    close(tlayers.linear(t(x), tp, torch.float32), jlayers.linear(jnp.asarray(x), jp,
                                                                  jnp.float32))


@pytest.mark.parametrize("kind", ["gated", "vanilla"])
def test_mlp(kind):
    rng = np.random.default_rng(3)
    x = normal(rng, 2, 5, 64)
    names = ("wi", "wg", "wo") if kind == "gated" else ("wi", "wo")
    shapes = {"wi": (64, 128), "wg": (64, 128), "wo": (128, 64)}
    p = {n: {"w": normal(rng, *shapes[n], scale=0.3)} for n in names}
    got = tlayers.mlp(t(x), lm_params_from_jax(p, "cpu"), kind, torch.float32)
    close(got, jlayers.mlp(jnp.asarray(x), _jnp(p), kind, jnp.float32))
    # the GELU is the tanh approximation, as jax.nn.gelu's default
    h = normal(rng, 1000, scale=3.0)
    close(tlayers.gelu(t(h)), jax.nn.gelu(jnp.asarray(h)))
    assert float((torch.nn.functional.gelu(t(h)) - tlayers.gelu(t(h))).abs().max()) > 1e-4


@pytest.mark.parametrize("quant", [False, True])
def test_embed(quant):
    rng = np.random.default_rng(4)
    w = normal(rng, 512, 64, scale=0.02)
    toks = rng.integers(0, 512, (3, 7)).astype(np.int32)
    jp = {"w": jnp.asarray(w)}
    if quant:
        jp = jptq.quantize_tree({"embed": jp})["embed"]
    tp = lm_params_from_jax(jp, "cpu")
    close(tlayers.embed(t(toks), tp, torch.float32),
          jlayers.embed(jnp.asarray(toks), jp, jnp.float32), 0.0)


@pytest.mark.parametrize("S,q_chunk,causal", [(16, 16, True), (16, 4, True), (12, 5, True),
                                              (16, 4, False)])
def test_causal_attention(S, q_chunk, causal):
    """One chunk, four, two of six rows (12 // 5), and non-causal chunked."""
    rng = np.random.default_rng(5)
    q, k, v = normal(rng, 2, S, 4, 16), normal(rng, 2, S, 2, 16), normal(rng, 2, S, 2, 16)
    close(tattn.causal_attention(t(q), t(k), t(v), q_chunk=q_chunk, causal=causal),
          jattn.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 q_chunk=q_chunk, causal=causal))


def test_causal_attention_rejects_an_uneven_split():
    q = torch.zeros(1, 10, 4, 16)
    k = torch.zeros(1, 10, 2, 16)
    with pytest.raises(ValueError):
        tattn.causal_attention(q, k, k, q_chunk=3)       # 10 rows in 3 chunks
    with pytest.raises(AssertionError):
        jattn.causal_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                               jnp.asarray(k.numpy()), q_chunk=3)


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2.5-14b"])
def test_attention_block(arch):
    cfg, jcfg, tp, jp = block(arch, "attn")
    rng = np.random.default_rng(6)
    x = normal(rng, 2, 16, 64)
    pos = np.arange(16)
    close(tattn.attention_block(t(x), tp, cfg, t(pos)),
          jattn.attention_block(jnp.asarray(x), jp, jcfg, jnp.asarray(pos)))


@pytest.mark.parametrize("pos", [3, 7, 8, 11])
def test_decode_attention_block(pos):
    """T = 8 slots: a step inside the cache, at its last slot, and past it
    (where neither package writes, and both attend over all eight)."""
    cfg, jcfg, tp, jp = block("granite-3-2b", "attn")
    rng = np.random.default_rng(7)
    x = normal(rng, 2, 1, 64)
    ck, cv = normal(rng, 2, 8, 2, 16), normal(rng, 2, 8, 2, 16)
    cache = tattn.KVCache(t(ck.copy()), t(cv.copy()))
    out, new = tattn.decode_attention_block(t(x), tp, cfg, cache, pos)
    jout, jnew = jattn.decode_attention_block(jnp.asarray(x), jp, jcfg,
                                              jattn.KVCache(jnp.asarray(ck), jnp.asarray(cv)),
                                              jnp.asarray(pos, jnp.int32))
    close(out, jout)
    close(new.k, jnew.k)
    close(new.v, jnew.v)
    assert new.k.data_ptr() == cache.k.data_ptr()           # written in place
    if pos >= 8:
        np.testing.assert_array_equal(new.k.numpy(), ck)


def test_cross_attention():
    cfg, jcfg, tp, jp = block("whisper-tiny", "cross")
    rng = np.random.default_rng(8)
    x, enc = normal(rng, 2, 5, 64), normal(rng, 2, 16, 64)
    ek, ev = tattn.encoder_kv(t(enc), tp, cfg)
    jek, jev = jattn.encoder_kv(jnp.asarray(enc), jp, jcfg)
    close(ek, jek)
    close(ev, jev)
    close(tattn.cross_attention_block(t(x), tp, cfg, ek, ev),
          jattn.cross_attention_block(jnp.asarray(x), jp, jcfg, jek, jev))


@pytest.mark.parametrize("arch,cf,group", [("qwen3-moe-235b-a22b", 1.25, 512),
                                           ("qwen3-moe-235b-a22b", 0.5, 512),
                                           ("moonshot-v1-16b-a3b", 0.5, 8),
                                           ("qwen3-moe-235b-a22b", 1.25, 2)])
def test_moe(arch, cf, group):
    """Capacity dispatch, with tokens dropped past capacity where cf = 0.5
    (C = 4 a group of 32 at top-2 of 8 experts; the test checks some
    expert's queue runs past it), and decode-sized groups."""
    cfg, jcfg, tp, jp = block(arch, "mlp")
    rng = np.random.default_rng(9)
    x = normal(rng, 2, 16, 64)
    y, aux = tmoe.moe_mlp(t(x), tp, cfg, group_size=group, capacity_factor=cf)
    jy, jaux = jmoe.moe_mlp(jnp.asarray(x), jp, jcfg, group_size=group, capacity_factor=cf)
    close(y, jy)
    close(aux, jaux)
    if cf < 1:
        g = tmoe._pick_group(32, group)
        C = max(1, int(g * cfg.top_k * cf / cfg.n_experts))
        probs = torch.softmax(t(x).reshape(-1, g, 64) @ tp["router"]["w"], -1)
        _, topi = tmoe.top_k(probs, cfg.top_k)
        counts = tmoe.one_hot(topi, cfg.n_experts, torch.int32).sum(dim=(1, 2))
        assert int(counts.max()) > C


def test_top_k_breaks_ties_toward_the_lower_index():
    p = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1]], np.float32)
    vals, idx = tmoe.top_k(t(p), 3)
    jv, ji = jax.lax.top_k(jnp.asarray(p), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    close(vals, jv, 0.0)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_block(with_state):
    cfg, jcfg, tp, jp = block("jamba-1.5-large-398b", "mamba")
    tp, jp = _index(tp, 2), {k: v[2] for k, v in jp.items()}    # the third mamba sublayer
    rng = np.random.default_rng(10)
    x = normal(rng, 2, 6, 64)
    state = None
    if with_state:
        state = {"conv": normal(rng, 2, 3, 128), "ssm": normal(rng, 2, 128, 16)}
    y, st = tmamba.mamba_block(t(x), tp, cfg,
                               state=None if state is None else {k: t(v) for k, v in
                                                                 state.items()})
    jy, jst = jmamba.mamba_block(jnp.asarray(x), jp, jcfg,
                                 state=None if state is None else _jnp(state))
    close(y, jy)
    close(st["conv"], jst["conv"])
    close(st["ssm"], jst["ssm"])


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_time_and_channel_mix(with_state):
    cfg, jcfg, tp, jp = block("rwkv6-3b", "rwkv")
    rng = np.random.default_rng(11)
    x = normal(rng, 2, 5, 64)
    kw, jkw, ckw, jckw = {}, {}, {}, {}
    if with_state:
        xp, s, xc = normal(rng, 2, 64), normal(rng, 2, 4, 16, 16), normal(rng, 2, 64)
        kw, jkw = dict(xprev_last=t(xp), state=t(s)), dict(xprev_last=jnp.asarray(xp),
                                                           state=jnp.asarray(s))
        ckw, jckw = dict(xprev_last=t(xc)), dict(xprev_last=jnp.asarray(xc))
    y, (xl, st) = trwkv.time_mix(t(x), tp, cfg, **kw)
    jy, (jxl, jst) = jrwkv.time_mix(jnp.asarray(x), jp, jcfg, **jkw)
    close(y, jy)
    close(xl, jxl, 0.0)
    close(st, jst)
    y, xl = trwkv.channel_mix(t(x), tp, cfg, **ckw)
    jy, jxl = jrwkv.channel_mix(jnp.asarray(x), jp, jcfg, **jckw)
    close(y, jy)
    close(xl, jxl, 0.0)


@pytest.mark.parametrize("T,chunk", [(10, 4), (7, 128), (12, 4)])
def test_chunked_scan(T, chunk):
    """The port's loop over time against the reference's chunked scan at a
    T its chunk does not divide (it shrinks the chunk to a divisor), one
    chunk, and an even split."""
    rng = np.random.default_rng(12)
    xs = (normal(rng, T, 3, 5), normal(rng, T, 3, 5, scale=0.5))
    h0 = normal(rng, 3, 5)

    def tstep(h, inp):
        a, b = inp
        h = torch.tanh(h * b + a)
        return h, h.sum(-1)

    def jstep(h, inp):
        a, b = inp
        h = jnp.tanh(h * b + a)
        return h, h.sum(-1)
    h, ys = tscan.chunked_scan(tstep, t(h0), tuple(map(t, xs)))
    jh, jys = jscan.chunked_scan(jstep, jnp.asarray(h0), tuple(map(jnp.asarray, xs)),
                                 chunk=chunk)
    close(h, jh)
    close(ys, jys)


def test_layer_indexes_quanttensor_words_and_scales():
    """`transformer.layer` picks layer i of a QuantTensor leaf: its words and
    its per-(layer, channel) scales, as the reference's tree_map does."""
    w = np.random.default_rng(13).standard_normal((3, 8, 4)).astype(np.float32)
    q = tptq.quantize_tree({"blocks": {"w": t(w)}})["blocks"]["w"]
    one = TT.layer({"w": q}, 1)["w"]
    assert torch.equal(one.q, q.q[1]) and torch.equal(one.scale, q.scale[1])
    assert one.scale.shape == (1, 4) and TT.n_stacked({"a": {"w": q}}) == 3
