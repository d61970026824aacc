"""Kimi Linear's block (the port's "kda_mla_moe" family) against its plain
reference, `models/kimi_linear_ref.py`, at a small size on the CPU with the
block's structure kept: d 64, KDA with 2 heads of 16 and convolutions of
4, MLA with 4 heads (latent rank 32, nope 16, the unrotated pe 8, v 16),
8 experts top-2 and 1 shared, the first layer dense; 5 layers, KDA at
0, 1, 2 and 4 and MLA at 3 (or Kimi's own 27-layer pattern where a test
counts spans), on seeded random float32 weights.

Tolerances: both sides compute in float32 on the CPU, in other orders of
summation (the port runs KDA in chunks of 64 and sorts the routed pairs
into a padded batch; the reference steps the recurrence token by token
and loops over experts); logits of magnitude ~4 then differ by ~5e-5
after 5 layers.  `ATOL` 2e-4 allows that with margin and is ~1e3 times
under the gap a dropped expert, a stale state or a wrong convolution tail
makes.  The chunked recurrence against the per-token one: values of
magnitude ~0.5 differ by ~1e-6; 1e-5.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import base
from repro_torch.kernels import kda as KK
from repro_torch.models import kimi_linear_ref as R
from repro_torch.models import moe, transformer
from repro_torch.obs import trace
from repro_torch.serving.engine import Engine, Request

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 2e-4


def small(**kw):
    d = dict(n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab=512, head_dim=24,
             n_experts=8, top_k=2, experts_held=0, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, moe_d_ff=32, n_shared_experts=1,
             first_dense_layers=1, q_chunk=8, kda_layers=(0, 1, 2, 4), kda_heads=2,
             kda_head_dim=16, dtype=torch.float32, param_dtype=torch.float32)
    d.update(kw)
    return dataclasses.replace(base.get_config("kimi-linear-48b-a3b"), **d)


def arch(cfg) -> dict:
    """The published config's keys the reference reads."""
    return {"num_attention_heads": cfg.n_heads, "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim, "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "rms_norm_eps": cfg.norm_eps,
            "num_experts_per_token": cfg.top_k, "moe_renormalize": cfg.norm_topk_prob,
            "routed_scaling_factor": cfg.routed_scale, "expert_offset": cfg.expert_offset,
            "linear_attn_config": {"kda_layers": [i + 1 for i in cfg.kda_layers],
                                   "num_heads": cfg.kda_heads, "head_dim": cfg.kda_head_dim,
                                   "short_conv_kernel_size": cfg.short_conv_kernel_size}}


@pytest.fixture(scope="module")
def model():
    cfg = small()
    params, _ = transformer.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    return cfg, params


def tokens(n, seed=0, vocab=512):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, size=n))


def reference(cfg, params, seq, want=None, module=R, chunked=False):
    return module.logits(params, arch(cfg), [seq], None if want is None else [want],
                         chunked=chunked)[0]


def recurrence_inputs(B, T, H, K, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(B, T, H, K, generator=g), dim=-1) * K ** -0.5
    k = torch.nn.functional.normalize(torch.randn(B, T, H, K, generator=g), dim=-1)
    v = torch.randn(B, T, H, K, generator=g)
    # decays from ~1 to e^-20 a step: products over a chunk underflow float32
    decay = -torch.rand(B, T, H, K, generator=g) * 20 * (torch.rand(B, T, H, 1, generator=g) < 0.5)
    return q, k, v, decay, torch.rand(B, T, H, generator=g)


# -- the configuration -----------------------------------------------------------

def test_the_config_has_the_published_values():
    c = base.get_config("kimi-linear-48b-a3b")
    assert isinstance(c, base.HybridLatentMoEConfig) and c.family == "kda_mla_moe"
    assert (c.n_layers, c.d_model, c.n_heads, c.d_ff, c.vocab) == (27, 2304, 32, 9216, 163840)
    assert [i + 1 for i in c.kda_layers] == [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18,
                                            19, 21, 22, 23, 25, 26]
    assert (c.kda_heads, c.kda_head_dim, c.short_conv_kernel_size) == (32, 128, 4)
    assert (c.kv_lora_rank, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim) == \
        (512, 128, 64, 128)
    assert c.mla_rope is False
    assert (c.n_experts, c.top_k, c.moe_d_ff, c.n_shared_experts, c.first_dense_layers) == \
        (256, 8, 1024, 1, 1)
    assert (c.experts_held, c.expert_offset, c.n_held) == (128, 0, 128)
    assert (c.router_scoring, c.routed_scale, c.norm_topk_prob, c.norm_eps) == \
        ("sigmoid", 2.446, True, 1e-5)
    assert (c.context_length, c.tie_embeddings) == (1048576, False)
    assert c.dtype == c.param_dtype == torch.bfloat16 and c.router_dtype == torch.float32
    assert "kimi-linear-48b-a3b" not in base.ARCH_IDS
    assert "kda_mla_moe" in transformer.PER_SLOT_POSITIONS


def test_the_cut_holds_half_the_experts_and_every_width():
    """25.57 B params with 128 of 256 experts held; the cache at 64 slots
    of 8448 as the cell holds it."""
    c = base.get_config("kimi-linear-48b-a3b")
    params, _ = transformer.init_params(c, device="meta")
    n = sum(t.numel() for t in all_leaves(params))
    assert round(n / 1e9, 2) == 25.57
    moe_p = params["blocks"]["mlp"]
    assert tuple(moe_p["router"]["w"].shape) == (26, 2304, 256)
    assert tuple(moe_p["wi"].shape) == (26, 128, 2304, 1024)
    cache = transformer.init_cache_shape(c, 64, 8448)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "ckv": (7, 64, 8448, 512), "kpe": (7, 64, 8448, 64),
        "kda_state": (20, 64, 32, 128, 128), "kda_conv": (20, 64, 3, 12288)}
    assert cache["kda_state"].dtype == torch.float32
    whole, _ = transformer.init_params(dataclasses.replace(c, experts_held=0), device="meta")
    assert round(sum(t.numel() for t in all_leaves(whole)) / 1e9, 1) == 49.1


def all_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from all_leaves(v)
    else:
        yield tree


# -- the recurrence ------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 5, 63, 65, 130])
def test_the_chunked_prefill_is_the_recurrence(T):
    q, k, v, g, beta = recurrence_inputs(2, T, 3, 16, seed=T)
    o, state = KK.kda_chunk_prefill_plain(q, k, v, g, beta)
    want = torch.stack([R.recurrence(q[b], k[b], v[b], g[b], beta[b]) for b in range(2)])
    torch.testing.assert_close(o, want, rtol=0, atol=1e-5)
    st = torch.zeros(2, 3, 16, 16)
    steps = [KK.kda_decode_step_plain(q[:, t], k[:, t], v[:, t], g[:, t], beta[:, t], st)
             for t in range(T)]
    torch.testing.assert_close(torch.stack(steps, 1), want, rtol=0, atol=1e-5)
    torch.testing.assert_close(state, st, rtol=0, atol=1e-5)


@pytest.mark.parametrize("T", [7, 64, 129])
def test_the_references_chunked_form_is_its_recurrence(T):
    q, k, v, g, beta = recurrence_inputs(1, T, 2, 16, seed=100 + T)
    torch.testing.assert_close(R.chunked(q[0], k[0], v[0], g[0], beta[0]),
                               R.recurrence(q[0], k[0], v[0], g[0], beta[0]), rtol=0, atol=1e-5)


# -- the model against the reference ----------------------------------------------

def test_forward_against_the_reference(model):
    cfg, params = model
    seq = tokens(150, seed=1)
    got, _ = transformer.forward(cfg, params, {"tokens": seq[None]})
    want = reference(cfg, params, seq)
    torch.testing.assert_close(got[0, :, :cfg.vocab], want, rtol=0, atol=ATOL)
    torch.testing.assert_close(reference(cfg, params, seq, chunked=True), want,
                               rtol=0, atol=ATOL)


def test_prefill_then_decode_through_the_slot_cache(model):
    """A prompt of 70 (two chunks) prefilled into slot 1 of a 2-slot cache,
    then 8 tokens decoded through the state, the tail and the latent
    cache, slot 0 decoding other tokens at its own positions beside it."""
    cfg, params = model
    seq = tokens(78, seed=2)
    want = reference(cfg, params, seq)
    cache = transformer.zeros_cache(cfg, 2, 96, device="cpu")
    last, _ = transformer.prefill(cfg, params, {"tokens": seq[None, :70]}, cache=cache, slots=[1])
    torch.testing.assert_close(last[0, :cfg.vocab], want[69], rtol=0, atol=ATOL)
    other = tokens(8, seed=9)
    for i, t in enumerate(range(70, 78)):
        tok = torch.stack([other[i], seq[t]])[:, None]
        logits, _ = transformer.decode_step(cfg, params, cache, tok, np.array([i, t]))
        torch.testing.assert_close(logits[1, :cfg.vocab], want[t], rtol=0, atol=ATOL)


def serve(cfg, params, reqs, eng=None):
    eng = eng or Engine(cfg, params, batch_size=2, max_len=64, device="cpu")
    for r in reqs:
        eng.submit(r)
    while eng.pending:
        eng.step()
    return eng


def request(uid, n, new, seed):
    rng = np.random.default_rng(seed)
    return Request(uid, rng.integers(0, 512, size=n).astype(np.int32), max_new_tokens=new,
                   keep_logits=True)


def test_the_engine_serves_requests_against_the_reference(model):
    """5 requests over 2 slots with refills: each request's logits at the
    prefill's last position and every decode position against the
    reference's full forward over its prompt and its own answer; the
    counters balance and count a state reset a prefill."""
    cfg, params = model
    reqs = [request(i, n, new, seed=10 + i) for i, (n, new) in
            enumerate([(9, 6), (3, 1), (40, 3), (13, 7), (2, 4)])]
    eng = serve(cfg, params, reqs)
    st = eng.stats()
    assert st["accounted"] and st["finished"] == 5 and st["pending"] == 0
    assert st["state_resets"] == 5 and st["kda_launches"] == 0      # plain versions on the CPU
    for r in reqs:
        assert r.done and len(r.out) == len(r.logits) == r.max_new_tokens
        seq = torch.from_numpy(np.concatenate([r.prompt, r.out[:-1]]).astype(np.int64))
        want = reference(cfg, params, seq, torch.arange(len(r.prompt) - 1, len(seq)))
        torch.testing.assert_close(torch.stack(r.logits)[:, :cfg.vocab], want,
                                   rtol=0, atol=ATOL)


def test_a_reused_slot_starts_from_a_zero_state(model):
    """A request served in a slot that an earlier request (and the dummy
    tokens a free slot decodes) left state in gives the logits a fresh
    engine gives it, to the bit."""
    cfg, params = model
    eng = serve(cfg, params, [request(0, 30, 5, seed=1), request(1, 20, 9, seed=2)])
    again = request(2, 17, 6, seed=3)
    serve(cfg, params, [again], eng)
    fresh = request(2, 17, 6, seed=3)
    serve(cfg, params, [fresh])
    assert again.out == fresh.out
    torch.testing.assert_close(torch.stack(again.logits), torch.stack(fresh.logits),
                               rtol=0, atol=0)
    assert eng.stats()["state_resets"] == 3


# -- the expert share -----------------------------------------------------------

def test_two_expert_shares_add_to_the_whole_layer(model):
    """Experts 0-3 on one device and 4-7 on the other: the two partial
    results, with the shared expert (computed on both) counted once, add
    up to the uncut reference layer; in decode (a fixed capacity) too."""
    cfg, params = model
    p = transformer.layer(params["blocks"], 0)["mlp"]
    x = torch.randn(1, 40, cfg.d_model, generator=torch.Generator().manual_seed(8))
    whole = R.moe(x[0], p, arch(cfg))
    sh = p["shared"]
    shared = (torch.nn.functional.silu(x[0] @ sh["wg"]["w"]) * (x[0] @ sh["wi"]["w"])) @ \
        sh["wo"]["w"]
    for capacity in (None, 40):
        parts = []
        for first in (0, 4):
            c = dataclasses.replace(cfg, experts_held=4, expert_offset=first)
            held = dict(p, **{n: p[n][first:first + 4] for n in ("wi", "wg", "wo")})
            load = []
            parts.append(moe.routed_moe(x, held, c, capacity=capacity, load=load)[0])
            assert load[0].shape == (4,)
            torch.testing.assert_close(parts[-1], R.moe(x[0], held, dict(arch(c))),
                                       rtol=0, atol=1e-5)
        torch.testing.assert_close(parts[0] + parts[1] - shared, whole, rtol=0, atol=1e-5)
        assert float((parts[0] - shared).abs().max()) > 1e-2


# -- Moonlight, on the shared code ---------------------------------------------------

def _project_before(x, p, cfg, positions):
    """`mla.project` as it was before its NoPE switch."""
    from repro_torch.models import layers
    B, S, _ = x.shape
    H, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = layers.linear(x, p["wq"], cfg.dtype).reshape(B, S, H, nope + rope)
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    ckv, k_pe = layers.linear(x, p["wkv_a"], cfg.dtype).split([r, rope], dim=-1)
    ckv = layers.rmsnorm(ckv, p["kv_norm"]["w"], cfg.norm_eps)
    q_pe = layers.apply_rope(q_pe, positions, cfg.rope_theta)
    k_pe = layers.apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_pe, ckv, k_pe


def _routed_moe_before(x, p, cfg, *, capacity=None, load=None):
    """`moe.routed_moe` as it was before its expert share."""
    from repro_torch.models import layers
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    x2 = x.reshape(T, d)
    weights, idx = moe.route_sigmoid(x2, p, cfg)
    e = idx.reshape(-1)
    order = torch.argsort(e, stable=True)
    e_s = e[order]
    tok = order // k
    counts = torch.bincount(e, minlength=E)
    if load is not None:
        load.append(counts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * k, device=x.device) - starts[e_s]
    C = capacity if capacity is not None else int(counts.max())
    xe = torch.zeros((E, C, d), dtype=cfg.dtype, device=x.device)
    xe[e_s, rank] = x2[tok].to(cfg.dtype)
    wi, wg, wo = (layers._materialize(p[n], cfg.dtype) for n in ("wi", "wg", "wo"))
    h = layers.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wi)
    ye = torch.bmm(h, wo)
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    y.index_add_(0, tok, ye[e_s, rank].float() * weights.reshape(-1)[order, None])
    shared = layers.mlp(x, p["shared"], "gated", cfg.dtype)
    return y.to(cfg.dtype).reshape(B, S, d) + shared


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moonlight_is_bit_identical_with_all_experts_and_rope(monkeypatch, dtype):
    """Moonlight's block at a small size (all experts held, RoPE on): the
    forward's logits, a prefill's and each decode step's through the
    latent cache are the same bits as with the shared functions as they
    were before the NoPE switch and the expert share."""
    from repro_torch.models import mla
    cfg = dataclasses.replace(
        base.get_config("moonlight-16b-a3b"), n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab=512, head_dim=24, n_experts=8, top_k=2, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, moe_d_ff=32,
        n_shared_experts=1, first_dense_layers=1, q_chunk=8, dtype=dtype, param_dtype=dtype)
    params, _ = transformer.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    seq = tokens(30, seed=4)

    def run():
        out = [transformer.forward(cfg, params, {"tokens": seq[None]})[0]]
        cache = transformer.zeros_cache(cfg, 2, 40, device="cpu")
        out.append(transformer.prefill(cfg, params, {"tokens": seq[None, :20]}, cache=cache,
                                       slots=[1])[0])
        for i, t in enumerate(range(20, 30)):
            tok = torch.stack([seq[i], seq[t]])[:, None]
            out.append(transformer.decode_step(cfg, params, cache, tok, np.array([i, t]))[0])
        return out

    now = run()
    monkeypatch.setattr(mla, "project", _project_before)
    monkeypatch.setattr(moe, "routed_moe", _routed_moe_before)
    before = run()
    for a, b in zip(now, before):
        assert torch.equal(a, b)


# -- spans and counters ----------------------------------------------------------

def test_a_traced_step_has_a_span_a_layer():
    """At Kimi's own 27-layer pattern (narrow widths): a traced decode step
    has 20 "kda", 7 "mla", 26 "moe" and 1 "dense_mlp" children, and so
    has a traced prefill."""
    full = base.get_config("kimi-linear-48b-a3b")
    cfg = small(n_layers=27, kda_layers=full.kda_layers)
    params, _ = transformer.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    tr = trace.enable(capacity=4096)
    try:
        serve(cfg, params, [request(0, 12, 3, seed=5)])
        spans = list(tr.recorder.spans())
    finally:
        trace.disable()
    for phase in ("lm_decode", "lm_prefill"):
        ids = {s.span_id for s in spans if s.name == phase}
        kids = [s.name for s in spans if s.parent_id in ids]
        n = len(ids)
        assert n >= 1
        assert (kids.count("kda"), kids.count("mla"), kids.count("moe"),
                kids.count("dense_mlp")) == (20 * n, 7 * n, 26 * n, n), phase


# -- the kernels on the card -----------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the KDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("T", [1, 63, 200, 2049])
def test_the_prefill_kernel_matches_its_plain_version_on_card(cuda, T):
    """Both in float32 on the card (the kernel's products in IEEE float32):
    outputs of magnitude ~1 within 2e-4, the final state within 2e-4."""
    args = [t.to(cuda) for t in recurrence_inputs(2, T, 32, 128, seed=T)]
    o, state = KK.kda_chunk_prefill(*args)
    want_o, want_s = KK.kda_chunk_prefill_plain(*args)
    torch.testing.assert_close(o, want_o, rtol=0, atol=2e-4)
    torch.testing.assert_close(state, want_s, rtol=0, atol=2e-4)


def test_the_decode_kernel_matches_its_plain_version_on_card(cuda):
    q, k, v, g, beta = (t.to(cuda)[:, 0].contiguous()
                        for t in recurrence_inputs(64, 1, 32, 128, seed=7))
    gen = torch.Generator(device=cuda).manual_seed(1)
    s0 = torch.randn(64, 32, 128, 128, device=cuda, generator=gen)
    s1, s2 = s0.clone(), s0.clone()
    o = KK.kda_decode_step(q, k, v, g, beta, s1)
    want = KK.kda_decode_step_plain(q, k, v, g, beta, s2)
    torch.testing.assert_close(o, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(s1, s2, rtol=0, atol=1e-5)


# -- the benchmark's copy ----------------------------------------------------------

def test_the_benchmarks_copy_is_the_reference(model):
    path = ROOT / "bench" / "reference" / "kimi_linear.py"
    assert path.read_text() == pathlib.Path(R.__file__).read_text()
    spec = importlib.util.spec_from_file_location("bench_reference_kimi_linear", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg, params = model
    seq = tokens(17, seed=3)
    torch.testing.assert_close(reference(cfg, params, seq, module=mod),
                               reference(cfg, params, seq), rtol=0, atol=0)
