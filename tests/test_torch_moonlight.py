"""Moonlight-16B-A3B's block (the port's "mla_moe" family) against its plain
reference, `models/moonlight_ref.py`, at a small size on the CPU with the
block's structure kept: d 64, 4 heads, latent rank 32, rope 8, nope 16,
v 16, 8 experts top-2 and 1 shared, 1 dense layer then 2 MoE layers, on
seeded random float32 weights.

Tolerances: both sides compute in float32 on the CPU, in other orders of
summation (the port sorts the routed pairs into a padded batch, the
reference loops over experts; the port's attention runs in query chunks
of 8 rows, the reference's in one); logits of magnitude ~4 then differ by
a few 1e-6.  `ATOL` 1e-4 allows that with margin and is ~1e4 times under
the gap a dropped expert or a wrong position makes.  No test drops a
token: the program's MoE is dropless by construction, and the planted
routings check it.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.analysis import roofline
from repro_torch.configs import base
from repro_torch.models import mla, moe, moonlight_ref, transformer
from repro_torch.serving.engine import Engine, Request

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-4


def small(**kw):
    d = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab=512, head_dim=24,
             n_experts=8, top_k=2, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, moe_d_ff=32, n_shared_experts=1, first_dense_layers=1, q_chunk=8,
             dtype=torch.float32, param_dtype=torch.float32)
    d.update(kw)
    return dataclasses.replace(base.get_config("moonlight-16b-a3b"), **d)


def arch(cfg) -> dict:
    """The published config's keys the reference reads."""
    return {"num_attention_heads": cfg.n_heads, "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim, "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.norm_eps, "num_experts_per_tok": cfg.top_k,
            "norm_topk_prob": cfg.norm_topk_prob, "routed_scaling_factor": cfg.routed_scale}


@pytest.fixture(scope="module")
def model():
    cfg = small()
    params, _ = transformer.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    return cfg, params


def tokens(n, seed=0, vocab=512):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, size=n))


def reference(cfg, params, seq, want=None, module=moonlight_ref):
    return module.logits(params, arch(cfg), [seq], None if want is None else [want])[0]


# -- the configuration -----------------------------------------------------------

def test_the_config_has_the_published_values():
    c = base.get_config("moonlight-16b-a3b")
    assert isinstance(c, base.LatentMoEConfig) and c.family == "mla_moe"
    assert (c.n_layers, c.d_model, c.n_heads, c.d_ff, c.vocab) == (27, 2048, 16, 11264, 163840)
    assert (c.kv_lora_rank, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim) == \
        (512, 128, 64, 128)
    assert (c.n_experts, c.top_k, c.moe_d_ff, c.n_shared_experts, c.first_dense_layers) == \
        (64, 6, 1408, 2, 1)
    assert (c.router_scoring, c.routed_scale, c.norm_topk_prob, c.norm_eps) == \
        ("sigmoid", 2.446, True, 1e-5)
    assert (c.rope_theta, c.context_length, c.tie_embeddings) == (50000.0, 8192, False)
    assert c.dtype == c.param_dtype == torch.bfloat16 and c.router_dtype == torch.float32
    assert c.source.startswith("https://huggingface.co/moonshotai/Moonlight-16B-A3B")
    assert "moonlight-16b-a3b" not in base.ARCH_IDS
    assert not any(isinstance(base.get_config(a), base.LatentMoEConfig) for a in base.ARCH_IDS)


def test_roofline_counts_the_family():
    total, active = roofline.param_count(base.get_config("moonlight-16b-a3b"))
    assert round(total / 1e9, 2) == 15.96 and round(active / 1e9, 2) == 2.58
    cfg = small()
    params, _ = transformer.init_params(cfg, device="meta")
    n = sum(t.numel() for t in all_leaves(params))
    assert roofline.param_count(cfg)[0] == n


def all_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from all_leaves(v)
    else:
        yield tree


# -- the model against the reference ----------------------------------------------

def test_forward_against_the_reference(model):
    cfg, params = model
    seq = tokens(37, seed=1)
    got, _ = transformer.forward(cfg, params, {"tokens": seq[None]})
    want = reference(cfg, params, seq)
    torch.testing.assert_close(got[0, :, :cfg.vocab], want, rtol=0, atol=ATOL)


def test_prefill_then_decode_against_the_full_forward(model):
    """A prompt of 13 prefilled into slot 1 of a 2-slot cache, then 8
    tokens decoded through the latent cache, slot 0 decoding at its own
    (other) positions beside it."""
    cfg, params = model
    seq = tokens(21, seed=2)
    want = reference(cfg, params, seq)
    cache = transformer.zeros_cache(cfg, 2, 32, device="cpu")
    last, _ = transformer.prefill(cfg, params, {"tokens": seq[None, :13]}, cache=cache, slots=[1])
    torch.testing.assert_close(last[0, :cfg.vocab], want[12], rtol=0, atol=ATOL)
    other = tokens(8, seed=9)
    for i, t in enumerate(range(13, 21)):
        tok = torch.stack([other[i], seq[t]])[:, None]
        logits, _ = transformer.decode_step(cfg, params, cache, tok, np.array([i, t]))
        torch.testing.assert_close(logits[1, :cfg.vocab], want[t], rtol=0, atol=ATOL)


def test_absorbed_decode_equals_expanded(model):
    """The latent-space decode of the last position equals the expanded
    attention's last row, on the cache rows the prefill form wrote."""
    cfg, params = model
    p = transformer.layer(params["blocks"], 0)["attn"]
    x = torch.randn(1, 11, cfg.d_model, generator=torch.Generator().manual_seed(5))
    full = mla.mla_block(x, p, cfg, torch.arange(11))
    _, ckv, kpe = mla.prefill_block(x[:, :10], p, cfg, torch.arange(10))
    ckv_cache = torch.zeros(1, 16, cfg.kv_lora_rank)
    kpe_cache = torch.zeros(1, 16, cfg.qk_rope_head_dim)
    ckv_cache[:, :10], kpe_cache[:, :10] = ckv, kpe
    got = mla.absorbed_decode(x[:, 10:], p, cfg, ckv_cache, kpe_cache, torch.tensor([10]), 16)
    torch.testing.assert_close(got[:, 0], full[:, 10], rtol=0, atol=1e-5)


# -- the routed experts -----------------------------------------------------------

def planted(cfg, params, *, router_w=None, bias=None):
    p = transformer.layer(params["blocks"], 0)["mlp"]
    p = dict(p, router=dict(p["router"]))
    if router_w is not None:
        p["router"]["w"] = router_w
    if bias is not None:
        p["router"]["bias"] = bias
    return p


def ref_moe(cfg, p, x):
    return moonlight_ref.moe(x, p, arch(cfg))


@pytest.mark.parametrize("capacity", [None, 20])
def test_one_expert_takes_every_token_and_none_drops(model, capacity):
    """A bias of 10 on expert 3: every token picks it; with the padded batch
    sized by the largest count (or given as T) every pair is computed."""
    cfg, params = model
    bias = torch.zeros(cfg.n_experts)
    bias[3] = 10.0
    p = planted(cfg, params, bias=bias)
    x = torch.randn(1, 20, cfg.d_model, generator=torch.Generator().manual_seed(6))
    load = []
    got = moe.routed_moe(x, p, cfg, capacity=capacity, load=load)
    assert int(load[0][3]) == 20 and int(load[0].sum()) == 20 * cfg.top_k
    torch.testing.assert_close(got[0], ref_moe(cfg, p, x[0]), rtol=0, atol=ATOL)


def test_the_bias_picks_the_experts_but_not_their_weights(model):
    cfg, params = model
    x = torch.randn(12, cfg.d_model, generator=torch.Generator().manual_seed(7))
    p0 = planted(cfg, params, bias=torch.zeros(cfg.n_experts))
    w0, i0 = moe.route_sigmoid(x, p0, cfg)
    bias = torch.zeros(cfg.n_experts)
    bias[[1, 6]] = 5.0
    w1, i1 = moe.route_sigmoid(x, planted(cfg, params, bias=bias), cfg)
    assert (torch.sort(i1, -1).values == torch.tensor([1, 6])).all()
    assert not torch.equal(torch.sort(i0, -1).values, torch.sort(i1, -1).values)
    scores = torch.sigmoid(x @ p0["router"]["w"])
    want = scores[:, [1, 6]] / scores[:, [1, 6]].sum(-1, keepdim=True) * cfg.routed_scale
    torch.testing.assert_close(torch.gather(w1, -1, torch.argsort(i1, -1)), want)


def test_the_shared_experts_share(model):
    """The layer less its routed experts (all weights zeroed) is the shared
    experts' gated MLP on every token."""
    cfg, params = model
    p = planted(cfg, params)
    x = torch.randn(1, 9, cfg.d_model, generator=torch.Generator().manual_seed(8))
    zero = dict(p, wo=torch.zeros_like(p["wo"]))
    sh = p["shared"]
    want = (torch.nn.functional.silu(x[0] @ sh["wg"]["w"]) * (x[0] @ sh["wi"]["w"])) @ \
        sh["wo"]["w"]
    torch.testing.assert_close(moe.routed_moe(x, zero, cfg)[0], want, rtol=0, atol=1e-5)
    routed = moe.routed_moe(x, p, cfg)[0] - want
    assert float(routed.abs().max()) > 1e-2


# -- the engine's step-granular path --------------------------------------------------

def test_the_engine_serves_five_requests_over_two_slots(model):
    """5 requests over 2 slots, 2 of them submitted after the engine
    started, with refills: each request's logits (prefill's last position
    and every decode position) against the reference's full forward over
    its prompt and its own answer; the counters balance."""
    cfg, params = model
    eng = Engine(cfg, params, batch_size=2, max_len=40, device="cpu")
    rng = np.random.default_rng(4)
    reqs = [Request(i, rng.integers(0, cfg.vocab, size=int(rng.integers(3, 14))).astype(np.int32),
                    max_new_tokens=int(n), keep_logits=True)
            for i, n in enumerate([6, 1, 3, 7, 2])]
    for r in reqs[:3]:
        eng.submit(r)
    steps = 0
    while eng.pending:
        eng.step()
        steps += 1
        if steps == 2:
            for r in reqs[3:]:
                eng.submit(r)
    st = eng.stats()
    assert st["accounted"] and st["finished"] == 5 and st["pending"] == 0
    assert st["prefill_tokens"] == sum(len(r.prompt) for r in reqs)
    assert st["decode_tokens"] == sum(r.max_new_tokens - 1 for r in reqs)
    for r in reqs:
        assert r.done and len(r.out) == len(r.logits) == len(r.t_tokens) == r.max_new_tokens
        seq = torch.from_numpy(np.concatenate([r.prompt, r.out[:-1]]).astype(np.int64))
        want = reference(cfg, params, seq, torch.arange(len(r.prompt) - 1, len(seq)))
        torch.testing.assert_close(torch.stack(r.logits)[:, :cfg.vocab], want,
                                   rtol=0, atol=ATOL)


def test_the_step_path_refuses_a_shared_position_family():
    cfg = base.get_config("granite-3-2b").smoke()
    params, _ = transformer.init_params(cfg, device="cpu")
    eng = Engine(cfg, params, batch_size=2, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="shared"):
        eng.submit(Request(0, np.arange(3, dtype=np.int32)))


def test_the_benchmarks_copy_is_the_reference(model):
    path = ROOT / "bench" / "reference" / "moonlight.py"
    assert path.read_text() == pathlib.Path(moonlight_ref.__file__).read_text()
    spec = importlib.util.spec_from_file_location("bench_reference_moonlight", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg, params = model
    seq = tokens(17, seed=3)
    torch.testing.assert_close(reference(cfg, params, seq, module=mod),
                               reference(cfg, params, seq), rtol=0, atol=0)
