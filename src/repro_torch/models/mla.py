"""Multi-head latent attention (MLA), DeepSeek-V3's, without a query
low-rank projection, with a latent cache.

Per token, `wkv_a` gives a latent `c_kv` (`kv_lora_rank`) and one roped
key `k_pe` (`qk_rope_head_dim`) shared by the heads; `c_kv` is normed
(`kv_norm`) and `wkv_b` expands it into each head's `k_nope` and `v`.
Queries are `wq`'s, split into `q_nope` and a roped `q_pe`.  A score is
(q_nope . k_nope + q_pe . k_pe) / sqrt(qk_nope_head_dim + qk_rope_head_dim).

Two forms of the same attention:

- expanded (`expanded_attention`, forward and prefill): `k_nope` and `v`
  expanded from the normed latent, float32 scores and softmax over chunks
  of `q_chunk` queries, each against the keys up to its last row, as
  `attention.causal_attention` computes them (NEG_INF masking);
- absorbed (`absorbed_decode`, one token a slot): `q_nope` goes through
  `W_UK` (the `k_nope` columns of `wkv_b`) into the latent space, scores
  are taken against the cached normed latent plus `q_pe . k_pe`, and the
  latent output goes through `W_UV` (the `v` columns) and `wo`.  The
  cache's products run in the compute dtype (float32 accumulation); the
  softmax in float32.

With `mla_rope` False (Kimi Linear's `mla_use_nope`) q_pe and k_pe are
left unrotated: the same columns, the same score scale and the same
cache, without positions.

The cache of one layer is `ckv` (B, T, kv_lora_rank), the normed latent,
and `kpe` (B, T, qk_rope_head_dim), the roped key, in the compute dtype:
576 values a token a layer where full K/V of 16 heads would hold 5,120.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers
from repro_torch.models.attention import NEG_INF


def init_mla(draw: layers.Draw, cfg, lead: tuple = ()) -> tuple[dict, dict]:
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = cfg.param_dtype
    wq, aq = layers.init_linear(draw, d, H * (nope + rope), dt, lead=lead, out_axis="qkv")
    wa, aa = layers.init_linear(draw, d, r + rope, dt, lead=lead, out_axis=None)
    n, an = layers.init_norm(draw, r, "rmsnorm", dt, lead)
    wb, ab = layers.init_linear(draw, r, H * (nope + vd), dt, lead=lead, in_axis=None,
                                out_axis="qkv")
    wo, ao = layers.init_linear(draw, H * vd, d, dt, lead=lead, in_axis="qkv", out_axis="fsdp")
    return ({"wq": wq, "wkv_a": wa, "kv_norm": n, "wkv_b": wb, "wo": wo},
            {"wq": aq, "wkv_a": aa, "kv_norm": an, "wkv_b": ab, "wo": ao})


def project(x, p, cfg, positions):
    """x (B, S, d); positions (S,) or (B, S) -> q_nope (B,S,H,nope),
    q_pe (B,S,H,rope) roped, ckv (B,S,r) normed, k_pe (B,S,rope) roped
    (both left unrotated where `cfg.mla_rope` is False)."""
    B, S, _ = x.shape
    H, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = layers.linear(x, p["wq"], cfg.dtype).reshape(B, S, H, nope + rope)
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    ckv, k_pe = layers.linear(x, p["wkv_a"], cfg.dtype).split([r, rope], dim=-1)
    ckv = layers.rmsnorm(ckv, p["kv_norm"]["w"], cfg.norm_eps)
    if cfg.mla_rope:
        q_pe = layers.apply_rope(q_pe, positions, cfg.rope_theta)
        k_pe = layers.apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_pe, ckv, k_pe


def _scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def expanded_attention(q_nope, q_pe, ckv, k_pe, p, cfg):
    """Causal attention of S queries over the same S positions, with k_nope
    and v expanded from the normed latent -> (B, S, d) after `wo`."""
    B, S, H, nope = q_nope.shape
    vd = cfg.v_head_dim
    kv = layers.linear(ckv, p["wkv_b"], cfg.dtype).reshape(B, S, H, nope + vd)
    k_nope, v = kv.split([nope, vd], dim=-1)
    k_nope, v, k_pe = k_nope.float(), v.float(), k_pe.float()
    scale = _scale(cfg)
    c = max(1, min(cfg.q_chunk, S))
    outs = []
    for a in range(0, S, c):
        b = min(a + c, S)
        s = torch.einsum("bqhn,bthn->bqht", q_nope[:, a:b].float(), k_nope[:, :b])
        s = (s + torch.einsum("bqhr,btr->bqht", q_pe[:, a:b].float(), k_pe[:, :b])) * scale
        mask = torch.arange(b, device=s.device)[None, :] <= \
            torch.arange(a, b, device=s.device)[:, None]
        s = torch.where(mask[None, :, None, :], s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bqht,bthv->bqhv", w, v[:, :b]).to(cfg.dtype))
    o = torch.cat(outs, dim=1).reshape(B, S, H * vd)
    return layers.linear(o, p["wo"], cfg.dtype)


def mla_block(x, p, cfg, positions):
    """The attention sublayer over a whole sequence (forward) -> (B, S, d)."""
    q_nope, q_pe, ckv, k_pe = project(x, p, cfg, positions)
    return expanded_attention(q_nope, q_pe, ckv, k_pe, p, cfg)


def prefill_block(x, p, cfg, positions):
    """As `mla_block`, also returning the cache rows (ckv, k_pe) of the S
    positions, in the compute dtype."""
    q_nope, q_pe, ckv, k_pe = project(x, p, cfg, positions)
    return expanded_attention(q_nope, q_pe, ckv, k_pe, p, cfg), ckv, k_pe


def absorbed_decode(x, p, cfg, ckv_cache, kpe_cache, pos: torch.Tensor, t_used: int):
    """One token a slot at its own position.  x (B, 1, d); `ckv_cache`
    (B, T, r) and `kpe_cache` (B, T, rope) of this layer, written in place
    at (slot, pos[slot]); pos (B,) int64 on x's device; `t_used` > every
    pos: the cache is read over [0, t_used), masked per slot at its pos.
    -> (B, 1, d)."""
    B = x.shape[0]
    H, r = cfg.n_heads, cfg.kv_lora_rank
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    q_nope, q_pe, ckv, k_pe = project(x, p, cfg, pos[:, None])
    slots = torch.arange(B, device=x.device)
    ckv_cache[slots, pos] = ckv[:, 0].to(ckv_cache.dtype)
    kpe_cache[slots, pos] = k_pe[:, 0].to(kpe_cache.dtype)
    wb = layers._materialize(p["wkv_b"]["w"], cfg.dtype).reshape(r, H, nope + vd)
    w_uk, w_uv = wb[..., :nope], wb[..., nope:]
    # q_nope into the latent space, in float32, then in the cache's dtype
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(), w_uk.float())
    ck, kp = ckv_cache[:, :t_used], kpe_cache[:, :t_used]
    s = torch.bmm(q_lat.to(ck.dtype), ck.transpose(1, 2)).float()
    s = (s + torch.bmm(q_pe[:, 0].to(kp.dtype), kp.transpose(1, 2)).float()) * _scale(cfg)
    mask = torch.arange(t_used, device=x.device)[None, None, :] <= pos[:, None, None]
    w = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)           # (B, H, t)
    o_lat = torch.bmm(w.to(ck.dtype), ck)                               # (B, H, r)
    o = torch.einsum("bhr,rhv->bhv", o_lat.float(), w_uv.float()).to(cfg.dtype)
    return layers.linear(o.reshape(B, 1, H * vd), p["wo"], cfg.dtype)
