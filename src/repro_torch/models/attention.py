"""GQA attention: chunked-causal (train/prefill) + KV-cache decode.

Port of `repro.models.attention`.  Scores and softmax are float32, masked
with NEG_INF = -1e9 (not -inf), as the reference's; no library attention
kernel.  Prefill loops over query chunks, so one (q-chunk x full-KV) tile
of scores lives at a time.  Decode writes the step's K/V row into the
cache in place, where the reference rewrites the cache with a masked
write: at `pos` past the cache's length it writes nothing, as the
reference's mask does, and the step still attends over every slot.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import layers

NEG_INF = -1e9


def init_attention(draw: layers.Draw, cfg, lead: tuple = ()) -> tuple[dict, dict]:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(lead=lead, bias=cfg.qkv_bias, out_axis="qkv")
    wq, aq = layers.init_linear(draw, d, H * hd, cfg.param_dtype, **kw)
    wk, ak = layers.init_linear(draw, d, K * hd, cfg.param_dtype, **kw)
    wv, av = layers.init_linear(draw, d, K * hd, cfg.param_dtype, **kw)
    wo, ao = layers.init_linear(draw, H * hd, d, cfg.param_dtype, lead=lead,
                                in_axis="qkv", out_axis="fsdp")
    return ({"wq": wq, "wk": wk, "wv": wv, "wo": wo},
            {"wq": aq, "wk": ak, "wv": av, "wo": ao})


def _qkv(x, p, cfg, positions):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = layers.linear(x, p["wq"], cfg.dtype).reshape(B, S, H, hd)
    k = layers.linear(x, p["wk"], cfg.dtype).reshape(B, S, K, hd)
    v = layers.linear(x, p["wv"], cfg.dtype).reshape(B, S, K, hd)
    if cfg.use_rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(q, k, scale):
    """q (B,Sq,H,hd), k (B,Skv,K,hd) -> (B, Sq, H, Skv) with GQA grouping."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    s = torch.einsum("bqkgd,btkd->bqkgt", qg.float(), k.float()) * scale
    return s.reshape(B, Sq, H, k.shape[1])


def _gqa_out(w, v):
    """w (B,Sq,H,Skv) f32, v (B,Skv,K,hd) -> (B,Sq,H,hd)."""
    B, Sq, H, T = w.shape
    K = v.shape[2]
    wg = w.reshape(B, Sq, K, H // K, T)
    o = torch.einsum("bqkgt,btkd->bqkgd", wg, v.float())
    return o.reshape(B, Sq, H, v.shape[3])


def causal_attention(q, k, v, *, q_chunk: int = 512, causal: bool = True):
    """Attention over query chunks of S // max(1, S // q_chunk) rows; S
    must split into that many equal chunks.  Shapes as in _gqa_scores."""
    B, S, H, hd = q.shape
    scale = 1.0 / (hd ** 0.5)
    nchunk = max(1, S // q_chunk)
    if S % nchunk:
        raise ValueError(f"sequence {S} does not split into {nchunk} chunks "
                         f"(q_chunk {q_chunk})")
    c = S // nchunk
    kpos = torch.arange(S, device=q.device)
    outs = []
    for i in range(nchunk):
        s = _gqa_scores(q[:, i * c:(i + 1) * c], k, scale)
        if causal:
            mask = kpos[None, :] <= (i * c + torch.arange(c, device=q.device))[:, None]
            s = torch.where(mask[None, :, None, :], s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        outs.append(_gqa_out(w, v).to(q.dtype))           # (B, c, H, hd)
    return torch.cat(outs, dim=1)


def attention_block(x, p, cfg, positions, *, causal=True):
    """Full attention sublayer: qkv -> chunked attention -> out proj."""
    B, S, _ = x.shape
    q, k, v = _qkv(x, p, cfg, positions)
    o = causal_attention(q, k, v, q_chunk=min(cfg.q_chunk, S), causal=causal)
    return layers.linear(o.reshape(B, S, -1), p["wo"], cfg.dtype)


# --- decode with KV cache ----------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor   # (B, T, K, hd)
    v: torch.Tensor   # (B, T, K, hd)


def init_kv_cache(batch: int, max_len: int, cfg, dtype=None, device=None) -> KVCache:
    dt = dtype or cfg.dtype
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))


def decode_attention_block(x, p, cfg, cache: KVCache, pos: int):
    """x (B, 1, d); pos the current position; writes the step's K/V row
    into `cache` in place (nothing where pos >= its length) and returns
    (out, cache)."""
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = int(pos)
    q = layers.linear(x, p["wq"], cfg.dtype).reshape(B, 1, H, hd)
    k = layers.linear(x, p["wk"], cfg.dtype).reshape(B, 1, K, hd)
    v = layers.linear(x, p["wv"], cfg.dtype).reshape(B, 1, K, hd)
    if cfg.use_rope:
        posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = layers.apply_rope(q, posb, cfg.rope_theta)
        k = layers.apply_rope(k, posb, cfg.rope_theta)
    T = cache.k.shape[1]
    if pos < T:
        cache.k[:, pos] = k[:, 0].to(cache.k.dtype)
        cache.v[:, pos] = v[:, 0].to(cache.v.dtype)
    scale = 1.0 / (hd ** 0.5)
    s = _gqa_scores(q, cache.k, scale)                        # (B, 1, H, T)
    mask = torch.arange(T, device=x.device)[None, None, None, :] <= pos
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = _gqa_out(w, cache.v).to(x.dtype).reshape(B, 1, H * hd)
    return layers.linear(o, p["wo"], cfg.dtype), cache


# --- cross attention (whisper decoder) ---------------------------------------

def cross_attention_block(x, p, cfg, enc_k, enc_v):
    """x (B,S,d); enc_k/enc_v (B,T,K,hd) precomputed from encoder output."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = layers.linear(x, p["wq"], cfg.dtype).reshape(B, S, H, hd)
    scale = 1.0 / (hd ** 0.5)
    w = torch.softmax(_gqa_scores(q, enc_k, scale), dim=-1)
    o = _gqa_out(w, enc_v).to(x.dtype).reshape(B, S, H * hd)
    return layers.linear(o, p["wo"], cfg.dtype)


def encoder_kv(enc_out, p, cfg):
    B, T, _ = enc_out.shape
    K, hd = cfg.n_kv_heads, cfg.head_dim
    k = layers.linear(enc_out, p["wk"], cfg.dtype).reshape(B, T, K, hd)
    v = layers.linear(enc_out, p["wv"], cfg.dtype).reshape(B, T, K, hd)
    return k, v
