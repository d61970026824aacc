"""Kimi Delta Attention (KDA), Kimi Linear's linear-attention layer: a
channel-wise gated delta rule behind short causal convolutions.

Per token, with H heads of K = V channels (`kda_heads`, `kda_head_dim`)
and the layer's input x (normed):

    q, k, v = SiLU(Conv(x W_q)), SiLU(Conv(x W_k)), SiLU(Conv(x W_v))
    q, k L2-normed per head, q scaled by K^-1/2
    g = -exp(A_log[h]) * softplus(x W_fa W_fb + dt_bias)      (per channel)
    beta = sigmoid(x W_b)                                      (per head)
    S_t = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t
    out = (RMSNorm(o) * w * sigmoid(x W_ga W_gb + b_gb)) W_o

`Conv` is depthwise, causal and bias-free over the 3 H K channels of
q, k and v side by side (one `wqkv` projection, one `conv` weight of
`short_conv_kernel_size` taps, the last tap on the current token).  The
state S (K x V a head) is float32 and starts at zero for every request;
so does the convolution's tail of the W - 1 tokens before the first.
The recurrence runs in `kernels/kda` (a chunked prefill, a one-token
decode step); around it the projections run in the compute dtype and
the rest in float32, the output cast to the compute dtype for W_o.

A slot's cache is its state (H, K, V) float32 and its convolution tail
(W - 1, 3 H K) in the compute dtype: a prefill writes both from zero, a
decode step updates both in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import kda as K_
from repro_torch.models import layers

L2_EPS = 1e-6


def init_kda(draw: layers.Draw, cfg, lead: tuple = ()) -> tuple[dict, dict]:
    d, H, K = cfg.d_model, cfg.kda_heads, cfg.kda_head_dim
    W, dt = cfg.short_conv_kernel_size, cfg.param_dtype
    p, a = {}, {}
    for name, (d_in, d_out, bias) in {"wqkv": (d, 3 * H * K, False), "f_a": (d, K, False),
                                      "f_b": (K, H * K, False), "b": (d, H, False),
                                      "g_a": (d, K, False), "g_b": (K, H * K, True),
                                      "wo": (H * K, d, False)}.items():
        p[name], a[name] = layers.init_linear(draw, d_in, d_out, dt, lead=lead, bias=bias)
    p["conv"] = {"w": draw.normal(lead + (3 * H * K, W), 1.0 / math.sqrt(W), dt)}
    a["conv"] = layers.stacked_axes({"w": (None, None)}, lead)
    # decay rates 1..16 over the heads (as the published init's range), and
    # a dt bias around softplus^-1(0.01): most channels keep their state
    # over tens of tokens, some over hundreds
    p["A_log"] = draw.expand(torch.log(torch.linspace(1.0, 16.0, H)), lead + (H,), torch.float32)
    p["dt_bias"] = draw.normal(lead + (H * K,), 1.0, torch.float32) - 4.6
    a["A_log"] = layers.stacked_axes((None,), lead)
    a["dt_bias"] = layers.stacked_axes((None,), lead)
    p["o_norm"], a["o_norm"] = layers.init_norm(draw, K, "rmsnorm", dt, lead)
    return p, a


def _conv(ext, w, S: int):
    """Causal depthwise convolution: ext (B, S + W - 1, D) the tail then the
    S new rows, w (D, W) -> (B, S, D) float32."""
    W = w.shape[-1]
    wf = layers._materialize(w, torch.float32)
    out = ext[:, :S].float() * wf[:, 0]
    for i in range(1, W):
        out = out + ext[:, i:i + S].float() * wf[:, i]
    return out


def _l2norm(x):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def _inputs(conv, x, p, cfg):
    """The recurrence's inputs from the convolution's output (B, S, 3HK)
    and the layer's input x: q, k, g (B, S, H, K), v (B, S, H, V), beta
    (B, S, H), float32."""
    B, S, _ = conv.shape
    H, K = cfg.kda_heads, cfg.kda_head_dim
    q, k, v = F.silu(conv).reshape(B, S, 3, H, K).unbind(2)
    q = _l2norm(q) * K ** -0.5
    k = _l2norm(k)
    f = layers.linear(layers.linear(x, p["f_a"], cfg.dtype), p["f_b"], cfg.dtype)
    g = -p["A_log"].float().exp()[:, None] * F.softplus(
        (f.float() + p["dt_bias"].float()).reshape(B, S, H, K))
    beta = torch.sigmoid(layers.linear(x, p["b"], cfg.dtype).float())
    return q.contiguous(), k, v.contiguous(), g.contiguous(), beta.contiguous()


def _output(o, x, p, cfg):
    """o (B, S, H, V) float32 -> the layer's output (B, S, d): the per-head
    RMSNorm, the output gate, W_o."""
    B, S, H, V = o.shape
    gate = layers.linear(layers.linear(x, p["g_a"], cfg.dtype), p["g_b"], cfg.dtype)
    o = layers.rmsnorm(o, p["o_norm"]["w"], cfg.norm_eps) * \
        torch.sigmoid(gate.float()).reshape(B, S, H, V)
    return layers.linear(o.reshape(B, S, H * V).to(cfg.dtype), p["wo"], cfg.dtype)


def kda_prefill(x, p, cfg):
    """x (B, S, d) normed, from a zero state and tail -> (out (B, S, d),
    final state (B, H, K, V) float32, conv tail (B, W - 1, 3HK))."""
    S = x.shape[1]
    W = cfg.short_conv_kernel_size
    ext = F.pad(layers.linear(x, p["wqkv"], cfg.dtype), (0, 0, W - 1, 0))
    q, k, v, g, beta = _inputs(_conv(ext, p["conv"]["w"], S), x, p, cfg)
    o, state = K_.kda_chunk_prefill(q, k, v, g, beta)
    return _output(o, x, p, cfg), state, ext[:, S:]


def kda_decode(x, p, cfg, state, tail):
    """One token a slot: x (B, 1, d) normed; `state` (B, H, K, V) float32
    and `tail` (B, W - 1, 3HK) of this layer, updated in place -> (B, 1, d)."""
    ext = torch.cat([tail, layers.linear(x, p["wqkv"], cfg.dtype).to(tail.dtype)], dim=1)
    tail.copy_(ext[:, 1:])
    q, k, v, g, beta = _inputs(_conv(ext, p["conv"]["w"], 1), x, p, cfg)
    o = K_.kda_decode_step(q[:, 0], k[:, 0], v[:, 0], g[:, 0], beta[:, 0], state)
    return _output(o[:, None], x, p, cfg)
