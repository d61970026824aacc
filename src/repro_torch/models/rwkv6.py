"""RWKV-6 "Finch" block: data-dependent-decay time mix + channel mix.

Port of `repro.models.rwkv6`: token-shift LoRA modulation, per-channel
decay w = exp(-exp(clip(., -8, 4))), bonus `u`, per-head norm, gated
output.  The WKV recurrence runs in float32 over time with state
(B, H, hd, hd); the decay enters it rounded to bfloat16, as the
reference's scan inputs are.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers, scan_utils

LORA_RANK = 32


def init_rwkv_block(draw: layers.Draw, cfg, lead: tuple = ()) -> tuple[dict, dict]:
    d, dff = cfg.d_model, cfg.d_ff
    H, hd = cfg.n_heads, cfg.head_dim
    std = 1.0 / math.sqrt(d)
    dn = lambda sh, s=std: draw.normal(lead + sh, s, cfg.param_dtype)
    p = {
        # time-mix interpolation params + LoRA
        "mu": dn((5, d), 0.02),                    # per-channel mix for w,k,v,r,g
        "lora_a": dn((d, 5 * LORA_RANK)),
        "lora_b": dn((5, LORA_RANK, d), 0.02),
        "w0": dn((d,), 0.02),                      # decay bias
        "u": dn((H, hd), 0.02),                    # bonus
        "wr": dn((d, d)), "wk": dn((d, d)),
        "wv": dn((d, d)), "wg": dn((d, d)),
        "wo": dn((d, d)),
        "ln_x": draw.full(lead + (d,), 1.0, cfg.param_dtype),   # per-head group norm scale
        # channel mix
        "mu_c": dn((2, d), 0.02),
        "ck": dn((d, dff)),
        "cr": dn((d, d)),
        "cv": dn((dff, d)),
    }
    a = {
        "mu": (None, None), "lora_a": ("fsdp", None), "lora_b": (None, None, "fsdp"),
        "w0": (None,), "u": (None, None),
        "wr": ("fsdp", "qkv"), "wk": ("fsdp", "qkv"),
        "wv": ("fsdp", "qkv"), "wg": ("fsdp", "qkv"), "wo": ("qkv", "fsdp"),
        "ln_x": (None,),
        "mu_c": (None, None), "ck": ("fsdp", "ffn"),
        "cr": ("fsdp", "qkv"), "cv": ("ffn", "fsdp"),
    }
    return p, layers.stacked_axes(a, lead)


def _shifted(x, xprev_last):
    """The previous token's x at every position: zeros (or `xprev_last`,
    the last token of the previous call) before the first."""
    if xprev_last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([xprev_last[:, None], x[:, :-1]], 1)


def _mix_inputs(x, xprev, p, cfg):
    """Token-shift LoRA: five modulated interpolations (w,k,v,r,g).  The w
    branch is left as its float32 sum: the reference upcasts it at once for
    the decay LoRA, and its default compilation drops the bfloat16 rounding
    between (`layers.add_norm`)."""
    delta = xprev - x                                             # (B,T,d)
    base = x + delta * p["mu"][0].to(x.dtype)
    lo = torch.tanh(base @ p["lora_a"].to(x.dtype))               # (B,T,5R)
    B, T, _ = x.shape
    lo = lo.reshape(B, T, 5, LORA_RANK)
    mod = torch.einsum("btzr,zrd->btzd", lo, p["lora_b"].to(x.dtype))
    mus = p["mu"].to(x.dtype)                                     # (5, d)
    parts = [delta * (mus[z] + mod[:, :, z]) for z in range(5)]
    return [x.float() + parts[0]] + [x + d for d in parts[1:]]


def _wkv_scan(r, k, v, w, u, *, state=None):
    """Linear recurrence.  r,k,v (B,T,H,hd); w (B,T,H,hd) decay in (0,1).
    Returns (y (B,T,H,hd), final state (B,H,hd,hd))."""
    B, T, H, hd = r.shape
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)

    def step(S, inp):
        rt, kt, vt, wt = (a.float() for a in inp)                 # (B,H,hd)
        kv = kt[..., :, None] * vt[..., None, :]                  # (B,H,hd,hd)
        yt = torch.einsum("bhk,bhkv->bhv", rt, S)
        return wt[..., :, None] * S + kv, yt

    xs = (r.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1),
          w.to(torch.bfloat16).transpose(0, 1))
    state, ys = scan_utils.chunked_scan(step, state, xs)
    y = ys.transpose(0, 1)
    # the `u` bonus term is separable from the recurrence:
    #   y_t = r_t.S_{t-1} + (sum_k r*u*k)_t * v_t
    bonus = torch.einsum("bthk,hk,bthk->bth", r.float(), u, k.float())
    return y + bonus[..., None] * v.float(), state


def time_mix(x, p, cfg, *, xprev_last=None, state=None):
    """x (B,T,d). For decode, xprev_last (B,d) is the previous token's x and
    state the carried WKV state; returns (out, (new_xprev, new_state))."""
    B, T, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    xw, xk, xv, xr, xg = _mix_inputs(x, _shifted(x, xprev_last), p, cfg)
    r = (xr @ p["wr"].to(x.dtype)).reshape(B, T, H, hd)
    k = (xk @ p["wk"].to(x.dtype)).reshape(B, T, H, hd)
    v = (xv @ p["wv"].to(x.dtype)).reshape(B, T, H, hd)
    g = layers.silu(xg @ p["wg"].to(x.dtype))
    # decay: w0 + per-token LoRA-modulated channel decay (uses the xw branch)
    wlog = p["w0"].float()[None, None, :] + \
        torch.tanh(xw.float() @ p["lora_a"].float()[:, :LORA_RANK]) @ p["lora_b"][0].float()
    wdec = torch.exp(-torch.exp(torch.clamp(wlog, -8.0, 4.0))).reshape(B, T, H, hd)
    y, new_state = _wkv_scan(r, k, v, wdec, p["u"].float(), state=state)
    # per-head group norm, then gate + out proj
    mu = torch.mean(y, -1, keepdim=True)
    var = torch.mean(torch.square(y - mu), -1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(B, T, d)
    y = (y * p["ln_x"].float()).to(x.dtype) * g
    out = y @ p["wo"].to(x.dtype)
    return out, (x[:, -1], new_state)


def channel_mix(x, p, cfg, *, xprev_last=None):
    delta = _shifted(x, xprev_last) - x
    mus = p["mu_c"].to(x.dtype)
    xk = x + delta * mus[0]
    xr = x + delta * mus[1]
    k = torch.square(F.relu(xk @ p["ck"].to(x.dtype)))
    r = layers.sigmoid(xr @ p["cr"].to(x.dtype))
    return r * (k @ p["cv"].to(x.dtype)), x[:, -1]


def rwkv_state_shape(batch: int, cfg) -> dict:
    """Decode-carry state for one block, as meta tensors."""
    H, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    return {
        "wkv": meta((batch, H, hd, hd), torch.float32),
        "x_tm": meta((batch, d), cfg.dtype),
        "x_cm": meta((batch, d), cfg.dtype),
    }
