"""Selective SSM (Mamba) block for the Jamba hybrid.

Port of `repro.models.mamba`: in_proj -> causal depthwise conv1d (k=4) ->
silu -> selective scan (data-dependent dt, B, C; diagonal A; float32) ->
gate -> out_proj.  State is (B, d_inner, d_state): O(1) in sequence length.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers, scan_utils

D_STATE = 16
D_CONV = 4
DT_RANK_DIV = 16     # dt_rank = d_model / 16


def init_mamba_block(draw: layers.Draw, cfg, lead: tuple = ()) -> tuple[dict, dict]:
    d = cfg.d_model
    d_in = 2 * d
    dt_rank = max(1, d // DT_RANK_DIV)
    std = 1.0 / math.sqrt(d)
    dt = cfg.param_dtype
    dn = lambda sh, s=std: draw.normal(lead + sh, s, dt)
    a_log = torch.log(torch.arange(1, D_STATE + 1, dtype=torch.float32))
    p = {
        "in_proj": dn((d, 2 * d_in)),                 # x & gate
        "conv_w": dn((D_CONV, d_in), 0.2),            # depthwise
        "conv_b": draw.full(lead + (d_in,), 0.0, dt),
        "x_proj": dn((d_in, dt_rank + 2 * D_STATE)),
        "dt_proj": dn((dt_rank, d_in), 0.1),
        "dt_bias": draw.full(lead + (d_in,), 0.0, dt),
        "A_log": draw.expand(a_log, lead + (d_in, D_STATE), dt),
        "D": draw.full(lead + (d_in,), 1.0, dt),
        "out_proj": dn((d_in, d)),
    }
    a = {
        "in_proj": ("fsdp", "ffn"), "conv_w": (None, "ffn"), "conv_b": ("ffn",),
        "x_proj": ("ffn", None), "dt_proj": (None, "ffn"), "dt_bias": ("ffn",),
        "A_log": ("ffn", None), "D": ("ffn",), "out_proj": ("ffn", "fsdp"),
    }
    return p, layers.stacked_axes(a, lead)


def _causal_conv(x, w, b, *, state=None):
    """Depthwise causal conv along T. x (B,T,C); w (K,C); returns (y, new_state)
    where state is the last K-1 inputs (B, K-1, C)."""
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(K))
    return y + b[None, None, :], xp[:, -(K - 1):, :]


def _selective_scan(u, dt, Bc, Cc, A, D, *, state=None):
    """u (B,T,C); dt (B,T,C); Bc/Cc (B,T,N); A (C,N); D (C,).
    h_t = exp(dt*A) h + dt*B*u ; y = C.h + D*u. Returns (y, final h (B,C,N))."""
    Bsz, T, C = u.shape
    N = A.shape[1]
    if state is None:
        state = torch.zeros((Bsz, C, N), dtype=torch.float32, device=u.device)

    def step(h, inp):
        ut, dtt, bt, ct = (a.float() for a in inp)              # upcast per step
        dA = torch.exp(dtt[..., None] * A[None])                # (B,C,N)
        dBu = (dtt * ut)[..., None] * bt[:, None, :]
        h = dA * h + dBu
        return h, torch.einsum("bcn,bn->bc", h, ct)

    xs = (u.transpose(0, 1), dt.transpose(0, 1), Bc.transpose(0, 1), Cc.transpose(0, 1))
    state, ys = scan_utils.chunked_scan(step, state, xs)
    return ys.transpose(0, 1) + u.float() * D[None, None, :], state


def mamba_block(x, p, cfg, *, state=None):
    """x (B,T,d) -> (out, new_state). state = {"conv": (B,3,d_in), "ssm": (B,d_in,N)}."""
    d = x.shape[-1]
    dt_rank = max(1, d // DT_RANK_DIV)
    st_conv = None if state is None else state["conv"]
    st_ssm = None if state is None else state["ssm"]
    xz = x @ p["in_proj"].to(x.dtype)               # (B,T,2*d_in)
    xs, z = torch.chunk(xz, 2, dim=-1)
    xs, new_conv = _causal_conv(xs, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype),
                                state=st_conv)
    xs = layers.silu(xs)
    proj = xs @ p["x_proj"].to(x.dtype)             # (B,T,dt_rank+2N)
    dt_raw = proj[..., :dt_rank]
    Bc = proj[..., dt_rank:dt_rank + D_STATE]
    Cc = proj[..., dt_rank + D_STATE:]
    dt = layers.softplus(dt_raw @ p["dt_proj"].to(x.dtype) + p["dt_bias"].to(x.dtype))
    A = -torch.exp(p["A_log"].float())
    y, new_ssm = _selective_scan(xs, dt, Bc, Cc, A, p["D"].float(), state=st_ssm)
    y = y.to(x.dtype) * layers.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    return out, {"conv": new_conv, "ssm": new_ssm}


def mamba_state_shape(batch: int, cfg) -> dict:
    """The decode state of one block, as meta tensors (shapes and dtypes)."""
    d_in = 2 * cfg.d_model
    return {
        "conv": torch.empty((batch, D_CONV - 1, d_in), dtype=cfg.dtype, device="meta"),
        "ssm": torch.empty((batch, d_in, D_STATE), dtype=torch.float32, device="meta"),
    }
