"""Mixture-of-Experts: top-k router + GShard-style capacity dispatch.

Port of `repro.models.moe`.  Tokens are grouped, each group routes
through a (g, E, C) one-hot dispatch/combine tensor and two einsums;
tokens past an expert's capacity C = max(1, int(g*k*cf/E)) are dropped.
The router runs in float32.  Its top-k breaks ties toward the lower
expert index, as `jax.lax.top_k` does (a stable descending sort).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers


def init_moe(draw: layers.Draw, cfg, lead: tuple = ()) -> tuple[dict, dict]:
    d, dff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    std = 1.0 / math.sqrt(d)
    dt = cfg.param_dtype
    p = {
        "router": {"w": draw.normal(lead + (d, E), std, dt)},
        "wi": draw.normal(lead + (E, d, dff), std, dt),
        "wg": draw.normal(lead + (E, d, dff), std, dt),
        "wo": draw.normal(lead + (E, dff, d), 1.0 / math.sqrt(dff), dt),
    }
    a = {
        "router": {"w": (None, None)},
        "wi": ("experts", "fsdp", None),
        "wg": ("experts", "fsdp", None),
        "wo": ("experts", None, "fsdp"),
    }
    return p, layers.stacked_axes(a, lead)


def _pick_group(T: int, group_size: int) -> int:
    """Largest divisor of T that is <= group_size."""
    g = min(group_size, T)
    while T % g:
        g -= 1
    return g


def one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """`jax.nn.one_hot`: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: equal values in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_mlp(x, p, cfg, *, group_size: int = 512, capacity_factor: float = 1.25):
    """x (B, S, d) -> ((B, S, d), aux_loss). GShard grouped capacity dispatch."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    g = _pick_group(T, group_size)
    G = T // g
    C = max(1, int(g * k * capacity_factor / E))
    xt = x.reshape(G, g, d)

    # --- router (f32) ---
    logits = torch.einsum("gsd,de->gse", xt.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)                      # (G,g,E)
    topw, topi = top_k(probs, k)                               # (G,g,k)
    topw = topw / torch.sum(topw, -1, keepdim=True)
    # Switch-style load-balance aux
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(one_hot(topi[..., 0], E, torch.float32), dim=(0, 1))
    aux = E * torch.sum(me * ce)

    # --- capacity positions: rank of each (token, choice) in its expert queue
    oh = one_hot(topi, E, torch.int32)                         # (G,g,k,E)
    pos = (torch.cumsum(oh.reshape(G, g * k, E), dim=1) - 1).reshape(G, g, k, E)
    pos_k = torch.sum(pos * oh, dim=-1)                        # (G,g,k)
    in_cap = pos_k < C

    # --- combine tensor (G,g,E,C), built per choice
    combine = torch.zeros((G, g, E, C), dtype=torch.float32, device=x.device)
    for kk in range(k):
        oe = one_hot(topi[..., kk], E, torch.float32)                         # (G,g,E)
        oc = one_hot(torch.where(in_cap[..., kk], pos_k[..., kk], -1), C,
                     torch.float32)                                           # (G,g,C)
        combine = combine + topw[..., kk, None, None] * oe[..., None] * oc[:, :, None, :]
    dispatch = (combine > 0).to(cfg.dtype)                     # (G,g,E,C)

    # --- dispatch -> expert FFN -> combine ---
    xe = torch.einsum("gsec,gsd->egcd", dispatch, xt.to(cfg.dtype))
    wi, wg, wo = (p[n].to(cfg.dtype) for n in ("wi", "wg", "wo"))
    if cfg.mlp == "gated":
        h = layers.silu(torch.einsum("egcd,edf->egcf", xe, wg)) * \
            torch.einsum("egcd,edf->egcf", xe, wi)
    else:
        h = layers.gelu(torch.einsum("egcd,edf->egcf", xe, wi))
    ye = torch.einsum("egcf,efd->egcd", h, wo)
    y = torch.einsum("gsec,egcd->gsd", combine.to(cfg.dtype), ye)
    return y.reshape(B, S, d), aux
