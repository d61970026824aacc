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


# --- DeepSeek-V3's routed experts: sigmoid + bias, dropless, shared experts --

ROUTER_BIAS_STD = 0.05    # the correction bias's draw (learned in the release)
# Each routed expert is drawn as one draw shared by the layer's experts plus
# EXPERT_SPREAD times a draw of its own (as sparse upcycling starts its
# experts from one dense MLP, Komatsuzaki et al. 2022).  With independent
# random experts, each rounding that flips a top-k choice swaps a k-th of
# the layer's routed output for an unrelated one; over 26 MoE layers that
# makes a random model chaotic, and bfloat16 and int8 weights then land
# equally far from a float32 forward (`PERF.md` §6).
EXPERT_SPREAD = 0.1


def init_routed_moe(draw: layers.Draw, cfg, lead: tuple = ()) -> tuple[dict, dict]:
    """Router (float32 `router_dtype`, with its correction bias) over
    `n_experts`, the `n_held` gated experts held here of width `moe_d_ff`
    and one gated MLP of width `n_shared_experts * moe_d_ff` for the
    shared experts.  The experts'
    stacks are drawn a layer at a time around a shared draw
    (`Draw.normal_around`, `EXPERT_SPREAD`)."""
    if cfg.router_scoring != "sigmoid":
        raise ValueError(f"routed_moe routes by sigmoid scores, not {cfg.router_scoring!r}")
    d, f, E, Eh = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, cfg.n_held
    dt, rt = cfg.param_dtype, cfg.router_dtype
    p = {
        "router": {"w": draw.normal(lead + (d, E), 1.0 / math.sqrt(d), rt),
                   "bias": draw.normal(lead + (E,), ROUTER_BIAS_STD, rt)},
        "wi": draw.normal_around(lead + (Eh, d, f), 1.0 / math.sqrt(d), EXPERT_SPREAD, dt),
        "wg": draw.normal_around(lead + (Eh, d, f), 1.0 / math.sqrt(d), EXPERT_SPREAD, dt),
        "wo": draw.normal_around(lead + (Eh, f, d), 1.0 / math.sqrt(f), EXPERT_SPREAD, dt),
    }
    ps, as_ = layers.init_mlp(draw, d, cfg.n_shared_experts * f, "gated", dt, lead)
    p["shared"] = ps
    a = {
        "router": {"w": (None, None), "bias": (None,)},
        "wi": ("experts", "fsdp", None),
        "wg": ("experts", "fsdp", None),
        "wo": ("experts", None, "fsdp"),
    }
    return p, dict(layers.stacked_axes(a, lead), shared=as_)


def route_sigmoid(x2, p, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x2 (T, d) -> (weights (T, k) float32, experts (T, k) int64): the
    published `noaux_tc` gate with one group.  Scores are the sigmoid of
    float32 logits; the k experts are picked on score + bias (ties toward
    the lower index); their weights are the unbiased scores, renormalised
    over the k (`norm_topk_prob`, + 1e-20 as published) and times
    `routed_scale`."""
    w = layers._materialize(p["router"]["w"], torch.float32)
    scores = torch.sigmoid(x2.float() @ w)
    _, idx = top_k(scores + p["router"]["bias"].float(), cfg.top_k)
    weights = torch.gather(scores, -1, idx)
    if cfg.top_k > 1 and cfg.norm_topk_prob:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return weights * cfg.routed_scale, idx


def routed_moe(x, p, cfg, *, capacity: int | None = None, load: list | None = None):
    """x (B, S, d) -> (B, S, d): every (token, expert) pair the router picks
    is computed (dropless), weighted and summed in float32, plus the shared
    experts' gated MLP on every token.

    The routed pairs are sorted by expert into a padded (E, C, d) batch,
    C the most pairs any expert got, and the experts run as three batched
    matmuls over it: one launch each for all experts.  `capacity` fixes C
    instead (>= that most; a token picks an expert at most once, so C = T
    always holds): with it nothing is read back to the host, which a decode
    step uses.  With `load` a list, the experts' pair counts (E,) are
    appended to it, on the device.

    Where this device holds a share of the experts (`cfg.n_held` of
    `n_experts`, from `expert_offset`), the router still picks over all of
    them, and only the pairs routed to the held experts are computed: the
    others are sorted last, behind a bin of their own, and written to a
    row of the batch that no matmul reads, with weight 0.  The result is
    this device's part of the layer, the shared experts included."""
    B, S, d = x.shape
    E, k = cfg.n_held, cfg.top_k
    T = B * S
    x2 = x.reshape(T, d)
    weights, idx = route_sigmoid(x2, p, cfg)
    e = idx.reshape(-1)                                           # (T*k,)
    w = weights.reshape(-1)
    share = E != cfg.n_experts
    if share:
        e = e - cfg.expert_offset
        mine = (e >= 0) & (e < E)
        e = torch.where(mine, e, E)                              # E: not held here
    order = torch.argsort(e, stable=True)
    e_s = e[order]
    tok = order // k
    counts = torch.bincount(e, minlength=E + share)
    if share:
        counts = counts[:E]
    if load is not None:
        load.append(counts)
    starts = torch.cumsum(counts, 0) - counts
    if share:
        e_g = e_s.clamp(max=E - 1)              # the pairs not held read 0 weight
        rank = torch.where(e_s < E, torch.arange(T * k, device=x.device) - starts[e_g], 0)
        w = torch.where(mine, w, 0.0)
    else:
        e_g = e_s
        rank = torch.arange(T * k, device=x.device) - starts[e_s]
    C = capacity if capacity is not None else int(counts.max())
    xe = torch.zeros((E + share, C, d), dtype=cfg.dtype, device=x.device)
    xe[e_s, rank] = x2[tok].to(cfg.dtype)
    xe = xe[:E]
    wi, wg, wo = (layers._materialize(p[n], cfg.dtype) for n in ("wi", "wg", "wo"))
    h = layers.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wi)
    ye = torch.bmm(h, wo)                                          # (E, C, d)
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    y.index_add_(0, tok, ye[e_g, rank].float() * w[order, None])
    shared = layers.mlp(x, p["shared"], "gated", cfg.dtype)
    return y.to(cfg.dtype).reshape(B, S, d) + shared
