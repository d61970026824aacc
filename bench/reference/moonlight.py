"""Plain reference of Moonlight-16B-A3B's forward pass (DeepSeek-V3's block),
in float32 `torch` operations: no kernel, no cache, no batching.

It follows the published modelling code of `model_type: deepseek_v3`
(`DeepseekV3ForCausalLM`), read from its description:

    x = embed(tokens)
    each layer:  h = x + MLA(rmsnorm(x));  x = h + MLP(rmsnorm(h))
    logits = lm_head(rmsnorm(x))

- MLA without a query low-rank projection: q = x Wq split into q_nope and
  q_pe; [c_kv, k_pe] = x Wkv_a; k_nope and v from rmsnorm(c_kv) Wkv_b;
  RoPE on q_pe and k_pe (k_pe shared by the heads); causal softmax of
  (q_nope . k_nope + q_pe . k_pe) / sqrt(qk_nope_head_dim + qk_rope_head_dim)
  over v, then Wo.
- MLP: silu(x Wg) * (x Wi) Wo, of width `intermediate_size` on the first
  `first_k_dense_replace` layers.  The others: routed experts of width
  `moe_intermediate_size` and a shared gated MLP of `n_shared_experts`
  times that width.  The gate (`noaux_tc`, one group): sigmoid of the
  float32 logits, the `num_experts_per_tok` experts of largest score +
  `e_score_correction_bias`, weighted by their unbiased scores
  renormalised over them (`norm_topk_prob`) times
  `routed_scaling_factor`.  Every picked expert is computed; nothing drops.
- RMSNorm with `rms_norm_eps`; RoPE with `rope_theta`, no scaling.

Departure: RoPE rotates the two halves of q_pe/k_pe, where the published
code de-interleaves their even and odd columns first; on any weights
that is a fixed permutation of the rope columns of Wq and Wkv_a.
Everything else is computed as published, in float32 (TF32 off).

Weights are a dict of tensors, each matrix (d_in, d_out), the layers
stacked on a leading axis: "embed" {"w" (V, d)}, "final_norm" {"w"},
"lm_head" {"w" (d, V)}, and "dense_blocks" / "blocks" each {"attn":
{"wq", "wkv_a", "kv_norm", "wkv_b", "wo"}, "norm1", "norm2", "mlp"}; a
dense "mlp" is {"wi", "wg", "wo"}, a MoE one {"router": {"w" (d, E),
"bias" (E,)}, "wi" (E, d, f), "wg", "wo" (E, f, d), "shared": {"wi", "wg",
"wo"}}; every leaf is {"w": ...} but the experts' stacks.  Each layer's
weights are upcast to float32 in turn, so a model held in bfloat16 fits
beside its reference.  `arch` holds the published config's keys.

This file imports nothing but torch; `bench/reference/moonlight.py` is a
copy of it.
"""
from __future__ import annotations

import torch

Q_CHUNK = 1024        # query rows a score tile holds


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _n_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """x (S, H, D), positions (S,): the two halves rotated by
    positions * theta^(-2i/D)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device, dtype=torch.float32) / D)
    ang = positions.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(x, p, arch):
    """x (S, d) normed -> (S, d)."""
    S = x.shape[0]
    H, r = arch["num_attention_heads"], arch["kv_lora_rank"]
    nope, rp, vd = arch["qk_nope_head_dim"], arch["qk_rope_head_dim"], arch["v_head_dim"]
    pos = torch.arange(S, device=x.device)
    q = (x @ p["wq"]["w"]).reshape(S, H, nope + rp)
    q_nope, q_pe = q[..., :nope], rope(q[..., nope:], pos, arch["rope_theta"])
    kv_a = x @ p["wkv_a"]["w"]
    ckv = rmsnorm(kv_a[:, :r], p["kv_norm"]["w"], arch["rms_norm_eps"])
    k_pe = rope(kv_a[:, None, r:], pos, arch["rope_theta"])[:, 0]          # (S, rope)
    kv = (ckv @ p["wkv_b"]["w"]).reshape(S, H, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    scale = (nope + rp) ** -0.5
    out = []
    for a in range(0, S, Q_CHUNK):
        b = min(a + Q_CHUNK, S)
        s = (torch.einsum("qhn,thn->hqt", q_nope[a:b], k_nope[:b])
             + torch.einsum("qhr,tr->hqt", q_pe[a:b], k_pe[:b])) * scale
        causal = torch.arange(b, device=x.device)[None, :] <= \
            torch.arange(a, b, device=x.device)[:, None]
        s = s.masked_fill(~causal[None], float("-inf"))
        out.append(torch.einsum("hqt,thv->qhv", torch.softmax(s, dim=-1), v[:b]))
    return torch.cat(out).reshape(S, H * vd) @ p["wo"]["w"]


def gated(x, wi, wg, wo):
    return (torch.nn.functional.silu(x @ wg) * (x @ wi)) @ wo


def route(x, p, arch):
    """x (S, d) -> (weights (S, k), experts (S, k))."""
    scores = torch.sigmoid(x @ p["router"]["w"])
    k = arch["num_experts_per_tok"]
    idx = torch.topk(scores + p["router"]["bias"], k, dim=-1).indices
    w = torch.gather(scores, -1, idx)
    if k > 1 and arch["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * arch["routed_scaling_factor"], idx


def moe(x, p, arch):
    """x (S, d) normed -> (S, d): every picked expert on its tokens, then
    the shared experts on every token."""
    w, idx = route(x, p, arch)
    y = torch.zeros_like(x)
    for e in range(p["wi"].shape[0]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if len(tok):
            y.index_add_(0, tok, w[tok, slot, None] *
                         gated(x[tok], p["wi"][e], p["wg"][e], p["wo"][e]))
    sh = p["shared"]
    return y + gated(x, sh["wi"]["w"], sh["wg"]["w"], sh["wo"]["w"])


def logits(params: dict, arch: dict, seqs: list, want: list | None = None) -> list:
    """The float32 logits of each token sequence in `seqs` ((S,) int
    tensors on the params' device), at the positions `want[i]` gives (all
    where None): a list of (n_i, V) tensors.  The model runs layer by
    layer over the sequences, each in turn."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = arch["rms_norm_eps"]
    try:
        with torch.no_grad():
            xs = [params["embed"]["w"][s.long()].float() for s in seqs]
            for name, dense in (("dense_blocks", True), ("blocks", False)):
                stack = params[name]
                for i in range(_n_layers(stack)):
                    p = _f32(_layer(stack, i))
                    for j, x in enumerate(xs):
                        h = x + attention(rmsnorm(x, p["norm1"]["w"], eps), p["attn"], arch)
                        hn = rmsnorm(h, p["norm2"]["w"], eps)
                        if dense:
                            m = p["mlp"]
                            y = gated(hn, m["wi"]["w"], m["wg"]["w"], m["wo"]["w"])
                        else:
                            y = moe(hn, p["mlp"], arch)
                        xs[j] = h + y
                    del p
            head = params["lm_head"]["w"].float()
            norm = params["final_norm"]["w"].float()
            out = []
            for j, x in enumerate(xs):
                if want is not None:
                    x = x[want[j]]
                out.append(rmsnorm(x, norm, eps) @ head)
            return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
