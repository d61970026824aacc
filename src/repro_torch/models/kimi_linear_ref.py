"""Plain reference of Kimi-Linear-48B-A3B's forward pass, in float32
`torch` operations: no kernel, no cache, no batching.

It follows the published description of `model_type: kimi_linear` (the
model's `config.json` and the Kimi Linear tech report, arXiv:2510.26692):

    x = embed(tokens)
    each layer:  h = x + Attn(rmsnorm(x));  x = h + MLP(rmsnorm(h))
    logits = lm_head(rmsnorm(x))

- Attn is Kimi Delta Attention on the layers `linear_attn_config.
  kda_layers` names (1-based), MLA on the others.
- KDA, per head of `head_dim` K = V channels: q, k, v = SiLU of a causal
  depthwise convolution (`short_conv_kernel_size` taps, no bias, zero
  before the first token) of x Wq, x Wk, x Wv; q and k L2-normed (+ 1e-6),
  q scaled by K^-1/2; g = -exp(A_log[h]) * softplus(x Wfa Wfb + dt_bias)
  per channel; beta = sigmoid(x Wb) per head; from S_0 = 0,
      S_t = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + beta_t k_t v_t^T,
      o_t = S_t^T q_t;
  then RMSNorm(o) per head times sigmoid(x Wga Wgb + b), and Wo.
- MLA without a query low-rank projection and without RoPE
  (`mla_use_nope`): q = x Wq split into q_nope and q_pe; [c_kv, k_pe] =
  x Wkv_a; k_nope and v from rmsnorm(c_kv) Wkv_b; causal softmax of
  (q_nope . k_nope + q_pe . k_pe) / sqrt(qk_nope_head_dim +
  qk_rope_head_dim) over v, then Wo.
- MLP: silu(x Wg) * (x Wi) Wo, of width `intermediate_size` on the first
  `first_k_dense_replace` layers.  The others: routed experts of width
  `moe_intermediate_size` and a shared gated MLP of `num_shared_experts`
  times that width.  The gate: sigmoid of the float32 logits over all
  `num_experts`, the `num_experts_per_token` of largest score + the
  correction bias, weighted by their unbiased scores renormalised over
  them (`moe_renormalize`) times `routed_scaling_factor`.  The params may
  hold a share of the routed experts, from `expert_offset` on (expert
  parallelism): only the picked experts held are computed, and the
  others' part of the result is left out.

`logits(..., chunked=True)` runs the same recurrence in chunks of 64
tokens (the WY form, each decay factor taken as the exponential of a
later cumulative log decay less an earlier one); a test holds it to the
per-token form.  Everything is computed in float32 (TF32 off).

Weights are a dict of tensors, each matrix (d_in, d_out), the layers
stacked on a leading axis: "embed" {"w" (V, d)}, "final_norm" {"w"},
"lm_head" {"w" (d, V)}; "dense_blocks" / "blocks" each {"norm1", "norm2",
"mlp"}, a dense "mlp" {"wi", "wg", "wo"}, a MoE one {"router": {"w" (d,
E), "bias" (E,)}, "wi" (E_held, d, f), "wg", "wo" (E_held, f, d),
"shared": {"wi", "wg", "wo"}}; "kda_blocks" {"wqkv", "conv" (3HK, W),
"f_a", "f_b", "b", "g_a", "g_b" (with "b"), "A_log" (H,), "dt_bias"
(HK,), "o_norm", "wo"} and "mla_blocks" {"wq", "wkv_a", "kv_norm",
"wkv_b", "wo"}, each over its own layers in order; every leaf is {"w":
...} but the experts' stacks, A_log and dt_bias.  Each layer's weights
are upcast to float32 in turn, so a model held in bfloat16 fits beside
its reference.  `arch` holds the published config's keys (and
`expert_offset`).

This file imports nothing but torch; `bench/reference/kimi_linear.py` is
a copy of it.
"""
from __future__ import annotations

import torch

Q_CHUNK = 1024        # query rows a score tile holds
KDA_CHUNK = 64        # tokens a chunk of the chunked recurrence
L2_EPS = 1e-6


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def mla(x, p, arch):
    """x (S, d) normed -> (S, d)."""
    S = x.shape[0]
    H, r = arch["num_attention_heads"], arch["kv_lora_rank"]
    nope, rp, vd = arch["qk_nope_head_dim"], arch["qk_rope_head_dim"], arch["v_head_dim"]
    q = (x @ p["wq"]["w"]).reshape(S, H, nope + rp)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    kv_a = x @ p["wkv_a"]["w"]
    ckv = rmsnorm(kv_a[:, :r], p["kv_norm"]["w"], arch["rms_norm_eps"])
    k_pe = kv_a[:, r:]
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


def recurrence(q, k, v, g, beta):
    """The delta rule token by token: q, k, g (S, H, K), v (S, H, V), beta
    (S, H) -> o (S, H, V), from S_0 = 0."""
    S, H, K = k.shape
    state = torch.zeros(H, K, v.shape[-1], dtype=torch.float32, device=k.device)
    out = []
    for t in range(S):
        state = state * g[t].exp()[..., None]
        kt = k[t][..., None]                                              # (H, K, 1)
        state = state - beta[t][:, None, None] * kt * (kt.transpose(1, 2) @ state) \
            + beta[t][:, None, None] * kt * v[t][:, None, :]
        out.append(torch.einsum("hkv,hk->hv", state, q[t]))
    return torch.stack(out)


def chunked(q, k, v, g, beta, chunk: int = KDA_CHUNK):
    """The same recurrence in chunks of `chunk` tokens, the state carried
    from chunk to chunk: within one, with b the cumulative log decay,
    A[t, s] = sum_c k_tc k_sc exp(b_tc - b_sc) (s < t) and P the same of
    q and k (s <= t); (I + beta A) U = beta (v - (k exp(b)) S);
    o = (q exp(b)) S + P U; S <- exp(b_last) S + (k exp(b_last - b))^T U."""
    S_len, H, K = k.shape
    state = torch.zeros(H, K, v.shape[-1], dtype=torch.float32, device=k.device)
    out = []
    for a in range(0, S_len, chunk):
        e = min(a + chunk, S_len)
        n = e - a
        qc, kc, vc = (x[a:e].transpose(0, 1) for x in (q, k, v))            # (H, n, .)
        bc = g[a:e].transpose(0, 1).cumsum(1)                                # (H, n, K)
        bt = beta[a:e].transpose(0, 1)[..., None]                            # (H, n, 1)
        t = torch.arange(n, device=k.device)
        diff = (bc[:, :, None, :] - bc[:, None, :, :]).masked_fill(
            (t[:, None] < t[None, :])[None, :, :, None], float("-inf"))
        decay = diff.exp()                                                   # (H, t, s, K)
        A = torch.einsum("htk,hsk,htsk->hts", kc, kc, decay) * (t[:, None] > t[None, :])
        P = torch.einsum("htk,hsk,htsk->hts", qc, kc, decay)
        rhs = bt * (vc - (kc * bc.exp()) @ state)
        U = torch.linalg.solve_triangular(torch.eye(n, device=k.device) + bt * A, rhs,
                                          upper=False, unitriangular=True)
        out.append(((qc * bc.exp()) @ state + P @ U).transpose(0, 1))
        last = bc[:, -1:, :]                                                 # (H, 1, K)
        state = last.transpose(1, 2).exp() * state + \
            (kc * (last - bc).exp()).transpose(1, 2) @ U
    return torch.cat(out)


def kda(x, p, arch, use_chunks: bool):
    """x (S, d) normed -> (S, d)."""
    S = x.shape[0]
    la = arch["linear_attn_config"]
    H, K, W = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    xp = torch.cat([torch.zeros(W - 1, 3 * H * K, device=x.device), x @ p["wqkv"]["w"]])
    conv = sum(xp[i:i + S] * p["conv"]["w"][:, i] for i in range(W))
    q, k, v = torch.nn.functional.silu(conv).reshape(S, 3, H, K).unbind(1)
    q = q * torch.rsqrt(q.pow(2).sum(-1, keepdim=True) + L2_EPS) * K ** -0.5
    k = k * torch.rsqrt(k.pow(2).sum(-1, keepdim=True) + L2_EPS)
    f = (x @ p["f_a"]["w"]) @ p["f_b"]["w"] + p["dt_bias"]
    g = -p["A_log"].exp()[:, None] * torch.nn.functional.softplus(f.reshape(S, H, K))
    beta = torch.sigmoid(x @ p["b"]["w"])
    o = (chunked if use_chunks else recurrence)(q, k, v, g, beta)
    gate = torch.sigmoid((x @ p["g_a"]["w"]) @ p["g_b"]["w"] + p["g_b"]["b"]).reshape(S, H, K)
    o = rmsnorm(o, p["o_norm"]["w"], arch["rms_norm_eps"]) * gate
    return o.reshape(S, H * K) @ p["wo"]["w"]


def gated(x, wi, wg, wo):
    return (torch.nn.functional.silu(x @ wg) * (x @ wi)) @ wo


def route(x, p, arch):
    """x (S, d) -> (weights (S, k), experts (S, k)) over all experts."""
    scores = torch.sigmoid(x @ p["router"]["w"])
    k = arch["num_experts_per_token"]
    idx = torch.topk(scores + p["router"]["bias"], k, dim=-1).indices
    w = torch.gather(scores, -1, idx)
    if k > 1 and arch["moe_renormalize"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * arch["routed_scaling_factor"], idx


def moe(x, p, arch):
    """x (S, d) normed -> (S, d): every picked expert held here on its
    tokens, then the shared experts on every token."""
    w, idx = route(x, p, arch)
    y = torch.zeros_like(x)
    first = arch.get("expert_offset", 0)
    for e in range(p["wi"].shape[0]):
        tok, slot = torch.nonzero(idx == first + e, as_tuple=True)
        if len(tok):
            y.index_add_(0, tok, w[tok, slot, None] *
                         gated(x[tok], p["wi"][e], p["wg"][e], p["wo"][e]))
    sh = p["shared"]
    return y + gated(x, sh["wi"]["w"], sh["wg"]["w"], sh["wo"]["w"])


def logits(params: dict, arch: dict, seqs: list, want: list | None = None,
           chunked: bool = False) -> list:
    """The float32 logits of each token sequence in `seqs` ((S,) int
    tensors on the params' device), at the positions `want[i]` gives (all
    where None): a list of (n_i, V) tensors.  The model runs layer by
    layer over the sequences, each in turn; `chunked` runs KDA's
    recurrence in its chunked form."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = arch["rms_norm_eps"]
    kda_layers = {i - 1 for i in arch["linear_attn_config"]["kda_layers"]}
    try:
        with torch.no_grad():
            xs = [params["embed"]["w"][s.long()].float() for s in seqs]
            n_dense = params["dense_blocks"]["norm1"]["w"].shape[0]
            n_layers = n_dense + params["blocks"]["norm1"]["w"].shape[0]
            seen = {"kda_blocks": 0, "mla_blocks": 0}
            for li in range(n_layers):
                dense = li < n_dense
                blk = _f32(_layer(params["dense_blocks" if dense else "blocks"],
                                  li if dense else li - n_dense))
                stack = "kda_blocks" if li in kda_layers else "mla_blocks"
                pa = _f32(_layer(params[stack], seen[stack]))
                seen[stack] += 1
                for j, x in enumerate(xs):
                    xn = rmsnorm(x, blk["norm1"]["w"], eps)
                    h = x + (kda(xn, pa, arch, chunked) if stack == "kda_blocks"
                             else mla(xn, pa, arch))
                    hn = rmsnorm(h, blk["norm2"]["w"], eps)
                    m = blk["mlp"]
                    y = gated(hn, m["wi"]["w"], m["wg"]["w"], m["wo"]["w"]) if dense \
                        else moe(hn, m, arch)
                    xs[j] = h + y
                del blk, pa
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
