"""The useful work of Kimi-Linear-48B-A3B's served steps, counted from the
configuration's published keys (`bench/configs/kimi-linear-48b-a3b-ep2.
json`: this device's `num_experts` of the router's `router_experts`),
and of its two KDA kernels.

FLOPs are 2 a multiply-add of the matmuls the algorithm needs: every
weight matrix a token passes through (the experts it picks that this
device holds, k E_held / E_router a token on average under a uniform
choice; the lm head where logits are taken), MLA over the context in the
form the program runs it (expanded in prefill: causal pairs only, q_nope
. k_nope + q_pe . k_pe, then the values; absorbed in decode: scores
against the latent and the pe key, the latent output), and KDA's
recurrence: a decode step's decay, delta update and readout, 4 K V
multiply-adds a head and token; a prefill's chunked form,
`kda_prefill_flops`.  The short convolutions and the gates' elementwise
work are left out.

Bytes: each weight read once a call (a decode step reads only the held
experts its tokens touched), the latent cache read over each slot's
context and written once a token, the KDA state read and written once a
decode step (float32) and written once a prefill, the embedding rows and
the logits written.  Activations between the layers are left out.  A KDA
kernel call: its inputs read once and its outputs written once (float32).

`PEAK_BF16` is the dense bfloat16 rate of the H100 SXM5 data sheet at its
700 W limit (989 TFLOP/s); `bench/work/peaks.py` holds the card's other
rates and its memory bandwidth.
"""
from __future__ import annotations

PEAK_BF16 = 989e12
BYTES = 2                       # bfloat16 weights and cache
F32 = 4                         # the router, A_log, dt_bias, the KDA state
CHUNK = 64                      # the prefill kernel's chunk


def _kda(arch: dict) -> tuple[int, int, int, int]:
    """(KDA layers, heads, head width, convolution taps)."""
    la = arch["linear_attn_config"]
    return len(la["kda_layers"]), la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]


def sizes(arch: dict) -> dict:
    """The parameter counts by part (the experts held here)."""
    d, H = arch["hidden_size"], arch["num_attention_heads"]
    r, nope, rope, vd = (arch["kv_lora_rank"], arch["qk_nope_head_dim"],
                         arch["qk_rope_head_dim"], arch["v_head_dim"])
    nk, Hk, K, W = _kda(arch)
    E, Er, f = arch["num_experts"], arch["router_experts"], arch["moe_intermediate_size"]
    L, Ld = arch["num_hidden_layers"], arch["first_k_dense_replace"]
    mla = d * H * (nope + rope) + d * (r + rope) + r * H * (nope + vd) + H * vd * d
    kda_mm = d * 3 * Hk * K + d * K + K * Hk * K + d * Hk + d * K + K * Hk * K + Hk * K * d
    # the convolution, g_b's bias, A_log, dt_bias, the output norm
    kda_other = 3 * Hk * K * W + Hk * K + Hk + Hk * K + K
    return {"mla": mla, "mla_norm": r, "kda_mm": kda_mm, "kda_other": kda_other,
            "norms": 2 * d, "dense_mlp": 3 * d * arch["intermediate_size"],
            "expert": 3 * d * f, "n_experts": E, "router_experts": Er,
            "shared": 3 * d * f * arch["num_shared_experts"], "router": d * Er + Er,
            "vocab": arch["vocab_size"] * d, "layers": L, "dense_layers": Ld,
            "moe_layers": L - Ld, "kda_layers": nk, "mla_layers": L - nk}


def params_total(arch: dict) -> int:
    s = sizes(arch)
    moe = s["n_experts"] * s["expert"] + s["shared"] + s["router"]
    return (s["mla_layers"] * (s["mla"] + s["mla_norm"])
            + s["kda_layers"] * (s["kda_mm"] + s["kda_other"]) + s["layers"] * s["norms"]
            + s["dense_layers"] * s["dense_mlp"] + s["moe_layers"] * moe
            + 2 * s["vocab"] + arch["hidden_size"])


def experts_a_token(arch: dict) -> float:
    """The held experts a token picks, on average: k E_held / E_router."""
    return arch["num_experts_per_token"] * arch["num_experts"] / arch["router_experts"]


def params_active(arch: dict) -> float:
    """The weights a token's matmuls pass through: every layer's attention
    projections, the dense MLP, its held experts and the shared one, the
    routers, the lm head (the embedding is a gather)."""
    s = sizes(arch)
    return (s["mla_layers"] * s["mla"] + s["kda_layers"] * s["kda_mm"]
            + s["dense_layers"] * s["dense_mlp"]
            + s["moe_layers"] * (experts_a_token(arch) * s["expert"] + s["shared"] + s["router"])
            + s["vocab"])


def kda_prefill_flops(arch: dict, S: int) -> float:
    """One KDA layer's chunked recurrence over a prompt of S tokens, every
    head: a chunk of c tokens computes A (c (c - 1) / 2 key pairs) and P
    (c (c + 1) / 2 query-key pairs) over K channels, the state's products
    with k and q (2 c K V), the triangular solve (c (c - 1) / 2 V), P U
    (c (c + 1) / 2 V) and the state's update (c K V)."""
    _, H, K, _ = _kda(arch)
    V = K
    total = 0.0
    for a in range(0, S, CHUNK):
        c = min(CHUNK, S - a)
        pairs = c * c
        total += pairs * K + pairs * V + 3 * c * K * V
    return 2.0 * H * total


def kda_decode_flops(arch: dict, active: int) -> float:
    """One KDA layer's step over `active` slots: decay, S^T k, the rank-1
    update, S^T q."""
    _, H, K, _ = _kda(arch)
    return 2.0 * active * H * 4 * K * K


def kda_prefill_bytes(arch: dict, S: int) -> float:
    """A prefill kernel call: q, k, g and v, beta read, o and the final
    state written, float32."""
    _, H, K, _ = _kda(arch)
    return F32 * (S * H * (3 * K + K + 1) + S * H * K + H * K * K)


def kda_decode_bytes(arch: dict, active: int) -> float:
    """A decode kernel call: each slot's state read and written, its q, k,
    g, v and beta read and o written, float32."""
    _, H, K, _ = _kda(arch)
    return F32 * active * H * (2 * K * K + 5 * K + 1)


def kda_kernels_bound_s(arch: dict, work: dict, peaks: dict) -> float:
    """The least time of a window's KDA kernel calls: every KDA layer of
    each prefill and each decode step, each call the larger of its FLOPs
    over the card's float32 peak (the kernels compute in float32) and its
    bytes over the memory's rate."""
    nk = _kda(arch)[0]

    def call(flops, nbytes):
        return nk * max(flops / peaks["float32"], nbytes / peaks["hbm_bytes_per_s"])
    return (sum(call(kda_prefill_flops(arch, S), kda_prefill_bytes(arch, S))
                for S in work["prompts"])
            + sum(call(kda_decode_flops(arch, a), kda_decode_bytes(arch, a))
                  for a, _ in work["steps"]))


def prefill_flops(arch: dict, S: int) -> float:
    """A prompt of S tokens: the matmuls of every token (the lm head at the
    last only), expanded causal MLA, S (S + 1) / 2 pairs a layer and head,
    and every KDA layer's chunked recurrence."""
    s = sizes(arch)
    H, nope, rope, vd = (arch["num_attention_heads"], arch["qk_nope_head_dim"],
                         arch["qk_rope_head_dim"], arch["v_head_dim"])
    attn = s["mla_layers"] * 2.0 * H * (nope + rope + vd) * S * (S + 1) / 2
    return (S * 2.0 * (params_active(arch) - s["vocab"]) + 2.0 * s["vocab"] + attn
            + s["kda_layers"] * kda_prefill_flops(arch, S))


def decode_flops(arch: dict, active: int, ctx: float) -> float:
    """A decode step of `active` tokens whose contexts sum to `ctx`:
    absorbed MLA (scores on the latent and the pe key, the latent output)
    and KDA's step besides the matmuls."""
    s = sizes(arch)
    H, r, rope = arch["num_attention_heads"], arch["kv_lora_rank"], arch["qk_rope_head_dim"]
    return (active * 2.0 * params_active(arch)
            + s["mla_layers"] * 2.0 * H * (2 * r + rope) * ctx
            + s["kda_layers"] * kda_decode_flops(arch, active))


def cache_bytes_token(arch: dict) -> int:
    """The latent cache of one token over the MLA layers (ckv and kpe)."""
    return sizes(arch)["mla_layers"] * (arch["kv_lora_rank"] + arch["qk_rope_head_dim"]) * BYTES


def state_bytes_slot(arch: dict) -> int:
    """A slot's KDA state over the KDA layers (float32)."""
    nk, H, K, _ = _kda(arch)
    return nk * H * K * K * F32


def experts_touched(arch: dict, tokens: int) -> float:
    """The held experts of a layer that `tokens` tokens touch, expected
    under a uniform choice of k of the router's E: E_held (1 - (1 -
    k / E)^tokens)."""
    k, Er = arch["num_experts_per_token"], arch["router_experts"]
    return arch["num_experts"] * (1.0 - (1.0 - k / Er) ** tokens)


def _weights_bytes(arch: dict, touched_per_layer: float) -> float:
    s = sizes(arch)
    dense = (s["mla_layers"] * (s["mla"] + s["mla_norm"]) + s["kda_layers"] * s["kda_mm"]
             + s["layers"] * s["norms"] + s["dense_layers"] * s["dense_mlp"]
             + s["moe_layers"] * s["shared"] + s["vocab"]) * BYTES
    return (dense + s["kda_layers"] * s["kda_other"] * F32
            + s["moe_layers"] * (touched_per_layer * s["expert"] * BYTES
                                 + s["router"] * F32))


def decode_step_bytes(arch: dict, active: int, ctx_total: float) -> float:
    """A decode step of `active` slots whose contexts sum to `ctx_total`
    positions: the weights (the held experts touched), the latent cache
    read over each context and written once a slot, the KDA state read
    and written, the tokens' embedding rows, the logits (float32)
    written."""
    d, V = arch["hidden_size"], arch["vocab_size"]
    return (_weights_bytes(arch, experts_touched(arch, active))
            + ctx_total * cache_bytes_token(arch) + 2 * active * state_bytes_slot(arch)
            + active * (d * BYTES + 4 * V))


def prefill_bytes(arch: dict, S: int) -> float:
    """A prompt of S tokens: every weight once (the held experts its tokens
    touch), the latent rows and the KDA state written, the embedding rows,
    one logits row."""
    d, V = arch["hidden_size"], arch["vocab_size"]
    return (_weights_bytes(arch, experts_touched(arch, S)) + S * cache_bytes_token(arch)
            + state_bytes_slot(arch) + S * d * BYTES + 4 * V)


def bound_s(flops: float, nbytes: float, hbm_bytes_per_s: float) -> float:
    return max(flops / PEAK_BF16, nbytes / hbm_bytes_per_s)


def window_bound_s(arch: dict, work: dict, hbm_bytes_per_s: float) -> float:
    """The least time of a window's work: each prefill and each decode step
    at its own bound.  `work`: "prompts" (the prompt lengths prefilled),
    "steps" (each decode step's [active slots, summed context])."""
    t = sum(bound_s(prefill_flops(arch, S), prefill_bytes(arch, S), hbm_bytes_per_s)
            for S in work["prompts"])
    return t + sum(bound_s(decode_flops(arch, a, c), decode_step_bytes(arch, a, c),
                           hbm_bytes_per_s) for a, c in work["steps"])


def window_flops(arch: dict, work: dict) -> float:
    """The useful FLOPs of a window's prefills and decode steps."""
    return (sum(prefill_flops(arch, S) for S in work["prompts"])
            + sum(decode_flops(arch, a, c) for a, c in work["steps"]))
