"""The useful work of Moonlight-16B-A3B's served steps, counted from the
published config's keys (`bench/configs/moonlight-16b-a3b.json`), and
the card's bfloat16 peak.

FLOPs are 2 a multiply-add of the matmuls the algorithm needs: every
weight matrix a token passes through (the 6 routed experts it picks, not
all 64; the lm head where logits are taken), and attention over the
context in the form the program runs it: expanded in prefill (causal
pairs only, q_nope . k_nope + q_pe . k_pe, then the values), absorbed in
decode (scores against the latent and the roped key, the latent output).
Bytes: each weight read once a call (a decode step reads only the experts
its tokens touched), the latent cache read over each slot's context and
written once a token, embedding rows, and the logits written.
Activations between the layers are left out.

`PEAK_BF16` is the dense bfloat16 rate of the H100 SXM5 data sheet at its
700 W limit (989 TFLOP/s); `bench/work/peaks.py` holds the card's other
rates and its memory bandwidth.
"""
from __future__ import annotations

PEAK_BF16 = 989e12
BYTES = 2                       # bfloat16 weights and cache
ROUTER_BYTES = 4                # the float32 router and its bias


def sizes(arch: dict) -> dict:
    """The parameter counts by part."""
    d, H = arch["hidden_size"], arch["num_attention_heads"]
    r, nope, rope, vd = (arch["kv_lora_rank"], arch["qk_nope_head_dim"],
                         arch["qk_rope_head_dim"], arch["v_head_dim"])
    E, f = arch["n_routed_experts"], arch["moe_intermediate_size"]
    L, Ld = arch["num_hidden_layers"], arch["first_k_dense_replace"]
    attn = d * H * (nope + rope) + d * (r + rope) + r * H * (nope + vd) + H * vd * d
    norms = 2 * d + r
    return {"attn": attn, "norms": norms,
            "dense_mlp": 3 * d * arch["intermediate_size"],
            "expert": 3 * d * f, "n_experts": E,
            "shared": 3 * d * f * arch["n_shared_experts"],
            "router": d * E + E,
            "vocab": arch["vocab_size"] * d,
            "layers": L, "dense_layers": Ld, "moe_layers": L - Ld}


def params_total(arch: dict) -> int:
    s = sizes(arch)
    per_layer = s["attn"] + s["norms"]
    moe = s["n_experts"] * s["expert"] + s["shared"] + s["router"]
    return (s["layers"] * per_layer + s["dense_layers"] * s["dense_mlp"]
            + s["moe_layers"] * moe + 2 * s["vocab"] + arch["hidden_size"])


def params_active(arch: dict) -> int:
    """The weights a token's matmuls pass through: every layer's attention,
    the dense MLP, k experts and the shared ones, the routers, the lm head
    (the embedding is a gather, not a matmul)."""
    s = sizes(arch)
    k = arch["num_experts_per_tok"]
    return (s["layers"] * s["attn"] + s["dense_layers"] * s["dense_mlp"]
            + s["moe_layers"] * (k * s["expert"] + s["shared"] + s["router"])
            + s["vocab"])


def _matmul_flops_token(arch: dict, head: bool) -> float:
    s = sizes(arch)
    return 2.0 * (params_active(arch) - (0 if head else s["vocab"]))


def prefill_flops(arch: dict, S: int) -> float:
    """A prompt of S tokens: the matmuls of every token (the lm head at the
    last only) and expanded causal attention, S (S + 1) / 2 pairs a
    layer and head."""
    H, nope, rope, vd = (arch["num_attention_heads"], arch["qk_nope_head_dim"],
                         arch["qk_rope_head_dim"], arch["v_head_dim"])
    pairs = S * (S + 1) / 2
    attn = arch["num_hidden_layers"] * 2.0 * H * (nope + rope + vd) * pairs
    return S * _matmul_flops_token(arch, False) + 2.0 * sizes(arch)["vocab"] + attn


def decode_attn_flops(arch: dict, ctx: float) -> float:
    """Absorbed attention over `ctx` positions in all (summed over a step's
    slots, each context with its own token): scores on the latent and the
    roped key, the latent output."""
    H, r, rope = (arch["num_attention_heads"], arch["kv_lora_rank"],
                  arch["qk_rope_head_dim"])
    return arch["num_hidden_layers"] * 2.0 * H * (2 * r + rope) * ctx


def decode_flops(arch: dict, active: int, ctx: float) -> float:
    """A decode step of `active` tokens whose contexts sum to `ctx`."""
    return active * _matmul_flops_token(arch, True) + decode_attn_flops(arch, ctx)


def cache_bytes_token(arch: dict) -> int:
    """The latent cache of one token over all layers (ckv and kpe)."""
    return arch["num_hidden_layers"] * (arch["kv_lora_rank"] + arch["qk_rope_head_dim"]) * BYTES


def experts_touched(arch: dict, tokens: int) -> float:
    """The experts of a layer that `tokens` tokens touch, expected under a
    uniform choice of k of E: E (1 - (1 - k/E)^tokens)."""
    E, k = arch["n_routed_experts"], arch["num_experts_per_tok"]
    return E * (1.0 - (1.0 - k / E) ** tokens)


def _weights_bytes(arch: dict, touched_per_layer: float) -> float:
    s = sizes(arch)
    dense = (s["layers"] * (s["attn"] + s["norms"]) + s["dense_layers"] * s["dense_mlp"]
             + s["moe_layers"] * s["shared"] + s["vocab"]) * BYTES
    return (dense + s["moe_layers"] * (touched_per_layer * s["expert"] * BYTES
                                       + s["router"] * ROUTER_BYTES))


def decode_step_bytes(arch: dict, active: int, ctx_total: float,
                      touched_per_layer: float | None = None) -> float:
    """A decode step of `active` slots whose contexts sum to `ctx_total`
    positions: the weights (the experts touched, by default as many as a
    uniform choice touches on average), the cache read over each context
    and written once a slot, the tokens' embedding rows, the logits
    (float32) written."""
    if touched_per_layer is None:
        touched_per_layer = experts_touched(arch, active)
    d, V = arch["hidden_size"], arch["vocab_size"]
    return (_weights_bytes(arch, touched_per_layer) + ctx_total * cache_bytes_token(arch)
            + active * (d * BYTES + 4 * V))


def prefill_bytes(arch: dict, S: int) -> float:
    """A prompt of S tokens: every weight once (the experts its tokens
    touch), the cache rows written, the embedding rows, one logits row."""
    d, V = arch["hidden_size"], arch["vocab_size"]
    return (_weights_bytes(arch, experts_touched(arch, S)) + S * cache_bytes_token(arch)
            + S * d * BYTES + 4 * V)


def bound_s(flops: float, nbytes: float, hbm_bytes_per_s: float) -> float:
    return max(flops / PEAK_BF16, nbytes / hbm_bytes_per_s)


def window_bound_s(arch: dict, work: dict, hbm_bytes_per_s: float) -> float:
    """The least time of a window's work: each prefill and each decode step
    at its own bound.  `work`: "prompts" (the prompt lengths prefilled),
    "steps" (each decode step's [active slots, summed context])."""
    t = sum(bound_s(prefill_flops(arch, S), prefill_bytes(arch, S), hbm_bytes_per_s)
            for S in work["prompts"])
    for active, ctx in work["steps"]:
        t += bound_s(decode_flops(arch, active, ctx), decode_step_bytes(arch, active, ctx),
                     hbm_bytes_per_s)
    return t


def window_flops(arch: dict, work: dict) -> float:
    """The useful FLOPs of a window's prefills and decode steps."""
    return (sum(prefill_flops(arch, S) for S in work["prompts"])
            + sum(decode_flops(arch, a, c) for a, c in work["steps"]))
