"""moonlight-16b-a3b [mla_moe] — Moonlight-16B-A3B, DeepSeek-V3's block at
hidden size 2048 [https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json].

Every value of the published `config.json` (`model_type: deepseek_v3`):
27 layers, the first dense (`first_k_dense_replace: 1`, width 11264), the
other 26 MoE layers of 64 routed experts of width 1408, 6 a token, and 2
shared experts; MLA with 16 heads, no query low-rank projection
(`q_lora_rank: null`), `kv_lora_rank` 512, `qk_nope_head_dim` 128,
`qk_rope_head_dim` 64, `v_head_dim` 128; routing `scoring_func: sigmoid`,
`topk_method: noaux_tc` with `n_group` = `topk_group` = 1 (group-limited
selection is then trivial), `norm_topk_prob`, `routed_scaling_factor`
2.446; `rope_theta` 50000 without scaling, `rms_norm_eps` 1e-5,
vocabulary 163840, untied, context 8192.  Weights and compute in
bfloat16; the router and its correction bias in float32, as the
published gate computes.

One departure: RoPE rotates the two halves of `q_pe`/`k_pe` (the port's
`layers.apply_rope`), where the published code first de-interleaves
them (`view(..., d // 2, 2).transpose`).  On any weights that is a fixed
permutation of the rope columns of `wq` and `wkv_a`.

The port's `moonshot-v1-16b-a3b` cites the same source but is the
reference's MHA block with capacity-dropping softmax routing; this is the
published block.  Not in `ARCH_IDS`: `get_config("moonlight-16b-a3b")`.
"""
import torch

from repro_torch.configs.base import LatentMoEConfig

CONFIG = LatentMoEConfig(
    name="moonlight-16b-a3b", family="mla_moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=11264, vocab=163840, head_dim=192,
    n_experts=64, top_k=6,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    moe_d_ff=1408, n_shared_experts=2, first_dense_layers=1,
    router_scoring="sigmoid", routed_scale=2.446, norm_topk_prob=True,
    router_dtype=torch.float32, norm_eps=1e-5, context_length=8192,
    rope_theta=50000.0, norm="rmsnorm", mlp="gated", tie_embeddings=False,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    source="https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json",
)
