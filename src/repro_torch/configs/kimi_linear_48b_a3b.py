"""kimi-linear-48b-a3b [kda_mla_moe] — Kimi-Linear-48B-A3B-Instruct, Kimi
Delta Attention beside latent attention at hidden size 2304
[https://huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct/blob/main/config.json;
Kimi Linear tech report, arXiv:2510.26692].

Every value of the published `config.json` (`model_type: kimi_linear`)
that the block reads: 27 layers, 20 of them KDA (`linear_attn_config.
kda_layers`, 1-based 1-3, 5-7, ..., 25-26) and 7 full MLA layers (4, 8,
12, 16, 20, 24, 27), 3:1; KDA with 32 heads of 128 (`linear_attn_config.
num_heads`, `head_dim`) and short convolutions of 4; MLA with 32 heads,
no query low-rank projection, `kv_lora_rank` 512, `qk_nope_head_dim`
128, `qk_rope_head_dim` 64, `v_head_dim` 128, and no RoPE
(`mla_use_nope`); the first layer's MLP dense (`first_k_dense_replace: 1`,
width 9216), the other 26 MoE layers of 256 routed experts of width 1024,
8 a token (`num_experts_per_token`), sigmoid-routed and renormalised
(`moe_renormalize`), times `routed_scaling_factor` 2.446, and 1 shared
expert; `rms_norm_eps` 1e-5, vocabulary 163840, untied.  The top-level
`head_dim: 72` is 2304 / 32 and sizes nothing here: `head_dim` below is
MLA's query/key width, 128 + 64.

The expert share: the router keeps all 256 outputs and its top 8; this
configuration holds experts 0-127 of every MoE layer, one of the two
devices that share each layer under expert parallelism 2, and computes
only the pairs routed to them (`LatentMoEConfig.experts_held`).  With all
256 held (`experts_held=0`) it is the whole model, 49.1 B params.

Weights and compute in bfloat16; the router, KDA's `A_log` and
`dt_bias` and the recurrent state in float32.  Not in `ARCH_IDS`:
`get_config("kimi-linear-48b-a3b")`.
"""
import torch

from repro_torch.configs.base import HybridLatentMoEConfig

CONFIG = HybridLatentMoEConfig(
    name="kimi-linear-48b-a3b", family="kda_mla_moe",
    n_layers=27, d_model=2304, n_heads=32, n_kv_heads=32,
    d_ff=9216, vocab=163840, head_dim=192,
    n_experts=256, top_k=8, experts_held=128, expert_offset=0,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    mla_rope=False,
    moe_d_ff=1024, n_shared_experts=1, first_dense_layers=1,
    router_scoring="sigmoid", routed_scale=2.446, norm_topk_prob=True,
    router_dtype=torch.float32, norm_eps=1e-5, context_length=1048576,
    rope_theta=10000.0, norm="rmsnorm", mlp="gated", tie_embeddings=False,
    kda_layers=(0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13, 14, 16, 17, 18, 20, 21, 22, 24, 25),
    kda_heads=32, kda_head_dim=128, short_conv_kernel_size=4,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    source="https://huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct/blob/main/config.json",
)
