"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7, MoE 16e top-2 [arXiv:2403.19887; hf].
72 layers = 9 super-blocks x 8 sublayers; attention at sublayer 3 of each
super-block; MoE MLP on every 2nd sublayer. Runs long_500k (states + KV only
in 9 attention layers)."""
from repro_torch.configs.base import ArchConfig
import torch

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, head_dim=128,
    n_experts=16, top_k=2, moe_every=2,
    attn_period=8, attn_offset=3,
    use_rope=False, norm="rmsnorm", mlp="gated",
    param_dtype=torch.bfloat16, micro_batch=16,
    source="arXiv:2403.19887",
)
