"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].
d_ff=1536 is the per-expert FFN width."""
from repro_torch.configs.base import ArchConfig
import torch

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, head_dim=64,
    n_experts=128, top_k=8,
    rope_theta=1000000.0, norm="rmsnorm", mlp="gated",
    param_dtype=torch.bfloat16, micro_batch=32,
    source="hf:Qwen/Qwen3-30B-A3B",
)
