"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783; unverified]."""
from repro_torch.configs.base import ArchConfig
import torch

CONFIG = ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab=128256, head_dim=128,
    rope_theta=500000.0, norm="rmsnorm", mlp="gated",
    param_dtype=torch.bfloat16,          # HBM fit: bf16 params+moments >=100B (DESIGN.md §5)
    micro_batch=32,
    source="arXiv:2407.21783",
)
