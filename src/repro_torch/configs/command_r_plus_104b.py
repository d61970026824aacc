"""command-r-plus-104b [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from repro_torch.configs.base import ArchConfig
import torch

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab=256000, head_dim=128,
    qkv_bias=False, rope_theta=75000000.0, norm="layernorm", mlp="gated",
    param_dtype=torch.bfloat16, micro_batch=32,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
