"""qwen2.5-14b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].
40 heads % 16 != 0 -> attention core falls back to dim-sharded TP (DESIGN.md §4)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064, head_dim=128,
    qkv_bias=True, rope_theta=1000000.0, norm="rmsnorm", mlp="gated",
    micro_batch=64,
    source="hf:Qwen/Qwen2.5-0.5B",
)
