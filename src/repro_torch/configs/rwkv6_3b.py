"""rwkv6-3b [ssm] — Finch, data-dependent decay, attn-free [arXiv:2404.05892; hf].
head_dim fixed at 64 (RWKV convention) -> 40 heads; runs long_500k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536, head_dim=64,
    use_rope=False, norm="layernorm", mlp="vanilla",
    micro_batch=64,
    source="arXiv:2404.05892",
)
