"""internvl2-2b [vlm] — InternViT (stub) + InternLM2 backbone [arXiv:2404.16821; hf].
input_specs() supplies precomputed patch embeddings (B, 256, vit_dim=1024),
projected into the first 256 token positions."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553, head_dim=128,
    rope_theta=1000000.0, norm="rmsnorm", mlp="gated",
    vision_tokens=256, vit_dim=1024,
    micro_batch=128,
    source="arXiv:2404.16821",
)
