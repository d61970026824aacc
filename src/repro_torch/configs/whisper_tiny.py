"""whisper-tiny [audio] — enc-dec, conv frontend STUB [arXiv:2212.04356; unverified].
4L = 4 encoder + 4 decoder (whisper-tiny). input_specs() supplies precomputed
frame embeddings (B, 1500, d_model); seq shapes apply to the decoder."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, head_dim=64,
    use_rope=False, norm="layernorm", mlp="vanilla",
    encoder_layers=4, encoder_frames=1500,
    micro_batch=256,
    source="arXiv:2212.04356",
)
