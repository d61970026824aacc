"""ArchConfig + the assigned input-shape sets + the config registry.

Port of `repro.configs.base`: every field and every config is the
reference's, with the dtypes as torch's (`torch.bfloat16` compute,
`torch.float32` params unless a config says otherwise).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1           # jamba: MoE MLP on every 2nd sublayer
    # attention
    qkv_bias: bool = False
    use_rope: bool = True
    rope_theta: float = 500000.0
    q_chunk: int = 512
    # layer kinds
    norm: str = "rmsnorm"
    mlp: str = "gated"
    tie_embeddings: bool = False
    # hybrid (jamba): one attention sublayer per `attn_period` sublayers
    attn_period: int = 0
    attn_offset: int = 3
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 0
    # vlm
    vision_tokens: int = 0
    vit_dim: int = 0
    # numerics / execution
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    micro_batch: int = 64        # per-train-step microbatch size (global)
    remat: bool = True
    # provenance
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab, 256)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 8 if self.family == "hybrid" else 2),
            d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_frames=min(self.encoder_frames, 16) if self.encoder_frames else 0,
            vision_tokens=min(self.vision_tokens, 8) if self.vision_tokens else 0,
            vit_dim=min(self.vit_dim, 32) if self.vit_dim else 0,
            q_chunk=16, micro_batch=4,
            dtype=torch.float32, param_dtype=torch.float32,
        )

    def supports_long_context(self) -> bool:
        """Sub-quadratic archs only (ssm / hybrid) — DESIGN.md §4 skip rule."""
        return self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class LatentMoEConfig(ArchConfig):
    """DeepSeek-V3's block: multi-head latent attention (MLA) and a routed
    MoE with shared experts behind `first_dense_layers` dense layers
    (family "mla_moe").  A subclass, so that every `ArchConfig` keeps the
    reference's fields.  `head_dim` is the query/key head width,
    `qk_nope_head_dim + qk_rope_head_dim`."""
    # MLA: no query low-rank projection; keys and values from a latent of
    # `kv_lora_rank`, beside a shared roped key of `qk_rope_head_dim`
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # MoE: routed experts of width `moe_d_ff`, shared experts of the same
    # width, `first_dense_layers` dense layers of width `d_ff` first
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    # the router: sigmoid scores, experts picked on score + bias, weights
    # the unbiased scores (renormalised over the top k) times `routed_scale`
    router_scoring: str = "sigmoid"
    routed_scale: float = 1.0
    norm_topk_prob: bool = True
    router_dtype: Any = torch.float32
    norm_eps: float = 1e-6
    context_length: int = 0
    # `mla_rope` False: q_pe and k_pe left unrotated (NoPE), the score and
    # the cache as with RoPE
    mla_rope: bool = True
    # expert parallelism: this device holds routed experts
    # [expert_offset, expert_offset + experts_held) of the router's
    # `n_experts` (0: all of them) and computes only their pairs
    experts_held: int = 0
    expert_offset: int = 0

    @property
    def n_held(self) -> int:
        return self.experts_held or self.n_experts


@dataclasses.dataclass(frozen=True)
class HybridLatentMoEConfig(LatentMoEConfig):
    """Kimi Linear's block (family "kda_mla_moe"): the layers of
    `kda_layers` (0-based) are Kimi Delta Attention, a channel-wise gated
    delta rule of `kda_heads` heads of `kda_head_dim` behind causal
    depthwise convolutions of `short_conv_kernel_size`; the others MLA.
    The MLPs are as `LatentMoEConfig`'s."""
    kda_layers: tuple = ()
    kda_heads: int = 0
    kda_head_dim: int = 0
    short_conv_kernel_size: int = 0


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "llama3-405b", "granite-3-2b", "command-r-plus-104b", "qwen2.5-14b",
    "rwkv6-3b", "qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b",
    "whisper-tiny", "internvl2-2b", "jamba-1.5-large-398b",
]


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def cells():
    """Every (arch, shape) cell per the assignment (with documented skips)."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            if s.name == "long_500k" and not cfg.supports_long_context():
                continue
            out.append((a, s.name))
    return out
