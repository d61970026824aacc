"""Three-term roofline of a lowered cell on one device of the database.

    compute term    = FLOPs_per_device / the device's bf16 peak
    memory term     = analytic_bytes per device / its memory bandwidth
    collective term = collective_bytes_per_device / its link bandwidth

Port of `repro.analysis.roofline`.  `param_count`, `model_flops` and
`analytic_bytes` are the reference's closed forms, formula for formula
(`tests/test_torch_roofline.py` holds them equal on every arch, shape and
device count).  Two inputs the reference read from XLA come from the
port's own lowering (`launch/lowering.py`):

  * FLOPs: the cell's step counted by `FlopCounterMode` on the meta device
    (`count_flops`; loops and all, where the reference parsed the
    partitioned HLO with while-loop trip multipliers);
  * collective bytes: from the shapes and specs under the sharding policy
    (`collective_bytes`), where the reference parsed the HLO's collectives.

The peaks are those of an entry of `analysis/mfu.DEVICE_DB` (default
the H100's), named on the record: no TPU constant enters.  MODEL_FLOPS = 6*N*D (dense) /
6*N_active*D (MoE) cross-checks how much of the counted compute is
useful.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis import mfu
from repro_torch.analysis.mfu import DEVICE_DB
from repro_torch.configs.base import ArchConfig, ShapeSpec


@dataclasses.dataclass
class Roofline:
    """The reference's record, plus the database device it was taken on.
    The port has no raw compiler count: `hlo_flops_per_device` and
    `hlo_flops_raw` both hold the counted FLOPs a device, and
    `collective_bytes_raw` equals `collective_bytes_per_device` (there is
    no bf16-wire correction to make)."""
    arch: str
    shape: str
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops_per_device: float
    hlo_flops_raw: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_bytes_raw: float
    collective_breakdown: dict
    model_flops_total: float           # 6ND / 6N_active*D
    useful_ratio: float                # MODEL_FLOPS / (FLOPs * devices)
    devices: int
    device: str = "h100"               # the DEVICE_DB entry the terms divide by

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step estimate: overlapped model = max of the three."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the device's bf16 peak at the roofline
        step time (the MFU upper bound the counted step implies)."""
        if self.step_time_s <= 0:
            return 0.0
        per_dev = self.model_flops_total / self.devices
        return per_dev / (self.step_time_s * DEVICE_DB[self.device].peak("bf16"))


def _latent_moe_params(cfg) -> tuple[float, float]:
    """mla_moe (DeepSeek-V3's block): total, and active a token as the
    matmuls a token passes through (its `top_k` experts, the shared ones,
    the router, the lm head; the embedding is a gather)."""
    d, L, H, r = cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    attn = d * H * (nope + rope) + d * (r + rope) + r * H * (nope + vd) + H * vd * d
    norms = 2 * d + r
    expert = 3 * d * cfg.moe_d_ff
    shared = cfg.n_shared_experts * expert
    router = d * cfg.n_experts + cfg.n_experts
    Ld = cfg.first_dense_layers
    dense_mlp = 3 * d * cfg.d_ff
    vocab = cfg.vocab_padded * d
    total = (L * (attn + norms) + Ld * dense_mlp
             + (L - Ld) * (cfg.n_experts * expert + shared + router) + 2 * vocab + d)
    active = (L * attn + Ld * dense_mlp
              + (L - Ld) * (cfg.top_k * expert + shared + router) + vocab)
    return float(total), float(active)


def param_count(cfg: ArchConfig) -> tuple[float, float]:
    """(total params, active params) analytic."""
    if cfg.family == "mla_moe":
        return _latent_moe_params(cfg)
    d, L, ff, hd = cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    attn = d * H * hd + 2 * d * K * hd + H * hd * d
    mlp_dense = (3 if cfg.mlp == "gated" else 2) * d * ff
    embed = cfg.vocab_padded * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "moe":
        moe = cfg.n_experts * 3 * d * ff + d * cfg.n_experts
        total = L * (attn + moe) + embed
        active = L * (attn + cfg.top_k * 3 * d * ff) + embed
        return float(total), float(active)
    if cfg.family == "ssm":
        # rwkv block: 5 square proj + lora + channel mix (ck, cv, cr)
        blk = 5 * d * d + d * ff * 2 + d * d + 10 * 32 * d
        total = L * blk + embed
        return float(total), float(total)
    if cfg.family == "hybrid":
        P = cfg.attn_period
        n_super = L // P
        d_in = 2 * d
        mamba = d * 2 * d_in + d_in * (max(1, d // 16) + 32) + \
            max(1, d // 16) * d_in + d_in * d
        moe = cfg.n_experts * 3 * d * ff
        per_super = (P - 1) * mamba + attn + (P // cfg.moe_every) * moe + \
            (P - P // cfg.moe_every) * mlp_dense
        active_super = (P - 1) * mamba + attn + \
            (P // cfg.moe_every) * cfg.top_k * 3 * d * ff + \
            (P - P // cfg.moe_every) * mlp_dense
        return float(n_super * per_super + embed), float(n_super * active_super + embed)
    if cfg.family == "audio":
        enc = cfg.encoder_layers * (attn + mlp_dense)
        dec = L * (2 * attn + mlp_dense)
        return float(enc + dec + embed), float(enc + dec + embed)
    total = L * (attn + mlp_dense) + embed
    return float(total), float(total)


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """6*N_active*D for train; 2*N_active*D for prefill; 2*N_active*B for
    one decode step (+ attention term where applicable)."""
    _, active = param_count(cfg)
    if shape.kind == "train":
        D = shape.global_batch * shape.seq_len
        return 6.0 * active * D
    if shape.kind == "prefill":
        D = shape.global_batch * shape.seq_len
        return 2.0 * active * D
    # decode: one token per sequence + attention over the cache
    flops = 2.0 * active * shape.global_batch
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        attn_layers = cfg.n_layers
    elif cfg.family == "hybrid":
        attn_layers = cfg.n_layers // cfg.attn_period
    else:
        attn_layers = 0
    if cfg.family == "mla_moe":
        # absorbed: scores on the latent and the roped key, the latent output
        return flops + (2.0 * shape.global_batch * cfg.n_heads
                        * (2 * cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                        * shape.seq_len * cfg.n_layers)
    flops += (4.0 * shape.global_batch * cfg.n_heads * cfg.head_dim
              * shape.seq_len * attn_layers)
    return flops


def analytic_bytes(cfg: ArchConfig, shape: ShapeSpec, devices: int) -> float:
    """Per-device HBM traffic model (the reference's):
    train:   n_micro*(2 reads + 1 grad write of params) + 3x optimizer state
             + 4x layer-boundary activations
    prefill: params once + 2x activations + KV write
    decode:  params once + full KV/state cache read + write-back of one slot
    Parameter bytes are `cfg.param_dtype`'s; all bytes are spread evenly
    over the devices (/devices).  An mla_moe cache is the latent one
    (`kv_lora_rank + qk_rope_head_dim` a token and layer).
    """
    total, _ = param_count(cfg)
    # the reference reads `param_dtype.__name__`, which torch dtypes lack
    pb = total * (torch.finfo(cfg.param_dtype).bits // 8)
    dt = 2  # activation bytes (bf16)
    if shape.kind == "train":
        n_micro = max(1, shape.global_batch // max(1, cfg.micro_batch))
        acts = cfg.n_layers * shape.global_batch * shape.seq_len * cfg.d_model * dt
        opt = 3 * pb
        traffic = n_micro * 3 * pb + opt + 4 * acts
    elif shape.kind == "prefill":
        acts = cfg.n_layers * shape.global_batch * shape.seq_len * cfg.d_model * dt
        kv = (2 * cfg.n_layers * shape.global_batch * shape.seq_len
              * cfg.n_kv_heads * cfg.head_dim * dt)
        if cfg.family == "mla_moe":
            kv = _latent_cache_bytes(cfg, shape)
        traffic = pb + 2 * acts + kv
    else:
        if cfg.family == "ssm":
            cache = (cfg.n_layers * shape.global_batch * cfg.n_heads
                     * cfg.head_dim * cfg.head_dim * 4)
        elif cfg.family == "hybrid":
            n_super = cfg.n_layers // cfg.attn_period
            cache = (2 * n_super * shape.global_batch * shape.seq_len
                     * cfg.n_kv_heads * cfg.head_dim * dt)
            cache += (cfg.n_layers - n_super) * shape.global_batch * \
                2 * cfg.d_model * 16 * 4
        elif cfg.family == "mla_moe":
            cache = _latent_cache_bytes(cfg, shape)
        else:
            cache = (2 * cfg.n_layers * shape.global_batch * shape.seq_len
                     * cfg.n_kv_heads * cfg.head_dim * dt)
        traffic = pb + cache
    return traffic / devices


def _latent_cache_bytes(cfg, shape: ShapeSpec) -> float:
    return (cfg.n_layers * shape.global_batch * shape.seq_len
            * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2)


def roofline_from_cell(art, *, device: str = "h100") -> Roofline:
    """The roofline of a lowered cell (`launch.lowering.lower_cell`) on
    `device`, a `DEVICE_DB` name: its FLOPs counted a device (`count_flops`)
    over the bf16 peak, `analytic_bytes` over the memory bandwidth, and the
    collective bytes a device (`collective_bytes`) over the link bandwidth
    (a device without one raises before anything is counted)."""
    from repro_torch.launch.lowering import collective_bytes, count_flops

    dev = DEVICE_DB[device]
    link = dev.link()
    cfg, shape, n = art.cfg, art.spec, art.n_devices
    flops = count_flops(art)
    breakdown = collective_bytes(art)
    coll = sum(breakdown.values())
    mf = model_flops(cfg, shape)
    bytes_dev = analytic_bytes(cfg, shape, n)
    return Roofline(
        arch=art.arch, shape=art.shape,
        compute_s=flops / dev.peak("bf16"),
        memory_s=bytes_dev / dev.mem_bw,
        collective_s=coll / link,
        hlo_flops_per_device=flops,
        hlo_flops_raw=flops,
        bytes_per_device=bytes_dev,
        collective_bytes_per_device=coll,
        collective_bytes_raw=coll,
        collective_breakdown=breakdown,
        model_flops_total=mf,
        useful_ratio=mf / max(flops * n, 1.0),
        devices=n,
        device=device,
    )


def to_dict(r: Roofline) -> dict:
    d = dataclasses.asdict(r)
    d["dominant"] = r.dominant
    d["step_time_s"] = r.step_time_s
    d["roofline_fraction"] = r.roofline_fraction
    return d


def smallnet_rooflines(*, device_name: str = "h100", H: int = 112,
                       W: int = 112, stride: int = 8) -> dict[str, dict]:
    """Analytic two-term rooflines for smallNet's hot paths: the ledger
    routes (host tiler / composed sweep / one-launch sweep) in the float
    (`ref`) and Qm.n (`fixed_cuda`) numerics, plus the deployed
    single-image cell, on one device of the database.  Closed form
    (`analysis/mfu.py`), so it runs in microseconds; a NaN or a zero
    denominator here means the model or a device entry broke."""
    from repro_torch.streaming.tiler import tile_positions

    if device_name not in DEVICE_DB:
        raise KeyError(f"unknown device {device_name!r} "
                       f"(known: {sorted(DEVICE_DB)})")
    dev = DEVICE_DB[device_name]
    n_windows = len(tile_positions((H, W), mfu.PATCH, stride))
    out: dict[str, dict] = {}
    for backend in ("ref", "fixed_cuda"):
        dtype, wb = mfu.backend_numerics(backend)
        for route in mfu.ROUTE_WORKLOADS:
            wl = mfu.route_workload(route, H, W, n_windows, wb)
            out[f"smallnet-{backend}|{route}"] = mfu.roofline_terms(
                wl, device=dev, dtype=dtype)
    dtype, wb = mfu.backend_numerics("fixed_cuda")
    out["smallnet-fixed_cuda|deployed"] = mfu.roofline_terms(
        mfu.deployed_workload(wb), device=dev, dtype=dtype)
    return out
