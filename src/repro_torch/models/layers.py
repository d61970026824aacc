"""Shared model layers: norms, RoPE, MLPs, embeddings.

Port of `repro.models.layers`.  Params are nested dicts of tensors in the
reference's layout (a linear weight is (d_in, d_out)); every init function
returns (params, axes), where `axes` is a parallel tree of logical-axis
name tuples, as the reference's.  An init draws its leaves with a leading
`lead` shape (the stacked-layer axes) and names those axes "layers".

The numerics keep the reference's float32 islands: norms in float32,
RoPE on split halves in float32, GELU as `jax.nn.gelu`'s default tanh
approximation.  The sharding annotations of the reference (`constrain`)
are no-ops on one device and are left out.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.ptq import QuantTensor


class Draw:
    """The port's parameter draws: normal leaves from one `torch.Generator`
    on `device`, in float32 then cast, as the reference's
    `jax.random.normal(...) * std`.  On the meta device it allocates
    nothing (`models.model.abstract_params`)."""

    def __init__(self, generator: torch.Generator | None, device: torch.device):
        self.gen, self.device = generator, device

    def normal(self, shape, std: float, dtype) -> torch.Tensor:
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        x = torch.randn(shape, generator=self.gen, device=self.device, dtype=torch.float32)
        return (x * std).to(dtype)

    def full(self, shape, value: float, dtype) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)

    def expand(self, value: torch.Tensor, shape, dtype) -> torch.Tensor:
        """A constant leaf: `value` broadcast to `shape`."""
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        return value.to(self.device, dtype).expand(shape).clone()


def stacked_axes(axes, lead: tuple) -> object:
    """Prefix every axes tuple of a tree with one "layers" per lead axis."""
    if isinstance(axes, dict):
        return {k: stacked_axes(v, lead) for k, v in axes.items()}
    return ("layers",) * len(lead) + axes


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(torch.square(x), -1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.mean(torch.square(x - mu), -1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def apply_norm(x, p, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


def init_norm(draw: Draw, d: int, kind: str, dtype, lead: tuple = ()) -> tuple[dict, dict]:
    if kind == "rmsnorm":
        p, a = {"w": draw.full(lead + (d,), 1.0, dtype)}, {"w": (None,)}
    else:
        p = {"w": draw.full(lead + (d,), 1.0, dtype), "b": draw.full(lead + (d,), 0.0, dtype)}
        a = {"w": (None,), "b": (None,)}
    return p, stacked_axes(a, lead)


# --- RoPE -------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D); positions (B, S) or (S,)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (D/2,)
    ang = positions[..., None].float() * freqs                  # (..., S, D/2)
    if ang.ndim == 2:                                           # (S, D/2) -> broadcast B
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# --- dense / linear ---------------------------------------------------------

def init_linear(draw: Draw, d_in: int, d_out: int, dtype, *, lead: tuple = (),
                bias: bool = False, in_axis: str | None = "fsdp",
                out_axis: str | None = "w_model",
                scale: float | None = None) -> tuple[dict, dict]:
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": draw.normal(lead + (d_in, d_out), std, dtype)}
    a = {"w": (in_axis, out_axis)}
    if bias:
        p["b"] = draw.full(lead + (d_out,), 0.0, dtype)
        a["b"] = (out_axis,)
    return p, stacked_axes(a, lead)


def _materialize(w, compute_dtype):
    """int8 (paper-style baked) weights dequantize on use: q * scale in the
    compute dtype, as the reference's."""
    if isinstance(w, QuantTensor):
        return w.q.to(compute_dtype) * w.scale.to(compute_dtype)
    return w.to(compute_dtype)


def linear(x: torch.Tensor, p: dict, compute_dtype=torch.bfloat16) -> torch.Tensor:
    y = x.to(compute_dtype) @ _materialize(p["w"], compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


# --- MLP --------------------------------------------------------------------

def init_mlp(draw: Draw, d: int, d_ff: int, kind: str, dtype,
             lead: tuple = ()) -> tuple[dict, dict]:
    if kind == "gated":          # SwiGLU (llama family)
        wi, ai = init_linear(draw, d, d_ff, dtype, lead=lead)
        wg, ag = init_linear(draw, d, d_ff, dtype, lead=lead)
        wo, ao = init_linear(draw, d_ff, d, dtype, lead=lead, in_axis="w_model",
                             out_axis="fsdp")
        return ({"wi": wi, "wg": wg, "wo": wo}, {"wi": ai, "wg": ag, "wo": ao})
    wi, ai = init_linear(draw, d, d_ff, dtype, lead=lead)
    wo, ao = init_linear(draw, d_ff, d, dtype, lead=lead, in_axis="w_model", out_axis="fsdp")
    return ({"wi": wi, "wo": wo}, {"wi": ai, "wo": ao})


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(x: torch.Tensor, p: dict, kind: str, compute_dtype=torch.bfloat16) -> torch.Tensor:
    if kind == "gated":
        h = F.silu(linear(x, p["wg"], compute_dtype)) * linear(x, p["wi"], compute_dtype)
    else:
        h = gelu(linear(x, p["wi"], compute_dtype))
    return linear(h, p["wo"], compute_dtype)


# --- embeddings -------------------------------------------------------------

def init_embed(draw: Draw, vocab: int, d: int, dtype) -> tuple[dict, dict]:
    return {"w": draw.normal((vocab, d), 0.02, dtype)}, {"w": ("vocab", "fsdp")}


def embed(tokens: torch.Tensor, p: dict, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Rows gathered, then cast (the same values as the reference's cast of
    the whole table, then its gather); int8 rows times the per-column
    scales."""
    w, tokens = p["w"], tokens.long()
    if isinstance(w, QuantTensor):
        rows = w.q[tokens].to(compute_dtype)
        return rows * w.scale.reshape(-1).to(compute_dtype)
    return w[tokens].to(compute_dtype)
