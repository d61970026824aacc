"""Shared model layers: norms, RoPE, MLPs, embeddings.

Port of `repro.models.layers`.  Params are nested dicts of tensors in the
reference's layout (a linear weight is (d_in, d_out)); every init function
returns (params, axes), where `axes` is a parallel tree of logical-axis
name tuples, as the reference's.  An init draws its leaves with a leading
`lead` shape (the stacked-layer axes) and names those axes "layers".

The numerics keep the reference's float32 islands: norms in float32,
RoPE on split halves in float32, GELU as `jax.nn.gelu`'s default tanh
approximation, and in bfloat16 the reference's default compilation: the
activations rounded op by op as XLA lowers them (`silu`, `gelu`,
`sigmoid`, `softplus`), and a norm reading its residual sum unrounded
(`add_norm`).  The sharding
annotations of the reference (`constrain`) are no-ops on one device and
are left out.
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

    def normal_around(self, shape, std: float, spread: float, dtype) -> torch.Tensor:
        """A (L, E, ...) stack of E leaves a slice, each one shared draw of
        the slice plus `spread` times a draw of its own, scaled back to
        `std`: (base + spread * own) * std / sqrt(1 + spread^2).  Drawn and
        cast a slice at a time: a stack of billions of bfloat16 weights
        never exists whole in float32."""
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        out = torch.empty(shape, dtype=dtype, device=self.device)
        k = std / math.sqrt(1.0 + spread * spread)
        for i in range(shape[0]):
            base = torch.randn((1,) + tuple(shape[2:]), generator=self.gen, device=self.device)
            own = torch.randn(shape[1:], generator=self.gen, device=self.device)
            out[i] = ((base + spread * own) * k).to(dtype)
        return out

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


def add_norm(x: torch.Tensor, y: torch.Tensor, p, kind: str):
    """The residual sum `x + y` in x's dtype, and its norm as the
    reference's default compilation computes it: there XLA drops the
    bfloat16 rounding of a sum that a norm upcasts at once (excess precision
    allowed), so the norm reads the float32 sum.  The same in float32."""
    s = x.float() + y.float()
    return s.to(x.dtype), apply_norm(s, p, kind).to(x.dtype)


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


# --- activations ------------------------------------------------------------
#
# In bfloat16, XLA lowers each of `jax.nn`'s activations as a chain of
# elementwise ops and rounds to bfloat16 after every one (read from the
# compiled CPU HLO).  A torch op on bfloat16 tensors computes in float32 and
# rounds once, so each chain below is written op by op on bfloat16 tensors,
# with the reference's constants rounded to bfloat16 as its lowering has
# them.  The backward passes are JAX's derivative rules, op by op in the
# order its transposition accumulates them: `logistic` ans * (1 - ans),
# `tanh` (g + g * ans) * (1 - ans), `integer_pow` 3 * x^2, and
# `logaddexp`'s custom rule g * exp(x - out).  Other dtypes take the fused
# torch op, as before.

_GELU_C = float(torch.tensor(0.044715, dtype=torch.bfloat16))         # 0.0446777...
_GELU_K = float(torch.tensor(math.sqrt(2 / math.pi), dtype=torch.bfloat16))  # 0.796875


def _logistic(x):
    return 1 / (torch.exp(-x) + 1)


class _Sigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _logistic(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


class _Silu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = _logistic(x)
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


class _Softplus(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
        y = torch.where(torch.isnan(x), x, y)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        finite = lambda a: torch.where(torch.isinf(a), 0, a)   # noqa: E731
        return g * torch.exp(finite(x) - finite(y))


class _Gelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x2 = x * x
        t = torch.tanh((x + (x2 * x) * _GELU_C) * _GELU_K)
        cdf = (t + 1) * 0.5
        ctx.save_for_backward(x, x2, t, cdf)
        return x * cdf

    @staticmethod
    def backward(ctx, g):
        x, x2, t, cdf = ctx.saved_tensors
        dt = ((g * x) * 0.5) * (1 - t)
        db = (dt + dt * t) * _GELU_K
        return (g * cdf + db) + (db * _GELU_C) * (x2 * 3)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid`; bfloat16: 1 / (1 + exp(-x)), rounded after each op."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return _Sigmoid.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`; bfloat16: x * (1 / (1 + exp(-x))), rounded after each op."""
    if x.dtype != torch.bfloat16:
        return F.silu(x)
    return _Silu.apply(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus` (`logaddexp(x, 0)`); bfloat16: max(x, 0) +
    log1p(exp(-|x|)), rounded after each op, NaN passed through."""
    if x.dtype != torch.bfloat16:
        return F.softplus(x)
    return _Softplus.apply(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default, the tanh approximation; bfloat16:
    x * (0.5 * (1 + tanh(k * (x + c * (x * x * x))))), rounded after each op,
    with c = 0.044715 and k = sqrt(2 / pi) rounded to bfloat16."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return _Gelu.apply(x)


def mlp(x: torch.Tensor, p: dict, kind: str, compute_dtype=torch.bfloat16) -> torch.Tensor:
    if kind == "gated":
        h = silu(linear(x, p["wg"], compute_dtype)) * linear(x, p["wi"], compute_dtype)
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
