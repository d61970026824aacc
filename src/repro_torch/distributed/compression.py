"""Block-int8 gradient compression for the all-reduce, with error feedback.

Port of `repro.distributed.compression`, as plain torch ops and
`torch.distributed` collectives.  smallNet's thesis (match the numeric
format to the fabric) applied to gradient averaging: each block of
`BLOCK` values is quantized to int8 against its own float32 scale
(max |x| / 127), the integer words and the scales are summed over the
group, and the sum is dequantized after.  `compression_error_feedback`
carries what quantization dropped into the next round (Seide et al.).

What goes on the wire: the words are summed as int32, as the reference's
psum carries `q.astype(int32)`, so the sum is exact for up to 2^24 peers.
The three `all_reduce` calls of `compressed_psum` move, for n elements in
b = ceil(n / BLOCK) blocks, 4 * b * BLOCK bytes of words, 4 * b bytes of
scales and 4 bytes of peer count (`allreduce_bytes`): slightly MORE than
the 4 n bytes of a float32 all-reduce, not a quarter of them.  The
arithmetic (quantization error, error feedback) is the compressed one;
no transport packs the int8 words.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.backends import tree_leaves, tree_map

BLOCK = 256


def _on(x: torch.Tensor, value: float) -> torch.Tensor:
    """`value` as a float32 scalar on x's device: CUDA divides by a Python
    scalar through its reciprocal, which can move the last bit of a scale
    off the true quotient that XLA and the CPU give (`core/ptq.py`)."""
    return torch.tensor(value, dtype=torch.float32, device=x.device)


def _quantize_block(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., BLOCK) float32 -> (int8 values, float32 scale per block)."""
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / _on(x, 127.0) + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """x flattened to float32, zero-padded to whole blocks: (blocks, BLOCK)."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)


def allreduce_bytes(numel: int) -> int:
    """The bytes each peer hands to `compressed_psum`'s three all_reduce
    calls for a tensor of `numel` elements: int32 words of whole blocks,
    a float32 scale a block, a float32 peer count."""
    blocks = -(-numel // BLOCK)
    return 4 * blocks * BLOCK + 4 * blocks + 4


def compressed_psum(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """The sum of `x` over `group` (None: the default group), compressed.

    Each peer quantizes its blocks; the int words are summed as int32
    (exact), the scales and the peer count as float32; the result is the
    summed words times the mean scale.  Where the peers' block scales
    agree the per-block error is at most n_peers * max|x| / 127 (the
    reference's bound); where they differ, the mean scale biases the sum
    (the reference's arithmetic, kept)."""
    shape, n = x.shape, x.numel()
    q, scale = _quantize_block(_blocks(x))
    # carry values as int32 so the reduction itself is exact
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=group)
    ssum = scale.clone()
    dist.all_reduce(ssum, group=group)
    npeers = torch.ones((), dtype=torch.float32, device=x.device)
    dist.all_reduce(npeers, group=group)
    out = qsum.to(torch.float32) * (ssum / npeers)
    return out.reshape(-1)[:n].reshape(shape)


def make_compressed_allreduce(mesh, axis: str = "pod"):
    """Tree-level compressed mean over one axis of a `DeviceMesh` (e.g.
    cross-pod gradient averaging while FSDP handles intra-pod): every leaf
    goes through `compressed_psum` over `mesh.get_group(axis)`, is divided
    by that axis' size and cast back to its dtype."""
    group = mesh.get_group(axis)
    size = mesh.size(list(mesh.mesh_dim_names).index(axis))

    def allreduce(tree):
        return tree_map(lambda g: (compressed_psum(g, group) / _on(g, float(size))).to(g.dtype),
                        tree)
    return allreduce


def compression_error_feedback(grads, residual):
    """Error-feedback accumulator (Seide et al.): add the previous round's
    quantization residual before compressing; return (to_send, new_residual)."""
    if residual is None:
        residual = tree_map(torch.zeros_like, grads)
    res = iter(tree_leaves(residual))          # the same structure as grads
    to_send = tree_map(lambda g: g + next(res), grads)

    def _resid(s):
        q, scale = _quantize_block(_blocks(s))
        deq = (q.to(torch.float32) * scale).reshape(-1)[:s.numel()].reshape(s.shape)
        return (s - deq).to(s.dtype)

    return to_send, tree_map(_resid, to_send)
