"""Kimi Delta Attention's recurrence: a chunked prefill (a CUDA kernel,
`csrc/kda.cu`) and a one-token decode step (a Triton kernel), each beside
its plain PyTorch version for CPU tensors.

Per head, with keys and queries of K channels and values of V, a state S
(K, V) in float32 that starts at zero for every request:

    S_t = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t

`g_t` (K,) is the log of a decay per key channel (<= 0), `beta_t` a
scalar in (0, 1); q and k come L2-normed, q already scaled.  The layer
around it (projections, short convolutions, gates, norm) is
`models/kda.py`'s.

These kernels replace no kernel of the JAX package: it has no KDA layer.

`kda_chunk_prefill` (one launch a layer and prompt): chunks of `CHUNK`
tokens in the WY/UT form.  Inside a chunk, with b_t the cumulative log
decay from the chunk's start and S the state carried in,

    A[t, s] = sum_c k_tc k_sc exp(b_tc - b_sc)      (s < t)
    P[t, s] = sum_c q_tc k_sc exp(b_tc - b_sc)      (s <= t)
    (I + Diag(beta) A) U = Diag(beta) (V - (k * exp(b)) S)
    O = (q * exp(b)) S + P U
    S <- exp(b_C) S + (k * exp(b_C - b))^T U

Every exponent is of a later cumulative decay less an earlier one, so no
factor passes 1 however fast a channel decays (a product of exp(b_t) and
exp(-b_s) would overflow).  The kernel takes one block a (head, sequence),
which holds the head's state in shared memory across the chunks and
computes A and P once a chunk for all V columns; its design and bound are
in `csrc/kda.cu`.  It takes K = V = 128, Kimi Linear's head width.

`kda_decode_step` (one launch a layer and decode step): one block a
(slot, head, half of the value columns): the 128 x 64 float32 half-state
is read, decayed, updated by the delta rule and written back in place,
and the output row stored.  Bound: the state's bytes, read and written
once (64 slots x 32 heads x 64 KB x 2 = 268 MB a layer).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import count_launch, on_cuda, require_tensor, stream_of

CHUNK = 64                # tokens a chunk of the prefill (csrc/kda.cu kC)
DECODE_BV = 64            # value columns a decode block


# -- plain versions -----------------------------------------------------------

def kda_chunk_prefill_plain(q, k, v, g, beta, chunk: int = CHUNK):
    """q, k, g (B, T, H, K), v (B, T, H, V), beta (B, T, H), all float32,
    -> (o (B, T, H, V), final state (B, H, K, V)), from a zero state, by
    the chunked form above."""
    B, T, H, K = k.shape
    V = v.shape[-1]
    S = torch.zeros((B, H, K, V), dtype=torch.float32, device=k.device)
    o = torch.empty((B, T, H, V), dtype=torch.float32, device=k.device)
    for a in range(0, T, chunk):
        e = min(a + chunk, T)
        qc, kc, gc, vc = (x[:, a:e].transpose(1, 2) for x in (q, k, g, v))   # (B, H, c, .)
        bc = beta[:, a:e].transpose(1, 2)[..., None]                        # (B, H, c, 1)
        c = e - a
        cum = gc.cumsum(2)
        ts = torch.arange(c, device=k.device)
        lower = ts[:, None] >= ts[None, :]
        diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]                 # (B, H, t, s, K)
        dec = torch.exp(diff.masked_fill(~lower[:, :, None], float("-inf")))
        A = torch.einsum("bhtk,bhsk,bhtsk->bhts", kc, kc, dec)
        A = A.masked_fill(~(ts[:, None] > ts[None, :]), 0.0)
        P = torch.einsum("bhtk,bhsk,bhtsk->bhts", qc, kc, dec)
        R = bc * (vc - (kc * cum.exp()) @ S)
        eye = torch.eye(c, dtype=torch.float32, device=k.device)
        U = torch.linalg.solve_triangular(eye + bc * A, R, upper=False, unitriangular=True)
        o[:, a:e] = ((qc * cum.exp()) @ S + P @ U).transpose(1, 2)
        last = cum[:, :, -1:]                                                # (B, H, 1, K)
        S = last.transpose(-1, -2).exp() * S + (kc * (last - cum).exp()).transpose(-1, -2) @ U
    return o, S


def kda_decode_step_plain(q, k, v, g, beta, state):
    """One token a slot: q, k, g (B, H, K), v (B, H, V), beta (B, H)
    float32; `state` (B, H, K, V) float32 updated in place -> o (B, H, V)."""
    S = state * g.exp()[..., None]
    u = beta[..., None] * (v - torch.einsum("bhkv,bhk->bhv", S, k))
    S = S + k[..., None] * u[..., None, :]
    state.copy_(S)
    return torch.einsum("bhkv,bhk->bhv", S, q)


# -- the kernels ----------------------------------------------------------------

@functools.cache
def _decode_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def kda_decode_step_kernel(q_ptr, k_ptr, v_ptr, g_ptr, beta_ptr, s_ptr, o_ptr,
               K: tl.constexpr, V: tl.constexpr, BV: tl.constexpr):
        i_bh, i_v = tl.program_id(0), tl.program_id(1)
        rk = tl.arange(0, K)
        rv = i_v * BV + tl.arange(0, BV)
        q = tl.load(q_ptr + i_bh * K + rk)
        k = tl.load(k_ptr + i_bh * K + rk)
        g = tl.load(g_ptr + i_bh * K + rk)
        v = tl.load(v_ptr + i_bh * V + rv)
        beta = tl.load(beta_ptr + i_bh)
        sp = s_ptr + i_bh * K * V + rk[:, None] * V + rv[None, :]
        S = tl.load(sp) * tl.exp(g)[:, None]
        u = beta * (v - tl.sum(S * k[:, None], axis=0))
        S = S + k[:, None] * u[None, :]
        tl.store(sp, S)
        tl.store(o_ptr + i_bh * V + rv, tl.sum(S * q[:, None], axis=0))

    return kda_decode_step_kernel


def _check(what, tensors, shapes):
    for name, t, shape in zip(what, tensors, shapes):
        require_tensor(f"kda {name}", t, (torch.float32,), ndim=len(shape))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"kda {name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def kda_chunk_prefill(q, k, v, g, beta):
    """As `kda_chunk_prefill_plain`: CPU tensors go to it, CUDA tensors to
    the kernel, one launch for every sequence and head."""
    B, T, H, K = k.shape
    V = v.shape[-1]
    _check(("q", "k", "v", "g", "beta"), (q, k, v, g, beta),
           ((B, T, H, K),) * 2 + ((B, T, H, V), (B, T, H, K), (B, T, H)))
    if not on_cuda(q, k, v, g, beta):
        return kda_chunk_prefill_plain(q, k, v, g, beta)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("kda_chunk_prefill: the kernel reads 16-byte aligned rows")
    n = -(-T // CHUNK)
    # the cumulative log decay from each chunk's start, over whole chunks
    # (the padding's g is 0, so a last chunk's tail keeps its last value)
    b = torch.nn.functional.pad(g, (0, 0, 0, 0, 0, n * CHUNK - T))
    b = b.reshape(B, n, CHUNK, H, K).cumsum(2).reshape(B, n * CHUNK, H, K)
    o = torch.empty((B, T, H, V), dtype=torch.float32, device=k.device)
    state = torch.empty((B, H, K, V), dtype=torch.float32, device=k.device)
    lib = _build.library("kda")
    dev, stream = stream_of(q)
    rc = lib.kda_chunk_prefill_launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      b.data_ptr(), beta.data_ptr(), o.data_ptr(),
                                      state.data_ptr(), B, T, H, K, V, stream)
    _build.check(lib, rc, f"kda_chunk_prefill of {T} tokens, K {K}, V {V}")
    count_launch("kda_chunk_prefill")
    return o, state


def kda_decode_step(q, k, v, g, beta, state):
    """As `kda_decode_step_plain`, `state` updated in place: CPU tensors go
    to it, CUDA tensors to the kernel, one launch for every slot and head."""
    B, H, K = k.shape
    V = v.shape[-1]
    _check(("q", "k", "v", "g", "beta", "state"), (q, k, v, g, beta, state),
           ((B, H, K),) * 2 + ((B, H, V), (B, H, K), (B, H), (B, H, K, V)))
    if not on_cuda(q, k, v, g, beta, state):
        return kda_decode_step_plain(q, k, v, g, beta, state)
    if V % DECODE_BV or K & (K - 1):
        raise ValueError(f"kda_decode_step: K {K} must be a power of 2 and V {V} a "
                         f"multiple of {DECODE_BV}")
    o = torch.empty((B, H, V), dtype=torch.float32, device=k.device)
    _decode_kernel()[(B * H, V // DECODE_BV)](q, k, v, g, beta, state, o, K=K, V=V,
                                              BV=DECODE_BV, num_warps=4)
    count_launch("kda_decode_step")
    return o
