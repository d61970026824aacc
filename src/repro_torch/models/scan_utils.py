"""Linear-recurrence scan over time.

Port of `repro.models.scan_utils.chunked_scan`.  The reference chunks its
`lax.scan` only to bound the memory of the backward pass (per-chunk
remat); the result is the plain scan's, so here it is a loop over time.
"""
from __future__ import annotations

import torch


def chunked_scan(step, init_state, xs):
    """Like lax.scan(step, init_state, xs) for time-major xs (a tuple of
    tensors with T leading); `step(state, x_t) -> (state, y_t)`.  Returns
    (final state, the y_t stacked on a leading T axis).  The reference's
    `chunk` (its remat granularity) has no counterpart."""
    state, ys = init_state, []
    for t in range(xs[0].shape[0]):
        state, y = step(state, tuple(a[t] for a in xs))
        ys.append(y)
    return state, torch.stack(ys)
