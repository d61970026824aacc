"""The comparisons that decide `correct`, on outputs the program produced
and on the reference's outputs for the same inputs.  NumPy only.

Qm.n configurations are exact: every score word equals the reference's,
every Max Finder output and every detection too (limit 0).  Float
configurations compare the widest gap between a score and the
reference's; a Max Finder output is judged only where the reference's two
best scores lie further apart than that gap's limit (closer, rounding may
order them either way), and detections are judged as the deterministic
function of the program's own window scores that they are.
"""
from __future__ import annotations

import numpy as np

from bench.harness import Compared
from bench.reference import smallnet as ref


def scores(got: np.ndarray, want: np.ndarray, preds: np.ndarray, exact: bool,
           limits: dict, prefix: str = "") -> list[Compared]:
    """(n, 10) scores and (n,) Max Finder outputs against the reference's
    (n, 10) scores."""
    got = np.asarray(got)
    want = np.asarray(want)
    want_preds = ref.predict(want)
    if exact:
        differ = int((got.astype(np.int64) != want.astype(np.int64)).any(axis=-1).sum())
        out = [Compared(f"{prefix}score_words_differ", differ,
                        limits[f"{prefix}score_words_differ"])]
        if preds is not None:
            out.append(Compared(f"{prefix}preds_differ", int((preds != want_preds).sum()),
                                limits[f"{prefix}preds_differ"]))
        return out
    lim = limits[f"{prefix}score_gap_max"]
    gap = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max()) if len(got) else 0.0
    out = [Compared(f"{prefix}score_gap_max", gap, lim)]
    if preds is not None:
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > lim
        out.append(Compared(f"{prefix}preds_differ_clear",
                            int(((preds != want_preds) & clear).sum()),
                            limits[f"{prefix}preds_differ_clear"]))
    return out
