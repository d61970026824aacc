"""The program under test as a configuration states it: its backend, its
params on the card, and how its scores read.  With the drivers and the
control, the only part of the benchmark that imports the program
(`repro_torch`); the reference imports none of it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench.reference import smallnet as ref


def backend(config: dict, fmt: dict | None = None):
    """The program's backend for `config`, checked against what the
    configuration states; `fmt` overrides a Qm.n backend's format (the
    lower-precision control)."""
    from repro_torch.core import backends as B
    from repro_torch.core import fixed_point as fxp
    be = B.get_backend(config["backend"])
    if "format" in config:
        want = fxp.FixedPointConfig(**config["format"])
        if be.cfg != want:
            raise ValueError(f"backend {be.name} runs {be.cfg}, the configuration states {want}")
        if fmt is not None:
            be = dataclasses.replace(be, cfg=fxp.FixedPointConfig(**fmt))
    elif getattr(be, "activation", None) != config["activation"]:
        raise ValueError(f"backend {be.name} does not run the {config['activation']} activation")
    return be


def score_format(config: dict, fmt: dict | None = None) -> ref.Format | None:
    """The Qm.n format the program's scores are words of, or None (floats)."""
    spec = fmt if fmt is not None else config.get("format")
    return None if spec is None else ref.format_of(spec)


def tiler_cfg(fmt: ref.Format | None):
    from repro_torch.core import fixed_point as fxp
    if fmt is None:
        return fxp.Q16_16                  # unused: float scores are confidences
    return fxp.FixedPointConfig(fmt.total_bits, fmt.frac_bits,
                                round_nearest=fmt.round_nearest)


def params_on(params: dict, device) -> dict:
    return {layer: {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    for k, v in leaves.items()} for layer, leaves in params.items()}


def as_reference_words(scores: np.ndarray, fmt: ref.Format | None,
                       want: ref.Format | None) -> np.ndarray:
    """Scores of the program in `fmt` as words of the reference's format
    `want` (a Q8.8 word is a Q16.16 word shifted left by 8), so that the
    control's outputs are judged in the configuration's own terms."""
    if fmt is None or want is None or fmt == want:
        return np.asarray(scores)
    return np.asarray(scores, np.int64) << (want.frac_bits - fmt.frac_bits)
