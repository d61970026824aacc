"""The one place that resolves the port's device.

The port's entry points run on the card unless the caller asks for the
CPU: `None` means "cuda".  Asking for CUDA on a host without it raises;
nothing falls back quietly.  There is no interpret switch (the reference's
`core/runtime.py`): each kernel wrapper sends a CPU tensor to its plain
PyTorch version and launches its CUDA kernel for a CUDA tensor.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """`None` -> cuda; raises RuntimeError when CUDA is asked for and absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def as_device_tensor(x, device: torch.device | str | None = None, *,
                     dtype: torch.dtype | None = None) -> torch.Tensor:
    """A tensor stays where it is unless `device` names another place; any
    other array goes to `resolve_device(device)`."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
        return x.to(device=dev, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=resolve_device(device))
