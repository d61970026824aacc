"""What every kernel wrapper shares: input checks, the CPU/CUDA route, the
launch counts.

A wrapper checks its tensors (device, dtype, shape, contiguity), then
sends CPU tensors to its plain PyTorch version and launches its CUDA kernel
for CUDA tensors; any other device raises.  There is no fallback: a CUDA
tensor either goes through the kernel or the call raises.

`count_launch(name)` is called by a wrapper where it launches its kernel
and nowhere else, so a run can show which kernels its path went through
(`reset_launches()` before, `launches()` after).  The count is taken under
a lock: engines started with `VisionEngine.start` step on threads of their
own.  Inside `recorded_launches()` a thread's launches are recorded and
not counted: a CUDA graph's capture enqueues launches the card does not
run, and each replay of the graph counts them.
"""
from __future__ import annotations

import collections
import contextlib
import threading

import torch

LAUNCHES: collections.Counter[str] = collections.Counter()
_LAUNCHES_LOCK = threading.Lock()


_RECORDING = threading.local()


def count_launch(name: str) -> None:
    names = getattr(_RECORDING, "names", None)
    if names is not None:
        names.append(name)
        return
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def recorded_launches():
    """Within the block, this thread's `count_launch` calls append their
    names to the yielded list instead of counting."""
    names: list[str] = []
    _RECORDING.names = names
    try:
        yield names
    finally:
        _RECORDING.names = None


def launches() -> dict[str, int]:
    with _LAUNCHES_LOCK:
        return dict(LAUNCHES)


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES.clear()


def require_words(what: str, t: torch.Tensor, *, ndim: int | None = None,
                  numel: int | None = None) -> None:
    """Raise unless `t` is a contiguous int32 tensor of the given rank/size."""
    require_tensor(what, t, (torch.int32,), ndim=ndim, numel=numel)


def require_tensor(what: str, t: torch.Tensor, dtypes: tuple[torch.dtype, ...], *,
                   ndim: int | None = None, numel: int | None = None) -> None:
    """Raise unless `t` is a contiguous tensor of one of `dtypes` and of the
    given rank/size."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: expected {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{what}: expected {numel} words, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True to launch the kernel (CUDA), False for the plain version (CPU)."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {dev}")


def stream_of(t: torch.Tensor) -> tuple[int, int]:
    """(device index, current stream handle) for a launch next to `t`."""
    index = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(index).cuda_stream
