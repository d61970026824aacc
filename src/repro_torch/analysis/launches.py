"""Launches-per-call accounting: count the port's kernels on the card.

Port of `repro.analysis.launches`, which counts `pallas_call` equations in
a traced program.  The port has no traced program: a call launches its
kernels as it runs.  So `count_launches` runs the call once under
`torch.profiler` (CUDA activity only), counts the device kernels whose
names are kernels of `src/repro_torch/csrc/`, and holds that count against
the wrappers' own counts (`kernels/_launch.LAUNCHES`) over the same call.
Two independent counts of one run must agree: the profiler's sees what the
card ran, the wrappers' what the Python path asked for.

The name matching (`kernel_counts`) is a pure function of a list of event
names, so it is tested without a card.
"""
from __future__ import annotations

import collections
import re
from typing import Any, Callable, Iterable

# `__global__` function in csrc/*.cu -> the wrapper's launch-count name
# (`count_launch(name)`); one wrapper may take one of several kernels
KERNEL_LAUNCHES: dict[str, str] = {
    "fixed_conv2d_kernel": "fixed_conv2d",
    "fixed_maxpool2x2_kernel": "fixed_maxpool2x2",
    "fixed_sigmoid_kernel": "fixed_sigmoid",
    "fixed_smallnet_kernel": "fixed_smallnet",
    "fixed_dense_kernel": "fixed_dense",
    "fixed_dense_rows_kernel": "fixed_dense",
    "fixed_window_head_kernel": "fixed_window_head",
    "frame_trunk_kernel": "frame_trunk",
    "conv2d_tile_kernel": "conv2d",
    "conv2d_direct_kernel": "conv2d",
    "float_smallnet_kernel": "float_smallnet",
    "maxpool2d_kernel": "maxpool2d",
    "sigmoid_pla_kernel": "sigmoid_pla",
    "qmm_dp4a_kernel": "quant_matmul",
    "qmm_wgmma_kernel": "quant_matmul",
}
# kernels a wrapper launches besides its counted one, not counted:
# `quant_matmul`'s wgmma route transposes `wq` with a kernel of its own first
HELPER_KERNELS = frozenset({"qmm_transpose_kernel"})

_MANGLED_IDENT = re.compile(r"(\d+)([A-Za-z_])")


def kernel_base_name(event_name: str) -> str:
    """The function name of a device kernel event: "void
    frame_trunk_kernel<...>(int const*, ...)" -> "frame_trunk_kernel".
    A mangled name ("_Z18frame_trunk_kernel...") gives its first
    length-prefixed identifier that ends in "_kernel"."""
    s = event_name.replace("(anonymous namespace)::", "")
    if s.startswith("_Z"):
        for m in _MANGLED_IDENT.finditer(s):
            ident = s[m.start(2):m.start(2) + int(m.group(1))]
            if ident.endswith("_kernel"):
                return ident
        return ""
    head = re.split(r"[<(]", s, maxsplit=1)[0].split()
    return head[-1].split("::")[-1] if head else ""


def kernel_counts(event_names: Iterable[str]) -> dict[str, int]:
    """Per launch-count name, the device kernel events of its kernels.
    Names of other kernels (PyTorch's own, copies, `HELPER_KERNELS`) are
    ignored."""
    return dict(collections.Counter(
        KERNEL_LAUNCHES[base] for base in map(kernel_base_name, event_names)
        if base in KERNEL_LAUNCHES))


def count_launches(fn: Callable, *args: Any, **kwargs: Any) -> dict[str, int]:
    """Per launch-count name, the port's kernels the card ran during one
    call of `fn(*args, **kwargs)`, counted by the profiler.  Raises if that
    count differs from the wrappers' `LAUNCHES` over the same call (so no
    other thread may launch the port's kernels meanwhile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _launch

    before = _launch.launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args, **kwargs)
        torch.cuda.synchronize()
    after = _launch.launches()
    counted = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = kernel_counts(names)
    if seen != counted:
        raise RuntimeError(
            f"kernel launches seen by the profiler {seen} differ from the "
            f"wrappers' counts {counted} ({len(names)} device events)")
    return seen
