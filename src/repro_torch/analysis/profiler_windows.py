"""How often torch.profiler loses the device activity of a short window.

    PYTHONPATH=src python -m repro_torch.analysis.profiler_windows \
        [--seconds 240] [--launches 3] [--pads 0 0.005 0.02]

Profiles windows of `--launches` back-to-back `fixed_maxpool2x2` launches
(64 frames of 28x28 words, a few microseconds each), taken in turns with
each pad of host idle at both ends of the window, for `--seconds`; then
prints the card (nvidia-smi's name and power limit) and one JSON line a pad:
the windows, those that saw fewer device kernels than were launched, and
those that saw none.  `chip_smoke.py`'s `device_trace` and
`launches.count_launches` pad their windows from what this reads.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time


def window(launch, n: int, pad_s: float) -> int:
    """Device kernels the profiler saw over `n` calls of `launch`, with
    `pad_s` of host idle at each end of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(n):
            launch()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--launches", type=int, default=3)
    ap.add_argument("--pads", type=float, nargs="+", default=[0.0, 0.005, 0.02])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.device import resolve_device
    from repro_torch.kernels.fixed_conv.ops import fixed_maxpool2x2

    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise ValueError(f"profiler_windows reads the card's activity; {dev} has none")
    x = torch.randint(-2**20, 2**20, (64, 28, 28), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(0)).to(dev)
    launch = lambda: fixed_maxpool2x2(x)
    launch()
    tally = {pad: {"windows": 0, "missing_launches": 0, "empty": 0} for pad in args.pads}
    end = time.perf_counter() + args.seconds
    while time.perf_counter() < end:
        for pad in args.pads:
            seen = window(launch, args.launches, pad)
            t = tally[pad]
            t["windows"] += 1
            t["missing_launches"] += seen < args.launches
            t["empty"] += seen == 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    for pad, t in tally.items():
        print(json.dumps({"pad_s": pad, "launches_a_window": args.launches, **t}), flush=True)
    return tally


if __name__ == "__main__":
    main()
