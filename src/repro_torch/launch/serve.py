"""Serving launcher: continuous-batching engine over a selected arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --requests 16 --batch 4 [--int8] [--device cpu]

Port of `repro.launch.serve`: the arch's smoke config with seeded random
weights (`torch.Generator`, seed 0), 6-token prompts from numpy seed 0.
`--int8` applies the paper's deployment flow (PTQ int8 weights,
dequantized) before serving.  Runs on the card unless `--device` says
otherwise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv: list[str] | None = None) -> list:
    """Serve the workload; returns the finished requests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import get_config
    from repro_torch.core import ptq
    from repro_torch.core.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).smoke()
    model = M.build(cfg)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    if args.int8:
        params = ptq.dequantize_tree(ptq.quantize_tree(params))
        print("serving int8-quantized weights (PTQ, per-channel)")
    eng = Engine(cfg, params, batch_size=args.batch, max_len=64, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, 6).astype(np.int32),
                    max_new_tokens=args.max_new) for i in range(args.requests)]
    t0 = time.perf_counter()
    done = eng.submit_and_run(reqs)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    print(f"{len(done)} requests, {toks} tokens, {dt:.2f}s ({toks/dt:.1f} tok/s)")
    return done


if __name__ == "__main__":
    main()
