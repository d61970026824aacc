"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --steps 100 --preset smoke [--device cpu] [--ckpt-dir DIR]

Port of `repro.launch.train` on one device: the arch's smoke or published
config, the reference's flags and defaults, and `--device` (the card
unless it says otherwise).  With `--ckpt-dir` it checkpoints every 25
steps and resumes from the latest checkpoint there.  The reference's
`--distributed` waits for the port's distribution slice.
"""
from __future__ import annotations

import argparse


def main(argv: list[str] | None = None):
    """Train; returns (state, history) from `Trainer.run`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import get_config
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.smoke()
    t = Trainer(cfg, TrainerConfig(
        total_steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, lr=args.lr,
        warmup_steps=max(5, args.steps // 20),
        ckpt_dir=args.ckpt_dir, ckpt_every=25, log_every=10), device=args.device)
    state, history = t.run(on_metrics=lambda s, m: print(
        f"step {s:5d} loss {m['loss']:.4f}", flush=True))
    if history:
        print(f"done: loss {history[0]:.4f} -> {history[-1]:.4f}")
    return state, history


if __name__ == "__main__":
    main()
