"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --steps 100 --preset smoke [--device cpu] [--ckpt-dir DIR]
    torchrun --nproc-per-node N -m repro_torch.launch.train --distributed ...

Port of `repro.launch.train`: the arch's smoke or published config, the
reference's flags and defaults, and `--device` (the card unless it says
otherwise).  With `--ckpt-dir` it checkpoints every 25 steps and resumes
from the latest checkpoint there.

`--distributed` is the reference's `jax.distributed.initialize()` from
the environment: it reads torchrun's RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT, brings up the process group (NCCL on
cuda:LOCAL_RANK; gloo with `--device cpu`) before training, and destroys
it after.  As in the reference, the Trainer itself neither shards nor
splits the data: every rank trains the whole batch (no DDP or FSDP
wrapping), and each rank should be given its own `--ckpt-dir`.  A group
that does not come up raises.
"""
from __future__ import annotations

import argparse
import os

DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device: str | None) -> str:
    """Bring up the default process group from torchrun's environment;
    returns the device this rank trains on."""
    import torch
    import torch.distributed as dist

    missing = [k for k in DIST_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed: {', '.join(missing)} not set (run under torchrun)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    if device is not None and torch.device(device).type == "cpu":
        backend, dev, device_id = "gloo", "cpu", None
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed: NCCL needs CUDA; pass --device cpu for gloo")
        dev = f"cuda:{local}"
        torch.cuda.set_device(local)
        backend, device_id = "nccl", torch.device(dev)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            device_id=device_id)
    return dev


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
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process: init the process group from torchrun's env")
    args = ap.parse_args(argv)

    if not args.distributed:
        return _train(args, args.device)
    import torch.distributed as dist
    device = init_distributed(args.device)
    try:
        return _train(args, device)
    finally:
        dist.destroy_process_group()


def _train(args, device: str | None):
    from repro_torch.configs.base import get_config
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.smoke()
    t = Trainer(cfg, TrainerConfig(
        total_steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, lr=args.lr,
        warmup_steps=max(5, args.steps // 20),
        ckpt_dir=args.ckpt_dir, ckpt_every=25, log_every=10), device=device)
    state, history = t.run(on_metrics=lambda s, m: print(
        f"step {s:5d} loss {m['loss']:.4f}", flush=True))
    if history:
        print(f"done: loss {history[0]:.4f} -> {history[-1]:.4f}")
    return state, history


if __name__ == "__main__":
    main()
