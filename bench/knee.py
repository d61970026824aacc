"""Find a fleet cell's knee and capacity once, by a sweep of offered rates
on the card.

    python3 bench/knee.py --workload q16-fleet-tail --seconds 8 --seeds 1 2 \
        --rates 1000 2000 3000 [--closed 3]

One process; at each rate and seed the cell's fleet is built afresh and
driven for `--seconds` as a run drives it.  Prints a JSON line a run: the
requests answered within the limit a second and their share, p50 and p99
from the scheduled arrival, the share shed, and the median latency of
the first and of the last fifth of the arrivals (a backlog that grows
through the window shows as a later fifth slower than the first).  The knee is the highest rate at which p99 is within the
limit, 99 % are answered within it, and the last fifth is no slower than
the limit allows.  With `--closed n`, first n rounds of the fleet's
closed-loop capacity: 4,096 requests submitted at once with a deadline of
a minute, drained, over the wall time.  The cells' mixes hold a rate
derived from these as a number.
"""
from __future__ import annotations

import argparse
import gc
import itertools
import json
import pathlib
import sys
import time

ROOT = pathlib.Path.cwd()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--closed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    from bench import harness
    if not torch.cuda.is_available():
        raise SystemExit("knee: no CUDA card")
    cell = harness.cell(args.workload)
    slo = cell.mix["limit_ms"]
    Run = harness.load_driver(cell.driver).Run
    card = torch.cuda.get_device_name(0)
    for r in range(args.closed):
        run = Run(cell, args.seeds[0] + r, 1.0)
        run.setup()
        images = list(run.pool)
        t0 = time.perf_counter()
        uids = run.router.submit_many(images, deadline_ms=60_000.0)
        run.router.wait(uids, timeout=600)
        wall = time.perf_counter() - t0
        shed = len(run.router.pop_shed(uids))
        run.router.pop_results(uids)
        run.router.stop()
        run.release()
        del run
        gc.collect()
        print(json.dumps({"workload": args.workload, "closed_loop_round": r,
                          "requests": len(images), "shed": shed,
                          "capacity_qps": (len(images) - shed) / wall, "card": card}), flush=True)
    for rate, seed in itertools.product(args.rates, args.seeds):
        run = Run(cell, seed, args.seconds, rate_qps=rate)
        run.setup()
        run.window()
        lat = run.latency_ms
        fifth = max(len(lat) // 5, 1)
        row = {"workload": args.workload, "rate_qps": rate, "seed": seed, "requests": len(lat),
               "in_time_per_s": float((lat <= slo).sum()) / args.seconds,
               "in_time_share": float((lat <= slo).mean()),
               "p50_ms": harness.nearest_rank(lat, 50), "p99_ms": harness.nearest_rank(lat, 99),
               "shed_share": float(run.shed.mean()), "gc": run.gc,
               "first_fifth_p50_ms": float(np.median(lat[:fifth])),
               "last_fifth_p50_ms": float(np.median(lat[-fifth:])),
               "late_p99_ms": harness.nearest_rank(run.late_s * 1e3, 99),
               "card": card}
        run.release()
        del run
        gc.collect()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
