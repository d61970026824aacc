"""The benchmark of the PyTorch/CUDA port of smallNet, one cell a run.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, `bench/` and the
program (`src/repro_torch`), on a machine with a CUDA card.  Set-up
(counted in `setup_s`, from the start of this script to the window) makes
the inputs and params from the seed, builds or loads the kernels and
warms the cell's shapes; the window runs the program for `--seconds`;
then the program's state is freed and every output the window produced is
compared with the plain NumPy reference in `bench/reference/`.  The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer metrics, read from a profiled window), `device`, with
`--trace 1` a `breakdown`, and last `compared`, each compared number
beside its limit; the same numbers end standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse          # noqa: E402
import json              # noqa: E402
import os                # noqa: E402
import pathlib           # noqa: E402
import sys               # noqa: E402

ROOT = pathlib.Path.cwd()
BUILD = ROOT / "build"


def fail(msg: str, code: int) -> "NoReturn":  # noqa: F821
    print(f"bench: {msg}", file=sys.stderr)
    raise SystemExit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "BENCHMARK.json").is_file() or not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"run from the root of a checkout with BENCHMARK.json and src/repro_torch "
             f"(cwd {ROOT})", 2)
    # every cache of the program inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(BUILD / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from bench import harness
    from bench.work.peaks import peaks_for
    benchmark = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in benchmark["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        fail(f"{args.workload!r} is no cell of BENCHMARK.json", 2)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        fail(f"the cell needs {entry['chips']} CUDA card(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    cell = harness.cell(args.workload)
    seed = args.seed % 2 ** 63
    run = harness.load_driver(cell.driver).Run(cell, seed, args.seconds)
    torch.cuda.reset_peak_memory_stats()
    run.setup()
    torch.cuda.synchronize()
    # the reference's share of set-up (a threshold it computes) is the
    # benchmark's own work, not the program's: timed apart and left out
    setup_s = time.perf_counter() - T_START - getattr(run, "reference_s", 0.0)
    run.window(trace=bool(args.trace))
    peak = int(torch.cuda.max_memory_allocated())
    found = harness.forbidden_modules(sys.modules)
    if found:
        fail(f"the run loaded {', '.join(found)}: JAX, Flax or the JAX package", 4)
    run.release()
    compared = run.check()

    rec = run.record()
    rec["setup_s"] = setup_s
    rec["peaks"] = peaks_for(torch.cuda.get_device_name(0))
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in harness.metrics_for(benchmark, args.workload, kind):
        value = harness.load_metric(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
              "memory_peak_bytes": peak}
    out = {"correct": all(c.ok for c in compared), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if args.trace:
        tr = rec["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": [[n, s] for n, s in tr["device_ops"]],
                            "idle_gaps": tr["idle_gaps"]}
    out["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in compared}
    print(f"bench: {rec['notes']}", file=sys.stderr)
    for c in compared:
        print(f"compared {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
