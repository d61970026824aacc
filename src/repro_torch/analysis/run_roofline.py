"""Roofline sweep -> build/roofline/results.json.

Port of `repro.analysis.run_roofline`.  Full mode lowers every
single-pod LLM cell (`launch.mesh.make_production_mesh()`, 256 devices;
long_500k only where the arch supports long context) on the meta device,
counts its step's FLOPs (`launch.lowering.count_flops`) and collective
bytes, and writes its three-term roofline (`analysis/roofline.py`).  All
modes also write the SMALLNET rows: analytic two-term rooflines for the
ledger routes (tiler / composed sweep / one-launch sweep, `ref` and
`fixed_cuda` numerics) from `analysis/mfu.py`'s workload model,
cross-checked against `FlopCounterMode` over the port's plain trunk.

    python -m repro_torch.analysis.run_roofline [--arch A] [--shape S] [--force]
    python -m repro_torch.analysis.run_roofline --smoke   # smallnet only, a gate

--smoke recomputes only the smallnet rows and exits nonzero if any
roofline term is NaN, infinite or not positive, or the FLOP cross-check
drifts past 2 %.  Every count runs on the meta device: nothing is
allocated on a card or set in the environment.  The cells already
recorded without an error are skipped unless --force; results go to
build/roofline/results.json at the repository root, or to --out.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import pathlib
import sys
import time
import traceback

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "roofline" / "results.json"


def smallnet_rows(device_name: str, *, frame_device="meta") -> tuple[dict, list[str]]:
    """(rows keyed 'smallnet-<backend>|<route>', failures).  Failures are
    non-finite or non-positive terms (a zero peak or bandwidth included)
    and FLOP-cross-check drift (its frame on `frame_device`)."""
    from repro_torch.analysis.roofline import smallnet_rooflines

    try:
        rows = smallnet_rooflines(device_name=device_name)
    except (ZeroDivisionError, KeyError) as e:
        return {}, [f"device {device_name!r}: {type(e).__name__}: {e}"]
    failures = []
    for key, r in rows.items():
        for term in ("flops", "bytes", "intensity", "compute_s", "memory_s",
                     "attainable_flops", "peak_flops", "mem_bw"):
            v = r[term]
            if not math.isfinite(v):
                failures.append(f"{key}: {term}={v!r} is not finite")
            elif v <= 0:
                failures.append(f"{key}: {term}={v!r} — zero/negative "
                                f"denominator would make MFU meaningless")
    failures += _flop_crosscheck(device=frame_device)
    return rows, failures


def _elementwise(*args, out_shape=None, **kwargs) -> int:
    """One FLOP an output element."""
    return math.prod(out_shape)


def _flop_crosscheck(H: int = 56, W: int = 56, *, device="meta") -> list[str]:
    """Count the plain `ref` trunk's FLOPs over one (1,H,W,1) frame on
    `device` (the meta device unless the caller names another) with
    FlopCounterMode and compare them with the analytic model.  The plain
    conv is elementwise (`kernels/conv2d/ops.conv2d_plain`: each tap a
    product, summed, then the bias), so the counter is given one FLOP an
    output element of aten.mul and aten.add: 4 products, 3 sums and the
    bias add an output, the model's 2 x 4 taps; the sigmoid and the pool's
    max are neither.  The two totals must agree to 2 %."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.mfu import trunk_workload
    from repro_torch.core import smallnet
    from repro_torch.core.device import resolve_device

    dev = resolve_device(device)
    params = smallnet.init_params(torch.Generator().manual_seed(0), device="cpu")
    params = {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
    frame = torch.zeros((1, H, W, 1), dtype=torch.float32, device=dev)
    aten = torch.ops.aten
    with FlopCounterMode(display=False, custom_mapping={aten.mul: _elementwise,
                                                        aten.add: _elementwise}) as c:
        smallnet.conv_trunk(params, frame, backend="ref", device=dev)
    counted = c.get_total_flops()
    model = trunk_workload(H, W, "trunk").flops
    if counted <= 0:
        return [f"flop-crosscheck: FlopCounterMode counts {counted} FLOPs for "
                f"the {H}x{W} ref trunk"]
    drift = abs(counted - model) / model
    if drift > 0.02:
        return [f"flop-crosscheck: analytic trunk model {model} vs counted "
                f"{counted} FLOPs ({drift:.1%} drift) — the workload model no "
                f"longer matches the plain trunk"]
    return []


def _save(path: pathlib.Path, res: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(res, indent=1, sort_keys=True))
    tmp.replace(path)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="smallnet rows only; nonzero exit on NaN/zero "
                         "rooflines or FLOP-model drift")
    ap.add_argument("--device", default="h100",
                    help="MFU-database device whose peaks the rooflines divide by")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    res = json.loads(out.read_text()) if out.exists() else {}

    rows, failures = smallnet_rows(args.device)
    res.update({k: dict(v, device=args.device) for k, v in rows.items()})
    for key in sorted(rows):
        r = rows[key]
        print(f"[roofline] {key} bound={r['bound']} "
              f"intensity={r['intensity']:.1f} flop/B "
              f"attainable={r['attainable_flops']:.3g} FLOP/s", flush=True)
    _save(out, res)

    if args.smoke:
        for f in failures:
            print(f"[roofline] FAIL {f}")
        print(f"[roofline] smoke {'FAIL' if failures else 'OK'}")
        return 1 if failures else 0

    from repro_torch.analysis.roofline import roofline_from_cell, to_dict
    from repro_torch.configs.base import cells
    from repro_torch.launch.lowering import lower_cell
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    n_llm_failures = 0
    for arch, shape in cells():
        if (args.arch and arch != args.arch) or (args.shape and shape != args.shape):
            continue
        key = f"{arch}|{shape}"
        if not args.force and key in res and "error" not in res[key]:
            continue
        t0 = time.perf_counter()
        print(f"[roofline] {key} ...", flush=True)
        try:
            d = to_dict(roofline_from_cell(lower_cell(arch, shape, mesh), device=args.device))
            d["count_seconds"] = round(time.perf_counter() - t0, 1)
            res[key] = d
            print(f"[roofline] {key} dominant={d['dominant']} "
                  f"step={d['step_time_s']*1e3:.1f}ms "
                  f"frac={d['roofline_fraction']:.3f} ({d['count_seconds']} s)", flush=True)
            gc.collect()
        except Exception as e:      # noqa: BLE001 — a failed cell is recorded; the sweep goes on
            n_llm_failures += 1
            res[key] = {"error": f"{type(e).__name__}: {e}"}
            traceback.print_exc(limit=3)
        _save(out, res)
    print(f"[roofline] done, {n_llm_failures} failures")
    return 1 if (n_llm_failures or failures) else 0


if __name__ == "__main__":
    sys.exit(main())
