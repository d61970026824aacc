"""Multi-pod dry run: lower every (arch x shape x mesh) cell on the meta
device and record each device's argument, output and alias bytes.

Port of `repro.launch.dryrun`.  The reference compiles each cell through
XLA on 512 placeholder devices; the port lowers it with
`launch/lowering.py` over the abstract production meshes
(`launch/mesh.make_production_mesh`): nothing is allocated, no device or
process group is touched, and no environment variable is set.

Usage:
    python -m repro_torch.launch.dryrun                   # full sweep
    python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k --mesh single_pod
    python -m repro_torch.launch.dryrun --out build/dryrun/alone.json

Per-cell results go to build/dryrun/results.json at the repository root,
or to `--out` (idempotent: cells already recorded OK are skipped unless
--force).  There is no `--hlo-dir`: there is no HLO.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback

from repro_torch.configs.base import cells
from repro_torch.launch.lowering import cell_report, lower_cell
from repro_torch.launch.mesh import make_production_mesh

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun" / "results.json"
MESH_KINDS = ("single_pod", "multi_pod")


def load_results(path: pathlib.Path) -> dict:
    if path.exists():
        return json.loads(path.read_text())
    return {}


def save_results(path: pathlib.Path, res: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(res, indent=1, sort_keys=True))
    tmp.replace(path)


def cell_key(arch: str, shape: str, mesh_kind: str) -> str:
    return f"{arch}|{shape}|{mesh_kind}"


def iter_cells(mesh_kinds):
    """Every cell of `configs.base.cells()` (long_500k only where the arch
    supports long context) on each mesh kind."""
    for arch, shape in cells():
        for mk in mesh_kinds:
            yield arch, shape, mk


def run_cell(arch: str, shape: str, mesh_kind: str) -> dict:
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi_pod"))
    t0 = time.perf_counter()
    rep = cell_report(lower_cell(arch, shape, mesh))
    rep["lower_seconds"] = time.perf_counter() - t0
    return rep


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=MESH_KINDS)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)

    out = pathlib.Path(args.out)
    mesh_kinds = [args.mesh] if args.mesh else list(MESH_KINDS)
    results = load_results(out)
    failures = 0
    for arch, shape, mk in iter_cells(mesh_kinds):
        if args.arch and arch != args.arch:
            continue
        if args.shape and shape != args.shape:
            continue
        key = cell_key(arch, shape, mk)
        if not args.force and results.get(key, {}).get("ok"):
            continue
        try:
            rep = run_cell(arch, shape, mk)
            print(f"[dryrun] {key} OK args "
                  f"{rep['memory']['argument_bytes_per_device'] / 2**30:.2f} GiB/device",
                  flush=True)
        except Exception as e:          # noqa: BLE001 — a failed cell is recorded, the sweep goes on
            failures += 1
            rep = {"arch": arch, "shape": shape, "mesh": mk, "ok": False,
                   "error": f"{type(e).__name__}: {e}"}
            print(f"[dryrun] {key} FAIL: {rep['error']}", flush=True)
            traceback.print_exc(limit=3)
        results[key] = rep
    save_results(out, results)
    print(f"[dryrun] done; {failures} failures; results -> {out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
