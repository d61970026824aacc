"""The control of a cell's comparison: the nearest precision below the
configuration's, put in the program's place, run through the cell's
traffic and judged as a run is judged; it has to come out not correct.

    python3 bench/control.py --workload <cell> --seconds 5 --seeds 1 2 3

Qm.n configurations: the program's own Q8.8 path on the same kernels
(their `control.format`), its words read as the configuration's words.
Float32 configurations: the reference computed in bfloat16, every
operation rounded (`reference.smallnet.to_bf16`), as the served step's
scores or as the sweep's window scores.  Prints one JSON line a seed with
each compared number, its limit, and whether the run came out correct.
Runs on the card; `controlled_run(..., device="cpu")` is what the tests
drive.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path.cwd()


def bf16_backend(params: dict):
    """A backend of the program whose served step is the bfloat16
    reference's forward (on the host), answered on the images' device."""
    import dataclasses

    import torch
    from repro_torch.core import backends as B

    from bench.reference import smallnet as ref

    @dataclasses.dataclass(frozen=True)
    class Bf16Reference(B.Backend):
        name: str = "bf16_reference"

        def net_scores(self, images, p):
            x = images.detach().cpu().numpy()
            return torch.from_numpy(ref.net_float(params, x, ref.to_bf16)).to(images.device)

    return Bf16Reference()


def bf16_scorer(positions):
    from bench.reference import smallnet as ref
    from bench.reference import sweep as rs

    def score(params, frames):
        frame = frames[0]
        return rs.window_scores(frame, positions,
                                lambda c: ref.net_float(params, c, ref.to_bf16))
    return score


def controlled_run(cell, seed: int, seconds: float, *, device: str = "cuda"):
    """A driver's run with the control in the program's place, set up,
    run and judged; -> (run, compared)."""
    from bench import harness, program
    from bench.reference import sweep as rs
    driver = harness.load_driver(cell.driver)
    ctl = cell.config["control"]
    params = harness.params_for(cell.config, seed)
    if "format" in ctl:
        kw = {"backend": program.backend(cell.config, fmt=ctl["format"]),
              "score_fmt": ctl["format"]}
    elif driver.KIND == "fleet":
        kw = {"backend": bf16_backend(params)}
    else:
        shape = tuple(cell.mix["frame_shape"])
        kw = {"scorer": bf16_scorer(rs.positions(shape, 28, cell.mix["stride"]))}
    run = driver.Run(cell, seed, seconds, device=device, **kw)
    run.setup()
    run.window()
    run.release()
    return run, run.check()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench import harness
    if not torch.cuda.is_available():
        raise SystemExit("control: no CUDA card")
    cell = harness.cell(args.workload)
    for seed in args.seeds:
        run, compared = controlled_run(cell, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": cell.config["control"],
                          "correct": all(c.ok for c in compared), "attempted": run.attempted,
                          "compared": {c.name: {"value": c.value, "limit": c.limit}
                                       for c in compared},
                          "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
