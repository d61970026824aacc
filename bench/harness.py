"""What the benchmark finds by name, and the parts of a run that every cell
shares.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file of its own, found by its name:

    bench/workloads/<cell>.json     its configuration, traffic mix and the
                                    limits of its comparison
    bench/configs/<config>.json     the model's sizes, arithmetic and
                                    the program's backend that runs it
    bench/traffic/mixes/<mix>.json  the parameters that a driver reads
    bench/traffic/<driver>.py       a general driver of one kind of traffic
    bench/metrics/<metric>.py       `read(rec) -> float | None`

`BENCHMARK.json` at the root says which metrics a cell reports.  A later
change adds a cell, a mix or a metric by adding files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

import numpy as np

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")     # top-level module names


def names(kind: str, suffix: str, bench: pathlib.Path = BENCH) -> list[str]:
    """The names of `kind` ("workloads", "configs", "traffic/mixes",
    "metrics") that files under `bench` define."""
    return sorted(p.name[:-len(suffix)] for p in (bench / kind).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def load_json(kind: str, name: str, bench: pathlib.Path = BENCH) -> dict:
    path = bench / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind} file for {name!r}: {path} "
                         f"(known: {names(kind, '.json', bench)})")
    return json.loads(path.read_text())


def load_metric(name: str, bench: pathlib.Path = BENCH):
    """The reader of metric `name`: bench/metrics/<name>.py's `read`."""
    path = bench / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_driver(kind: str):
    return importlib.import_module(f"bench.traffic.{kind}")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict

    @property
    def driver(self) -> str:
        return self.mix["driver"]


def cell(name: str, bench: pathlib.Path = BENCH) -> Cell:
    w = load_json("workloads", name, bench)
    return Cell(name, w, load_json("configs", w["config"], bench),
                load_json("traffic/mixes", w["traffic"], bench))


def metrics_for(benchmark: dict, cell_name: str, kind: str) -> list[dict]:
    """The entries of `end_to_end` or `per_layer` that `cell_name` reports:
    those that list it under `workloads`, or list no cells at all."""
    return [m for m in benchmark[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def params_from_seed(seed: int) -> dict:
    """510 float32 params drawn from `seed`: glorot-uniform weights (Keras's
    default, as the paper trains it: conv fans 4 and 4, dense 49 and 10)
    and biases U(-0.5, 0.5), not zero, so that the bias path is part of
    every comparison."""
    rng = np.random.default_rng([seed, 0x5A11])

    def glorot(shape, fan_in, fan_out):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-lim, lim, size=shape).astype(np.float32)

    def bias(n):
        return rng.uniform(-0.5, 0.5, size=(n,)).astype(np.float32)

    return {"conv1": {"w": glorot((2, 2, 1, 1), 4, 4), "b": bias(1)},
            "conv2": {"w": glorot((2, 2, 1, 1), 4, 4), "b": bias(1)},
            "dense": {"w": glorot((49, 10), 49, 10), "b": bias(10)}}


def params_for(config: dict, seed: int) -> dict:
    """A run's params: the configuration's one draw (`params_seed`) with its
    ten classes in an order drawn from the run's seed.  Weights drawn anew
    for every seed change how many of a frame's windows tie at the
    detection threshold, and with it the sweep's work by up to 1.5x; a
    permutation of the classes moves every score to another place and
    leaves each window's best confidence, so every seed gets the same work."""
    p = params_from_seed(config["params_seed"])
    perm = np.random.default_rng([seed, 0xC1A5]).permutation(p["dense"]["w"].shape[1])
    p["dense"] = {"w": np.ascontiguousarray(p["dense"]["w"][:, perm]), "b": p["dense"]["b"][perm]}
    return p


def forbidden_modules(modules) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is
    JAX's, Flax's or the JAX package's, compared whole."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Compared:
    """One number of the correctness check beside its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


def nearest_rank(values, q: float) -> float:
    """The q-th percentile of `values` by nearest rank."""
    v = np.sort(np.asarray(values, np.float64))
    return float(v[max(int(np.ceil(q / 100.0 * len(v))) - 1, 0)])
