"""BENCHMARK.json against the benchmark's contract, and the harness's
discovery of cells and metrics by their files."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from bench import harness

ROOT = harness.ROOT
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CHOSEN = ("better", "bound", "layer", "moves", "source", "unit")


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["command"] == ["python3", "bench/run.py"] and B["paths"] == ["bench"]
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    entries = B["configs"] + B["workloads"] + B["end_to_end"] + B["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for w in B["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for text in ([c["why"] for c in B["configs"] + B["workloads"]]
                 + [c["source"] for c in B["configs"]] + [m["layer"] for m in B["per_layer"]]
                 + B["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in B[kind]]
        assert len(names) == len(set(names)), kind
    assert len({m["name"] for m in B["end_to_end"] + B["per_layer"]}) == \
        len(B["end_to_end"]) + len(B["per_layer"])


def test_entry_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"] == []
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert next(m for m in B["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for w in B["workloads"]:
        mine = [m["name"] for m in harness.metrics_for(B, w["name"], "end_to_end")]
        assert "setup_s" in mine and len(mine) >= 2, w["name"]
        assert harness.metrics_for(B, w["name"], "per_layer"), w["name"]
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            reports = [x["name"] for x in harness.metrics_for(B, cell, "end_to_end")]
            assert m["moves"] in reports, (m["name"], cell)
    layers = {m["layer"] for m in B["per_layer"]}
    assert layers <= {"client", "fleet", "engine", "pipeline stages", "sweep", "aggregate",
                      "graph", "kernels", "device", "whole step"}


def test_roofline_and_mfu_names():
    for m in B["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        if "mfu" in m["name"]:
            assert m["unit"] == "%"
    mfu_moves = {m["moves"] for m in B["per_layer"] if "mfu" in m["name"]}
    roof_moves = {m["moves"] for m in B["per_layer"] if m["name"].endswith("_roofline")}
    assert roof_moves <= mfu_moves


def test_files_agree_with_the_manifest():
    assert set(harness.names("workloads", ".json")) == {w["name"] for w in B["workloads"]}
    assert set(harness.names("configs", ".json")) == {c["name"] for c in B["configs"]}
    for w in B["workloads"]:
        cell = harness.cell(w["name"])
        assert cell.workload["config"] == w["config"] and cell.workload["traffic"] == w["traffic"]
        assert harness.load_driver(cell.driver).KIND == cell.driver
    for m in B["end_to_end"] + B["per_layer"]:
        assert callable(harness.load_metric(m["name"])), m["name"]


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "workloads" / "q16-fleet-bursty.json").write_text(json.dumps(
        {"config": "smallnet-q16.16", "traffic": "fleet-bursty-q16", "limits": {}}))
    (bench / "traffic" / "mixes" / "fleet-bursty-q16.json").write_text(json.dumps(
        {"driver": "fleet", "process": "bursty", "rate_qps": 100.0}))
    (bench / "metrics" / "dummy_ms.py").write_text("def read(rec):\n    return 1.5\n")
    assert "q16-fleet-bursty" in harness.names("workloads", ".json", bench)
    assert "dummy_ms" in harness.names("metrics", ".py", bench)
    cell = harness.cell("q16-fleet-bursty", bench)
    assert cell.driver == "fleet" and cell.config["backend"] == "fixed_cuda"
    assert harness.load_metric("dummy_ms", bench)({}) == 1.5


def test_run_refuses_without_the_program(tmp_path):
    """From a directory that holds only BENCHMARK.json and bench/, a run
    exits with another code than 0 and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", "q16-fleet-tail",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_run_refuses_without_a_card(cell):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", cell, "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
