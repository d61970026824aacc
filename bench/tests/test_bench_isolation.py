"""Nothing under bench/ imports JAX, Flax or the JAX package (`repro`),
judged on whole top-level names, so the port `repro_torch` is allowed;
bench/reference/ imports nothing of the program either."""
import ast
import json
import subprocess
import sys

from bench import harness

BENCH = harness.BENCH


def _modules():
    out = []
    for p in sorted(BENCH.rglob("*.py")):
        rel = p.relative_to(BENCH.parent)
        if "tests" in rel.parts or p.parent.name == "metrics":
            continue
        out.append(".".join(rel.with_suffix("").parts).removesuffix(".__init__"))
    return out


def _loaded_after(code: str) -> set[str]:
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted(sys.modules)))"],
                       cwd=BENCH.parent, capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": f"{BENCH.parent / 'src'}:{BENCH.parent}",
                            "PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.splitlines()[-1]))


def test_forbidden_names_compare_whole_top_levels():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.core", "jax", "jaxlib.xla", "flax.linen"]) == \
        ["flax.linen", "jax", "jaxlib.xla", "repro.core"]


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert "bench.run" in mods and "bench.traffic.fleet" in mods
    code = "import importlib\n" + "".join(f"importlib.import_module({m!r})\n" for m in mods)
    code += ("from bench import harness\n"
             "[harness.load_metric(n) for n in harness.names('metrics', '.py')]\n")
    loaded = _loaded_after(code)
    assert harness.forbidden_modules(loaded) == []


def test_the_program_loads_no_jax():
    loaded = _loaded_after("import repro_torch.serving.router, repro_torch.streaming.pipeline, "
                           "repro_torch.streaming.fcn_sweep")
    assert "repro_torch" in loaded and harness.forbidden_modules(loaded) == []


def test_the_reference_imports_nothing_of_the_program():
    refs = sorted((BENCH / "reference").glob("*.py"))
    for p in refs:
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in ("numpy", "__future__", "dataclasses", "bench"), (p, n)
                if n.startswith("bench"):
                    assert n.startswith("bench.reference"), (p, n)
    loaded = _loaded_after("import bench.reference.smallnet, bench.reference.sweep")
    assert not any(m.split(".")[0] in ("repro_torch", "torch") for m in loaded)
    assert harness.forbidden_modules(loaded) == []
