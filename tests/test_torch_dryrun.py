"""The port's meta-device dry run (`launch/lowering.py`, `launch/dryrun.py`)
against the JAX reference, on the CPU.

- per-device argument, output and alias bytes of the reference's own
  (2,4) dry-run test cells (`tests/test_sharding.py`: the smoke train cell
  and the int8 decode cell; here also a prefill cell) equal the
  reference's compiled `memory_analysis()`, run in a subprocess with 8
  virtual CPU devices;
- the full sweep (10 archs x 4 shapes, long_500k only where the arch
  supports long context, on both production meshes) lowers every cell on
  the meta device with no failure and allocates nothing;
- the CLI's filters, its idempotent JSON cache and its failure count.
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.backends import tree_leaves  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import lowering as L  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from test_torch_sharding import reference_subprocess  # noqa: E402

RULES = {"batch": ("data",), "res_seq": "model", "seq": None,
         "heads": "model", "kv_heads": None, "head_dim": None,
         "qkv": "model", "ffn": "model", "vocab": "model",
         "experts": "model", "expert_group": ("data",),
         "cache_batch": ("data",), "cache_head_dim": "model",
         "fsdp": ("data",), "w_model": "model", "layers": None, "embed": None}
DECODE_RULES = dict(RULES, res_seq=None, kv_seq=None, cache_seq="model")
CELLS = {  # name: (shape, rules, config overrides, int8_serving)
    "t": (tbase.ShapeSpec("t", 64, 8, "train"), RULES, {"d_model": 64, "micro_batch": 4}, False),
    "d": (tbase.ShapeSpec("d", 64, 8, "decode"), DECODE_RULES, {"d_model": 64}, True),
    "p": (tbase.ShapeSpec("p", 64, 8, "prefill"), RULES, {"d_model": 64}, False),
}
KEYS = ("argument_bytes_per_device", "output_bytes_per_device", "alias_bytes_per_device")

_REFERENCE = """
    import dataclasses, json
    import jax
    from repro.configs import base as cbase
    from repro.configs.base import ShapeSpec, get_config
    import repro.launch.lowering as L
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for name, (shape, rules, over, int8) in %r.items():
        cbase.SHAPES[name] = ShapeSpec(*shape)
        cfg = dataclasses.replace(get_config("granite-3-2b").smoke(), **over)
        L.rules_for = lambda cfg, shape, mesh, rules=rules: rules
        art = L.lower_cell("granite-3-2b", name, mesh, cfg_override=cfg, int8_serving=int8)
        ma = art.compiled.memory_analysis()
        out[name] = {"argument_bytes_per_device": int(ma.argument_size_in_bytes),
                     "output_bytes_per_device": int(ma.output_size_in_bytes),
                     "alias_bytes_per_device": int(ma.alias_size_in_bytes)}
    print(json.dumps(out))
"""


def test_bytes_per_device_equal_the_reference_memory_analysis(monkeypatch):
    cells = {k: (dataclasses.astuple(s), r, o, i) for k, (s, r, o, i) in CELLS.items()}
    want = reference_subprocess(_REFERENCE % (cells,), 8)
    mesh = Mesh(("data", "model"), (2, 4))
    for name, (shape, rules, over, int8) in CELLS.items():
        monkeypatch.setitem(tbase.SHAPES, name, shape)
        monkeypatch.setattr(L, "rules_for", lambda cfg, shape, mesh, rules=rules: rules)
        cfg = dataclasses.replace(tbase.get_config("granite-3-2b").smoke(), **over)
        rep = L.cell_report(L.lower_cell("granite-3-2b", name, mesh, cfg_override=cfg,
                                         int8_serving=int8))
        assert rep["ok"] and rep["devices"] == 8
        assert rep["memory"] == want[name], name


def test_full_sweep_lowers_every_cell_on_the_meta_device(tmp_path):
    out = tmp_path / "results.json"
    env = dict(os.environ)
    assert dryrun.main(["--out", str(out)]) == 0
    assert dict(os.environ) == env                       # sets no environment variable
    res = json.loads(out.read_text())
    want = len(tbase.cells()) * 2
    assert len(res) == want == 64 and all(r["ok"] for r in res.values())
    assert not any("long_500k" in k and tbase.get_config(k.split("|")[0]).family
                   not in ("ssm", "hybrid") for k in res)
    rep = res["llama3-405b|train_4k|single_pod"]
    assert rep["devices"] == 256 and set(rep["memory"]) == set(KEYS)
    assert res["llama3-405b|train_4k|multi_pod"]["devices"] == 512
    # the multi-pod mesh spreads the ZeRO-3 dim over the pod axis too
    assert (res["llama3-405b|train_4k|multi_pod"]["memory"]["argument_bytes_per_device"]
            < rep["memory"]["argument_bytes_per_device"])


@pytest.mark.parametrize("mesh_kind", dryrun.MESH_KINDS)
def test_every_lowered_leaf_is_meta(mesh_kind):
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi_pod")
    for arch, shape in tbase.cells():
        art = L.lower_cell(arch, shape, mesh)
        leaves = [t for tree, _ in art.args + art.outs for t in tree_leaves(tree)]
        assert leaves and all(t.is_meta for t in leaves), (arch, shape)


def test_cli_filters_and_skips_cells_already_ok(tmp_path, capsys):
    out = tmp_path / "r.json"
    argv = ["--arch", "granite-3-2b", "--shape", "decode_32k", "--mesh", "multi_pod",
            "--out", str(out)]
    assert dryrun.main(argv) == 0
    assert list(json.loads(out.read_text())) == ["granite-3-2b|decode_32k|multi_pod"]
    assert "OK" in capsys.readouterr().out
    assert dryrun.main(argv) == 0                        # cached: nothing lowered again
    assert "OK" not in capsys.readouterr().out
    assert dryrun.main(argv + ["--force"]) == 0
    assert "OK" in capsys.readouterr().out


def test_a_spec_that_does_not_fit_fails_the_cell(tmp_path, monkeypatch):
    """Rules naming the "pod" axis on the single-pod mesh: the cell fails,
    is recorded, and the sweep exits 1."""
    monkeypatch.setattr(L, "rules_for", lambda cfg, shape, mesh: dict(RULES, fsdp=("pod",)))
    out = tmp_path / "r.json"
    assert dryrun.main(["--arch", "granite-3-2b", "--shape", "train_4k", "--mesh",
                        "single_pod", "--out", str(out)]) == 1
    rep = json.loads(out.read_text())["granite-3-2b|train_4k|single_pod"]
    assert not rep["ok"] and "pod" in rep["error"]


def test_report_keeps_only_what_shapes_decide():
    rep = L.cell_report(L.lower_cell("whisper-tiny", "decode_32k", make_production_mesh()))
    assert set(rep) == {"arch", "shape", "mesh", "devices", "ok", "memory"}
    assert set(rep["memory"]) == set(KEYS)


def test_uneven_dims_are_padded_to_the_ceiling():
    t = torch.empty((6, 10), dtype=torch.float32, device="meta")
    mesh = {"data": 4, "model": 16}
    assert L.shard_bytes(t, ("data", None), mesh) == 2 * 10 * 4
    assert L.shard_bytes(t, (("data", "model"),), mesh) == 1 * 10 * 4
    assert L.shard_bytes(t, (None, "model"), mesh) == 6 * 1 * 4
    for bad in (("data", "data"), ("pod",), (None, None, None)):
        with pytest.raises(ValueError):
            L.shard_bytes(t, bad, mesh)


def test_default_results_path_is_under_build():
    assert dryrun.RESULTS.parts[-3:] == ("build", "dryrun", "results.json")
