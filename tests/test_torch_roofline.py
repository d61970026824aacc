"""The port's roofline (`repro_torch.analysis.roofline`,
`repro_torch.analysis.run_roofline`) and the lowering's counts
(`launch/lowering.py`: `step_flops`, `count_flops`, `collective_bytes`)
against the JAX reference, on the CPU.

- `param_count`, `model_flops` and `analytic_bytes` equal the reference's
  exactly on every arch x shape x device count (1, 256, 512); the
  reference's own four tests (`tests/test_analysis.py`) mirrored;
- `smallnet_rooflines` row for row against the reference's h100 rows:
  FLOPs, bytes and intensity, and the peak-bound terms where the two
  databases agree (f32; the int32 peaks and the HBM rates differ, as
  `analysis/mfu.py` documents); the one-launch trunk follows the port's
  own kernel, as in `tests/test_torch_mfu.py`;
- `Roofline`'s properties on hand values, `to_dict`'s keys a superset of
  the reference's;
- the meta-device FLOP count equals `FlopCounterMode` over the same step
  on real CPU tensors (one arch of each family, each step kind), and its
  depth and micro-batch multipliers equal the whole count on every arch;
- the same counts against the reference's: `hlo_parse.analyze_hlo` over
  the reference's compiled step on one virtual CPU device, in a
  subprocess (equal for prefill and decode, train within 1 %);
- `collective_bytes` against a hand count on an abstract (2,4) mesh;
- the CLI: `--smoke`, a zero peak, filters and cached cells, the default
  path; the link bandwidth's rules.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.analysis import roofline as jroof  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro_torch.analysis import mfu  # noqa: E402
from repro_torch.analysis import roofline as troof  # noqa: E402
from repro_torch.analysis import run_roofline  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import lowering as L  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from test_torch_sharding import reference_subprocess  # noqa: E402

ARCHS = tbase.ARCH_IDS
FAMILY_ARCHS = {"dense": "granite-3-2b", "moe": "moonshot-v1-16b-a3b", "ssm": "rwkv6-3b",
                "hybrid": "jamba-1.5-large-398b", "audio": "whisper-tiny",
                "vlm": "internvl2-2b"}
SMALL = {"train": tbase.ShapeSpec("t", 16, 8, "train"),         # two micro-batches of 4
         "prefill": tbase.ShapeSpec("p", 16, 2, "prefill"),
         "decode": tbase.ShapeSpec("d", 16, 2, "decode")}
# the (2,4) test mesh's rules, as tests/test_torch_dryrun.py's
RULES = {"batch": ("data",), "res_seq": "model", "seq": None,
         "heads": "model", "kv_heads": None, "head_dim": None,
         "qkv": "model", "ffn": "model", "vocab": "model",
         "experts": "model", "expert_group": ("data",),
         "cache_batch": ("data",), "cache_head_dim": "model",
         "fsdp": ("data",), "w_model": "model", "layers": None, "embed": None}


# ---------------------------------------------------------------------------
# the closed forms against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(tbase.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_closed_forms_equal_the_reference(arch, shape):
    cfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    s, js = tbase.SHAPES[shape], jbase.SHAPES[shape]
    assert troof.param_count(cfg) == jroof.param_count(jcfg)
    assert troof.model_flops(cfg, s) == jroof.model_flops(jcfg, js)
    for devices in (1, 256, 512):
        assert troof.analytic_bytes(cfg, s, devices) == \
            jroof.analytic_bytes(jcfg, js, devices), devices


def test_param_bytes_come_from_the_dtype():
    cfg = tbase.get_config("granite-3-2b")
    bf16 = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    s = tbase.SHAPES["decode_32k"]
    n = troof.param_count(cfg)[0]
    assert troof.analytic_bytes(cfg, s, 1) - troof.analytic_bytes(bf16, s, 1) == 2 * n


def test_param_count_sane():
    """Analytic parameter counts land near the arch's nameplate."""
    cases = {"llama3-405b": (380e9, 440e9),
             "granite-3-2b": (2.0e9, 3.3e9),
             "command-r-plus-104b": (95e9, 120e9),
             "qwen2.5-14b": (12e9, 17e9),
             "rwkv6-3b": (2.5e9, 3.9e9),
             "qwen3-moe-235b-a22b": (200e9, 260e9),
             "jamba-1.5-large-398b": (330e9, 420e9)}
    for arch, (lo, hi) in cases.items():
        total, active = troof.param_count(tbase.get_config(arch))
        assert lo <= total <= hi, (arch, total)
        assert active <= total


def test_moe_active_params():
    total, active = troof.param_count(tbase.get_config("qwen3-moe-235b-a22b"))
    assert active < 0.25 * total          # 235B total vs 22B active


def test_model_flops_monotone():
    cfg = tbase.get_config("granite-3-2b")
    t = troof.model_flops(cfg, tbase.SHAPES["train_4k"])
    p = troof.model_flops(cfg, tbase.SHAPES["prefill_32k"])
    d = troof.model_flops(cfg, tbase.SHAPES["decode_32k"])
    assert t > p > d       # train(6ND, 1M tok) > prefill(2ND, 1M tok) > decode


def test_analytic_bytes_decode_dominated_by_cache():
    cfg = tbase.get_config("llama3-405b")
    b = troof.analytic_bytes(cfg, tbase.SHAPES["decode_32k"], 256)
    params_b = troof.param_count(cfg)[0] * 2 / 256
    assert b > params_b      # KV cache read exceeds weight read at B=128


# ---------------------------------------------------------------------------
# smallNet rows
# ---------------------------------------------------------------------------

def test_smallnet_rows_equal_the_reference():
    rows = troof.smallnet_rooflines()
    want = jroof.smallnet_rooflines(device_name="h100")
    port_name = {"ref": "ref", "fixed_pallas": "fixed_cuda"}
    assert set(rows) == {k.replace("fixed_pallas", "fixed_cuda") for k in want}
    for key, w in want.items():
        backend, route = key[len("smallnet-"):].split("|")
        r = rows[f"smallnet-{port_name[backend]}|{route}"]
        assert r["device"] == "h100" and r["dtype"] == w["dtype"]
        if route == "sweep_megakernel":        # the port's own kernel's account
            wl = mfu.route_workload(route, 112, 112, 144, 4)
            assert (r["flops"], r["bytes"], r["intensity"]) == \
                (wl.flops, wl.bytes_total, wl.intensity)
        else:
            assert (r["flops"], r["bytes"], r["intensity"]) == \
                (w["flops"], w["bytes"], w["intensity"]), key
            if w["dtype"] == "f32":            # the one peak both databases share
                assert (r["peak_flops"], r["compute_s"]) == \
                    (w["peak_flops"], w["compute_s"])
        assert r["mem_bw"] == 3.35e12 and r["compute_s"] > 0 and r["memory_s"] > 0


def test_smallnet_rows_refuse_an_unknown_device():
    with pytest.raises(KeyError, match="unknown device"):
        troof.smallnet_rooflines(device_name="tpu-v5e")


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------

def _record(**over):
    fields = dict(arch="a", shape="s", compute_s=2e-3, memory_s=5e-3, collective_s=1e-3,
                  hlo_flops_per_device=1e12, hlo_flops_raw=1e12, bytes_per_device=1e9,
                  collective_bytes_per_device=4e8, collective_bytes_raw=4e8,
                  collective_breakdown={"all-gather": 4e8}, model_flops_total=8e14,
                  useful_ratio=0.5, devices=4)
    fields.update(over)
    return fields


def test_roofline_properties_on_hand_values():
    r = troof.Roofline(**_record())
    assert r.dominant == "memory" and r.step_time_s == 5e-3
    assert r.roofline_fraction == pytest.approx(8e14 / 4 / (5e-3 * 989e12), rel=1e-15)
    c = troof.Roofline(**_record(collective_s=9e-3))
    assert c.dominant == "collective" and c.step_time_s == 9e-3
    assert troof.Roofline(**_record(compute_s=0.0, memory_s=0.0,
                                    collective_s=0.0)).roofline_fraction == 0.0


def test_to_dict_keeps_the_reference_keys():
    fields = _record()
    d = troof.to_dict(troof.Roofline(**fields))
    want = jroof.to_dict(jroof.Roofline(**fields))
    assert set(want) <= set(d) and set(d) - set(want) == {"device"}
    for k in ("dominant", "step_time_s"):
        assert d[k] == want[k]
    assert json.loads(json.dumps(d)) == d


def test_roofline_from_cell_terms():
    art = L.lower_cell("granite-3-2b", "decode_32k", make_production_mesh())
    r = troof.roofline_from_cell(art)
    h = mfu.DEVICE_DB["h100"]
    flops = L.count_flops(art)
    coll = L.collective_bytes(art)
    cfg, s = tbase.get_config("granite-3-2b"), tbase.SHAPES["decode_32k"]
    assert r.devices == 256 and r.device == "h100"
    assert r.hlo_flops_per_device == r.hlo_flops_raw == flops
    assert r.compute_s == flops / 989e12
    assert r.memory_s == troof.analytic_bytes(cfg, s, 256) / 3.35e12
    assert r.collective_breakdown == coll
    assert r.collective_bytes_per_device == r.collective_bytes_raw == sum(coll.values())
    assert r.collective_s == sum(coll.values()) / h.link_bw
    assert r.model_flops_total == troof.model_flops(cfg, s)
    assert r.useful_ratio == r.model_flops_total / (flops * 256)


# ---------------------------------------------------------------------------
# the link bandwidth
# ---------------------------------------------------------------------------

def test_h100_has_a_link_and_the_cpu_none():
    h = mfu.DEVICE_DB["h100"]
    assert h.link_bw == 450e9 and h.link() == 450e9
    assert "NVLink 4" in h.source and "450 GB/s a direction" in h.source
    assert mfu.DEVICE_DB["cpu"].link_bw is None
    with pytest.raises(KeyError, match="no link bandwidth"):
        mfu.DEVICE_DB["cpu"].link()


def test_a_collective_term_on_the_cpu_entry_raises():
    art = L.lower_cell("granite-3-2b", "decode_32k", make_production_mesh())
    with pytest.raises(KeyError, match="no link bandwidth"):
        troof.roofline_from_cell(art, device="cpu")


def test_the_record_divides_by_the_entry_it_names():
    """The terms and the fraction read one database entry: a device kind
    that is not an entry's name is refused, and the fraction of a record
    taken on another entry divides by that entry's bf16 peak."""
    art = L.lower_cell("granite-3-2b", "decode_32k", make_production_mesh())
    with pytest.raises(KeyError):
        troof.roofline_from_cell(art, device="NVIDIA H100 80GB HBM3")
    r = troof.Roofline(**_record(device="cpu"))
    assert r.roofline_fraction == pytest.approx(
        8e14 / 4 / (5e-3 * mfu.DEVICE_DB["cpu"].peak("bf16")), rel=1e-15)


# ---------------------------------------------------------------------------
# FLOPs: the meta count against real tensors, the multipliers against the whole count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_meta_count_equals_the_real_cpu_step(family, kind):
    """The step is traced the same way on meta and on CPU tensors, so the
    meta count is the count of the step that runs.  That the products are
    the reference's is the next test's."""
    cfg = tbase.get_config(FAMILY_ARCHS[family]).smoke()
    shape = SMALL[kind]
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = M.synth_batch(cfg, shape, device="cpu")
    with FlopCounterMode(display=False) as counter:
        L.run_step(cfg, shape, params, batch)
    real = counter.get_total_flops()
    assert real > 0 and params["embed"]["w"].device.type == "cpu"
    assert L.step_flops(cfg, shape) == real


_REFERENCE_DOTS = """
    import json
    import jax
    from repro.analysis.hlo_parse import analyze_hlo
    from repro.configs import base as cbase
    from repro.configs.base import ShapeSpec, get_config
    import repro.launch.lowering as L
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for family, arch in %r.items():
        for kind, shape in %r.items():
            cbase.SHAPES[shape[0]] = ShapeSpec(*shape)
            art = L.lower_cell(arch, shape[0], mesh, cfg_override=get_config(arch).smoke())
            out[family + "|" + kind] = analyze_hlo(art.compiled.as_text()).flops
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_dot_flops():
    """`hlo_parse.analyze_hlo(...).flops` of the reference's jitted step
    of each (family, kind) below on one virtual CPU device: its dots' FLOPs
    with the while loops' trip counts (the layer scan, the micro-batches,
    the recurrences).  It finds no convolution in these programs, so this
    is the dot count whatever JAX's version does to the conv parse."""
    shapes = {k: dataclasses.astuple(s) for k, s in SMALL.items()}
    return reference_subprocess(_REFERENCE_DOTS % (FAMILY_ARCHS, shapes), 1, timeout=600)


@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_step_flops_equal_the_reference_dot_flops(reference_dot_flops, family, kind):
    """The port's `step_flops` against the products XLA compiles for the
    reference's own step, at smoke width on one device.  A forward step
    (prefill, decode) does the same products: equal to the FLOP.  A train
    step is held to 1 %: the two autodiffs differ in a few small products,
    with or without remat (the same difference either way, so none of it
    is remat's recompute).  The port's backward runs the recurrences'
    outer products (contracted dim 1) as bmm, which the reference's HLO
    has as multiplies: rwkv6 +0.33 %, jamba +0.49 %; the reference's
    backward runs two attention products a whisper step that the port's
    does not: -0.61 %."""
    cfg = tbase.get_config(FAMILY_ARCHS[family]).smoke()
    want = reference_dot_flops[f"{family}|{kind}"]
    got = L.step_flops(cfg, SMALL[kind])
    if kind == "train":
        assert got == pytest.approx(want, rel=0.01)
    else:
        assert got == want


@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("arch", ARCHS)
def test_multiplied_count_equals_the_whole_count(arch, kind):
    """Three blocks of every stack (jamba: three superblocks; whisper: three
    encoder and three decoder blocks) and, in training, two micro-batches:
    the counted one block, two blocks and one micro-batch, multiplied,
    equal the whole step's count."""
    cfg = tbase.get_config(arch).smoke()
    deep = dataclasses.replace(
        cfg, n_layers=3 * (cfg.attn_period if cfg.family == "hybrid" else 1),
        encoder_layers=3 if cfg.encoder_layers else 0)
    shape = dataclasses.replace(SMALL[kind], seq_len=8)
    assert L.step_flops(deep, shape) == L._meta_flops(deep, shape, False) > 0


def test_count_flops_is_a_devices_share_and_cell_report_carries_it():
    mesh = make_production_mesh()
    art = L.lower_cell("granite-3-2b", "decode_32k", mesh)
    total = L.step_flops(tbase.get_config("granite-3-2b"), tbase.SHAPES["decode_32k"])
    assert L.count_flops(art) == total / 256
    assert "cost" not in L.cell_report(art)
    rep = L.cell_report(art, count=True)
    assert rep["cost"] == {"flops": total / 256}
    assert rep["memory"] == L.cell_report(art)["memory"]
    # int8 serving dequantizes on use: the same products
    q = L.lower_cell("granite-3-2b", "decode_32k", mesh, int8_serving=True)
    assert L.count_flops(q) == L.count_flops(art)


def test_granite_full_width_counts():
    """A regression guard, not a check against the reference: granite-3-2b
    at full width, counted on the meta device in seconds, equals the
    port's own whole count when it was written (`FlopCounterMode` over the
    whole step, 12-18 s a cell).  The reference's products are held
    against the port's at smoke width by
    `test_step_flops_equal_the_reference_dot_flops`."""
    cfg = tbase.get_config("granite-3-2b")
    assert L.step_flops(cfg, tbase.SHAPES["prefill_32k"]) == pytest.approx(1.636e16, rel=1e-3)
    assert L.step_flops(cfg, tbase.SHAPES["train_4k"]) == pytest.approx(2.527e16, rel=1e-3)


# ---------------------------------------------------------------------------
# collective bytes: a hand count
# ---------------------------------------------------------------------------

def _test_cell(monkeypatch, kind):
    monkeypatch.setattr(L, "rules_for", lambda cfg, shape, mesh: RULES)
    cfg = tbase.get_config("granite-3-2b").smoke()     # float32, tied, 2 layers
    return L.lower_cell("granite-3-2b", SMALL[kind], Mesh(("data", "model"), (2, 4)),
                        cfg_override=cfg)


def test_collective_bytes_hand_count(monkeypatch):
    """granite's smoke config (d 64, 4 heads of 16, 2 KV heads, d_ff 128,
    vocab 512 tied, 2 layers, float32 weights and activations) on a
    ("data" 2, "model" 4) mesh.  Each weight as a device holds it once
    gathered over "data" (its "model" split kept), 4-byte words:
    embed 512/4 x 64; wq 2 x 64 x 64/4, wk and wv 2 x 64 x 32/4, wo
    2 x 64/4 x 64; wi, wg 2 x 64 x 128/4, the MLP's wo 2 x 128/4 x 64."""
    held = 4 * (128 * 64 + 2 * 64 * 16 + 2 * 2 * 64 * 8 + 2 * 16 * 64
                + 2 * 2 * 64 * 32 + 2 * 32 * 64)
    ring_gather = held * (2 - 1) / 2
    ring_reduce = lambda b: 2 * b * (4 - 1) / 4       # noqa: E731  all-reduce over "model"

    # prefill, 2 sequences of 16 over 2 data shards: 16 tokens a device;
    # the lookup (vocab split) and the two out-projections a layer (input
    # dim split) all-reduce a (16, 64) output
    got = L.collective_bytes(_test_cell(monkeypatch, "prefill"))
    assert got == {"all-gather": ring_gather, "reduce-scatter": 0.0,
                   "all-reduce": ring_reduce(16 * 64 * 4) * (1 + 2 * 2)}

    # train, 8 sequences in 2 micro-batches of 4: 32 tokens a device each.
    # Per micro-batch: weights gathered twice, gradients reduce-scattered
    # once; the norms' gradients (2 x 64 twice, 64) all-reduced over
    # "data"; forward: the lookup once, the two out-projections twice
    # under remat; backward: the input gradients of wq, wk, wv, wi, wg
    # (output dim split) a layer and the tied logits' one
    act = 32 * 64 * 4
    norms = 4 * (2 * 64 + 2 * 64 + 64)
    per_micro = (ring_reduce(act) * (1 + 2 * 2 * 2 + 5 * 2 + 1)
                 + 2 * norms * (2 - 1) / 2)
    got = L.collective_bytes(_test_cell(monkeypatch, "train"))
    assert got == {"all-gather": 2 * 2 * ring_gather, "reduce-scatter": 2 * ring_gather,
                   "all-reduce": 2 * per_micro}


def test_collective_bytes_of_one_device_are_zero(monkeypatch):
    monkeypatch.setattr(L, "rules_for", lambda cfg, shape, mesh: RULES)
    cfg = tbase.get_config("granite-3-2b").smoke()
    art = L.lower_cell("granite-3-2b", SMALL["train"], Mesh(("data", "model"), (1, 1)),
                       cfg_override=cfg)
    assert L.collective_bytes(art) == {"all-gather": 0.0, "reduce-scatter": 0.0,
                                       "all-reduce": 0.0}


def test_int8_serving_gathers_its_words():
    """int8 words (and their float32 scales) in place of float32 weights:
    the all-gathers move about a quarter; the activations' all-reduces are
    the same."""
    mesh = make_production_mesh()
    f = L.collective_bytes(L.lower_cell("granite-3-2b", "decode_32k", mesh))
    q = L.collective_bytes(L.lower_cell("granite-3-2b", "decode_32k", mesh,
                                        int8_serving=True))
    assert f["all-gather"] / 4 < q["all-gather"] < f["all-gather"] / 3.9
    assert q["all-reduce"] == f["all-reduce"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_collective_bytes_of_every_production_cell_are_finite(arch):
    mesh = make_production_mesh()
    for a, shape in tbase.cells():
        if a != arch:
            continue
        got = L.collective_bytes(L.lower_cell(arch, shape, mesh))
        assert set(got) == {"all-gather", "reduce-scatter", "all-reduce"}
        assert all(v >= 0 for v in got.values()) and got["all-gather"] > 0, (shape, got)
        assert (got["reduce-scatter"] > 0) == (shape == "train_4k")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_smoke_exits_zero_and_writes_its_rows(tmp_path, capsys):
    out = tmp_path / "r" / "results.json"
    assert run_roofline.main(["--smoke", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert set(res) == set(troof.smallnet_rooflines())
    assert all(r["device"] == "h100" for r in res.values())
    assert "smoke OK" in capsys.readouterr().out


def test_a_zero_peak_fails_the_smoke(tmp_path, monkeypatch, capsys):
    h = mfu.DEVICE_DB["h100"]
    monkeypatch.setitem(mfu.DEVICE_DB, "zero", dataclasses.replace(
        h, name="zero", kinds=("zero",), peak_flops={k: 0.0 for k in h.peak_flops}))
    assert run_roofline.main(["--smoke", "--device", "zero",
                              "--out", str(tmp_path / "r.json")]) == 1
    assert "smoke FAIL" in capsys.readouterr().out


def test_flop_crosscheck_passes_and_catches_drift(monkeypatch):
    assert run_roofline._flop_crosscheck() == []
    assert run_roofline._flop_crosscheck(device="cpu") == []
    real = mfu.trunk_workload
    monkeypatch.setattr(mfu, "trunk_workload",
                        lambda H, W, route="trunk", word_bytes=4: dataclasses.replace(
                            real(H, W, route, word_bytes), flops=2 * real(H, W, route).flops))
    assert "drift" in run_roofline._flop_crosscheck()[0]


def test_cli_filters_and_skips_cells_already_done(tmp_path, capsys):
    out = tmp_path / "r.json"
    argv = ["--arch", "granite-3-2b", "--shape", "decode_32k", "--out", str(out)]
    assert run_roofline.main(argv) == 0
    res = json.loads(out.read_text())
    cells = [k for k in res if not k.startswith("smallnet-")]
    assert cells == ["granite-3-2b|decode_32k"]
    d = res["granite-3-2b|decode_32k"]
    assert d["devices"] == 256 and d["device"] == "h100" and d["count_seconds"] >= 0
    assert "dominant=" in capsys.readouterr().out
    assert run_roofline.main(argv) == 0                 # cached: nothing counted again
    assert "dominant=" not in capsys.readouterr().out
    assert run_roofline.main(argv + ["--force"]) == 0
    assert "dominant=" in capsys.readouterr().out


def test_cli_records_a_failed_cell_and_exits_one(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no count")
    monkeypatch.setattr(L, "count_flops", broken)
    out = tmp_path / "r.json"
    assert run_roofline.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                              "--out", str(out)]) == 1
    assert json.loads(out.read_text())["whisper-tiny|decode_32k"] == \
        {"error": "RuntimeError: no count"}


def test_default_output_is_under_build():
    root = run_roofline.RESULTS.parents[2]
    assert run_roofline.RESULTS.relative_to(root).parts == ("build", "roofline", "results.json")
    assert (root / "src" / "repro_torch").is_dir()
