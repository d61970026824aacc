"""The port's sharding rules and placements against the JAX reference, on
the CPU.

- `make_rules` equals the reference's dict for every arch x shape x
  {single, multi}-pod mesh;
- `specs_from_axes` of every arch's full-width axes tree (and of its int8
  serving tree, `ptq.quantize_axes`) equals the reference's PartitionSpecs
  entry for entry, under each cell's rules; the reference's axes are read
  as its `lowering.lower_cell` reads them, from its init under
  `jax.eval_shape` (its own `param_axes` raises under JAX 0.9);
- the reference's hypothesis property (the batch is never sharded
  unevenly) and its `constrain`-is-a-no-op test, on the port;
- placements: in a spawned 4-rank gloo group over a (2,2) `DeviceMesh`,
  each rank's local shard of a tensor laid out by `placements(spec)`
  equals the slice that the reference's `NamedSharding.devices_indices_map`
  gives that device on a (2,2) mesh of 4 virtual CPU devices.

`spawn_ranks` (also used by `test_torch_compression.py` and
`test_torch_checkpoint.py`) starts one process a rank with the `spawn`
context; each joins a gloo group through a `file://` store under the
test's tmp_path (no TCP ports for xdist's workers to race for), holds
torch to one thread, and writes its results under tmp_path.
"""
import json
import multiprocessing
import os
import pathlib
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hp = pytest.importorskip("hypothesis", reason="property tests need hypothesis")
st = pytest.importorskip("hypothesis.strategies")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import ptq as jptq  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import ptq as tptq  # noqa: E402
from repro_torch.core.backends import tree_leaves  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import lowering as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = tbase.ARCH_IDS
MESH_AXES = {"single_pod": ("data", "model"), "multi_pod": ("pod", "data", "model")}
JOIN_S = 120


# -- spawned gloo groups ---------------------------------------------------------

def init_rank(rank: int, world: int, store: str) -> None:
    """In a spawned worker: one torch thread, the gloo group up."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world)


def spawn_ranks(fn, world: int, tmp_path, *args) -> None:
    """Run `fn(rank, world, store, *args)` in `world` spawned processes and
    assert that every one exited 0 within JOIN_S seconds (stragglers are
    killed)."""
    ctx = multiprocessing.get_context("spawn")
    store = f"file://{tmp_path / 'store'}"
    procs = [ctx.Process(target=fn, args=(rank, world, store, *args)) for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    stragglers = [p for p in procs if p.is_alive()]
    for p in stragglers:
        p.kill()
        p.join()
    assert not stragglers, f"{len(stragglers)} ranks did not finish in {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * world


def reference_subprocess(program: str, n_devices: int, timeout: int = 120) -> dict:
    """Run a reference program on `n_devices` virtual CPU devices; its last
    stdout line is JSON."""
    prog = (f"import os\nos.environ['XLA_FLAGS'] = "
            f"'--xla_force_host_platform_device_count={n_devices}'\n") + textwrap.dedent(program)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                       timeout=timeout, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


# -- rules and specs ---------------------------------------------------------------

def _cells(arch):
    cfg = tbase.get_config(arch)
    for s in tbase.SHAPES.values():
        for mk, axes in MESH_AXES.items():
            yield cfg, s, axes


def _rules(cfg, s, axes):
    return shd.make_rules(mesh_axes=axes, global_batch=s.global_batch, n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads, decode=(s.kind == "decode"),
                          seq_len=s.seq_len, family=cfg.family)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_rules_equal_reference(arch):
    for cfg, s, axes in _cells(arch):
        want = jshd.make_rules(mesh_axes=axes, global_batch=s.global_batch,
                               n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                               decode=(s.kind == "decode"), seq_len=s.seq_len,
                               family=cfg.family)
        assert _rules(cfg, s, axes) == want, (s.name, axes)


def _reference_axes(arch):
    box = {}

    def init(key):
        params, box["axes"] = JT.init_params(jbase.get_config(arch), key)
        return params
    return jax.eval_shape(init, jax.random.key(0)), box["axes"]


def _reference_specs(specs) -> dict:
    """keystr path -> spec entries (a QuantTensor leaf: (q's, scale's))."""
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, (jax.sharding.PartitionSpec, jptq.QuantTensor)))[0]
    return {jax.tree_util.keystr(p): (tuple(v.q), tuple(v.scale))
            if isinstance(v, jptq.QuantTensor) else tuple(v) for p, v in leaves}


def _port_specs(specs, path="") -> dict:
    if isinstance(specs, dict):
        return {k: v for key, node in specs.items()
                for k, v in _port_specs(node, f"{path}['{key}']").items()}
    if isinstance(specs, tptq.QuantTensor):
        return {path: (tuple(specs.q), tuple(specs.scale))}
    assert isinstance(specs, shd.P), (path, specs)
    return {path: tuple(specs)}


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_from_axes_equal_reference(arch):
    """Every param leaf's spec, float and int8-serving trees, every cell's
    rules: the port's equals the reference's at the same path."""
    j_params, j_axes = _reference_axes(arch)
    j_qaxes = jptq.quantize_axes(j_params, j_axes)
    t_params, t_axes = TM.abstract_params(tbase.get_config(arch))
    t_qaxes = tptq.quantize_axes(t_params, t_axes)
    for cfg, s, axes in _cells(arch):
        rules = _rules(cfg, s, axes)
        for ja, ta in ((j_axes, t_axes), (j_qaxes, t_qaxes)):
            with jshd.sharding_rules(rules):
                want = _reference_specs(jshd.specs_from_axes(ja))
            with shd.sharding_rules(rules):
                got = _port_specs(shd.specs_from_axes(ta))
            assert got == want, (s.name, axes)


def test_every_spec_fits_its_leaf():
    """Each param spec has one entry a dim of its (meta) leaf."""
    for arch in ARCHS:
        cfg = tbase.get_config(arch)
        params, axes = TM.abstract_params(cfg)
        with shd.sharding_rules(_rules(cfg, tbase.SHAPES["train_4k"], MESH_AXES["multi_pod"])):
            specs = shd.specs_from_axes(axes)
        leaves = tree_leaves(params)
        spec_leaves = tree_leaves(specs, is_leaf=lambda x: isinstance(x, shd.P))
        assert len(leaves) == len(spec_leaves)
        assert all(len(sp) == t.ndim and t.is_meta for t, sp in zip(leaves, spec_leaves)), arch


def test_partition_spec_is_a_tuple_of_entries():
    spec = shd.P(("pod", "data"), None, "model")
    assert spec == (("pod", "data"), None, "model") and shd.P() == ()
    assert tuple(jax.sharding.PartitionSpec(("pod", "data"), None, "model")) == tuple(spec)
    with shd.sharding_rules({"batch": ("data",), "ffn": "model"}):
        assert shd.logical_spec("batch", None, "ffn") == ("data", None, "model")
    assert shd.logical_spec("batch", "ffn") == (None, None)       # no rules


def test_rules_divisibility_all_cells():
    """Every (arch x shape) cell produces mesh-divisible specs for the dims
    the policy shards (the reference's invariant of the dry run)."""
    for arch in ARCHS:
        for cfg, s, axes in _cells(arch):
            rules = _rules(cfg, s, axes)
            if rules["batch"] == ("pod", "data"):
                assert s.global_batch % 32 == 0
            elif rules["batch"] == ("data",):
                assert s.global_batch % 16 == 0
            if rules["heads"] == "model":
                assert cfg.n_heads % 16 == 0
            if rules["res_seq"] == "model":
                assert s.seq_len % 16 == 0
            assert cfg.d_model % 16 == 0
            assert cfg.vocab_padded % 256 == 0


@hp.given(st.integers(1, 4096), st.integers(1, 256), st.integers(1, 256))
@hp.settings(max_examples=100, deadline=None)
def test_rules_batch_never_uneven(batch, heads, kv):
    rules = shd.make_rules(mesh_axes=("data", "model"), global_batch=batch,
                           n_heads=heads, n_kv_heads=kv, seq_len=64)
    if rules["batch"] is not None:
        assert batch % 16 == 0
    if rules["heads"] == "model":
        assert heads % 16 == 0
    assert rules == jshd.make_rules(mesh_axes=("data", "model"), global_batch=batch,
                                    n_heads=heads, n_kv_heads=kv, seq_len=64)


def test_constrain_noop_without_rules():
    x = torch.ones(4, 4)
    assert shd.constrain(x, "batch", None) is x


def test_constrain_leaves_a_plain_tensor_under_rules():
    x = torch.ones(4, 4)
    with shd.sharding_rules({"batch": "data"}):
        assert shd.constrain(x, "batch", None) is x


def test_placements_follow_the_mesh_order_and_refuse_bad_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert shd.placements(shd.P(("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert shd.placements(shd.P(None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]
    assert shd.placements(shd.P(), mesh) == [Replicate()] * 3
    for bad in (shd.P(("data", "pod")), shd.P("data", "data"), shd.P("expert")):
        with pytest.raises(ValueError):
            shd.placements(bad, mesh)


def test_lowering_specs_come_from_the_same_rules():
    """`lowering.batch_pspecs` / `cache_pspecs` under a cell's rules equal
    the reference's, every family."""
    from repro.launch import lowering as JL
    for arch in ARCHS:
        for cfg, s, axes in _cells(arch):
            rules = _rules(cfg, s, axes)
            jcfg = jbase.get_config(arch)
            with jshd.sharding_rules(rules):
                want = _reference_specs(JL.batch_pspecs(jcfg, s))
            with shd.sharding_rules(rules):
                got = _port_specs(TL.batch_pspecs(cfg, s))
            assert got == want, (arch, s.name)


# -- placements on a (2,2) group against devices_indices_map -------------------------

PLACEMENT_SPECS = [(("data", "model"), None), ("data", "model"), (None, ("data", "model")),
                   ("model", None), (None,), ()]
PLACEMENT_SHAPE = (8, 12)


def _placement_worker(rank, world, store, out_dir):
    init_rank(rank, world, store)
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.launch.mesh import make_device_mesh
    try:
        mesh = make_device_mesh((2, 2), ("data", "model"))
        full = torch.arange(np.prod(PLACEMENT_SHAPE), dtype=torch.float32).reshape(PLACEMENT_SHAPE)
        locals_ = []
        for spec in PLACEMENT_SPECS:
            d = distribute_tensor(full, mesh, shd.placements(shd.P(*spec), mesh))
            locals_.append(d.to_local().tolist())
            assert torch.equal(d.full_tensor(), full)
        # constrain redistributes a DTensor under rules, onto the rules' spec
        d = distribute_tensor(full, mesh, shd.placements(shd.P(), mesh))
        with shd.sharding_rules({"batch": "data", "ffn": "model"}):
            c = shd.constrain(d, "batch", "ffn")
        assert isinstance(c, DTensor) and c.to_local().tolist() == locals_[1]
        (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(locals_))
    finally:
        dist.destroy_process_group()


_INDICES = """
    import json
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    full = np.arange(96, dtype=np.float32).reshape(8, 12)
    specs = %r
    out = []
    for dev in mesh.devices.reshape(-1):           # row-major: rank order
        row = []
        for spec in specs:
            idx = NamedSharding(mesh, P(*spec)).devices_indices_map(full.shape)[dev]
            row.append(full[idx].tolist())
        out.append(row)
    print(json.dumps(out))
"""


def test_placements_give_each_rank_the_reference_slice(tmp_path):
    want = reference_subprocess(_INDICES % (PLACEMENT_SPECS,), 4)
    spawn_ranks(_placement_worker, 4, tmp_path, str(tmp_path))
    for rank in range(4):
        got = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert got == want[rank], rank
