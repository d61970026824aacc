"""The port's checkpoints (`checkpoint/ckpt.py`) against the reference's.

Both packages write the same format (npz + manifest with shape, dtype and
crc32; bfloat16 as its uint16 bits; keys as `jax.tree_util.keystr`), so a
checkpoint written by either restores bit for bit in the other: a float32
leaf, a bfloat16 leaf, an int32 `step`, a Trainer-like state (an
`AdamState` NamedTuple under `['opt']`); a flipped crc or data byte is
refused.  Plus the reference's six tests of `tests/test_checkpoint.py`, on
the port, and its elastic restore (`tests/test_sharding.py`): a checkpoint
saved unsharded restores as DTensors on a 4-rank gloo group
(`restore_checkpoint(shardings=)`, through `restore_latest` too).
"""
import json
import pathlib
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.optim import AdamConfig as JAdamConfig  # noqa: E402
from repro.optim import adam_init as jadam_init  # noqa: E402
from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,  # noqa: E402
                                         restore_checkpoint, save_checkpoint)
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.backends import tree_leaves  # noqa: E402
from repro_torch.optim import AdamConfig, AdamState, adam_init  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_sharding import init_rank, spawn_ranks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tests: under the suite's
    parallel workers, torch's spinning OpenMP threads beside the other
    workers' JAX and torch threads oversubscribe the cores (the suite took
    1.8x as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_state(seed=0) -> dict:
    """Float32 params as numpy; `_torch_state` / `_jax_state` build a
    Trainer-like state from them (a bfloat16 leaf, Adam's int32 step and
    moments)."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((16, 8)).astype(np.float32),
              "b": np.arange(8, dtype=np.float32),
              "nested": {"m": rng.standard_normal(4).astype(np.float32)}}
    return params


def _torch_state(npp, step=3) -> dict:
    params = {"w": torch.from_numpy(npp["w"]), "b": torch.from_numpy(npp["b"]),
              "nested": {"m": torch.from_numpy(npp["nested"]["m"]).to(torch.bfloat16)}}
    opt = adam_init(params, AdamConfig())
    opt = AdamState(torch.tensor(step, dtype=torch.int32),
                    {k: v + 0.5 if k != "nested" else {"m": v["m"] + 0.25}
                     for k, v in opt.mu.items()}, opt.nu)
    return {"params": params, "opt": opt}


def _jax_state(npp, step=3) -> dict:
    params = {"w": jnp.asarray(npp["w"]), "b": jnp.asarray(npp["b"]),
              "nested": {"m": jnp.asarray(npp["nested"]["m"]).astype(jnp.bfloat16)}}
    opt = jadam_init(params, JAdamConfig())
    mu = jax.tree_util.tree_map(lambda v: v + 0.5, opt.mu)
    mu["nested"]["m"] = opt.mu["nested"]["m"] + 0.25
    return {"params": params, "opt": opt._replace(step=jnp.asarray(step, jnp.int32), mu=mu)}


def _bits(x) -> tuple[str, bytes]:
    """(dtype name, raw bytes) of a tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        t = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return name, t.contiguous().numpy().tobytes()
    a = np.asarray(x)
    return str(a.dtype), a.tobytes()


def _jax_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_leaves(state) -> dict:
    from repro_torch.checkpoint.ckpt import _flatten
    return _flatten(state)


def test_keys_are_the_references_keystr_strings(tmp_path):
    npp = _numpy_state()
    save_checkpoint(tmp_path / "t", 1, _torch_state(npp))
    jckpt.save_checkpoint(tmp_path / "j", 1, _jax_state(npp))
    got = json.loads((tmp_path / "t" / "step_1" / "manifest.json").read_text())
    want = json.loads((tmp_path / "j" / "step_1" / "manifest.json").read_text())
    assert got == want                      # keys, shapes, dtypes and crc32s
    assert "['opt'].step" in got["arrays"] and "['opt'].mu['nested']['m']" in got["arrays"]
    assert got["arrays"]["['params']['nested']['m']"]["dtype"] == "bfloat16"


def test_reference_checkpoint_restores_bit_for_bit_in_the_port(tmp_path):
    npp = _numpy_state(1)
    jstate = _jax_state(npp, step=7)
    jckpt.save_checkpoint(tmp_path, 7, jstate)
    like = _torch_state(_numpy_state(2), step=0)     # other values, same structure
    got = restore_checkpoint(tmp_path, like)
    assert isinstance(got["opt"], AdamState)
    want = _jax_leaves(jstate)
    flat = _torch_leaves(got)
    assert sorted(flat) == sorted(want)
    for k, v in flat.items():
        assert _bits(v) == _bits(want[k]), k
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 7


def test_port_checkpoint_restores_bit_for_bit_in_the_reference(tmp_path):
    npp = _numpy_state(3)
    tstate = _torch_state(npp, step=11)
    save_checkpoint(tmp_path, 11, tstate)
    like = _jax_state(_numpy_state(4), step=0)
    got = jckpt.restore_checkpoint(tmp_path, like)
    want = _torch_leaves(tstate)
    flat = _jax_leaves(got)
    assert sorted(flat) == sorted(want)
    for k, v in flat.items():
        assert _bits(v) == _bits(want[k]), k


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("where", ["manifest crc", "data byte"])
def test_a_flipped_byte_is_refused(tmp_path, writer, where):
    """A crc32 flipped in the manifest, or a byte of an array's data flipped
    in the npz: the port refuses either (IOError, "corruption"); the
    reference refuses the first likewise and the second through the zip's
    own CRC (`zipfile.BadZipFile`)."""
    npp = _numpy_state(5)
    if writer == "port":
        d = save_checkpoint(tmp_path, 1, _torch_state(npp))
    else:
        d = jckpt.save_checkpoint(tmp_path, 1, _jax_state(npp))
    if where == "manifest crc":
        man = json.loads((d / "manifest.json").read_text())
        man["arrays"]["['params']['w']"]["crc32"] ^= 1
        (d / "manifest.json").write_text(json.dumps(man))
    else:
        shard = d / "shard_0.npz"
        raw = bytearray(shard.read_bytes())
        at = bytes(raw).find(npp["w"].tobytes()) + 13
        assert at > 13
        raw[at] ^= 0x40
        shard.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corruption"):
        restore_checkpoint(tmp_path, _torch_state(npp))
    ref_error = IOError if where == "manifest crc" else (IOError, zipfile.BadZipFile)
    with pytest.raises(ref_error):
        jckpt.restore_checkpoint(tmp_path, _jax_state(npp))


def test_restore_refuses_shardings(tmp_path):
    """A shardings tree must name the leaves of `tree_like`, no more, no
    fewer."""
    t = _torch_state(_numpy_state())
    save_checkpoint(tmp_path, 1, t)
    with pytest.raises(ValueError, match="shardings"):
        restore_checkpoint(tmp_path, t, shardings={"w": None})


# -- the elastic restore: saved unsharded, restored as DTensors on a mesh ------------

def _elastic_worker(rank, world, store, ckpt_dir, out_dir):
    init_rank(rank, world, store)
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import P, NamedSharding
    from repro_torch.launch.mesh import make_device_mesh
    try:
        like = _torch_state(_numpy_state())
        out = {}
        for shape, names, spec_w, spec_m in (((4,), ("data",), P("data", None), P("data")),
                                              ((2, 2), ("data", "model"), P("data", "model"),
                                               P("model"))):
            mesh = make_device_mesh(shape, names)
            sh = {"params": {"w": NamedSharding(mesh, spec_w), "b": None,
                             "nested": {"m": NamedSharding(mesh, spec_m)}},
                  "opt": AdamState(None, {"w": NamedSharding(mesh, spec_w), "b": None,
                                          "nested": {"m": None}}, None)}
            r = restore_checkpoint(ckpt_dir, like, shardings=sh)
            w, m = r["params"]["w"], r["params"]["nested"]["m"]
            assert isinstance(w, DTensor) and isinstance(m, DTensor)
            assert isinstance(r["opt"].mu["w"], DTensor)
            assert not isinstance(r["params"]["b"], DTensor)
            assert m.dtype == torch.bfloat16 and w.dtype == torch.float32
            out["x".join(map(str, shape))] = {
                "w": w.to_local().tolist(), "m": m.to_local().float().tolist(),
                "w_full": torch.equal(w.full_tensor(), like["params"]["w"]),
                "m_full": torch.equal(m.full_tensor(), like["params"]["nested"]["m"]),
                "mu_full": torch.equal(r["opt"].mu["w"].full_tensor(), like["opt"].mu["w"]),
                "b": torch.equal(r["params"]["b"], like["params"]["b"]),
                "step": int(r["opt"].step)}
        (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def test_elastic_restore_onto_4_ranks(tmp_path):
    """Saved unsharded by the reference ("mesh A"), restored on 4 ranks as
    DTensors over a (4,) and a (2,2) mesh ("mesh B"): each rank holds its
    slice, and the whole tensors equal the saved ones bit for bit."""
    npp = _numpy_state()
    jckpt.save_checkpoint(tmp_path / "ck", 1, _jax_state(npp))
    spawn_ranks(_elastic_worker, 4, tmp_path, str(tmp_path / "ck"), str(tmp_path))
    w = npp["w"]
    m = torch.from_numpy(npp["nested"]["m"]).to(torch.bfloat16).float().numpy()
    for rank in range(4):
        got = json.loads((tmp_path / f"rank{rank}.json").read_text())
        d, c = divmod(rank, 2)
        want = {"4": (w[4 * rank:4 * rank + 4], m[rank:rank + 1]),
                "2x2": (w[8 * d:8 * d + 8, 4 * c:4 * c + 4], m[2 * c:2 * c + 2])}
        for mesh, (ww, mm) in want.items():
            g = got[mesh]
            np.testing.assert_array_equal(np.asarray(g["w"], np.float32), ww)
            np.testing.assert_array_equal(np.asarray(g["m"], np.float32), mm)
            assert g["w_full"] and g["m_full"] and g["mu_full"] and g["b"] and g["step"] == 3


def test_restore_latest_passes_shardings_on(tmp_path):
    """`CheckpointManager.restore_latest(tree_like, shardings)` restores
    the newest step through the same path, here on a gloo world of one."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import P, NamedSharding
    from repro_torch.launch.mesh import make_device_mesh
    t = {"w": torch.arange(32, dtype=torch.float32).reshape(4, 8), "b": torch.ones(3)}
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save_async(1, {k: v * 0 for k, v in t.items()})
    mgr.wait()
    mgr.save_async(2, t)
    mgr.wait()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = make_device_mesh((1, 1), ("data", "model"))
        r, step = mgr.restore_latest(t, {"w": NamedSharding(mesh, P("data", "model")),
                                         "b": NamedSharding(mesh, P())})
        assert step == 2 and all(isinstance(v, DTensor) for v in r.values())
        assert torch.equal(r["w"].full_tensor(), t["w"]) and torch.equal(r["b"].to_local(), t["b"])
    finally:
        dist.destroy_process_group()


def test_save_async_snapshots_before_an_in_place_update(tmp_path):
    """The host copy is taken in `save_async`: an in-place update right
    after it (the donated train step) does not reach the file."""
    t = {"w": torch.ones(64, 64)}
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(1, t)
    t["w"].add_(1.0)
    mgr.wait()
    r = restore_checkpoint(tmp_path, {"w": torch.zeros(64, 64)})
    assert torch.equal(r["w"], torch.ones(64, 64))


def test_a_failed_async_write_raises_in_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(blocker)
    mgr.save_async(1, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                                   # the error is raised once


# -- the reference's tests (tests/test_checkpoint.py), on the port ------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((16, 8), generator=g),
            "b": torch.arange(8, dtype=torch.float32),
            "nested": {"m": torch.ones((4,), dtype=torch.bfloat16)}}


def test_save_restore_bitwise(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 7, t)
    assert latest_step(tmp_path) == 7
    r = restore_checkpoint(tmp_path, t)
    for a, b in zip(tree_leaves(t), tree_leaves(r)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_corruption_detected(tmp_path):
    t = _tree()
    d = save_checkpoint(tmp_path, 1, t)
    man = json.loads((d / "manifest.json").read_text())
    next(iter(man["arrays"].values()))["crc32"] ^= 0xDEADBEEF
    (d / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(IOError, match="corruption"):
        restore_checkpoint(tmp_path, t)


def test_atomic_no_partial_visible(tmp_path):
    (tmp_path / "step_9.tmp").mkdir(parents=True)
    assert latest_step(tmp_path) is None


def test_manager_retention_and_async(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _tree(s))
    mgr.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir())
    assert steps == [3, 4]
    r, step = mgr.restore_latest(_tree())
    assert step == 4
    assert torch.equal(r["w"], _tree(4)["w"])


def test_restart_bitwise_identical(tmp_path):
    """Train 4 steps straight vs 2 steps -> crash -> resume 2 more: the
    parameters are bitwise identical (deterministic data + exact checkpoint)."""
    cfg = get_config("granite-3-2b").smoke()
    base = dict(total_steps=4, seq_len=32, global_batch=4, ckpt_every=2, log_every=100)
    state_full, hist_full = Trainer(cfg, TrainerConfig(**base), device="cpu").run()
    ckdir = tmp_path / "ck"
    Trainer(cfg, TrainerConfig(**{**base, "total_steps": 2}, ckpt_dir=str(ckdir)),
            device="cpu").run()
    state_b, hist_b = Trainer(cfg, TrainerConfig(**base, ckpt_dir=str(ckdir)),
                              device="cpu").run()
    assert len(hist_b) == 2 and hist_b == hist_full[2:]
    for a, b in zip(tree_leaves(state_full), tree_leaves(state_b)):
        assert torch.equal(a, b)


def test_elastic_restore_dtype_and_shape(tmp_path):
    """Restore into leaves of another dtype (the reference's
    ShapeDtypeStructs): each leaf is cast to its `tree_like` leaf's dtype."""
    t = _tree()
    save_checkpoint(tmp_path, 1, t)
    like = {"w": torch.empty((16, 8)), "b": torch.empty(8),
            "nested": {"m": torch.empty(4)}}
    r = restore_checkpoint(tmp_path, like)
    for leaf in tree_leaves(r):
        assert leaf.dtype == torch.float32 and leaf.device.type == "cpu"
    assert torch.equal(r["nested"]["m"], torch.ones(4))
