"""The vision serving path on a mesh (`VisionEngine(mesh=)`,
`ReplicaRouter.from_backends(mesh=)`, `smallnet.apply_sharded`), on the
CPU, against the unsharded port and the JAX reference.

The port splits each step's batch across the mesh's devices where the
reference lets its compiler partition one jitted step.  A test mesh here
has eight entries, each the CPU (`make_serving_mesh(devices=["cpu"] * 8)`):
the split, the per-device params and the gather in order are the ones
the card runs, on CPU tensors.

- the vision-rules preset (`make_vision_rules`, `vision_batch_axes`,
  `vision_batch_multiple`) as the reference's test has it;
- every registered backend: `apply_sharded` over eight shards equals the
  unsharded `apply`, word for word and bit for bit (int8 included: its
  per-tensor activation scale is taken over all shards), except `ref` and
  `cuda` (on CPU tensors: `F.conv2d`, `@` and `torch.sigmoid`), whose CPU
  kernels round a batch of 2 apart from one of 16 (vectorized blocks and
  their tails): they are held within `ULPS` float32 ulps of each score
  (at most 4 measured over 30 draws and shards of 1 to 32);
- the engine tests of the reference's `tests/test_serving.py`: the mesh
  engine's words equal the unsharded engine's; batch 6 rounds up to 8; 19
  ragged requests; `mesh_devices` counts the devices that compute a shard;
- the 8-entry mesh engine on `fixed` and `int8` (whose activation scale is
  the one step that couples shards) against the reference's
  `VisionEngine(mesh=)` on 8 virtual devices, run in a subprocess: the
  same words, predictions, batch size and `mesh_devices`; int8's scores
  within `TOL` (its float convs sum in another order than XLA's, as in
  `test_torch_float_backends.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")


from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch.mesh import make_serving_mesh as j_serving_mesh  # noqa: E402
from repro.serving.vision_engine import VisionEngine as JEngine  # noqa: E402
from repro_torch.core import backends as TB  # noqa: E402
from repro_torch.core import smallnet  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_host_mesh,  # noqa: E402
                                     make_production_mesh, make_serving_mesh)
from repro_torch.serving.router import ReplicaRouter  # noqa: E402
from repro_torch.serving.vision_engine import VisionEngine  # noqa: E402
from test_torch_sharding import reference_subprocess  # noqa: E402

BACKENDS = TB.list_backends()
CPU8 = ["cpu"] * 8
SIGMOID_ON_CPU = ("ref", "cuda")         # torch.sigmoid on CPU tensors
ULPS = 8
REF_MESH_BACKENDS = ("fixed", "int8")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    params = {"conv1": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, .5, (1,))},
              "conv2": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, .5, (1,))},
              "dense": {"w": rng.uniform(-.6, .6, (49, 10)), "b": rng.normal(0, .5, (10,))}}
    params = {k: {n: a.astype(np.float32) for n, a in v.items()} for k, v in params.items()}
    images = rng.uniform(0.0, 1.0, (19, 28, 28, 1)).astype(np.float32)
    return params, images


def _assert_equal_scores(got, want, backend):
    if backend in SIGMOID_ON_CPU:
        assert np.all(np.abs(got - want) <= ULPS * np.spacing(want)), np.abs(got - want).max()
    else:
        np.testing.assert_array_equal(got, want)


def test_vision_rules_preset():
    mesh = make_serving_mesh(devices=CPU8)
    rules = shd.make_vision_rules(mesh)
    assert rules["batch"] in ("data", ("data",), ("pod", "data"))
    assert shd.vision_batch_axes(mesh) == ("data",)
    assert shd.vision_batch_multiple(mesh) == mesh.size == 8
    # everything except batch is replicated: smallNet's 510 params are tiny
    assert all(v is None for k, v in rules.items() if k != "batch")
    j = j_serving_mesh()
    assert shd.make_vision_rules(Mesh(j.axis_names, tuple(j.shape.values()),
                                      ("cpu",) * j.devices.size)) == jshd.make_vision_rules(j)


def test_vision_rules_on_other_meshes():
    pod = Mesh(("pod", "data", "model"), (2, 2, 2), tuple(torch.device("cpu") for _ in range(8)))
    assert shd.vision_batch_axes(pod) == ("pod", "data")
    assert shd.vision_batch_multiple(pod) == 4
    assert shd.make_vision_rules(pod)["batch"] == ("pod", "data")
    bare = Mesh(("x",), (3,), ("cpu",) * 3)
    assert shd.vision_batch_axes(bare) == ("x",) and shd.vision_batch_multiple(bare) == 3


def test_batch_devices_skip_the_replicas():
    """A (4,2) ("data","model") host mesh: four batch shards, on the
    devices at model index 0, in data order."""
    devs = tuple(torch.device("meta") if i % 2 else torch.device("cpu") for i in range(8))
    mesh = Mesh(("data", "model"), (4, 2), devs)
    assert shd.vision_batch_devices(mesh) == [torch.device("cpu")] * 4
    tagged = Mesh(("pod", "data", "model"), (2, 2, 2), tuple(range(8)))
    assert shd.vision_batch_devices(tagged) == [0, 2, 4, 6]
    assert make_host_mesh(2, devices=CPU8).shape == {"data": 4, "model": 2}


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_apply_identical_to_unsharded(setup, backend):
    params, images = setup
    x = torch.from_numpy(images[:16])
    be = TB.get_backend(backend)
    p = be.prepare_params(params_from_jax(params, "cpu"), "cpu")
    base = smallnet.apply(p, x, backend=be).numpy()
    shards = smallnet.apply_sharded([p] * 8, list(torch.split(x, 2)), backend=be)
    _assert_equal_scores(torch.cat(shards).numpy(), base, backend)


def test_sharded_int8_takes_the_activation_scale_over_every_shard(setup):
    """One shard's own scale would give other words: the shards' scores
    equal the unsharded batch's only with the batch's scale."""
    params, images = setup
    be = TB.get_backend("int8")
    p = be.prepare_params(params_from_jax(params, "cpu"), "cpu")
    x = torch.from_numpy(images[:16])
    base = smallnet.apply(p, x, backend=be)
    shards = list(torch.split(x, 2))
    sharded = torch.cat(smallnet.apply_sharded([p] * 8, shards, backend=be))
    alone = torch.cat([smallnet.apply(p, s, backend=be) for s in shards])
    assert torch.equal(sharded, base) and not torch.equal(alone, base)


def test_vision_engine_sharded_serves_identical_words(setup):
    """A one-entry mesh engine serves the unsharded engine's words, and the
    reference's mesh-sharded engine's."""
    params, images = setup
    tp = params_from_jax(params, "cpu")
    res_m = VisionEngine(tp, backend="fixed", batch_size=8,
                         mesh=make_serving_mesh(devices=["cpu"])).serve(list(images))
    res_u = VisionEngine(tp, backend="fixed", batch_size=8, device="cpu").serve(list(images))
    res_j = JEngine(params, backend="fixed", batch_size=8,
                    mesh=j_serving_mesh()).serve(list(images))
    for other in (res_u, res_j):
        np.testing.assert_array_equal(np.stack([r.scores for r in res_m]),
                                      np.stack([np.asarray(r.scores) for r in other]))
        assert [r.pred for r in res_m] == [r.pred for r in other]


@pytest.mark.parametrize("backend", ["fixed", "fixed_cuda", "cuda_plan", "int8", "ref"])
def test_vision_engine_on_eight_devices(setup, backend):
    """Batch 6 rounds UP to the mesh multiple 8; 19 ragged requests; the
    words equal the unsharded engine's; `mesh_devices` is 8."""
    params, images = setup
    tp = params_from_jax(params, "cpu")
    mesh = make_serving_mesh(devices=CPU8)
    assert shd.vision_batch_multiple(mesh) == 8
    eng = VisionEngine(tp, backend=backend, batch_size=6, mesh=mesh)
    assert eng.batch_size == 8
    res = eng.serve(list(images))
    base = VisionEngine(tp, backend=backend, batch_size=8, device="cpu").serve(list(images))
    assert len(res) == 19
    _assert_equal_scores(np.stack([r.scores for r in res]), np.stack([r.scores for r in base]),
                         backend)
    if backend not in SIGMOID_ON_CPU:
        assert [r.pred for r in res] == [r.pred for r in base]
    st = eng.stats()
    assert st["mesh_devices"] == 8 and st["accounted"] and st["batches"] == 3
    assert st["device"] == "cpu"


_REF_MESH_ENGINE = """
    import json
    import numpy as np
    from repro.launch.mesh import make_serving_mesh
    from repro.serving.vision_engine import VisionEngine

    z = np.load(%r)
    params = {k: {n: z[k + "_" + n] for n in ("w", "b")} for k in ("conv1", "conv2", "dense")}
    mesh = make_serving_mesh()
    out = {}
    for backend in %r:
        eng = VisionEngine(params, backend=backend, batch_size=6, mesh=mesh)
        res = eng.serve(list(z["images"]))
        out[backend] = {"batch_size": eng.batch_size,
                        "mesh_devices": eng.stats()["mesh_devices"],
                        "scores": np.stack([np.asarray(r.scores) for r in res]).tolist(),
                        "pred": [int(r.pred) for r in res]}
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_mesh_engine(setup, tmp_path_factory):
    """The reference's mesh engine on 8 virtual devices over `setup`'s
    params and 19 requests, batch 6."""
    params, images = setup
    path = tmp_path_factory.mktemp("ref_mesh") / "inputs.npz"
    np.savez(path, images=images,
             **{f"{k}_{n}": a for k, v in params.items() for n, a in v.items()})
    return reference_subprocess(_REF_MESH_ENGINE % (str(path), REF_MESH_BACKENDS), 8)


@pytest.mark.parametrize("backend", REF_MESH_BACKENDS)
def test_vision_engine_on_eight_devices_equals_the_reference_mesh_engine(
        setup, reference_mesh_engine, backend):
    params, images = setup
    eng = VisionEngine(params_from_jax(params, "cpu"), backend=backend, batch_size=6,
                       mesh=make_serving_mesh(devices=CPU8))
    res = eng.serve(list(images))
    want = reference_mesh_engine[backend]
    assert want["batch_size"] == eng.batch_size == 8
    assert want["mesh_devices"] == eng.stats()["mesh_devices"] == 8
    got = np.stack([r.scores for r in res])
    ref = np.asarray(want["scores"], dtype=got.dtype)
    if backend == "int8":
        np.testing.assert_allclose(got, ref, **TOL)
    else:
        np.testing.assert_array_equal(got, ref)
    assert [r.pred for r in res] == want["pred"]


def test_vision_engine_on_a_host_mesh_counts_the_devices_that_compute(setup):
    """A (4,2) ("data","model") mesh: four batch shards, the model axis
    replicated; `mesh_devices` is 4, the words the unsharded engine's."""
    params, images = setup
    tp = params_from_jax(params, "cpu")
    mesh = make_host_mesh(2, devices=CPU8)
    eng = VisionEngine(tp, backend="fixed", batch_size=6, mesh=mesh)
    assert eng.batch_size == 8 and mesh.size == 8
    res = eng.serve(list(images))
    base = VisionEngine(tp, backend="fixed", batch_size=8, device="cpu").serve(list(images))
    np.testing.assert_array_equal(np.stack([r.scores for r in res]),
                                  np.stack([r.scores for r in base]))
    assert eng.stats()["mesh_devices"] == 4


def test_vision_engine_sharded_threaded(setup):
    params, images = setup
    eng = VisionEngine(params_from_jax(params, "cpu"), backend="fixed", batch_size=8,
                       mesh=make_serving_mesh(4, devices=CPU8)).start()
    try:
        res = eng.serve(list(images))
    finally:
        eng.stop()
    base = VisionEngine(params_from_jax(params, "cpu"), backend="fixed", batch_size=8,
                        device="cpu").serve(list(images))
    np.testing.assert_array_equal(np.stack([r.scores for r in res]),
                                  np.stack([r.scores for r in base]))
    assert eng.stats()["mesh_devices"] == 4


def test_unsharded_engine_reports_one_mesh_device(setup):
    params, _ = setup
    st = VisionEngine(params_from_jax(params, "cpu"), backend="fixed", device="cpu").stats()
    assert st["mesh_devices"] == 1


def test_engine_refuses_a_device_beside_a_mesh_and_an_abstract_mesh(setup):
    params, _ = setup
    tp = params_from_jax(params, "cpu")
    with pytest.raises(ValueError, match="mesh or a device"):
        VisionEngine(tp, backend="fixed", mesh=make_serving_mesh(devices=CPU8), device="cpu")
    with pytest.raises(ValueError, match="abstract"):
        VisionEngine(tp, backend="fixed", mesh=make_production_mesh())


def test_serving_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_serving_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        make_host_mesh()


def test_production_mesh_is_abstract():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert single.devices is None and multi.devices is None


def test_router_from_backends_passes_the_mesh_on(setup):
    params, images = setup
    mesh = make_serving_mesh(devices=CPU8)
    router = ReplicaRouter.from_backends(params_from_jax(params, "cpu"), ["fixed", "fixed"],
                                         batch_size=6, mesh=mesh)
    assert all(e.mesh is mesh and e.batch_size == 8 for e in router.replicas)
    uids = [router.submit(img) for img in images]
    router.run()
    res = router.pop_results(uids)
    base = VisionEngine(params_from_jax(params, "cpu"), backend="fixed", batch_size=8,
                        device="cpu").serve(list(images))
    np.testing.assert_array_equal(np.stack([res[u].scores for u in uids]),
                                  np.stack([r.scores for r in base]))
    assert router.stats()["accounted"]
