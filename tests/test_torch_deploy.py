"""The port's training flow and accuracy ladder against the JAX reference.

The same numpy params (every leaf nonzero) and `synth_mnist` batches go
through `repro.core.smallnet` / `repro.core.deploy` and through
`repro_torch.core.smallnet` / `repro_torch.core.deploy` on the CPU:

  * `loss_fn` and its gradients against `jax.value_and_grad`: rtol 1e-5,
    with an atol of 1e-5 times the leaf's largest gradient (a gradient
    element near zero has no relative scale);
  * 20 Adam steps (lr 2e-2, no clip, the reference's training config) in
    both packages from the same params: every param within 1e-4;
  * `evaluate_all_paths` on the same numpy params: equal, key for key;
  * the port's own `train_smallnet(n_train=6000, n_test=1200, epochs=14,
    seed=0)` reaches the reference's bar (test accuracy >= 0.80) and keeps
    every quantized path within 0.06 of float, as `tests/test_smallnet.py`
    asks of the reference;
  * both packages' `train_smallnet` at `chip_smoke.py`'s sizes from one
    init (the reference's seed-0 draw): params within 1e-3, every ladder
    accuracy within 0.002;
  * `bake` equals `apply`; `init_params` draws inside glorot's limits.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import deploy as jdeploy  # noqa: E402
from repro.core import smallnet as jsn  # noqa: E402
from repro.data import synth_mnist as j_synth  # noqa: E402
from repro.optim import AdamConfig as JAdamConfig  # noqa: E402
from repro.optim import adam_init as j_adam_init  # noqa: E402
from repro.optim import adam_update as j_adam_update  # noqa: E402
from repro_torch.core import backends as TB  # noqa: E402
from repro_torch.core import deploy  # noqa: E402
from repro_torch.core import smallnet as tsn  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.optim import AdamConfig, adam_init, adam_update  # noqa: E402

LAYERS = [(layer, leaf) for layer in ("conv1", "conv2", "dense") for leaf in ("w", "b")]


def numpy_params(seed=0):
    """Float params from numpy with every leaf nonzero."""
    rng = np.random.default_rng(seed)
    p = {"conv1": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "conv2": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "dense": {"w": rng.uniform(-0.6, 0.6, (49, 10)),
                   "b": rng.normal(0, 0.5, (10,))}}
    return {k: {n: a.astype(np.float32) for n, a in v.items()} for k, v in p.items()}


def to_numpy(tree):
    return {k: {n: np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)
                for n, a in v.items()} for k, v in tree.items()}


def port_value_and_grad(params, x, y):
    """The training step's autograd, as `train_smallnet` runs it."""
    return deploy._value_and_grad(params, torch.from_numpy(x), torch.from_numpy(y))


@pytest.fixture(scope="module")
def trained():
    return deploy.train_smallnet(n_train=6000, n_test=1200, epochs=14, seed=0, device="cpu")


# -- init --------------------------------------------------------------------------

def test_init_params_respects_glorot_and_counts_510():
    p = tsn.init_params(torch.Generator().manual_seed(3), device="cpu")
    assert tsn.param_count(p) == 510
    for layer, (fan_in, fan_out) in (("conv1", (4, 4)), ("conv2", (4, 4)), ("dense", (49, 10))):
        w, b = p[layer]["w"], p[layer]["b"]
        assert w.dtype == torch.float32 and w.device.type == "cpu"
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.5 * limit
        assert torch.equal(b, torch.zeros_like(b))
    # the dense draw covers its range: glorot's bound, not a narrower one
    w = p["dense"]["w"]
    assert float(w.min()) < -0.8 * math.sqrt(6 / 59) and float(w.max()) > 0.8 * math.sqrt(6 / 59)
    again = tsn.init_params(torch.Generator().manual_seed(3), device="cpu")
    for layer, leaf in LAYERS:
        assert torch.equal(p[layer][leaf], again[layer][leaf])
    other = tsn.init_params(torch.Generator().manual_seed(4), device="cpu")
    assert not torch.equal(p["dense"]["w"], other["dense"]["w"])
    assert tuple(p["conv1"]["w"].shape) == (2, 2, 1, 1) and tuple(w.shape) == (49, 10)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        tsn.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        deploy.evaluate_all_paths(numpy_params(), n_test=4)
    with pytest.raises(RuntimeError, match="cuda"):
        deploy.train_smallnet(n_train=64, n_test=8, epochs=1)


# -- loss and gradients ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grads_match_jax(seed):
    params = numpy_params(seed)
    x, y = j_synth.make_dataset(64, seed=3 + seed)
    j_loss, j_grads = jax.jit(jax.value_and_grad(jsn.loss_fn))(
        params, jnp.asarray(x), jnp.asarray(y))
    t_loss, t_grads = port_value_and_grad(params_from_jax(params, "cpu"), x, y)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    for layer, leaf in LAYERS:
        want = np.asarray(j_grads[layer][leaf])
        got = t_grads[layer][leaf].numpy()
        assert got.shape == want.shape and np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"{layer}.{leaf}")


def test_forward_logits_match_jax():
    params = numpy_params(2)
    x, _ = j_synth.make_dataset(16, seed=8)
    want = np.asarray(jax.jit(jsn.forward_logits)(params, jnp.asarray(x)))
    got = tsn.forward_logits(params_from_jax(params, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    # argmax over the logits is the deployed net's Max Finder
    scores = tsn.apply(params_from_jax(params, "cpu"), torch.from_numpy(x), backend="ref")
    assert torch.equal(tsn.predict(got), tsn.predict(scores))


def test_grads_on_blank_images_match_jax():
    """Zero images make every pool window a tie.  `reduce_window` max sends
    a tied window's gradient to its first value, `torch.maximum` splits it;
    here tied values come from equal inputs, so every weight's gradient is
    the same either way."""
    params = numpy_params(4)
    x = np.zeros((4, 28, 28, 1), np.float32)
    y = np.arange(4, dtype=np.int32)
    _, j_grads = jax.value_and_grad(jsn.loss_fn)(params, jnp.asarray(x), jnp.asarray(y))
    _, t_grads = port_value_and_grad(params_from_jax(params, "cpu"), x, y)
    for layer, leaf in LAYERS:
        want = np.asarray(j_grads[layer][leaf])
        np.testing.assert_allclose(t_grads[layer][leaf].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-12))


def test_twenty_adam_steps_track_jax():
    """20 steps of the reference's training step (Adam, lr 2e-2, no clip)
    from the same params over the same `synth_mnist.batches(seed=0)`."""
    params = numpy_params(5)
    xtr, ytr = j_synth.make_dataset(20 * 64, seed=0)
    jcfg = JAdamConfig(lr=2e-2, clip_norm=None)

    @jax.jit
    def j_step(p, s, xb, yb):
        loss, g = jax.value_and_grad(jsn.loss_fn)(p, xb, yb)
        p, s, _ = j_adam_update(g, s, p, jcfg)
        return p, s, loss

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = j_adam_init(jp, jcfg)
    tcfg = AdamConfig(lr=2e-2, clip_norm=None)
    tp = params_from_jax(params, "cpu")
    ts = adam_init(tp, tcfg)
    j_hist, t_hist = [], []
    for xb, yb in j_synth.batches(xtr, ytr, 64, seed=0):
        jp, js, jl = j_step(jp, js, jnp.asarray(xb), jnp.asarray(yb))
        tl, tg = port_value_and_grad(tp, xb, yb)
        tp, ts, _ = adam_update(tg, ts, tp, tcfg)
        j_hist.append(float(jl))
        t_hist.append(float(tl))
    assert len(t_hist) == 20 and int(ts.step) == int(js.step) == 20
    np.testing.assert_allclose(t_hist, j_hist, rtol=1e-4, atol=1e-4)
    for layer, leaf in LAYERS:
        np.testing.assert_allclose(tp[layer][leaf].numpy(), np.asarray(jp[layer][leaf]),
                                   rtol=0, atol=1e-4, err_msg=f"{layer}.{leaf}")
        assert not np.array_equal(tp[layer][leaf].numpy(), params[layer][leaf])


# -- training and the ladder -----------------------------------------------------

def test_training_reaches_deployable_accuracy(trained):
    # the reference's bar (tests/test_smallnet.py): >= 0.80 on the MNIST proxy
    assert trained.test_acc >= 0.80, trained.test_acc
    assert trained.train_acc >= 0.80, trained.train_acc
    assert len(trained.history) == 14 * (6000 // 64)
    assert all(math.isfinite(v) for v in trained.history)
    assert np.mean(trained.history[-50:]) < np.mean(trained.history[:50])
    assert tsn.param_count(trained.params) == 510


def test_accuracy_ladder(trained):
    accs = deploy.evaluate_all_paths(trained.params, n_test=800, device="cpu")
    assert set(accs) == {"float32", "float32_plan_sigmoid", "fixed_q16_16", "int8_ptq"}
    for name in ("fixed_q16_16", "int8_ptq", "float32_plan_sigmoid"):
        assert accs[name] >= accs["float32"] - 0.06, accs


def test_evaluate_all_paths_equals_jax_key_for_key(trained):
    """The same numpy params (the port's trained ones, so the accuracies
    are far from chance) through both packages' `evaluate_all_paths`."""
    params = to_numpy(trained.params)
    want = jdeploy.evaluate_all_paths(
        jax.tree_util.tree_map(jnp.asarray, params), n_test=1000)
    got = deploy.evaluate_all_paths(params_from_jax(params, "cpu"), n_test=1000,
                                    device="cpu")
    assert got == want
    assert min(got.values()) > 0.5


def test_training_from_one_init_gives_the_reference_ladder(monkeypatch):
    """Both packages' `train_smallnet` at `chip_smoke.py`'s sizes (8000
    images, 16 epochs, 2000 test images, seed 0) from one init, the
    reference's own seed-0 draw, then both `evaluate_all_paths`: every
    trained param within 1e-3, and every accuracy, the float32 -> PLAN step
    with them, within 0.002 (4 of 2000 images).  Where the port's own draw
    (torch.Generator) leaves a ladder step of another size, the draw made
    it, not the port.  Run with `-s` to see both ladders."""
    init = jax.tree_util.tree_map(np.asarray, jsn.init_params(jax.random.key(0)))
    monkeypatch.setattr(jsn, "init_params",
                        lambda key: jax.tree_util.tree_map(jnp.asarray, init))
    monkeypatch.setattr(tsn, "init_params",
                        lambda generator=None, *, device=None: params_from_jax(init, device))
    sizes = dict(n_train=8000, n_test=2000, epochs=16, seed=0)
    ref = jdeploy.train_smallnet(**sizes)
    port = deploy.train_smallnet(**sizes, device="cpu")
    want = jdeploy.evaluate_all_paths(ref.params, n_test=2000)
    got = deploy.evaluate_all_paths(port.params, n_test=2000, device="cpu")
    print(f"\nreference ladder {want}\nport ladder      {got}")
    for layer, leaf in LAYERS:
        np.testing.assert_allclose(port.params[layer][leaf].detach().numpy(),
                                   np.asarray(ref.params[layer][leaf]), rtol=0, atol=1e-3,
                                   err_msg=f"{layer}.{leaf}")
    assert abs(port.test_acc - ref.test_acc) <= 0.002
    assert set(got) == set(want)
    for name in want:
        assert abs(got[name] - want[name]) <= 0.002, (got, want)
    step = lambda a: a["float32"] - a["float32_plan_sigmoid"]  # noqa: E731
    assert abs(step(got) - step(want)) <= 0.002, (got, want)


@pytest.mark.parametrize("backend", ["fixed_cuda", "cuda", "cuda_plan", "int8"])
def test_bake_equals_apply(trained, backend):
    be = TB.get_backend(backend)
    native = be.prepare_params(trained.params, "cpu")
    baked = deploy.bake(lambda p, x: tsn.apply(p, x, backend=be), native, device="cpu")
    x, _ = j_synth.make_dataset(9, seed=3)
    got = baked(x)
    want = tsn.apply(trained.params, torch.from_numpy(x), backend=be)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_bake_closes_over_device_params():
    params = numpy_params(1)
    seen = []

    def apply_fn(p, x):
        seen.append(p)
        return tsn.apply(p, x, backend="fixed")
    baked = deploy.bake(apply_fn, params, device="cpu")
    x, _ = j_synth.make_dataset(2, seed=1)
    baked(x)
    baked(x)
    assert seen[0] is seen[1]                         # the same tensors every call
    assert all(isinstance(t, torch.Tensor) for t in TB.tree_leaves(seen[0]))


def test_measure_latency_is_wall_seconds_per_call():
    params = params_from_jax(numpy_params(1), "cpu")
    calls = []

    def apply_fn(p, x):
        calls.append(tuple(x.shape))
        return tsn.apply(p, x, backend="fixed")
    s = deploy.measure_latency(apply_fn, params, batch=3, iters=4, device="cpu")
    assert 0.0 < s < 5.0
    assert calls == [(3, 28, 28, 1)] * 5              # one warm-up call, then 4 timed
