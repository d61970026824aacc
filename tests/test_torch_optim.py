"""The port's Adam against the JAX reference's, on the same random trees.

`repro_torch.optim` and `repro.optim` get the same numpy params and
gradients for several steps; params, both moments, the step count and the
gradient norm must agree within rtol 1e-5 (float32 moments; bfloat16
moments within one bfloat16 ulp, 2^-7 relative, since a float32 value one
ulp either side of a rounding boundary rounds apart).  Covered: clip_norm
on and off (the clip folded into the update), weight_decay, bfloat16
moments and leaves, layer_chunked against the reference's `lax.map`,
`clip_by_global_norm` and `cosine_schedule`.  Also the reference's own
optimizer tests, on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as J  # noqa: E402
from repro_torch import optim as T  # noqa: E402


def random_tree(rng, scale=1.0):
    """A nest of dicts and a list holding leaves of rank 0 to 3."""
    return {"conv": {"w": rng.normal(0, scale, (2, 2, 1, 3)), "b": rng.normal(0, scale, (3,))},
            "stack": rng.normal(0, scale, (4, 6, 5)),
            "heads": [rng.normal(0, scale, (7,)), rng.normal(0, scale, ())]}


def _leaves_np(tree):
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):           # jax's leaf order
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            out.append(t)
    walk(tree)
    return out


def _to_torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, dtype) for v in tree]
    return torch.from_numpy(np.asarray(tree, np.float32)).to(dtype)


def _to_jax(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float32), dtype), tree)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got_tree, want_tree, rtol, what):
    got, want = _leaves_np(got_tree), jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w)), what
        np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=rtol * 1e-3,
                                   err_msg=what)


CASES = {
    "default (clip 1.0)": dict(lr=1e-2),
    "no clip": dict(lr=2e-2, clip_norm=None),
    "clip binding": dict(lr=1e-2, clip_norm=0.05),
    "weight decay": dict(lr=1e-2, weight_decay=0.1, clip_norm=None),
    "layer chunked": dict(lr=5e-2, layer_chunked=True),
    "bf16 moments": dict(lr=1e-2, moment_dtype="bf16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("leaf_dtype", ["f32", "bf16"])
def test_adam_update_matches_jax(case, leaf_dtype):
    kw = dict(CASES[case])
    bf16 = kw.pop("moment_dtype", None) == "bf16"
    t_cfg = T.AdamConfig(moment_dtype=torch.bfloat16 if bf16 else torch.float32, **kw)
    j_cfg = J.AdamConfig(moment_dtype=jnp.bfloat16 if bf16 else jnp.float32, **kw)
    t_dtype, j_dtype = ((torch.bfloat16, jnp.bfloat16) if leaf_dtype == "bf16"
                        else (torch.float32, jnp.float32))
    rng = np.random.default_rng([sorted(CASES).index(case), leaf_dtype == "bf16"])
    params = random_tree(rng)
    if leaf_dtype == "bf16":      # exact in both: start from bfloat16 values
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32), params)
    tp, jp = _to_torch(params, t_dtype), _to_jax(params, j_dtype)
    ts, js = T.adam_init(tp, t_cfg), J.adam_init(jp, j_cfg)
    # bf16 anywhere: within one bf16 ulp; float32 throughout: rtol 1e-5
    rtol = 2 ** -7 if (bf16 or leaf_dtype == "bf16") else 1e-5
    for step in range(4):
        grads = random_tree(rng, scale=0.5 + step)
        tp, ts, tm = T.adam_update(_to_torch(grads, t_dtype), ts, tp, t_cfg)
        jp, js, jm = J.adam_update(_to_jax(grads, j_dtype), js, jp, j_cfg)
        _close(tp, jp, rtol, f"{case} step {step}: params")
        _close(ts.mu, js.mu, rtol, f"{case} step {step}: mu")
        _close(ts.nu, js.nu, rtol, f"{case} step {step}: nu")
        assert int(ts.step) == int(js.step) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    for leaf in _leaves_np(tp):
        assert leaf.dtype == t_dtype
    for leaf in _leaves_np(ts.mu) + _leaves_np(ts.nu):
        assert leaf.dtype == (torch.bfloat16 if bf16 else torch.float32)


def test_explicit_lr_overrides_config():
    rng = np.random.default_rng(7)
    params, grads = random_tree(rng), random_tree(rng)
    t_cfg, j_cfg = T.AdamConfig(lr=1.0), J.AdamConfig(lr=1.0)
    tp, _, _ = T.adam_update(_to_torch(grads, torch.float32),
                             T.adam_init(_to_torch(params, torch.float32), t_cfg),
                             _to_torch(params, torch.float32), t_cfg,
                             lr=torch.tensor(3e-3))
    jp, _, _ = J.adam_update(_to_jax(grads, jnp.float32),
                             J.adam_init(_to_jax(params, jnp.float32), j_cfg),
                             _to_jax(params, jnp.float32), j_cfg, lr=jnp.float32(3e-3))
    _close(tp, jp, 1e-5, "explicit lr")


@pytest.mark.parametrize("max_norm", [0.1, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = random_tree(np.random.default_rng(3))
    t_out, t_gn = T.clip_by_global_norm(_to_torch(grads, torch.float32), max_norm)
    j_out, j_gn = J.clip_by_global_norm(_to_jax(grads, jnp.float32), max_norm)
    np.testing.assert_allclose(float(t_gn), float(j_gn), rtol=1e-6)
    _close(t_out, j_out, 1e-6, f"clip {max_norm}")


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (5, 5)])
def test_cosine_schedule_matches_jax(warmup, total):
    """rtol 1e-6, atol 1e-6 of the base lr (cos near pi/2 is near 0 and
    the two libraries' cos differ there in the last float32 bits)."""
    t_lr, j_lr = T.cosine_schedule(2e-3, warmup, total), J.cosine_schedule(2e-3, warmup, total)
    steps = [0, 1, 3, warmup, warmup + 1, (warmup + total) // 2, total - 1, total, total + 7]
    for s in steps:
        got, want = t_lr(s), j_lr(s)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=2e-3 * 1e-6,
                                   err_msg=f"step {s}")
    got = t_lr(torch.arange(total + 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_lr(jnp.arange(total + 3))),
                               rtol=1e-6, atol=2e-3 * 1e-6)


# -- the reference's own tests, on the port ----------------------------------------

def test_adam_converges_quadratic():
    cfg = T.AdamConfig(lr=0.1, clip_norm=None)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = T.adam_init(params, cfg)
    for _ in range(200):
        x = params["x"].detach().requires_grad_()
        torch.sum(torch.square(x)).backward()
        params, state, _ = T.adam_update({"x": x.grad}, state, params, cfg)
    assert float(torch.sum(torch.square(params["x"]))) < 1e-3


def test_clip_fold_matches_explicit_clip():
    params = {"w": torch.tensor([1.0, 2.0, 3.0])}
    grads = {"w": torch.tensor([10.0, -20.0, 5.0])}
    cfg = T.AdamConfig(lr=0.01, clip_norm=1.0)
    p1, _, m1 = T.adam_update(grads, T.adam_init(params, cfg), params, cfg)
    clipped, gn = T.clip_by_global_norm(grads, 1.0)
    cfg2 = T.AdamConfig(lr=0.01, clip_norm=None)
    p2, _, _ = T.adam_update(clipped, T.adam_init(params, cfg2), params, cfg2)
    np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(gn), rtol=1e-6)


def test_layer_chunked_update_matches_unchunked():
    g = torch.Generator().manual_seed(0)
    params = {"stack": torch.randn((6, 8, 4), generator=g)}
    grads = {"stack": torch.randn((6, 8, 4), generator=g)}
    c1 = T.AdamConfig(lr=0.1, layer_chunked=False)
    c2 = T.AdamConfig(lr=0.1, layer_chunked=True)
    p1, s1, _ = T.adam_update(grads, T.adam_init(params, c1), params, c1)
    p2, s2, _ = T.adam_update(grads, T.adam_init(params, c2), params, c2)
    assert torch.equal(p1["stack"], p2["stack"])
    assert torch.equal(s1.mu["stack"], s2.mu["stack"])
    assert torch.equal(s1.nu["stack"], s2.nu["stack"])


def test_moment_dtype_bf16():
    cfg = T.AdamConfig(moment_dtype=torch.bfloat16)
    params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    state = T.adam_init(params, cfg)
    assert state.mu["w"].dtype == torch.bfloat16
    g = {"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}
    p, s, _ = T.adam_update(g, state, params, cfg)
    assert p["w"].dtype == torch.bfloat16
    assert s.nu["w"].dtype == torch.bfloat16


def test_cosine_schedule_shape():
    lr = T.cosine_schedule(1e-3, warmup_steps=10, total_steps=100)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1e-3) < 1e-9
    assert float(lr(100)) < 1e-5
    vals = [float(lr(s)) for s in range(10, 101, 10)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))


def test_trees_pair_leaves_by_key_not_by_dict_order():
    params = {"a": torch.tensor([1.0, 2.0]), "b": torch.tensor([3.0])}
    grads = {"a": torch.tensor([0.5, -1.0]), "b": torch.tensor([2.0])}
    reordered = {"b": grads["b"], "a": grads["a"]}
    cfg = T.AdamConfig(lr=0.1)
    p1, s1, _ = T.adam_update(grads, T.adam_init(params, cfg), params, cfg)
    p2, s2, _ = T.adam_update(reordered, T.adam_init(params, cfg), params, cfg)
    for k in params:
        assert torch.equal(p1[k], p2[k]) and torch.equal(s1.nu[k], s2.nu[k])
