"""The port's smallNet graph against the JAX reference, word for word.

The same numpy params and images go through `repro.core.smallnet` (the
`fixed` backend, and `fixed_pallas` in interpret mode) and through
`repro_torch.core.smallnet` on the CPU (`fixed`, and `fixed_cuda`, whose
wrappers take their plain versions on CPU tensors), in all five
STANDARD_CONFIGS.  Params cross over through `params_from_jax`.  Scores are
int32 words: tolerance 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import backends as JB  # noqa: E402
from repro.core import fixed_point as jfxp  # noqa: E402
from repro.core import smallnet as jsn  # noqa: E402
from repro.data import synth_mnist as j_synth  # noqa: E402
from repro_torch.core import backends as TB  # noqa: E402
from repro_torch.core import fixed_point as tfxp  # noqa: E402
from repro_torch.core import smallnet as tsn  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.data import synth_mnist as t_synth  # noqa: E402

CONFIGS = sorted(tfxp.STANDARD_CONFIGS)


def numpy_params(seed=0):
    """Float params from numpy with every leaf nonzero."""
    rng = np.random.default_rng(seed)
    p = {"conv1": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "conv2": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "dense": {"w": rng.uniform(-0.6, 0.6, (49, 10)),
                   "b": rng.normal(0, 0.5, (10,))}}
    return {k: {n: a.astype(np.float32) for n, a in v.items()} for k, v in p.items()}


@pytest.fixture(scope="module")
def data():
    images, _ = j_synth.make_dataset(6, seed=3)
    return numpy_params(), images


def _backends(name):
    return (TB.FixedBackend(cfg=tfxp.STANDARD_CONFIGS[name]),
            TB.FixedCudaBackend(cfg=tfxp.STANDARD_CONFIGS[name]),
            JB.FixedBackend(cfg=jfxp.STANDARD_CONFIGS[name]))


def _jit(fn, be):
    """The reference jitted whole (eager JAX compiles every op anew)."""
    return jax.jit(lambda p, x: fn(p, x, backend=be))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfg_name", CONFIGS)
def test_apply_matches_jax_fixed_and_fixed_pallas(data, cfg_name):
    params, images = data
    t_fixed, t_cuda, j_fixed = _backends(cfg_name)
    j_pallas = JB.FixedPallasBackend(cfg=jfxp.STANDARD_CONFIGS[cfg_name])
    want = np.asarray(_jit(jsn.apply, j_fixed)(params, jnp.asarray(images)))
    _eq(want, _jit(jsn.apply, j_pallas)(params, jnp.asarray(images)))
    tp = params_from_jax(params, "cpu")
    for be in (t_fixed, t_cuda):
        _eq(tsn.apply(tp, torch.from_numpy(images), backend=be), want)


@pytest.mark.parametrize("cfg_name", CONFIGS)
def test_trunk_head_and_predict_match_jax(data, cfg_name):
    params, images = data
    t_fixed, t_cuda, j_fixed = _backends(cfg_name)
    tp = params_from_jax(params, "cpu")
    want_feats = np.asarray(_jit(jsn.conv_trunk, j_fixed)(params, jnp.asarray(images)))
    want_scores = np.asarray(_jit(jsn.dense_head, j_fixed)(params, jnp.asarray(want_feats)))
    for be in (t_fixed, t_cuda):
        # B=1 takes the frame_trunk fast path (its interior map) and B=6 the
        # composed stages; the reference's B=1 trunk equals its batched
        # trunk row by row, so the batched words are the reference for both
        for n in (1, 6):
            feats = tsn.conv_trunk(tp, torch.from_numpy(images[:n]), backend=be)
            _eq(feats, want_feats[:n])
        scores = tsn.dense_head(tp, feats, backend=be)
        _eq(scores, want_scores)
        _eq(tsn.dense_head(tp, feats.reshape(6, -1), backend=be), want_scores)
        np.testing.assert_array_equal(tsn.predict(scores).numpy(),
                                      np.asarray(jnp.argmax(want_scores, axis=-1)))


@pytest.mark.parametrize("cfg_name", ["q16_16", "q8_8"])
def test_quantized_params_cross_over(data, cfg_name):
    params, images = data
    t_fixed, t_cuda, j_fixed = _backends(cfg_name)
    jq = jsn.quantize_params_fixed(params, j_fixed.cfg)
    tq = tsn.quantize_params_fixed(params_from_jax(params, "cpu"), t_fixed.cfg)
    for layer in jq:
        for leaf in jq[layer]:
            _eq(tq[layer][leaf], jq[layer][leaf])
    want = np.asarray(_jit(jsn.apply, j_fixed)(jq, jnp.asarray(images)))
    _eq(tsn.forward_fixed(params_from_jax(jq, "cpu"), torch.from_numpy(images),
                          t_fixed.cfg), want)
    _eq(tsn.apply(params_from_jax(jq, "cpu"), torch.from_numpy(images),
                  backend=t_cuda), want)


def test_tied_top_scores_pick_the_first_index():
    # dense biases >= 8 drive four scores past |x| >= 5, where PLAN gives
    # exactly `one`: the Max Finder must then pick the first such index (1)
    params = numpy_params(seed=4)
    params["dense"]["w"] *= np.float32(0.05)
    params["dense"]["b"] = np.asarray([0.1, 9, 0.2, 10, -6, 12, 0, 8, 1, 2], np.float32)
    images, _ = j_synth.make_dataset(16, seed=5)
    want = np.asarray(_jit(jsn.apply, JB.get_backend("fixed"))(params, jnp.asarray(images)))
    got = tsn.apply(params_from_jax(params, "cpu"), torch.from_numpy(images),
                    backend="fixed_cuda")
    _eq(got, want)
    top = want.max(axis=1, keepdims=True)
    assert ((want == top).sum(axis=1) > 1).all(), "the case must contain ties"
    np.testing.assert_array_equal(tsn.predict(got).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(want), axis=-1)))
    ties = torch.tensor([[3, 9, 9, 1], [7, 7, 7, 7], [-5, -2, -9, -2]], dtype=torch.int32)
    assert tsn.predict(ties).tolist() == [1, 0, 1]


def test_params_from_jax_accepts_torch_tensors():
    params = numpy_params(seed=2)
    want = params_from_jax(params, "cpu")
    as_tensors = {k: {n: torch.from_numpy(a).requires_grad_() for n, a in v.items()}
                  for k, v in params.items()}
    words = tsn.quantize_params_fixed(want)
    for tree, ref in ((as_tensors, want), (words, words)):
        got = params_from_jax(tree, "cpu")
        for layer in ref:
            for leaf in ref[layer]:
                assert got[layer][leaf].dtype == ref[layer][leaf].dtype
                assert torch.equal(got[layer][leaf], ref[layer][leaf].detach())
    with pytest.raises(ValueError, match="shape"):
        params_from_jax({**params, "dense": {"w": torch.zeros(10, 49), "b": torch.zeros(10)}},
                        "cpu")


def test_param_count_and_registry():
    assert tsn.param_count(params_from_jax(numpy_params(), "cpu")) == 510
    assert TB.list_backends() == ["cuda", "cuda_plan", "fixed", "fixed_cuda", "int8",
                                  "plan", "ref"]
    with pytest.raises(KeyError):
        TB.get_backend("pallas")          # the port names it "cuda"


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    params, images = numpy_params(), np.zeros((1, 28, 28, 1), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        tsn.apply(params, images)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax(params)


def test_synth_mnist_copy_matches_reference():
    a, la = j_synth.make_dataset(32, seed=9)
    b, lb = t_synth.make_dataset(32, seed=9)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
