"""The port's post-training quantization against the JAX reference.

`repro_torch.core.ptq` and `repro.core.ptq` get the same numpy arrays;
int8 words must be equal (tolerance 0) and scales equal as float32 (the
same float ops on both sides: an absmax, a floor at 1e-8 and a division
by qmax).  A percentile scale interpolates linearly in both frameworks,
but torch.quantile takes the rank q*(n-1) in float64 and jnp.percentile
in float32: the scales differ by up to 3.3e-6 relative on this data, so
they are held within rtol 1e-5 (the words still equal).  Relative L2
errors are held
within rtol 1e-5 (two norms reduced in different orders).  Also: the
`QuantTensor` leaves of the port's parameter trees (`tree_map`,
`prepare_params`) and `params_from_jax` carrying the reference's
QuantTensors across.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ptq as jptq  # noqa: E402
from repro.core import smallnet as jsn  # noqa: E402
from repro_torch.core import backends as TB  # noqa: E402
from repro_torch.core import ptq  # noqa: E402
from repro_torch.core import smallnet as tsn  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402


def numpy_params(seed=0):
    rng = np.random.default_rng(seed)
    p = {"conv1": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "conv2": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "dense": {"w": rng.uniform(-0.6, 0.6, (49, 10)),
                   "b": rng.normal(0, 0.5, (10,))}}
    return {k: {n: a.astype(np.float32) for n, a in v.items()} for k, v in p.items()}


def _torch_tree(tree):
    """numpy leaves -> CPU tensors, through dicts and lists."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(tree)


def _eq_quant(got: ptq.QuantTensor, want: jptq.QuantTensor):
    assert got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert tuple(got.scale.shape) == np.asarray(want.scale).shape
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("shape", [(49, 10), (64, 49), (3, 4, 5), (7,), ()])
@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_matches_jax_words_and_scales(shape, per_channel):
    rng = np.random.default_rng(1)
    x = np.asarray(rng.normal(size=shape) * 3, np.float32)
    cfg = dict(per_channel=per_channel)
    got = ptq.quantize(torch.from_numpy(x), ptq.QuantConfig(**cfg))
    _eq_quant(got, jptq.quantize(jnp.asarray(x), jptq.QuantConfig(**cfg)))


@pytest.mark.parametrize("value", [0.0, 1e-30])
@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_of_zero_and_tiny_tensors_takes_the_floor_scale(value, per_channel):
    """An all-zero or 1e-30 tensor: the absmax is floored at 1e-8, so the
    scale is 1e-8 / 127 (7.874e-11) and every word 0, as in the reference."""
    x = np.full((6, 4), value, np.float32)
    cfg = dict(per_channel=per_channel)
    got = ptq.quantize(torch.from_numpy(x), ptq.QuantConfig(**cfg))
    _eq_quant(got, jptq.quantize(jnp.asarray(x), jptq.QuantConfig(**cfg)))
    np.testing.assert_array_equal(got.q.numpy(), np.zeros((6, 4), np.int8))
    np.testing.assert_allclose(got.scale.numpy(), np.float32(1e-8) / np.float32(127),
                               rtol=0)
    assert float(got.scale.reshape(-1)[0]) == pytest.approx(7.874e-11, rel=1e-4)
    assert tuple(got.scale.shape) == ((1, 4) if per_channel else (1, 1))


def test_quantize_rounds_half_to_even_and_clips():
    # x / scale lands on .5 exactly: both frameworks round half to even
    x = np.float32([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5])
    got = ptq.quantize(torch.from_numpy(x), ptq.QuantConfig(per_channel=False))
    want = jptq.quantize(jnp.asarray(x), jptq.QuantConfig(per_channel=False))
    _eq_quant(got, want)
    np.testing.assert_array_equal(got.q.numpy(), [127, 0, 2, 2, 0, -2, 126])
    scale = torch.tensor(0.01)
    q = ptq.quantize_activation(torch.tensor([5.0, -5.0, 0.015]), scale)
    np.testing.assert_array_equal(q.q.numpy(), [127, -128, 2])


def test_percentile_scale_and_activation_calibration_match_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_t(3, size=(40, 12)) * 2).astype(np.float32)
    for per_channel in (True, False):
        got = ptq.quantize(torch.from_numpy(x), ptq.QuantConfig(per_channel=per_channel,
                                                                 percentile=99.0))
        want = jptq.quantize(jnp.asarray(x), jptq.QuantConfig(per_channel=per_channel,
                                                              percentile=99.0))
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-5)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    s = ptq.calibrate_activation_scale(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy(),
                                  np.asarray(jptq.calibrate_activation_scale(jnp.asarray(x))))
    qa = ptq.quantize_activation(torch.from_numpy(x), s)
    _eq_quant(qa, jptq.quantize_activation(jnp.asarray(x), jnp.asarray(s.numpy())))


def test_quantize_tree_matches_jax_on_smallnet_params():
    p = numpy_params()
    got = ptq.quantize_tree(_torch_tree(p))
    want = jptq.quantize_tree({k: {n: jnp.asarray(a) for n, a in v.items()}
                               for k, v in p.items()})
    for layer in ("conv1", "conv2", "dense"):
        _eq_quant(got[layer]["w"], want[layer]["w"])
        assert torch.equal(got[layer]["b"], torch.from_numpy(p[layer]["b"]))   # float
    assert tuple(got["conv1"]["w"].scale.shape) == (2, 1, 1, 1)   # stacked-layer rule
    assert tuple(got["dense"]["w"].scale.shape) == (1, 10)        # per column
    # the same words as the reference's smallnet entry point
    want2 = jsn.quantize_params_int8(p)
    _eq_quant(tsn.quantize_params_int8(p, device="cpu")["dense"]["w"], want2["dense"]["w"])


def test_default_predicate_reads_the_path_as_jax_prints_it():
    rng = np.random.default_rng(3)
    m = lambda *s: rng.normal(size=s).astype(np.float32)       # noqa: E731
    tree = {"embed": m(6, 4), "blocks": {"w": m(2, 4, 4), "norm": m(2, 4)},
            "final_norm": m(4, 4), "pos": m(5, 4), "head": [m(4, 3), m(3)]}
    got = ptq.quantize_tree(_torch_tree(tree))
    want = jptq.quantize_tree(tree)
    for path, g, w in (("embed", got["embed"], want["embed"]),
                       ("blocks.w", got["blocks"]["w"], want["blocks"]["w"]),
                       ("blocks.norm", got["blocks"]["norm"], want["blocks"]["norm"]),
                       ("final_norm", got["final_norm"], want["final_norm"]),
                       ("pos", got["pos"], want["pos"]),
                       ("head[0]", got["head"][0], want["head"][0]),
                       ("head[1]", got["head"][1], want["head"][1])):
        assert isinstance(g, ptq.QuantTensor) == isinstance(w, jptq.QuantTensor), path
        if isinstance(g, ptq.QuantTensor):
            _eq_quant(g, w)


def test_dequantize_tree_and_quantization_error_match_jax():
    p = numpy_params(4)
    q = ptq.quantize_tree(_torch_tree(p))
    jq = jptq.quantize_tree(p)
    deq = ptq.dequantize_tree(q)
    jdeq = jptq.dequantize_tree(jq)
    for layer in p:
        for leaf in p[layer]:
            np.testing.assert_array_equal(deq[layer][leaf].numpy(),
                                          np.asarray(jdeq[layer][leaf]))
    got = ptq.quantization_error(p, q)
    want = jptq.quantization_error(p, jq)
    assert sorted(got) == sorted(want) == ["['conv1']['w']", "['conv2']['w']",
                                           "['dense']['w']"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


def test_quantized_matmul_ref_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 49)).astype(np.float32)
    w = rng.normal(size=(49, 10)).astype(np.float32)
    xq, wq = ptq.quantize(torch.from_numpy(x), ptq.QuantConfig(per_channel=False)), \
        ptq.quantize(torch.from_numpy(w))
    jx = jptq.quantize(jnp.asarray(x), jptq.QuantConfig(per_channel=False))
    jw = jptq.quantize(jnp.asarray(w))
    np.testing.assert_allclose(ptq.quantized_matmul_ref(xq, wq).numpy(),
                               np.asarray(jptq.quantized_matmul_ref(jx, jw)), rtol=1e-6)


def test_tree_map_maps_quant_tensors_field_by_field():
    q = ptq.quantize_tree(_torch_tree(numpy_params()))
    leaves = TB.tree_leaves(q)
    assert len(leaves) == 9                       # 3 x (q, scale) + 3 biases
    assert sum(t.dtype == torch.int8 for t in leaves) == 3
    whole = TB.tree_leaves(q, is_leaf=lambda x: isinstance(x, ptq.QuantTensor))
    assert sum(isinstance(t, ptq.QuantTensor) for t in whole) == 3
    doubled = TB.tree_map(lambda t: t * 2, q)
    assert isinstance(doubled["dense"]["w"], ptq.QuantTensor)
    assert torch.equal(doubled["dense"]["w"].scale, q["dense"]["w"].scale * 2)
    # prepare_params moves q and scale and keeps native params as they are
    be = TB.get_backend("int8")
    prepared = be.prepare_params(q, "cpu")
    assert be.params_native(prepared) and prepared["dense"]["w"].q.dtype == torch.int8
    assert torch.equal(prepared["dense"]["w"].q, q["dense"]["w"].q)
    assert not be.params_native(_torch_tree(numpy_params()))


def test_params_from_jax_carries_quant_tensors():
    p = numpy_params(6)
    jq = jsn.quantize_params_int8(p)
    tq = params_from_jax(jq, "cpu")
    for layer in p:
        _eq_quant(tq[layer]["w"], jq[layer]["w"])
        np.testing.assert_array_equal(tq[layer]["b"].numpy(), np.asarray(jq[layer]["b"]))
    bad = dict(jq, dense=dict(jq["dense"], w=jptq.QuantTensor(
        jnp.asarray(np.zeros((49, 10), np.int32)), jq["dense"]["w"].scale)))
    with pytest.raises(TypeError, match="int8"):
        params_from_jax(bad, "cpu")
    bad = dict(jq, dense=dict(jq["dense"], w=jptq.QuantTensor(
        jq["dense"]["w"].q, jnp.ones((49, 3), jnp.float32))))
    with pytest.raises(TypeError, match="broadcastable"):
        params_from_jax(bad, "cpu")
