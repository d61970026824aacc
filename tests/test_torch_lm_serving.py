"""The port's LM serving path against the JAX reference, on the CPU.

`serving/engine.Engine` mirrors `repro.serving.engine.Engine` step for
step, so from the same params and prompts its greedy tokens must equal the
reference engine's (tolerance 0 on tokens; the logits agree within 1e-4,
`tests/test_torch_lm_models.py`): 5 requests over 2 slots (refills at the
shared position, over the previous request's cache), and a run whose
shared position passes `max_len` (where both write nothing).  Also the four
LM tests of `tests/test_serving.py` on the port, the rest of `core/ptq.py`
(`quantize_tree` words and scales equal on the granite smoke tree,
`quantize_axes`, `abstract_quantize_tree` against `jax.eval_shape`), the
`serve` launcher, and the default device.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import ptq as jptq  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import ptq  # noqa: E402
from repro_torch.core.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from test_torch_lm_models import (flatten, jax_tree, numpy_params,  # noqa: E402
                                   reference_abstract)


@pytest.fixture(scope="module")
def setup():
    cfg = tbase.get_config("granite-3-2b").smoke()
    params, _ = M.build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def _reqs(n, rng):
    return [Request(uid=i, prompt=rng.integers(1, 100, size=4).astype(np.int32),
                    max_new_tokens=4) for i in range(n)]


def _copy(reqs, cls=Request):
    return [cls(r.uid, r.prompt.copy(), r.max_new_tokens) for r in reqs]


# -- the reference's four LM serving tests, on the port ----------------------

def test_all_requests_complete(setup, rng):
    cfg, params = setup
    eng = Engine(cfg, params, batch_size=2, max_len=32, device="cpu")
    done = eng.submit_and_run(_reqs(5, rng))             # 5 requests > 2 slots -> refill
    assert all(r.done for r in done)
    assert all(len(r.out) == 4 for r in done)
    assert all(0 <= t < cfg.vocab for r in done for t in r.out)


def test_greedy_determinism(setup):
    cfg, params = setup
    prompts = _reqs(2, np.random.default_rng(3))
    out1 = Engine(cfg, params, batch_size=2, max_len=32, device="cpu").submit_and_run(
        _copy(prompts))
    out2 = Engine(cfg, params, batch_size=2, max_len=32, device="cpu").submit_and_run(
        _copy(prompts))
    assert [r.out for r in out1] == [r.out for r in out2]


def test_quantized_deployment_flow(setup):
    """init -> PTQ -> serve: the dequantized int8 engine gives mostly the
    same greedy tokens (the reference's bar, 0.5)."""
    cfg, params = setup
    deq = ptq.dequantize_tree(ptq.quantize_tree(params))
    reqs = _reqs(2, np.random.default_rng(5))
    base = Engine(cfg, params, batch_size=2, max_len=32, device="cpu").submit_and_run(
        _copy(reqs))
    quant = Engine(cfg, deq, batch_size=2, max_len=32, device="cpu").submit_and_run(_copy(reqs))
    agree = np.mean([a == b for r1, r2 in zip(base, quant) for a, b in zip(r1.out, r2.out)])
    assert agree >= 0.5


def test_int8_quanttensor_serving_direct(setup, rng):
    """Served straight from QuantTensor (int8) params, dequantized on use."""
    cfg, params = setup
    qp = ptq.quantize_tree(params)
    assert isinstance(qp["blocks"]["attn"]["wq"]["w"], ptq.QuantTensor)
    reqs = [Request(uid=i, prompt=rng.integers(1, 100, size=4).astype(np.int32),
                    max_new_tokens=3) for i in range(2)]
    done = Engine(cfg, qp, batch_size=2, max_len=32, device="cpu").submit_and_run(reqs)
    assert all(r.done and len(r.out) == 3 for r in done)
    assert all(0 <= t < cfg.vocab for r in done for t in r.out)


# -- the engine against the reference engine ---------------------------------

def _both_engines(npp, jp, prompts, *, batch_size, max_len, max_new):
    cfg = tbase.get_config("granite-3-2b").smoke()
    jcfg = jbase.get_config("granite-3-2b").smoke()
    mk = lambda cls: [cls(i, p.copy(), max_new) for i, p in enumerate(prompts)]
    got = Engine(cfg, lm_params_from_jax(jp, "cpu"), batch_size=batch_size,
                 max_len=max_len, device="cpu").submit_and_run(mk(Request))
    want = jengine.Engine(jcfg, jp, batch_size=batch_size,
                          max_len=max_len).submit_and_run(mk(jengine.Request))
    return [r.out for r in got], [r.out for r in want]


@pytest.mark.parametrize("case", ["refill", "past_max_len", "int8"])
def test_engine_tokens_equal_the_reference_engine(case):
    """5 requests over 2 slots with prompts of 3 to 6 tokens: slots refill
    while the other slot is mid-request, so the shared position runs ahead
    of a refilled slot's own and its tokens attend over the last request's
    cache.  past_max_len: a cache of 6 slots while the shared position
    reaches 9.  int8: both engines served from QuantTensor params."""
    cfg = tbase.get_config("granite-3-2b").smoke()
    npp = numpy_params(cfg, seed=7)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in (3, 6, 4, 5, 3)]
    jp = jax_tree(npp)
    if case == "int8":
        jp = jptq.quantize_tree(jp)
    max_len = 6 if case == "past_max_len" else 32
    got, want = _both_engines(npp, jp, prompts, batch_size=2, max_len=max_len, max_new=5)
    assert got == want
    assert all(len(o) == 5 for o in got)


# -- the rest of core/ptq.py --------------------------------------------------

def test_quantize_tree_words_and_scales_equal_on_the_granite_tree():
    npp = numpy_params(tbase.get_config("granite-3-2b").smoke(), seed=9)
    got = ptq.quantize_tree(lm_params_from_jax(npp, "cpu"))
    want = jptq.quantize_tree(jax_tree(npp))
    flat_w = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jptq.QuantTensor))[0]}
    flat_g = flatten(got)
    assert sorted(flat_g) == sorted(flat_w)
    n_quant = 0
    for k, g in flat_g.items():
        w = flat_w[k]
        assert isinstance(g, ptq.QuantTensor) == isinstance(w, jptq.QuantTensor), k
        if isinstance(g, ptq.QuantTensor):
            n_quant += 1
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q), err_msg=k)
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale), err_msg=k)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)
    assert n_quant == 8           # embed (tied) + wq, wk, wv, wo, wi, wg, wo stacks
    errs, jerrs = ptq.quantization_error(lm_params_from_jax(npp, "cpu"), got), \
        jptq.quantization_error(jax_tree(npp), want)
    assert sorted(errs) == sorted(jerrs)
    np.testing.assert_allclose([errs[k] for k in sorted(errs)],
                               [jerrs[k] for k in sorted(jerrs)], rtol=1e-5)


def _axes_tree(tree, qt):
    """A comparable form of an axes tree with QuantTensor nodes."""
    if isinstance(tree, dict):
        return {k: _axes_tree(v, qt) for k, v in tree.items()}
    if isinstance(tree, qt):
        return ("quant", tree.q, tree.scale)
    return tree


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2.5-14b", "jamba-1.5-large-398b",
                                  "whisper-tiny"])
def test_quantize_axes_equal_the_reference(arch):
    params, axes = M.abstract_params(tbase.get_config(arch))
    jparams, jaxes = reference_abstract(arch)
    got = ptq.quantize_axes(params, axes)
    want = jptq.quantize_axes(jparams, jaxes)
    assert _axes_tree(got, ptq.QuantTensor) == _axes_tree(want, jptq.QuantTensor)


@pytest.mark.parametrize("arch", ["granite-3-2b", "llama3-405b", "internvl2-2b",
                                  "whisper-tiny"])
def test_abstract_quantize_tree_matches_eval_shape(arch):
    """Full width, meta tensors only: the quantized tree's shapes and dtypes
    equal `jax.eval_shape` of the reference's quantize_tree."""
    params, _ = M.abstract_params(tbase.get_config(arch))
    got = ptq.abstract_quantize_tree(params)
    want = jptq.abstract_quantize_tree(reference_abstract(arch)[0])
    flat_w = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jptq.QuantTensor))[0]}
    flat_g = flatten(got)
    assert sorted(flat_g) == sorted(flat_w)
    for k, g in flat_g.items():
        w = flat_w[k]
        pairs = [(g.q, w.q), (g.scale, w.scale)] if isinstance(g, ptq.QuantTensor) else [(g, w)]
        assert isinstance(w, jptq.QuantTensor) == isinstance(g, ptq.QuantTensor), k
        for a, b in pairs:
            assert a.is_meta and tuple(a.shape) == b.shape, k
            assert str(a.dtype).removeprefix("torch.") == b.dtype.name, k


def test_abstract_quantize_tree_takes_meta_tensors_only_and_its_percentile_route():
    """The percentile calibration works on meta tensors too (torch.quantile
    has a meta kernel); a real tensor is refused (no memory is used)."""
    params, _ = M.abstract_params(tbase.get_config("granite-3-2b"))
    q = ptq.abstract_quantize_tree(params, ptq.QuantConfig(percentile=99.9))
    w = q["blocks"]["mlp"]["wi"]["w"]
    assert w.q.is_meta and w.scale.shape == (40, 1, 8192) and w.q.dtype == torch.int8
    with pytest.raises(ValueError):
        ptq.abstract_quantize_tree({"w": torch.zeros(4, 4)})


# -- the launcher and the device ---------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
def test_serve_launcher_on_the_cpu(int8, capsys):
    argv = ["--device", "cpu", "--requests", "5", "--batch", "2", "--max-new", "3"]
    done = serve.main(argv + (["--int8"] if int8 else []))
    out = capsys.readouterr().out
    assert len(done) == 5 and all(r.done and len(r.out) == 3 for r in done)
    assert "5 requests, 15 tokens" in out
    assert ("serving int8-quantized weights" in out) == int8


def test_default_device_is_cuda_and_raises_without_it(monkeypatch, setup):
    """Every LM entry point resolves None to "cuda" and raises without it;
    nothing falls back to the CPU."""
    cfg, params = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: Engine(cfg, params),
                 lambda: TT.init_params(cfg),
                 lambda: TT.zeros_cache(cfg, 1, 4),
                 lambda: M.synth_batch(cfg, tbase.SHAPES["train_4k"], batch_override=1),
                 lambda: lm_params_from_jax({"w": np.zeros(2, np.float32)}),
                 lambda: serve.main([])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_engine_holds_linear_weights_cast_once(setup):
    """The engine casts linear and embedding weights to the compute dtype
    once (norms stay float32): a decode step over them equals, bit for
    bit, the step that casts the float32 params on every use."""
    cfg, params = setup
    bf = dataclasses.replace(cfg, dtype=torch.bfloat16)
    eng = Engine(bf, params, batch_size=2, max_len=16, device="cpu")
    assert eng.params["blocks"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert eng.params["embed"]["w"].dtype == torch.bfloat16
    assert eng.params["blocks"]["norm1"]["w"].dtype == torch.float32
    token = torch.tensor([[5], [9]], dtype=torch.int32)
    with torch.inference_mode():
        for p in (eng.params, params):
            cache = TT.zeros_cache(bf, 2, 16, device="cpu")
            for pos in range(3):
                logits, cache = TT.decode_step(bf, p, cache, token + pos, pos)
            if p is eng.params:
                held = logits
    assert torch.equal(held, logits)
