"""The port's LM families against the JAX reference, on the CPU.

For all ten archs at `.smoke()` width (float32), both packages get the
same numpy params (drawn into the reference's tree shapes, every leaf
nonzero) and the same numpy tokens; `forward`, `loss_fn` (`ce`, `aux`),
`prefill` (last logits and every cache leaf) and `decode_step` (logits
and the updated cache) must agree within rtol = atol = 1e-4 (float32
einsums reduced in different orders over a few layers).  Also: the
reference's two decode-vs-forward properties on the port alone (granite
2e-3, rwkv6 3e-3, as `tests/test_models_smoke.py`); `abstract_params` of
the ten full configs against `jax.eval_shape` of the reference's init
(shapes and dtypes, no memory); `param_axes` against the axes the
reference's init builds under that trace (and granite's concrete smoke
axes: they do not depend on width); `input_specs`;
`lm_params_from_jax` on float32, bfloat16 and QuantTensor trees.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import ptq as jptq  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import ptq as tptq  # noqa: E402
from repro_torch.core.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

TOL = 1e-4
ARCHS = tbase.ARCH_IDS
B, S = 2, 16


def numpy_params(cfg, seed: int = 0) -> dict:
    """Float params for `cfg` in the reference's tree (the port's abstract
    tree, whose shapes equal the reference's): normal draws scaled by
    1/sqrt(the contracted dim), norm scales 1 + 0.1 N, every leaf nonzero."""
    rng = np.random.default_rng(seed)
    abstract, _ = TM.abstract_params(cfg)

    def draw(path, t):
        shape = tuple(t.shape)
        if "norm" in path and path.endswith("['w']"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 2:
            a = rng.standard_normal(shape) / np.sqrt(shape[-2])
        else:
            a = 0.1 * rng.standard_normal(shape)
        return a.astype(np.float32)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}['{k}']") for k, v in node.items()}
        return draw(path, node)
    return walk(abstract, "")


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def numpy_batch(cfg, seed: int = 1, batch: int = B, seq: int = S) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = (0.1 * rng.standard_normal(
            (batch, cfg.encoder_frames, cfg.d_model))).astype(np.float32)
    if cfg.family == "vlm":
        out["vision"] = (0.1 * rng.standard_normal(
            (batch, cfg.vision_tokens, cfg.vit_dim))).astype(np.float32)
    return out


def close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(port cfg, reference cfg, numpy params, numpy batch)."""
    cfg = tbase.get_config(arch).smoke()
    return cfg, jbase.get_config(arch).smoke(), numpy_params(cfg), numpy_batch(cfg)


def torch_batch(nb, keys):
    return {k: torch.from_numpy(nb[k]) for k in keys if k in nb}


INPUTS = ("tokens", "frames", "vision")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    cfg, jcfg, npp, nb = setup(arch)
    tp = lm_params_from_jax(npp, "cpu")
    with torch.inference_mode():
        logits, aux = TT.forward(cfg, tp, torch_batch(nb, INPUTS))
        loss, metrics = TT.loss_fn(cfg, tp, torch_batch(nb, INPUTS + ("labels",)))
    jl, jaux = jax.jit(functools.partial(JT.forward, jcfg))(jax_tree(npp), jax_tree(
        {k: nb[k] for k in INPUTS if k in nb}))
    jloss, jmet = jax.jit(functools.partial(JT.loss_fn, jcfg))(jax_tree(npp), jax_tree(nb))
    assert logits.shape == (B, S, cfg.vocab_padded) and logits.dtype == torch.float32
    close(logits, jl, what=f"{arch} logits")
    close(aux, jaux, what=f"{arch} aux")
    close(loss, jloss, what=f"{arch} loss")
    close(metrics["ce"], jmet["ce"], what=f"{arch} ce")
    close(metrics["aux"], jmet["aux"], what=f"{arch} aux metric")
    if cfg.family == "moe":
        assert float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_reference(arch):
    """Prefill's last logits and every cache leaf, then one decode step at
    pos = S - 1 over the cache grown to S + 4 slots (its K/V written at S -
    1): logits and every updated cache leaf."""
    cfg, jcfg, npp, nb = setup(arch)
    tp = lm_params_from_jax(npp, "cpu")
    with torch.inference_mode():
        logits, cache = TT.prefill(cfg, tp, torch_batch(nb, INPUTS))
    jlogits, jcache = jax.jit(functools.partial(JT.prefill, jcfg))(
        jax_tree(npp), jax_tree({k: nb[k] for k in INPUTS if k in nb}))
    close(logits, jlogits, what=f"{arch} prefill logits")
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape, (arch, k)
        assert str(cache[k].dtype).removeprefix("torch.") == jcache[k].dtype.name, (arch, k)
        close(cache[k], jcache[k], what=f"{arch} prefill cache {k}")

    # one decode step on a cache grown past the prompt
    def grow(c, xp):
        out = {}
        for k, v in c.items():
            if k in ("k", "v"):
                pad = [(0, 0)] * v.ndim
                pad[2] = (0, 4)
                out[k] = xp.pad(v, pad) if xp is jnp else torch.nn.functional.pad(
                    v, (0, 0, 0, 0, 0, 4))
            else:
                out[k] = v
        return out
    token = np.asarray(nb["tokens"][:, -1:])
    with torch.inference_mode():
        tlog, tcache = TT.decode_step(cfg, tp, grow(cache, torch), torch.from_numpy(token),
                                      S - 1)
    jlog, jc2 = jax.jit(functools.partial(JT.decode_step, jcfg))(
        jax_tree(npp), grow(jcache, jnp), jnp.asarray(token), jnp.asarray(S - 1, jnp.int32))
    close(tlog, jlog, what=f"{arch} decode logits")
    for k in tcache:
        assert tuple(tcache[k].shape) == jc2[k].shape, (arch, k)
        close(tcache[k], jc2[k], what=f"{arch} decode cache {k}")


@pytest.mark.parametrize("arch,T,tol", [("granite-3-2b", 16, 2e-3), ("rwkv6-3b", 8, 3e-3)])
def test_decode_matches_forward(arch, T, tol):
    """The reference's decode-vs-forward property on the port: token-by-token
    decode reproduces the parallel forward's logits (granite with q_chunk 8,
    so the forward runs two query chunks)."""
    cfg = dataclasses.replace(tbase.get_config(arch).smoke(), q_chunk=8)
    params, _ = TT.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, T), generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        full, _ = TT.forward(cfg, params, {"tokens": toks})
        cache = TT.zeros_cache(cfg, 1, T, device="cpu")
        for t in range(T):
            lg, cache = TT.decode_step(cfg, params, cache, toks[:, t:t + 1], t)
            close(lg[0], full[0, t], tol, f"{arch} step {t}")


@functools.lru_cache(maxsize=None)
def reference_abstract(arch):
    """The reference's full-width init under `jax.eval_shape`: its params
    as ShapeDtypeStructs, and its axes tree, which the init builds in
    Python as it traces (its own `abstract_params` raises under JAX 0.9)."""
    box = {}

    def init(key):
        params, box["axes"] = JT.init_params(jbase.get_config(arch), key)
        return params
    params = jax.eval_shape(init, jax.random.key(0))
    return params, box["axes"]


def flatten(tree, path="") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, node in tree.items()
                for k, v in flatten(node, f"{path}['{key}']").items()}
    return {path: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference_eval_shape(arch):
    """Full width: shapes and dtypes of every leaf, on the meta device."""
    params, _ = TM.abstract_params(tbase.get_config(arch))
    want = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(reference_abstract(arch)[0])[0]}
    flat = flatten(params)
    assert sorted(flat) == sorted(want)
    for k, t in flat.items():
        assert t.is_meta, k
        assert tuple(t.shape) == want[k].shape, k
        assert str(t.dtype).removeprefix("torch.") == want[k].dtype.name, k


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_reference(arch):
    """The logical axes at full width equal the reference's, leaf for leaf,
    and equal its concrete smoke axes (they do not depend on width)."""
    axes = TM.param_axes(tbase.get_config(arch))
    assert axes == reference_abstract(arch)[1]
    if arch == "granite-3-2b":
        assert axes == JT.init_params(jbase.get_config(arch).smoke(), jax.random.key(0))[1]


@pytest.mark.parametrize("shape", list(tbase.SHAPES))
@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-tiny", "internvl2-2b",
                                  "jamba-1.5-large-398b", "rwkv6-3b"])
def test_input_specs_match_reference(arch, shape):
    got = TM.input_specs(tbase.get_config(arch), tbase.SHAPES[shape], batch_override=2)
    want = JM.input_specs(jbase.get_config(arch), jbase.SHAPES[shape], batch_override=2)
    flat_w = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = flatten(got)
    assert sorted(flat_g) == sorted(flat_w)
    for k, t in flat_g.items():
        assert t.is_meta and tuple(t.shape) == flat_w[k].shape, k
        assert str(t.dtype).removeprefix("torch.") == flat_w[k].dtype.name, k


def test_synth_batch_is_seeded_and_in_range():
    cfg = tbase.get_config("internvl2-2b").smoke()
    shape = tbase.ShapeSpec("t", 32, 2, "train")
    a = TM.synth_batch(cfg, shape, seed=3, device="cpu")
    b = TM.synth_batch(cfg, shape, seed=3, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert int(a["tokens"].max()) < cfg.vocab and int(a["tokens"].min()) >= 0
    assert a["vision"].shape == (2, cfg.vision_tokens, cfg.vit_dim)
    d = TM.synth_batch(cfg, tbase.ShapeSpec("d", 32, 2, "decode"), device="cpu")
    assert int(d["pos"]) == 16 and d["cache"]["k"].shape == (2, 2, 32, 2, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_lm_params_from_jax(dtype):
    """Every leaf carried in its own dtype, bit for bit: float32 leaves,
    bfloat16 leaves (ml_dtypes arrays, carried as bits) and the reference's
    QuantTensors; a leaf of another kind raises."""
    npp = numpy_params(tbase.get_config("granite-3-2b").smoke())
    jp = jax_tree(npp)
    if dtype == "bfloat16":
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    elif dtype == "int8":
        jp = jptq.quantize_tree(jp)
    tp = lm_params_from_jax(jp, "cpu")
    flat_j = jax.tree_util.tree_leaves(jp, is_leaf=lambda x: isinstance(x, jptq.QuantTensor))
    flat_t = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            flat_t.append(node)
    walk(tp)
    assert len(flat_j) == len(flat_t)
    for j, t in zip(flat_j, flat_t):
        pairs = ([(j.q, t.q), (j.scale, t.scale)] if isinstance(j, jptq.QuantTensor)
                 else [(j, t)])
        if isinstance(j, jptq.QuantTensor):
            assert isinstance(t, tptq.QuantTensor)
        for a, b in pairs:
            assert str(b.dtype).removeprefix("torch.") == a.dtype.name
            assert tuple(b.shape) == a.shape
            want = np.asarray(a)
            got = b.view(torch.uint16).numpy() if b.dtype == torch.bfloat16 else b.numpy()
            np.testing.assert_array_equal(got, want.view(np.uint16)
                                          if want.dtype.name == "bfloat16" else want)
    with pytest.raises(TypeError):
        lm_params_from_jax({"w": np.array(["a"])}, "cpu")
    with pytest.raises(TypeError):
        lm_params_from_jax({"w": None}, "cpu")
