"""The port's bfloat16 LM path against the JAX reference, on the CPU.

The reference is compiled as it runs: `jax.jit` with XLA's default options
(the `Engine`'s own decode, `forward`, `value_and_grad(loss_fn)`).  Two
things set its bfloat16 numerics apart from torch's fused ops, and
`models/layers.py` mirrors both:

- XLA lowers `jax.nn.silu`, the tanh `gelu`, `sigmoid` and `softplus` as
  chains of ops rounded to bfloat16 after each one (their compiled CPU
  HLO), and differentiates them by JAX's own rules.  Against the reference
  on every finite bfloat16 input (65,280 values; cotangents drawn with a
  seed): forward and VJP equal but where XLA's CPU code flushes a
  subnormal to zero (a subnormal input, or an op of the chain at
  x <= -86 whose float32 result is subnormal).  There the two differ by
  less than 2^-119: forward silu 511, gelu 508, sigmoid 3, softplus 11
  elements, each a +-0 against the port's subnormal; VJP silu 5, gelu 0,
  sigmoid 5, softplus 11 (JAX 0.9.0).
- With excess precision allowed (XLA's default), the bfloat16 rounding of
  a residual sum that a norm upcasts at once is dropped: the norm reads
  the float32 sum (`layers.add_norm`; the same for rwkv6's decay branch).
  `test_add_norm_is_the_reference_default_compilation` holds this
  bit for bit, and shows that `xla_allow_excess_precision=False` gives the
  plain norm instead.

Every family at smoke width with `dtype=bfloat16` (float32 params from
`numpy_params(seed=7)`):

- forward logits within `FWD_TOL` (2^-5, one bfloat16 ulp at the logits'
  scale of 4 to 8; measured 0 to 0.0078), argmax equal;
- the `Engine` (8 prompts of 6 tokens, 8 new tokens, batch 4, max_len 32:
  `ROADMAP.md` §3's setup): greedy tokens equal (agreement 1.000), each
  decode step's logits within 2^-5 (measured up to 0.024);
- bfloat16 `loss_fn` gradients of one arch for each activation (silu,
  MoE, sigmoid, gelu): loss within rtol 1e-3, each leaf within 2^-5 of
  its largest entry (measured 0.6 % median, 2.4 % worst; the backward
  rounds some hundred bfloat16 ops a leaf, and XLA's fusions of the
  backward move a few roundings).

Jamba is held to looser bars, for its router's near-ties: a half-ulp
change to its embedding table moves its logits by 1.36 (`ROADMAP.md`
§3), and the reference's own two compilations (default, and without
excess precision) agree on 0.094 of its greedy tokens.  Its forward logits
must lie within 1.0 (measured 0.69), its decode logits within 2.0 on the
steps whose inputs are still the reference's (the first 6; measured
1.67); its tokens have no bar, and its gradients are not compared.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from test_torch_lm_models import jax_tree, numpy_batch, numpy_params  # noqa: E402

ARCHS = tbase.ARCH_IDS
JAMBA = "jamba-1.5-large-398b"
FWD_TOL = {JAMBA: 1.0}
DECODE_TOL = {JAMBA: 2.0}
FLUSHED = {"silu": 511, "gelu": 508, "sigmoid": 3, "softplus": 11}
FLUSHED_VJP = {"silu": 5, "gelu": 0, "sigmoid": 5, "softplus": 11}
TINY = 2.0 ** -119
ACTIVATIONS = ["silu", "gelu", "sigmoid", "softplus"]


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


def _to_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def _all_bfloat16():
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    x = bits.view(ml_dtypes.bfloat16)
    return x[np.isfinite(x.astype(np.float32))]


def _assert_equal_but_flushes(want, got, x, n_flushed):
    """Bit-equal (NaN to NaN), except where the reference flushes a
    subnormal to zero: there the two differ by less than 2^-119;
    `n_flushed` such elements."""
    w, g = want.astype(np.float32), got.astype(np.float32)
    differ = (want.view(np.uint16) != got.view(np.uint16)) & ~(np.isnan(w) & np.isnan(g))
    assert np.all(np.abs(g - w)[differ] < TINY), x.astype(np.float32)[differ]
    assert int(differ.sum()) == n_flushed


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_matches_reference_on_every_bfloat16(name):
    x = _all_bfloat16()
    want = np.asarray(jax.jit(getattr(jax.nn, name))(jnp.asarray(x)))
    got = getattr(layers, name)(_to_torch(x))
    assert got.dtype == torch.bfloat16
    _assert_equal_but_flushes(want, _to_numpy(got), x, FLUSHED[name])


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_vjp_matches_reference_on_every_bfloat16(name):
    x = _all_bfloat16()
    g = np.random.default_rng(0).standard_normal(x.shape).astype(ml_dtypes.bfloat16)
    fn = getattr(jax.nn, name)
    want = np.asarray(jax.jit(lambda x, g: jax.vjp(fn, x)[1](g)[0])(jnp.asarray(x), jnp.asarray(g)))
    xt = _to_torch(x).requires_grad_(True)
    getattr(layers, name)(xt).backward(_to_torch(g))
    assert xt.grad.dtype == torch.bfloat16
    _assert_equal_but_flushes(want, _to_numpy(xt.grad), x, FLUSHED_VJP[name])


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_float32_is_the_fused_torch_op(name):
    x = torch.linspace(-30, 30, 4097)
    fused = {"silu": torch.nn.functional.silu, "sigmoid": torch.sigmoid,
             "softplus": torch.nn.functional.softplus,
             "gelu": functools.partial(torch.nn.functional.gelu, approximate="tanh")}[name]
    assert torch.equal(getattr(layers, name)(x), fused(x))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_add_norm_is_the_reference_default_compilation(kind):
    rng = np.random.default_rng(1)
    x, y = (rng.standard_normal((4, 8, 64)).astype(ml_dtypes.bfloat16) for _ in range(2))
    p = {"w": (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)}
    if kind == "layernorm":
        p["b"] = (0.1 * rng.standard_normal(64)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    h, hn = layers.add_norm(_to_torch(x), _to_torch(y), tp, kind)
    assert h.dtype == hn.dtype == torch.bfloat16
    plain = layers.apply_norm(_to_torch(x) + _to_torch(y), tp, kind)

    def ref(opts):
        f = jax.jit(lambda x, y, p: (x + y, JL.apply_norm(x + y, p, kind)),
                    compiler_options=opts)
        return [np.asarray(a) for a in f(jnp.asarray(x), jnp.asarray(y), jax_tree(p))]
    want_h, want_n = ref(None)
    assert np.array_equal(_to_numpy(h).view(np.uint16), want_h.view(np.uint16))
    assert np.array_equal(_to_numpy(hn).view(np.uint16), want_n.view(np.uint16))
    # without excess precision XLA rounds the sum first: the plain norm
    _, exact_n = ref({"xla_allow_excess_precision": False})
    assert np.array_equal(_to_numpy(plain).view(np.uint16), exact_n.view(np.uint16))
    assert not np.array_equal(exact_n.view(np.uint16), want_n.view(np.uint16))
    # float32: the plain sum and norm, bit for bit
    x32, y32 = _to_torch(x).float(), _to_torch(y).float()
    h32, hn32 = layers.add_norm(x32, y32, tp, kind)
    assert torch.equal(h32, x32 + y32)
    assert torch.equal(hn32, layers.apply_norm(x32 + y32, tp, kind))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = dataclasses.replace(tbase.get_config(arch).smoke(), dtype=torch.bfloat16)
    jcfg = dataclasses.replace(jbase.get_config(arch).smoke(), dtype=jnp.bfloat16)
    return cfg, jcfg, numpy_params(cfg, seed=7)


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_forward_matches_reference(arch):
    cfg, jcfg, npp = _setup(arch)
    nb = numpy_batch(cfg)
    ins = {k: nb[k] for k in ("tokens", "frames", "vision") if k in nb}
    with torch.inference_mode():
        got, _ = TT.forward(cfg, lm_params_from_jax(npp, "cpu"),
                            {k: torch.from_numpy(v) for k, v in ins.items()})
    got = got.numpy()
    want, _ = jax.jit(functools.partial(JT.forward, jcfg))(jax_tree(npp), jax_tree(ins))
    want = np.asarray(want)
    err, tol = float(np.abs(got - want).max()), FWD_TOL.get(arch, 2 ** -5)
    assert err <= tol, f"{arch}: logits {err} apart, past {tol}"
    if arch != JAMBA:
        V = cfg.vocab
        assert np.array_equal(got[..., :V].argmax(-1), want[..., :V].argmax(-1))


def _serve(eng, prompts, cls):
    """Greedy tokens of `prompts` through `eng`, and each decode step's
    input tokens and logits."""
    steps, decode = [], eng.decode

    def recorded(params, cache, tokens, pos):
        fed = np.asarray(tokens).copy()
        logits, cache = decode(params, cache, tokens, pos)
        steps.append((fed, np.asarray(logits.float() if isinstance(logits, torch.Tensor)
                                      else logits)))
        return logits, cache
    eng.decode = recorded
    done = eng.submit_and_run([cls(i, p.copy(), 8) for i, p in enumerate(prompts)])
    return [list(r.out) for r in done], steps


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_engine_matches_reference(arch):
    cfg, jcfg, npp = _setup(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, 6).astype(np.int32) for _ in range(8)]
    got, got_steps = _serve(Engine(cfg, lm_params_from_jax(npp, "cpu"), batch_size=4,
                                   max_len=32, device="cpu"), prompts, Request)
    want, want_steps = _serve(jengine.Engine(jcfg, jax_tree(npp), batch_size=4, max_len=32),
                              prompts, jengine.Request)
    if arch != JAMBA:
        agreement = np.mean([a == b for ra, rb in zip(got, want) for a, b in zip(ra, rb)])
        assert got == want, f"{arch}: token agreement {agreement}"
        assert len(got_steps) == len(want_steps)
    # logits on every step whose inputs so far are the reference's
    tol, same = DECODE_TOL.get(arch, 2 ** -5), 0
    for (fed, g), (wfed, w) in zip(got_steps, want_steps):
        if not np.array_equal(fed, wfed):
            break
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{arch} decode step {same}: logits {err} apart, past {tol}"
        same += 1
    assert same >= 6        # at least the first wave's prompts


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-235b-a22b", "rwkv6-3b",
                                  "whisper-tiny"])
def test_bfloat16_gradients_match_reference(arch):
    from test_torch_lm_training import port_grads, torch_batch
    cfg, jcfg, npp = _setup(arch)
    nb = numpy_batch(cfg)
    loss, _, grads = port_grads(cfg, lm_params_from_jax(npp, "cpu"), torch_batch(nb))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        functools.partial(JT.loss_fn, jcfg), has_aux=True))(jax_tree(npp), jax_tree(nb))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    want = {jax.tree_util.keystr(p): np.asarray(g)
            for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        w = want[k]
        scale = float(np.abs(w).max())
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= 2 ** -5 * scale + 1e-30, f"{arch} {k}: {err} past 2^-5 x {scale}"


def report(arch: str) -> str:
    """One family's readings against the reference's default compilation:
    greedy-token agreement, the largest decode-logit gap on steps with the
    reference's inputs, the forward-logit gap and argmax agreement."""
    cfg, jcfg, npp = _setup(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, 6).astype(np.int32) for _ in range(8)]
    got, gs = _serve(Engine(cfg, lm_params_from_jax(npp, "cpu"), batch_size=4, max_len=32,
                            device="cpu"), prompts, Request)
    want, ws = _serve(jengine.Engine(jcfg, jax_tree(npp), batch_size=4, max_len=32),
                      prompts, jengine.Request)
    agree = np.mean([a == b for ra, rb in zip(got, want) for a, b in zip(ra, rb)])
    gaps = []
    for (fed, g), (wfed, w) in zip(gs, ws):
        if not np.array_equal(fed, wfed):
            break
        gaps.append(float(np.abs(g - w).max()))
    nb = numpy_batch(cfg)
    ins = {k: nb[k] for k in ("tokens", "frames", "vision") if k in nb}
    with torch.inference_mode():
        f, _ = TT.forward(cfg, lm_params_from_jax(npp, "cpu"),
                          {k: torch.from_numpy(v) for k, v in ins.items()})
    f = f.numpy()
    w = np.asarray(jax.jit(functools.partial(JT.forward, jcfg))(jax_tree(npp), jax_tree(ins))[0])
    V = cfg.vocab
    return (f"{arch}: tokens {agree:.3f}, decode gap {max(gaps):.4g} over {len(gaps)} steps, "
            f"forward gap {float(np.abs(f - w).max()):.4g}, argmax "
            f"{float(np.mean(f[..., :V].argmax(-1) == w[..., :V].argmax(-1))):.3f}")


if __name__ == "__main__":
    # The readings behind the bars above, for the port on PYTHONPATH:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_bf16.py
    # (a parent checkout's port: put its src first on PYTHONPATH).
    for a in ARCHS:
        print(report(a), flush=True)
