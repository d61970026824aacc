"""The port's LM training path against the JAX reference, on the CPU.

Smoke width, float32, params drawn with numpy and handed to both packages
(`numpy_params`, `core/convert.lm_params_from_jax`):

- `loss_fn`'s value and every gradient leaf against
  `jax.value_and_grad(model.loss, has_aux=True)` for all ten archs: the
  loss within rtol 1e-6, each gradient leaf within `GRAD_TOL` of that
  leaf's largest entry (1e-5; rwkv6 2e-4, its decay enters the WKV scan
  rounded to bfloat16, where an ulp of float32 drift can move a decay by a
  bfloat16 ulp; jamba 1e-4, its float32 selective scan and router);
- three `runtime/steps.make_train_step` steps with `n_micro = 2` (smoke
  `micro_batch = 4`, batch 8) and the cosine schedule, against the
  reference's jitted step, one arch a family: losses within rtol 1e-5,
  gradient norms within rtol 1e-4, params within 0.25 lr (Adam's step is
  about lr an element; where a gradient is below the float32 error of the
  two sums its direction may differ);
- Adam in the giants' setting (bfloat16 params, gradients and moments)
  against the reference's `adam_update`: params equal, moments within one
  bfloat16 ulp on a few elements;
- remat on and off (`torch.utils.checkpoint` per block), and the donated
  (in-place) Adam update against the functional one: gradients, params
  and moments bit-equal;
- the reference's Trainer and fault tests of `tests/test_system.py`, on the
  port (loss decreases, watchdog, straggler, `run_with_restarts`), and the
  `train` launcher with a checkpoint resume and with `--distributed` (a
  gloo world of one: the losses of the run without it, bit for bit).
"""
import dataclasses
import functools
import signal
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as JO  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime.steps import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.backends import tree_leaves  # noqa: E402
from repro_torch.core.convert import lm_params_from_jax  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402
from repro_torch.runtime.steps import make_train_step  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_lm_models import flatten, jax_tree, numpy_batch, numpy_params  # noqa: E402

ARCHS = tbase.ARCH_IDS
GRAD_TOL = {"rwkv6-3b": 2e-4, "jamba-1.5-large-398b": 1e-4}
LR = 1e-3
# one arch a family: dense, moe, ssm, hybrid, audio, vlm
FAMILIES = ["granite-3-2b", "qwen3-moe-235b-a22b", "rwkv6-3b", "jamba-1.5-large-398b",
            "whisper-tiny", "internvl2-2b"]


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


def port_grads(cfg, params, batch):
    """(loss, metrics, {path: gradient}) of the port's loss_fn by autograd."""
    flat = flatten(params)
    req = {k: v.detach().requires_grad_() for k, v in flat.items()}

    def rebuild(node, path=""):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{path}['{k}']") for k, v in node.items()}
        return req[path]
    loss, metrics = TT.loss_fn(cfg, rebuild(params), batch)
    grads = torch.autograd.grad(loss, list(req.values()))
    return loss.detach(), metrics, dict(zip(req, grads))


def torch_batch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    cfg, jcfg = tbase.get_config(arch).smoke(), jbase.get_config(arch).smoke()
    npp, nb = numpy_params(cfg), numpy_batch(cfg)
    loss, metrics, grads = port_grads(cfg, lm_params_from_jax(npp, "cpu"), torch_batch(nb))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        functools.partial(JT.loss_fn, jcfg), has_aux=True))(jax_tree(npp), jax_tree(nb))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["aux"].detach()), float(jmet["aux"]),
                               rtol=1e-5, atol=1e-6)
    want = {jax.tree_util.keystr(p): np.asarray(g)
            for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert sorted(grads) == sorted(want)
    tol = GRAD_TOL.get(arch, 1e-5)
    for k, g in grads.items():
        w = want[k]
        assert g.shape == w.shape and g.dtype == torch.float32, k
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol * scale + 1e-30, f"{arch} {k}: {err} past {tol} x {scale}"


def _train_batches(cfg, n, seed=3):
    dc = lm_data.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for step in range(n):
        b = lm_data.host_batch(dc, step)
        if cfg.family == "audio":
            b["frames"] = (0.1 * rng.standard_normal((8, cfg.encoder_frames, cfg.d_model))
                           ).astype(np.float32)
        if cfg.family == "vlm":
            b["vision"] = (0.1 * rng.standard_normal((8, cfg.vision_tokens, cfg.vit_dim))
                           ).astype(np.float32)
        out.append(b)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_three_micro_batched_train_steps_match_reference(arch):
    cfg, jcfg = tbase.get_config(arch).smoke(), jbase.get_config(arch).smoke()
    assert max(1, 8 // cfg.micro_batch) == 2                  # n_micro = 2
    npp = numpy_params(cfg)
    step = make_train_step(TM.build(cfg), TO.AdamConfig(lr=LR), TO.cosine_schedule(LR, 1, 3))
    jstep = jax.jit(j_make_train_step(JM.build(jcfg), JO.AdamConfig(lr=LR),
                                      JO.cosine_schedule(LR, 1, 3)))
    tp = lm_params_from_jax(npp, "cpu")
    ts = TO.adam_init(tp, TO.AdamConfig(lr=LR))
    jp = jax_tree(npp)
    js = JO.adam_init(jp, JO.AdamConfig(lr=LR))
    for b in _train_batches(cfg, 3):
        tp, ts, tm = step(tp, ts, torch_batch(b))
        jp, js, jm = jstep(jp, js, jax_tree(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert int(ts.step) == int(js.step) == 3
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    for k, v in flatten(tp).items():
        err = float(np.abs(v.numpy() - want[k]).max())
        assert err <= 0.25 * LR, f"{arch} {k}: params {err} apart"


@pytest.mark.parametrize("clip_norm,layer_chunked", [(None, False), (1.0, False), (1.0, True)])
def test_adam_with_bfloat16_params_and_moments_matches_reference(clip_norm, layer_chunked):
    """The giants' setting (`param_dtype` bfloat16: bfloat16 params,
    accumulated gradients and moments), 8 steps on the cosine schedule,
    against the reference's `adam_update` run op by op (as
    tests/test_torch_optim.py runs it; jitted, XLA may contract a multiply
    and an add into one rounding).  Unclipped and unchunked, params and
    moments are bit-equal.  Otherwise params are bit-equal and the moments
    differ on at most 0.5 % of their elements, each within a bfloat16 ulp
    of itself plus half an ulp of its leaf's largest moment (a difference
    carried into a moment near zero spans several of its ulps): the clip
    scale comes from a float32 global norm that the two packages sum in
    different orders, and the reference compiles `lax.map`'s body as one
    loop."""
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 32), "s": (4, 8, 16), "v": (7,)}
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # noqa: E731
    to_t = lambda tree: {k: torch.from_numpy(v).bfloat16() for k, v in tree.items()}  # noqa: E731
    to_j = lambda tree: {k: jnp.asarray(v, jnp.bfloat16) for k, v in tree.items()}  # noqa: E731
    params = {k: bf(rng.standard_normal(s)) for k, s in shapes.items()}
    kw = dict(lr=1e-2, clip_norm=clip_norm, layer_chunked=layer_chunked)
    tc = TO.AdamConfig(moment_dtype=torch.bfloat16, **kw)
    jc = JO.AdamConfig(moment_dtype=jnp.bfloat16, **kw)
    exact = clip_norm is None and not layer_chunked
    tp, jp = to_t(params), to_j(params)
    ts, js = TO.adam_init(tp, tc), JO.adam_init(jp, jc)
    tlr, jlr = TO.cosine_schedule(1e-2, 2, 8), JO.cosine_schedule(1e-2, 2, 8)
    jupdate = functools.partial(JO.adam_update, cfg=jc)
    n = sum(int(np.prod(s)) for s in shapes.values())
    for step in range(8):
        g = {k: bf(rng.standard_normal(s) * (0.1 + step)) for k, s in shapes.items()}
        tp, ts, _ = TO.adam_update(to_t(g), ts, tp, tc, tlr(ts.step))
        jp, js, _ = jupdate(to_j(g), js, jp, lr=jlr(js.step))
        for k in shapes:
            assert tp[k].dtype == ts.mu[k].dtype == ts.nu[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(tp[k].float().numpy(), np.asarray(jp[k], np.float32))
        apart = 0
        for got, want in ((ts.mu, js.mu), (ts.nu, js.nu)):
            for k in shapes:
                a, b = got[k].float().numpy(), np.asarray(want[k], np.float32)
                if exact:
                    np.testing.assert_array_equal(a, b, err_msg=f"step {step} {k}")
                else:
                    np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=2 ** -8 * np.abs(b).max(),
                                               err_msg=f"step {step} {k}")
                apart += int((a != b).sum())
        assert apart <= 0.005 * 2 * n, (step, apart)


@pytest.mark.parametrize("arch", ["granite-3-2b", "jamba-1.5-large-398b", "whisper-tiny"])
def test_remat_leaves_gradients_bit_equal(arch):
    cfg = tbase.get_config(arch).smoke()
    assert cfg.remat
    npp, nb = numpy_params(cfg), numpy_batch(cfg)
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = port_grads(c, lm_params_from_jax(npp, "cpu"), torch_batch(nb))
    assert torch.equal(out[True][0], out[False][0])
    for k, g in out[True][2].items():
        assert torch.equal(g, out[False][2][k]), k


def test_remat_only_while_autograd_records(monkeypatch):
    """Serving and `torch.no_grad` forwards never checkpoint."""
    calls = []
    real = TT.checkpoint
    monkeypatch.setattr(TT, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = tbase.get_config("granite-3-2b").smoke()
    params, _ = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = torch_batch(numpy_batch(cfg))
    with torch.no_grad():
        TT.loss_fn(cfg, params, batch)
    assert calls == []
    for p in tree_leaves(params):
        p.requires_grad_()
    TT.loss_fn(cfg, params, batch)[0].backward()
    assert len(calls) == cfg.n_layers


@pytest.mark.parametrize("layer_chunked", [False, True])
def test_donated_adam_update_equals_the_functional_one(layer_chunked):
    """The train step's in-place update (`adam_update(donate=True)`) gives
    the functional update's params and moments, bit for bit, in the tensors
    it was given."""
    rng = np.random.default_rng(4)
    shapes = {"w": (6, 5), "stack": (3, 4, 5), "b": (5,)}
    draw = lambda: {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
                    for k, s in shapes.items()}
    params = draw()
    cfg = TO.AdamConfig(lr=LR, layer_chunked=layer_chunked)
    funct = (params, TO.adam_init(params, cfg))
    mine = ({k: v.clone() for k, v in params.items()}, TO.adam_init(params, cfg))
    for _ in range(3):
        g = draw()
        funct = TO.adam_update(g, funct[1], funct[0], cfg)[:2]
        before = mine[0]["stack"], mine[1].mu["stack"]
        mine = TO.adam_update(g, mine[1], mine[0], cfg, donate=True)[:2]
        assert mine[0]["stack"] is before[0] and mine[1].mu["stack"] is before[1]
    for a, b in zip(tree_leaves(funct), tree_leaves(mine)):
        assert torch.equal(a, b)


def test_train_step_updates_params_in_place():
    cfg = tbase.get_config("granite-3-2b").smoke()
    p = lm_params_from_jax(numpy_params(cfg), "cpu")
    s = TO.adam_init(p, TO.AdamConfig(lr=LR))
    first, before = p["embed"]["w"], p["embed"]["w"].clone()
    step = make_train_step(TM.build(cfg), TO.AdamConfig(lr=LR))
    p2, s2, _ = step(p, s, torch_batch(_train_batches(cfg, 1)[0]))
    assert p2["embed"]["w"] is first and s2.mu["embed"]["w"] is s.mu["embed"]["w"]
    assert not torch.equal(first, before)


def test_train_step_refuses_an_uneven_micro_split():
    cfg = dataclasses.replace(tbase.get_config("granite-3-2b").smoke(), micro_batch=3)
    params, _ = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(TM.build(cfg), TO.AdamConfig())
    b = torch_batch(lm_data.host_batch(lm_data.DataConfig(cfg.vocab, 8, 10), 0))
    with pytest.raises(ValueError, match="micro-batches"):
        step(params, TO.adam_init(params), b)


def test_trainer_takes_handed_in_params_and_leaves_them_untouched():
    cfg = tbase.get_config("granite-3-2b").smoke()
    tp = lm_params_from_jax(numpy_params(cfg), "cpu")
    before = {k: v.clone() for k, v in flatten(tp).items()}
    t = Trainer(cfg, TrainerConfig(total_steps=2, seq_len=16, global_batch=8, warmup_steps=0),
                device="cpu", params=tp)
    state, history = t.run()
    assert len(history) == 2 and all(isinstance(h, float) for h in history)
    for k, v in flatten(tp).items():
        assert torch.equal(v, before[k]), k
    assert not torch.equal(flatten(state["params"])["['embed']['w']"], before["['embed']['w']"])


def test_train_launcher_resumes_from_its_checkpoints(tmp_path, capsys):
    argv = ["--device", "cpu", "--steps", "26", "--seq-len", "16", "--global-batch", "8",
            "--ckpt-dir", str(tmp_path)]
    state, history = train_launcher.main(argv)
    assert len(history) == 26 and sorted(p.name for p in tmp_path.iterdir()) == ["step_25"]
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "done: loss" in out
    state2, history2 = train_launcher.main(argv)                 # resumes at 25
    assert history2 == history[25:]
    for a, b in zip(tree_leaves(state), tree_leaves(state2)):
        assert torch.equal(a, b)


def test_train_launcher_distributed_world_of_one_gives_the_same_losses(monkeypatch, capsys):
    """`--distributed --device cpu` brings up a gloo world of one from
    torchrun's variables (MASTER_PORT 0: the store takes a free port, so
    parallel workers do not race for one), trains as without the flag, bit
    for bit, and destroys the group."""
    import torch.distributed as dist
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "0")):
        monkeypatch.setenv(k, v)
    argv = ["--device", "cpu", "--steps", "6", "--seq-len", "16", "--global-batch", "8"]
    state, history = train_launcher.main(argv + ["--distributed"])
    assert not dist.is_initialized()
    state2, history2 = train_launcher.main(argv)
    assert len(history) == 6 and history == history2
    for a, b in zip(tree_leaves(state), tree_leaves(state2)):
        assert torch.equal(a, b)


def test_train_launcher_distributed_needs_torchrun_variables(monkeypatch):
    import torch.distributed as dist
    for k in train_launcher.DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="RANK"):
        train_launcher.main(["--device", "cpu", "--steps", "1", "--distributed"])
    assert not dist.is_initialized()


def test_trainer_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(tbase.get_config("granite-3-2b").smoke(), TrainerConfig())


# -- the reference's Trainer and fault tests (tests/test_system.py), on the port

def test_lm_training_loss_decreases():
    cfg = tbase.get_config("granite-3-2b").smoke()
    t = Trainer(cfg, TrainerConfig(total_steps=150, seq_len=64, global_batch=8,
                                   lr=1e-2, warmup_steps=10, log_every=100), device="cpu")
    state, history = t.run()
    first, last = np.mean(history[:5]), np.mean(history[-5:])
    assert last < first - 1.0, (first, last)          # structured data is learnable


def test_watchdog_fires():
    with pytest.raises(fault.StepTimeout):
        with fault.StepWatchdog(timeout_s=0.2):
            time.sleep(1.0)


def test_watchdog_restores_the_previous_handler():
    before = signal.getsignal(signal.SIGALRM)
    with fault.StepWatchdog(timeout_s=5.0):
        assert signal.getsignal(signal.SIGALRM) is not before
    assert signal.getsignal(signal.SIGALRM) is before
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)


def test_straggler_detection():
    st = fault.StepStats(window=20, slo_factor=2.0)
    for _ in range(10):
        assert st.record(0.1) is False
    assert st.record(0.5) is True


def test_run_with_restarts_recovers(tmp_path):
    """A crash injected mid-run: the loop resumes from the checkpoint and
    finishes with every step applied exactly once."""
    mgr = CheckpointManager(tmp_path)
    calls = {"n": 0, "crashed": False}

    def make_state():
        return {"x": torch.zeros(())}

    def train_one(state, step):
        calls["n"] += 1
        if step == 3 and not calls["crashed"]:
            calls["crashed"] = True
            raise RuntimeError("injected node failure")
        return {"x": state["x"] + 1.0}

    state, restarts = fault.run_with_restarts(
        make_state, train_one, mgr, total_steps=6, timeout_s=30.0)
    assert restarts == 1
    assert float(state["x"]) == 6.0
    assert calls["n"] == 7                       # steps 0-3, then 3-5 again from step 3


def test_run_with_restarts_gives_up_after_max_restarts(tmp_path):
    def train_one(state, step):
        raise RuntimeError("always fails")
    with pytest.raises(RuntimeError, match="always"):
        fault.run_with_restarts(lambda: {"x": torch.zeros(())}, train_one,
                                CheckpointManager(tmp_path), total_steps=2,
                                max_restarts=2, timeout_s=30.0)
