"""The LM cell's driver, readers and work counts on the CPU: a run of the
cell at smoke widths (the block's structure kept) comes out correct with
every request in time and a record the readers read; the int8 control
is judged not correct against a tight limit; the work counts equal a
hand count at the published widths."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from bench import harness
from bench.traffic import lm
from bench.work import moonlight as W

CELL = "moonlight-longprompt-poisson"
MIX = {"rate_qps": 6.0, "prompt_min": 8, "prompt_max": 40, "new_min": 2, "new_max": 6,
       "slots": 4, "max_len": 64, "keep_logits": 3}
SECONDS = 1.0


def narrow():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(
        get_config("moonlight-16b-a3b"), n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab=512, head_dim=24, n_experts=8, top_k=2, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, moe_d_ff=32,
        n_shared_experts=1, first_dense_layers=1, q_chunk=8,
        dtype=torch.float32, param_dtype=torch.float32)


def small_cell(**limits):
    c = harness.cell(CELL)
    return dataclasses.replace(c, mix=dict(c.mix, **MIX),
                               workload=dict(c.workload, limits=dict(c.workload["limits"],
                                                                     **limits)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cell(cell, **kw):
    run = lm.Run(cell, 2**31 + 17, SECONDS, device="cpu", cfg=narrow(), **kw)
    run.setup()
    run.window()
    run.release()
    return run, run.check()


def test_the_published_config_is_the_programs():
    cell = harness.cell(CELL)
    cfg = lm.program_config(cell.config)
    assert cfg.family == "mla_moe" and cell.config["reduced"] == []


def test_a_sound_run_is_correct_and_its_record_reads():
    run, compared = run_cell(small_cell())
    assert all(c.ok for c in compared), compared
    assert run.attempted == len(run.times) == 8 and run.failed == 0
    rec = run.record()
    assert rec["kind"] == "fleet" and rec["answered_in_time"] == run.attempted
    assert harness.load_metric("requests_per_s")(rec) == run.attempted / SECONDS
    eng = rec["lm"]["engine"]
    assert eng["prefill_tokens"] == sum(len(r.prompt) for r in run.reqs)
    assert len(rec["lm"]["work"]["prompts"]) == run.attempted
    assert harness.load_metric("tpot_ms.lm")(rec) > 0
    assert harness.load_metric("ttft_p99_ms.lm")(rec) > 0
    # untraced: the traced readers read nothing
    for name in ("lm_step_ms.decode", "decode_ms.moe", "device_idle_share.lm",
                 "lm_window_roofline", "mfu.lm"):
        assert harness.load_metric(name)(dict(rec, peaks={"hbm_bytes_per_s": 3.35e12})) is None


def test_the_int8_control_is_not_correct():
    """Against a limit far under the control's gap (the CPU run is float32,
    whose own gap is ~1e-6)."""
    run, compared = run_cell(small_cell(logits_rel_gap_median=1e-4, logits_rel_gap_max=1e-4),
                             control=True)
    bad = [c.name for c in compared if not c.ok]
    assert bad and set(bad) <= {"logits_rel_gap_max", "logits_rel_gap_median"}
    sound, compared = run_cell(small_cell(logits_rel_gap_median=1e-4, logits_rel_gap_max=1e-4))
    assert all(c.ok for c in compared), compared


def test_a_request_late_by_the_limits_is_not_in_time():
    run, _ = run_cell(small_cell())
    run.mix = dict(run.mix, tpot_limit_ms=0.0)
    assert run.record()["answered_in_time"] == 0


def test_a_traced_window_gives_every_reader_a_value():
    """The traced window on the CPU, the device trace replaced by a fake
    one: every per-layer metric of the cell reads a number."""
    from bench.traffic import lm as driver

    class FakeDevice:
        def __enter__(self):
            import time
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            import time
            self.t1 = time.perf_counter()
            return False

        def summary(self):
            w = self.t1 - self.t0
            return {"window_s": w, "busy_s": 0.5 * w, "kernel_s": 0.5 * w, "n_ops": 1,
                    "device_ops": [["k", 0.5 * w]], "gaps": [(self.t0, self.t0 + 0.5 * w)]}

    saved = driver.DeviceTrace
    driver.DeviceTrace = FakeDevice
    try:
        run = lm.Run(small_cell(), 2**31 + 17, SECONDS, device="cpu", cfg=narrow())
        run.setup()
        run.window(trace=True)
        run.release()
        assert all(c.ok for c in run.check())
    finally:
        driver.DeviceTrace = saved
    rec = dict(run.record(), peaks={"hbm_bytes_per_s": 3.35e12})
    B = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in harness.metrics_for(B, CELL, "per_layer")]
    assert len(names) == 10
    got = {n: harness.load_metric(n)(rec) for n in names}
    assert all(v is not None and np.isfinite(v) for v in got.values()), got
    assert got["expert_load_max_mean.lm"] >= 1.0
    assert rec["trace"]["idle_gaps"]


def test_work_counts_at_the_published_widths():
    a = harness.cell(CELL).config
    d, H, L = 2048, 16, 27
    attn = d * H * 192 + d * 576 + 512 * H * 256 + H * 128 * d
    expert, shared = 3 * d * 1408, 3 * d * 2816
    total = (L * (attn + 2 * d + 512) + 3 * d * 11264 + 26 * (64 * expert + shared + d * 64 + 64)
             + 2 * 163840 * d + d)
    assert W.params_total(a) == total
    assert round(W.params_total(a) / 1e9, 2) == 15.96
    active = L * attn + 3 * d * 11264 + 26 * (6 * expert + shared + d * 64 + 64) + 163840 * d
    assert W.params_active(a) == active and round(active / 1e9, 2) == 2.58
    # a decode step of 64 slots touching every expert, 1000 positions each
    nbytes = W.decode_step_bytes(a, 64, 64_000, touched_per_layer=64)
    # every weight in bfloat16 but the float32 routers, less the embedding
    # table (rows only) and the final norm
    weights = 2 * (total - 26 * (d * 64 + 64) - 163840 * d - d) + 4 * 26 * (d * 64 + 64)
    assert nbytes == pytest.approx(weights + 64_000 * 27 * 576 * 2
                                   + 64 * (2 * d + 4 * 163840), rel=1e-12)
    assert W.decode_flops(a, 1, 1) == 2.0 * active + 27 * 2.0 * H * (2 * 512 + 64)
    assert W.prefill_flops(a, 1) == 2.0 * active + 27 * 2.0 * H * (192 + 128)
