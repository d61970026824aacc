"""The hybrid LM cell's traffic module, readers and work counts on the CPU: a run
of `kimi-linear-longdoc-poisson` at narrow widths (Kimi Linear's 27-layer
pattern and expert share kept) comes out correct with every request in
time and a record every reader reads; the int8 control is judged not
correct against a tight limit; the configuration file is the program's;
the work counts equal a hand count at the published widths."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from bench import harness
from bench.traffic import lm_hybrid as hybrid
from bench.work import kimi_linear as W

CELL = "kimi-linear-longdoc-poisson"
MIX = {"rate_qps": 6.0, "prompt_min": 8, "prompt_max": 90, "new_min": 2, "new_max": 6,
       "slots": 4, "max_len": 128, "keep_logits": 3}
SECONDS = 1.0


def narrow():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(
        get_config("kimi-linear-48b-a3b"), d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab=512, head_dim=24, n_experts=16, experts_held=8, top_k=4, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, moe_d_ff=32,
        kda_heads=2, kda_head_dim=16, q_chunk=8, dtype=torch.float32,
        param_dtype=torch.float32)


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


def run_cell(cell, trace=False, **kw):
    run = hybrid.Run(cell, 2**31 + 17, SECONDS, device="cpu", cfg=narrow(), **kw)
    run.setup()
    run.window(trace=trace)
    run.release()
    return run, run.check()


def test_the_configuration_file_is_the_programs():
    cell = harness.cell(CELL)
    cfg = hybrid.program_config(cell.config)
    assert cfg.family == "kda_mla_moe" and cell.config["reduced"] == ["num_experts"]
    assert (cfg.n_held, cfg.n_experts) == (cell.config["num_experts"], 256)
    assert cell.config["deployment"]["expert_parallel"] * cfg.n_held == cfg.n_experts
    with pytest.raises(ValueError):
        hybrid.program_config(dict(cell.config, num_experts=256))


def test_a_sound_run_is_correct_and_its_record_reads():
    run, compared = run_cell(small_cell())
    assert all(c.ok for c in compared), compared
    assert run.attempted == len(run.times) == 8 and run.failed == 0
    rec = run.record()
    assert rec["kind"] == "fleet" and rec["answered_in_time"] == run.attempted
    eng = rec["lm"]["engine"]
    assert eng["state_resets"] == run.attempted and eng["kda_launches"] == 0
    assert harness.load_metric("requests_per_s")(rec) == run.attempted / SECONDS
    for name in ("decode_ms.kda", "kda_kernel_roofline", "kimi_window_roofline", "mfu.kimi"):
        assert harness.load_metric(name)(dict(rec, peaks={"hbm_bytes_per_s": 3.35e12,
                                                          "float32": 67e12})) is None


def test_the_int8_control_is_not_correct():
    _, compared = run_cell(small_cell(logits_rel_gap_median=1e-4, logits_rel_gap_max=1e-4),
                           control=True)
    bad = [c.name for c in compared if not c.ok]
    assert bad and set(bad) <= {"logits_rel_gap_max", "logits_rel_gap_median"}
    _, compared = run_cell(small_cell(logits_rel_gap_median=1e-4, logits_rel_gap_max=1e-4))
    assert all(c.ok for c in compared), compared


class FakeDevice:
    """The device trace on the CPU: the window busy half its length, the
    KDA kernels a tenth of it."""
    def __enter__(self):
        import time
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time
        self.t1 = time.perf_counter()
        w = self.t1 - self.t0
        self.events = [("kda_chunk_prefill_kernel", self.t0, self.t0 + 0.05 * w),
                       ("void kda_decode_step_kernel", self.t0, self.t0 + 0.05 * w)]
        return False

    def summary(self):
        w = self.t1 - self.t0
        return {"window_s": w, "busy_s": 0.5 * w, "kernel_s": 0.5 * w, "n_ops": 1,
                "device_ops": [["k", 0.5 * w]], "gaps": [(self.t0, self.t0 + 0.5 * w)]}


def test_a_traced_window_gives_every_reader_a_value(monkeypatch):
    monkeypatch.setattr(hybrid, "DeviceTrace", FakeDevice)
    run, compared = run_cell(small_cell(), trace=True)
    assert all(c.ok for c in compared)
    rec = dict(run.record(), peaks={"hbm_bytes_per_s": 3.35e12, "float32": 67e12})
    B = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in harness.metrics_for(B, CELL, "per_layer")]
    assert len(names) == 13
    got = {n: harness.load_metric(n)(rec) for n in names}
    assert all(v is not None and np.isfinite(v) for v in got.values()), got
    assert got["decode_ms.kda"] > 0 and got["prefill_ms_ktok.kda"] > 0
    assert rec["lm"]["kda_device"]["kda_decode_step_kernel"]["calls"] == 1
    assert any(n.startswith("kda") or n.startswith("prefill kda")
               for n, _ in run._labelled(run.program_spans))


def test_work_counts_at_the_published_widths():
    a = hybrid.work_arch(hybrid.program_config(harness.cell(CELL).config))
    d, H, L = 2304, 32, 27
    mla = d * H * 192 + d * 576 + 512 * H * 256 + H * 128 * d
    kda_mm = d * 12288 + 2 * (d * 128 + 128 * 4096) + d * 32 + 4096 * d
    kda_other = 12288 * 4 + 4096 + 32 + 4096 + 128
    expert, shared, router = 3 * d * 1024, 3 * d * 1024, d * 256 + 256
    total = (7 * (mla + 512) + 20 * (kda_mm + kda_other) + L * 2 * d + 3 * d * 9216
             + 26 * (128 * expert + shared + router) + 2 * 163840 * d + d)
    assert W.params_total(a) == total and round(total / 1e9, 2) == 25.57
    active = 7 * mla + 20 * kda_mm + 3 * d * 9216 + 26 * (4 * expert + shared + router) \
        + 163840 * d
    assert W.params_active(a) == active
    assert W.kda_decode_flops(a, 1) == 2.0 * 32 * 4 * 128 * 128
    assert W.kda_decode_bytes(a, 64) == 4 * 64 * 32 * (2 * 128 * 128 + 5 * 128 + 1)
    # one chunk of 64: A and P over 64^2 pairs, 3 K V products a token
    assert W.kda_prefill_flops(a, 64) == 2.0 * 32 * (64 * 64 * 256 + 3 * 64 * 128 * 128)
    assert W.decode_flops(a, 1, 1) == 2.0 * active + 7 * 2.0 * H * (2 * 512 + 64) + \
        20 * W.kda_decode_flops(a, 1)
