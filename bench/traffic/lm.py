"""Driver of LM traffic: open-loop arrivals of long prompts into the
program's LM `Engine` (its step-granular path), one card.

Set-up (counted in `setup_s`): the params drawn on the card from the
seed by the program's own init; with the control, every weight the
program's `core/ptq.quantize_tree` picks replaced by its int8 words
dequantized, a layer at a time; the engine built with its latent cache;
the schedule, each request's prompt (token ids uniform over the
vocabulary) and answer length from the seed, and `keep_logits` requests
picked from the schedule to keep their logits; then a warm-up: one
prefill at the shortest and at the longest prompt, and decode steps over
every slot.  The window: one thread submits each arrival when it is due,
stamped with its due time, before each engine step, and steps the engine
while it has work (prefill what was admitted, then one decode step over
the active slots); at the close it goes on until every request is
answered.  Then the program's engine is freed and the kept requests are
compared with the plain reference (`bench/reference/moonlight.py`): its
float32 forward over each prompt and the program's own answer tokens
(teacher-forced), at the prefill's last position and every decode
position, against the logits the program produced there.

The record is of kind "fleet", as the fleet's: `answered_in_time` counts
the requests whose time to first token and time per output token (from
the first token to the last, over the gaps) meet the mix's limits, and
`seconds` is the window's.  Its traced window turns the program's tracer
on (`bench.spans.ProgramTrace`).

Mix parameters: process, rate_qps, n_streams, prompt_min, prompt_max
(log-uniform), new_min, new_max (uniform, inclusive), slots, max_len,
ttft_limit_ms, tpot_limit_ms, keep_logits.

    python3 -m bench.traffic.lm knee --workload <cell> --rounds 2
    python3 -m bench.traffic.lm control --workload <cell> --seconds 20 --seeds 1 2 3

`knee`: the closed loop's completed requests a second with every slot
kept full, under the mix's lengths (from the root of a checkout, on the
card).  `control`: the cell run with the int8 control in the program's
place, judged as a run is judged; one JSON line a seed.
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from bench import harness, spans as bench_spans
from bench.reference import moonlight as ref
from bench.trace import DeviceTrace, GcPauses
from bench.traffic import schedule

KIND = "lm"
TICK_S = 0.002
# program spans that name an idle gap, innermost first
GAP_ORDER = ("sample", "lm_head", "mla", "dense_mlp", "moe")


def program_config(config: dict):
    """The program's configuration of `config`, checked against the
    published values the file states."""
    from repro_torch.configs.base import get_config
    cfg = get_config(config["arch"])
    want = {"n_layers": config["num_hidden_layers"], "d_model": config["hidden_size"],
            "n_heads": config["num_attention_heads"], "d_ff": config["intermediate_size"],
            "vocab": config["vocab_size"], "n_experts": config["n_routed_experts"],
            "top_k": config["num_experts_per_tok"], "kv_lora_rank": config["kv_lora_rank"],
            "qk_nope_head_dim": config["qk_nope_head_dim"],
            "qk_rope_head_dim": config["qk_rope_head_dim"], "v_head_dim": config["v_head_dim"],
            "moe_d_ff": config["moe_intermediate_size"],
            "n_shared_experts": config["n_shared_experts"],
            "first_dense_layers": config["first_k_dense_replace"],
            "routed_scale": config["routed_scaling_factor"],
            "norm_topk_prob": config["norm_topk_prob"], "norm_eps": config["rms_norm_eps"],
            "rope_theta": config["rope_theta"], "router_scoring": config["scoring_func"],
            "tie_embeddings": config["tie_word_embeddings"],
            "context_length": config["max_position_embeddings"]}
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise ValueError(f"{cfg.name}: {got} where the configuration states {want}")
    return cfg


def reference_arch(cfg) -> dict:
    """The published config's keys that the reference reads, from a
    program configuration (the CPU tests' narrow ones too)."""
    return {"num_attention_heads": cfg.n_heads, "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim, "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.norm_eps, "num_experts_per_tok": cfg.top_k,
            "norm_topk_prob": cfg.norm_topk_prob, "routed_scaling_factor": cfg.routed_scale}


def work_arch(cfg) -> dict:
    """The published config's keys that `bench/work/moonlight.py` reads."""
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "kv_lora_rank": cfg.kv_lora_rank, "qk_nope_head_dim": cfg.qk_nope_head_dim,
            "qk_rope_head_dim": cfg.qk_rope_head_dim, "v_head_dim": cfg.v_head_dim,
            "n_routed_experts": cfg.n_experts, "moe_intermediate_size": cfg.moe_d_ff,
            "num_hidden_layers": cfg.n_layers, "first_k_dense_replace": cfg.first_dense_layers,
            "intermediate_size": cfg.d_ff, "n_shared_experts": cfg.n_shared_experts,
            "vocab_size": cfg.vocab, "num_experts_per_tok": cfg.top_k}


def draw_params(cfg, seed: int, device):
    import torch
    from repro_torch.models import transformer
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    return transformer.init_params(cfg, gen, device=device)[0]


def int8_dequantized(params):
    """Each weight `quantize_tree` picks (by its default predicate) as its
    int8 words times their scales, in the weight's own dtype; a stacked
    leaf is quantized a layer at a time (its scales are per layer and
    output channel either way), so no float32 copy of a whole stack is
    made."""
    from repro_torch.core import ptq

    def one(path, leaf):
        if not ptq._default_predicate(path, leaf):
            return leaf
        parts = [leaf[i:i + 1] for i in range(leaf.shape[0])] if leaf.ndim >= 3 else [leaf]
        for part in parts:
            q = ptq.quantize_tree({"w": part}, predicate=lambda p, x: True)["w"]
            part.copy_(q.dequantize().to(part.dtype))
        return leaf
    return ptq._map_with_path(one, params)


def lengths(mix: dict, seed: int, n: int):
    """Prompt lengths log-uniform in [prompt_min, prompt_max], answer
    lengths uniform in [new_min, new_max], from the seed."""
    rng = np.random.default_rng([seed, 0x1A2])
    lo, hi = np.log(mix["prompt_min"]), np.log(mix["prompt_max"])
    prompt = np.minimum(np.floor(np.exp(rng.uniform(lo, hi, size=n))), mix["prompt_max"])
    new = rng.integers(mix["new_min"], mix["new_max"] + 1, size=n)
    return prompt.astype(np.int64), new.astype(np.int64)


def relative_gaps(got, want) -> np.ndarray:
    """||got - want|| / ||want|| of each logits row (float64)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)


class Run:
    def __init__(self, cell: harness.Cell, seed: int, seconds: float, *,
                 device: str = "cuda", control: bool = False, cfg=None):
        """`control` puts the int8 control in the program's place; `cfg`
        another program configuration (the CPU tests' narrow one)."""
        self.cell, self.seed, self.seconds, self.device = cell, seed, float(seconds), device
        self.mix = cell.mix
        self.control, self._cfg = control, cfg
        self.trace: dict | None = None
        self.program_spans, self.program_spans_evicted = None, None

    # -- set-up -----------------------------------------------------------------

    def _requests(self, n: int, seed: int, uid0: int = 0) -> list:
        from repro_torch.serving.engine import Request
        prompt, new = lengths(self.mix, seed, n)
        rng = np.random.default_rng([seed, 0x70C])
        return [Request(uid0 + i, rng.integers(0, self.cfg.vocab, size=int(s)).astype(np.int32),
                        max_new_tokens=int(m)) for i, (s, m) in enumerate(zip(prompt, new))]

    def setup(self) -> None:
        import torch
        from repro_torch.serving.engine import Engine
        mix = self.mix
        self.cfg = self._cfg if self._cfg is not None else program_config(self.cell.config)
        self.params = draw_params(self.cfg, self.seed, self.device)
        if self.control:
            self.params = int8_dequantized(self.params)
        self.engine = Engine(self.cfg, self.params, batch_size=mix["slots"],
                             max_len=mix["max_len"], device=self.device)
        self.times = schedule.arrivals(mix["process"], mix["rate_qps"], self.seconds,
                                       n_streams=mix["n_streams"], seed=self.seed)
        self.reqs = self._requests(len(self.times), self.seed)
        keep = np.random.default_rng([self.seed, 0x4EE9]).choice(
            len(self.reqs), size=min(mix["keep_logits"], len(self.reqs)), replace=False)
        for i in keep:
            self.reqs[i].keep_logits = True
        self.kept = sorted(int(i) for i in keep)
        # warm-up: the shortest and the longest prompt, then every slot decoding
        warm = self._requests(2 + mix["slots"], self.seed + 1, uid0=-10 ** 6)
        for r, s in zip(warm[:2], (mix["prompt_min"], mix["prompt_max"])):
            r.prompt, r.max_new_tokens = r.prompt[:1].repeat(s), 2
        for r in warm[2:]:
            r.prompt, r.max_new_tokens = r.prompt[:16], 3
        for r in warm:
            self.engine.submit(r)
        while self.engine.pending:
            self.engine.step()
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.stats0 = self.engine.stats()
        self.engine.work = {"prompts": [], "steps": []}
        gc.collect()
        gc.freeze()

    # -- the window ---------------------------------------------------------------

    def _replay(self) -> None:
        eng, reqs, times = self.engine, self.reqs, self.times
        n = len(times)
        self.late_s = np.zeros(n)
        t0 = time.perf_counter() + 0.001
        i = 0
        while True:
            now = time.perf_counter()
            while i < n and t0 + times[i] <= now:
                self.late_s[i] = now - (t0 + times[i])
                eng.submit(reqs[i], t_due=t0 + times[i])
                i += 1
            if eng.pending:
                eng.step()
            elif i < n:
                time.sleep(min(TICK_S, max(t0 + times[i] - now, 0.0)))
            else:
                break
        self.t0, self.t_end = t0, time.perf_counter()

    def window(self, trace: bool = False) -> None:
        dt = DeviceTrace() if trace else contextlib.nullcontext()
        pt = bench_spans.ProgramTrace(harness.ROOT / "build" / "flight") if trace \
            else contextlib.nullcontext()
        gcp = GcPauses()
        with dt, pt, gcp:
            self._replay()
        self.gc = gcp.summary()
        self.stats1 = self.engine.stats()
        self.work = self.engine.work
        if trace:
            s = dt.summary()
            labelled = self._labelled(pt.spans)
            s["idle_gaps"] = bench_spans.name_gaps(s.pop("gaps"), labelled,
                                                  "engine waiting for requests")
            self.trace = s
            self.program_spans, self.program_spans_evicted = pt.spans, pt.evicted

    @staticmethod
    def _labelled(spans):
        """Program spans by name, a prefill's layers apart from a decode
        step's, innermost first."""
        phase = {s.span_id: s.name for s in spans if s.name in ("lm_prefill", "lm_decode")}
        out = {}
        for s in spans:
            if s.name in GAP_ORDER:
                name = s.name if phase.get(s.parent_id) == "lm_decode" else "prefill " + s.name
            elif s.name in phase.values():
                name = s.name
            else:
                continue
            out.setdefault(name, []).append((s.t_start, s.t_end))
        order = [n for g in GAP_ORDER for n in (g, "prefill " + g)] + ["lm_prefill", "lm_decode"]
        return [(n, out.get(n, [])) for n in order]

    def release(self) -> None:
        """Free the engine and its cache on the card before the reference
        runs; the params stay for it (the control's are drawn again)."""
        import torch
        gc.unfreeze()
        self.engine = None
        for r in self.reqs:
            if r.keep_logits:
                r.logits = torch.stack(r.logits).cpu().numpy() if r.logits else None
        if self.control:
            self.params = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # -- results ---------------------------------------------------------------------

    @property
    def attempted(self) -> int:
        return len(self.times)

    def _answered(self) -> np.ndarray:
        return np.array([r.done and len(r.out) == r.max_new_tokens for r in self.reqs], bool)

    @property
    def failed(self) -> int:
        """Requests not answered in full."""
        return self.attempted - int(self._answered().sum())

    def _timings(self):
        ttft = np.array([(r.t_tokens[0] - r.t_due) * 1e3 if r.t_tokens else np.inf
                         for r in self.reqs])
        tpot = np.array([(r.t_tokens[-1] - r.t_tokens[0]) * 1e3 / (len(r.t_tokens) - 1)
                         if len(r.t_tokens) > 1 else 0.0 for r in self.reqs])
        return ttft, tpot

    def record(self) -> dict:
        mix = self.mix
        ttft, tpot = self._timings()
        in_time = (ttft <= mix["ttft_limit_ms"]) & (tpot <= mix["tpot_limit_ms"]) & \
            self._answered()
        c0, c1 = self.stats0, self.stats1
        engine = {k: c1[k] - c0[k] for k in ("submitted", "finished", "steps", "prefills",
                                              "prefill_tokens", "decode_tokens", "busy_s")}
        pct = lambda v: "/".join(f"{harness.nearest_rank(v, q):.1f}" for q in (50, 99))  # noqa: E731
        return {"kind": "fleet", "driver": KIND, "cell": self.cell.name,
                "config": self.cell.config, "seconds": self.seconds,
                "answered_in_time": int(in_time.sum()), "answered": int(self._answered().sum()),
                "lm": {"ttft_ms": ttft, "tpot_ms": tpot,
                       "n_tokens": [len(r.t_tokens) for r in self.reqs], "engine": engine,
                       "wall_s": self.t_end - self.t0, "work": self.work,
                       "arch": work_arch(self.cfg)},
                "trace": self.trace, "program_spans": self.program_spans,
                "program_spans_evicted": self.program_spans_evicted,
                "notes": f"gc during the window: {self.gc}; {self.attempted} requests, "
                         f"{int(in_time.sum())} in time; ttft p50/p99 {pct(ttft)} ms, "
                         f"tpot p50/p99 {pct(tpot)} ms; engine {engine}; replay "
                         f"{self.t_end - self.t0:.2f} s; client late p99 "
                         f"{harness.nearest_rank(self.late_s * 1e3, 99):.3f} ms"}

    def reference_logits(self) -> list:
        """The reference's logits of each kept request, teacher-forced on
        the program's answer, at the prefill's last position and every
        decode position."""
        import torch
        params = self.params
        if params is None:
            params = draw_params(self.cfg, self.seed, self.device)
        seqs, want = [], []
        for i in self.kept:
            r = self.reqs[i]
            seq = np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)]).astype(np.int64)
            seqs.append(torch.from_numpy(seq).to(self.device))
            want.append(torch.arange(len(r.prompt) - 1, len(seq), device=self.device))
        out = [x.cpu().numpy() for x in ref.logits(params, reference_arch(self.cfg), seqs, want)]
        self.params = None
        return out

    def check(self) -> list[harness.Compared]:
        limits = self.cell.workload["limits"]
        st = self.stats1
        answered = self._answered()
        out = [harness.Compared("unresolved", int((~answered).sum()), limits["unresolved"]),
               harness.Compared("ledger_unbalanced",
                                int(not (st["accounted"] and st["pending"] == 0
                                         and st["prefill_tokens"] - self.stats0["prefill_tokens"]
                                         == sum(len(r.prompt) for r in self.reqs)
                                         and st["decode_tokens"] - self.stats0["decode_tokens"]
                                         == sum(len(r.out) - 1 for r in self.reqs))),
                                limits["ledger_unbalanced"])]
        kept = [self.reqs[i] for i in self.kept]
        if not all(r.logits is not None and len(r.logits) == len(r.out) for r in kept):
            return out + [harness.Compared("kept_logits_missing", 1, 0)]
        want = self.reference_logits()
        V = self.cfg.vocab
        gaps = np.concatenate([relative_gaps(r.logits[:, :V], w) for r, w in zip(kept, want)])
        self.gaps = gaps
        return out + [harness.Compared("logits_rel_gap_max", float(gaps.max()),
                                       limits["logits_rel_gap_max"]),
                      harness.Compared("logits_rel_gap_median", float(np.median(gaps)),
                                       limits["logits_rel_gap_median"])]


# -- the knee and the control, on the card ----------------------------------------

def knee(cell: harness.Cell, seed: int, rounds: int, device: str = "cuda", cfg=None) -> list:
    """Closed loop: every slot kept full from a queue of requests of the
    mix's lengths, for `rounds` rounds of 2 x slots requests each; ->
    the completed requests a second of each round."""
    run = Run(cell, seed, 1.0, device=device, cfg=cfg)
    run.setup()
    out = []
    for k in range(rounds):
        reqs = run._requests(2 * run.mix["slots"], seed + 100 + k, uid0=10 ** 6 * (k + 1))
        eng = run.engine
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        while eng.pending:
            eng.step()
        wall = time.perf_counter() - t0
        out.append({"round": k, "requests": len(reqs), "wall_s": wall,
                    "closed_loop_rps": len(reqs) / wall,
                    "prompt_tokens": int(sum(len(r.prompt) for r in reqs)),
                    "new_tokens": int(sum(r.max_new_tokens for r in reqs))})
    run.release()
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import pathlib
    import sys
    ap = argparse.ArgumentParser(description="the LM cell's knee and control, on the card")
    ap.add_argument("what", choices=("knee", "control"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    root = pathlib.Path.cwd()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("lm: no CUDA card")
    cell = harness.cell(args.workload)
    card = torch.cuda.get_device_name(0)
    if args.what == "knee":
        for row in knee(cell, args.seeds[0], args.rounds):
            print(json.dumps(dict(row, workload=args.workload, card=card)), flush=True)
        return 0
    for seed in args.seeds:
        run = Run(cell, seed, args.seconds, control=True)
        run.setup()
        run.window()
        run.release()
        compared = run.check()
        print(json.dumps({"workload": args.workload, "seed": seed, "control": cell.config["control"],
                          "correct": all(c.ok for c in compared), "attempted": run.attempted,
                          "compared": {c.name: {"value": c.value, "limit": c.limit}
                                       for c in compared}, "card": card}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
