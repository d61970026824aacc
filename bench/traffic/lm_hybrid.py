"""LM traffic for a model whose layers keep recurrent state beside a
latent cache (the program's kda_mla_moe family, Kimi Linear), one card.

The run is `bench/traffic/lm.py`'s, step for step: the params drawn on the
card from the seed, the engine built with its slot cache (here the MLA
layers' latent rows and the KDA layers' float32 state and convolution
tail side by side), open-loop arrivals submitted when due, the engine
stepped while it has work, the kept requests' logits compared after the
window with the plain float32 reference.  What differs:

- the program's configuration is checked against the keys of
  `model_type: kimi_linear` that the configuration file states, with this
  device's share of the experts (`num_experts`, listed in `reduced`) and
  the router's width under `deployment`;
- the reference is `bench/reference/kimi_linear.py`, KDA's recurrence in
  its chunked form;
- the record's work counts are `bench/work/kimi_linear.py`'s keys;
- the traced window names idle gaps by the `kda` spans too, and keeps the
  KDA kernels' device time (`kda_chunk_prefill_kernel`,
  `kda_decode_step_kernel`), read from every device event by name.

Mix parameters as `lm.py`'s.

    python3 -m bench.traffic.lm_hybrid knee --workload <cell> --rounds 2
    python3 -m bench.traffic.lm_hybrid control --workload <cell> --seconds 20 --seeds 1 2 3
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from bench import harness, spans as bench_spans
from bench.reference import kimi_linear as ref
from bench.trace import DeviceTrace, GcPauses
from bench.traffic import lm

KIND = "lm_hybrid"
# program spans that name an idle gap, innermost first
GAP_ORDER = ("sample", "lm_head", "kda", "mla", "dense_mlp", "moe")
KDA_KERNELS = ("kda_chunk_prefill_kernel", "kda_decode_step_kernel")


def program_config(config: dict):
    """The program's configuration of `config`, checked against the
    published values the file states and the deployment's share."""
    from repro_torch.configs.base import get_config
    cfg = get_config(config["arch"])
    la, dep = config["linear_attn_config"], config["deployment"]
    want = {"n_layers": config["num_hidden_layers"], "d_model": config["hidden_size"],
            "n_heads": config["num_attention_heads"], "d_ff": config["intermediate_size"],
            "vocab": config["vocab_size"], "n_held": config["num_experts"],
            "n_experts": dep["router_experts"], "expert_offset": dep["expert_offset"],
            "top_k": config["num_experts_per_token"], "kv_lora_rank": config["kv_lora_rank"],
            "qk_nope_head_dim": config["qk_nope_head_dim"],
            "qk_rope_head_dim": config["qk_rope_head_dim"], "v_head_dim": config["v_head_dim"],
            "mla_rope": not config["mla_use_nope"],
            "moe_d_ff": config["moe_intermediate_size"],
            "n_shared_experts": config["num_shared_experts"],
            "first_dense_layers": config["first_k_dense_replace"],
            "routed_scale": config["routed_scaling_factor"],
            "norm_topk_prob": config["moe_renormalize"], "norm_eps": config["rms_norm_eps"],
            "router_scoring": config["moe_router_activation_func"],
            "tie_embeddings": config["tie_word_embeddings"],
            "context_length": config["model_max_length"],
            "kda_layers": tuple(i - 1 for i in la["kda_layers"]),
            "kda_heads": la["num_heads"], "kda_head_dim": la["head_dim"],
            "short_conv_kernel_size": la["short_conv_kernel_size"]}
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise ValueError(f"{cfg.name}: {got} where the configuration states {want}")
    return cfg


def _linear_attn(cfg) -> dict:
    return {"kda_layers": [i + 1 for i in cfg.kda_layers], "num_heads": cfg.kda_heads,
            "head_dim": cfg.kda_head_dim, "short_conv_kernel_size": cfg.short_conv_kernel_size}


def reference_arch(cfg) -> dict:
    """The published config's keys that the reference reads, from a
    program configuration (the CPU tests' narrow ones too)."""
    return {"num_attention_heads": cfg.n_heads, "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim, "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "rms_norm_eps": cfg.norm_eps,
            "num_experts_per_token": cfg.top_k, "moe_renormalize": cfg.norm_topk_prob,
            "routed_scaling_factor": cfg.routed_scale, "expert_offset": cfg.expert_offset,
            "linear_attn_config": _linear_attn(cfg)}


def work_arch(cfg) -> dict:
    """The published config's keys that `bench/work/kimi_linear.py` reads."""
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "kv_lora_rank": cfg.kv_lora_rank, "qk_nope_head_dim": cfg.qk_nope_head_dim,
            "qk_rope_head_dim": cfg.qk_rope_head_dim, "v_head_dim": cfg.v_head_dim,
            "num_experts": cfg.n_held, "router_experts": cfg.n_experts,
            "moe_intermediate_size": cfg.moe_d_ff, "num_hidden_layers": cfg.n_layers,
            "first_k_dense_replace": cfg.first_dense_layers,
            "intermediate_size": cfg.d_ff, "num_shared_experts": cfg.n_shared_experts,
            "vocab_size": cfg.vocab, "num_experts_per_token": cfg.top_k,
            "linear_attn_config": _linear_attn(cfg)}


def kda_device(events) -> dict:
    """Seconds and calls of each KDA kernel among a device trace's events
    (name, start, end), matched by name."""
    out = {n: {"s": 0.0, "calls": 0} for n in KDA_KERNELS}
    for name, s, e in events:
        for n in KDA_KERNELS:
            if n in name:
                out[n]["s"] += e - s
                out[n]["calls"] += 1
    return out


class Run(lm.Run):
    def setup(self) -> None:
        if self._cfg is None:
            self._cfg = program_config(self.cell.config)
        self.kda = None
        super().setup()

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
            s["idle_gaps"] = bench_spans.name_gaps(s.pop("gaps"), self._labelled(pt.spans),
                                                  "engine waiting for requests")
            self.trace = s
            self.kda = kda_device(dt.events)
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

    def record(self) -> dict:
        rec = super().record()
        rec["driver"] = KIND
        rec["lm"]["arch"] = work_arch(self.cfg)
        rec["lm"]["kda_device"] = self.kda
        c0, c1 = self.stats0, self.stats1
        kda = {k: c1[k] - c0[k] for k in ("state_resets", "kda_launches")}
        rec["lm"]["engine"].update(kda)
        rec["notes"] += f"; KDA {kda}"
        return rec

    def reference_logits(self) -> list:
        """The reference's logits of each kept request (KDA's recurrence in
        its chunked form), teacher-forced on the program's answer, at the
        prefill's last position and every decode position."""
        import torch
        params = self.params
        if params is None:
            params = lm.draw_params(self.cfg, self.seed, self.device)
        seqs, want = [], []
        for i in self.kept:
            r = self.reqs[i]
            seq = np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)]).astype(np.int64)
            seqs.append(torch.from_numpy(seq).to(self.device))
            want.append(torch.arange(len(r.prompt) - 1, len(seq), device=self.device))
        out = [x.cpu().numpy() for x in ref.logits(params, reference_arch(self.cfg), seqs, want,
                                                   chunked=True)]
        self.params = None
        return out


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
    import os
    import pathlib
    import sys
    ap = argparse.ArgumentParser(description="the hybrid LM cell's knee and control, on the card")
    ap.add_argument("what", choices=("knee", "control"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    root = pathlib.Path.cwd()
    sys.path[:0] = [str(root), str(root / "src")]
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("lm_hybrid: no CUDA card")
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
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": cell.config["control"],
                          "correct": all(c.ok for c in compared), "attempted": run.attempted,
                          "compared": {c.name: {"value": c.value, "limit": c.limit}
                                       for c in compared}, "card": card}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
