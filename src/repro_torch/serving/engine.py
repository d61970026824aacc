"""Batched LM serving engine: decode with continuous slot reuse.

Port of `repro.serving.engine`, step for step: requests stream in, a
batch slot is assigned, the prompt is fed token by token through
`decode_step`, the whole batch decodes in lockstep (one step per token),
finished slots are freed and refilled without draining the batch.  As in
the reference, every slot decodes at one shared position, the largest of
the slots' positions, and a refilled slot's cache is not cleared: its
tokens are written at the shared position and attend over the previous
request's K/V before it (`ROADMAP.md` §3).

That is `submit_and_run`.  `submit` and `step` are the port's own
step-granular path, for the families whose `decode_step` takes a
position a slot (`transformer.PER_SLOT_POSITIONS`): requests are
submitted while the engine runs, each stamped with its due time; at each
step boundary the queued requests are prefilled into free slots, one
prompt a `prefill` call written into its slot's cache rows; then one
decode step runs over the slots up to the highest active one, each at
its own position (a free slot among them decodes a dummy token at
position 0, which nothing reads); finished slots are freed and refilled
at the next step.  With the port's tracer on, each prefill is an
`lm_prefill` span and each decode step an `lm_decode` span, whose
children are the model's layer spans, then `sample` (argmax and copy
back).  `stats()` holds the path's counters; for a model with recurrent
state (kda_mla_moe) also `state_resets`, the slots whose state a prefill
wrote from zero, and `kda_launches`, the KDA kernels launched by this
engine's calls (0 on the CPU, where their plain versions run).

The cache is updated in place (the reference donates it to the step).
Float weights that every use casts to `cfg.dtype` (linear and embedding
weights and biases) are cast once, when the engine is built: the same
values each step, without a cast a step.  `QuantTensor` params (the
paper's int8 deployment flow, `core/ptq.quantize_tree`) are served as
they are and dequantize on use.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.ptq import QuantTensor
from repro_torch.kernels import launches
from repro_torch.models import model as M
from repro_torch.models import transformer
from repro_torch.obs import trace


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # the step-granular path: the due time the request carries, the host
    # time at which each output token was read back, and with
    # `keep_logits` each token's logits row (float32, on the device)
    t_due: float = 0.0
    t_tokens: list = dataclasses.field(default_factory=list)
    keep_logits: bool = False
    logits: list = dataclasses.field(default_factory=list)


def serving_params(cfg: ArchConfig, params, device: torch.device):
    """`params` on `device`, with each linear/embedding weight and bias
    ("w"/"b" leaves outside the norms and the MoE router, all read only
    through a cast to `cfg.dtype`) cast to `cfg.dtype` once."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, QuantTensor):
            return QuantTensor(node.q.to(device), node.scale.to(device))
        cast = path[-1] in ("w", "b") and not any(
            "norm" in k or k == "router" for k in path)
        return node.to(device, cfg.dtype if cast else node.dtype)
    return walk(params, ())


class Engine:
    def __init__(self, cfg: ArchConfig, params, *, batch_size: int = 4,
                 max_len: int = 256, greedy: bool = True, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = serving_params(cfg, params, self.device)
        self.B, self.T = batch_size, max_len
        self.model = M.build(cfg)
        self.decode = self.model.decode_step
        self.cache = transformer.zeros_cache(cfg, batch_size, max_len, device=self.device)
        self.pos = np.zeros(batch_size, np.int32)       # per-slot next pos
        self.slot_req: list[Request | None] = [None] * batch_size
        self.greedy = greedy
        self.queue: collections.deque[Request] = collections.deque()
        self.counters = dict(submitted=0, finished=0, steps=0, prefills=0,
                             prefill_tokens=0, decode_tokens=0, busy_s=0.0)
        self.recurrent = "kda_state" in self.cache
        if self.recurrent:
            self.counters.update(state_resets=0, kda_launches=0)
        # each prefill's prompt length and each decode step's (active
        # slots, their summed context): the work a step did, for its bound
        self.work: dict[str, list] = {"prompts": [], "steps": []}

    @torch.inference_mode()
    def submit_and_run(self, requests: list[Request]) -> list[Request]:
        """Run a workload of requests to completion with continuous batching."""
        queue = list(requests)
        tokens = np.zeros((self.B, 1), np.int32)
        pending_prompt: dict[int, list[int]] = {}

        def assign(slot: int, req: Request):
            self.slot_req[slot] = req
            self.pos[slot] = 0
            pending_prompt[slot] = list(req.prompt)

        # initial fill
        for slot in range(self.B):
            if queue:
                assign(slot, queue.pop(0))

        steps = 0
        vocab = self.cfg.vocab
        while any(r is not None for r in self.slot_req):
            # this step's token per slot: the next prompt token (prompt
            # phase) or the last generated token (decode phase)
            for slot, req in enumerate(self.slot_req):
                if req is None:
                    tokens[slot, 0] = 0
                elif pending_prompt[slot]:
                    tokens[slot, 0] = pending_prompt[slot].pop(0)
                else:
                    tokens[slot, 0] = req.out[-1] if req.out else 0
            # lockstep batch decode at one shared position, the slots' max
            pos = int(max(self.pos))
            logits, self.cache = self.decode(self.params, self.cache,
                                             torch.from_numpy(tokens).to(self.device), pos)
            nxt = torch.argmax(logits[:, :vocab], dim=-1).cpu().numpy()
            for slot, req in enumerate(self.slot_req):
                if req is None:
                    continue
                self.pos[slot] += 1
                if not pending_prompt[slot]:            # generating
                    req.out.append(int(nxt[slot]))
                    if len(req.out) >= req.max_new_tokens:
                        req.done = True
                        self.slot_req[slot] = None      # free slot
                        if queue:                        # continuous refill
                            assign(slot, queue.pop(0))
            steps += 1
            if steps > 16384:
                raise RuntimeError("engine wedged")
        return requests

    # -- the step-granular path ------------------------------------------------

    def _check_per_slot(self) -> None:
        if self.cfg.family not in transformer.PER_SLOT_POSITIONS:
            raise ValueError(f"family {self.cfg.family!r} decodes every slot at one shared "
                             "position; the step-granular path needs one a slot")

    def submit(self, req: Request, t_due: float | None = None) -> None:
        """Queue `req`, due at `t_due` (perf_counter seconds; now if None),
        for the next step boundary."""
        self._check_per_slot()
        if len(req.prompt) + req.max_new_tokens - 1 > self.T:
            raise ValueError(f"request {req.uid}: {len(req.prompt)} prompt tokens and "
                             f"{req.max_new_tokens} new ones pass max_len {self.T}")
        req.t_due = time.perf_counter() if t_due is None else t_due
        self.queue.append(req)
        self.counters["submitted"] += 1

    @property
    def pending(self) -> int:
        """Requests submitted and not finished: queued or in a slot."""
        return len(self.queue) + sum(r is not None for r in self.slot_req)

    def stats(self) -> dict:
        """The step-granular path's counters; `accounted` when every request
        submitted is finished or pending, and every token fed is counted."""
        c = dict(self.counters, pending=self.pending)
        c["accounted"] = c["submitted"] == c["finished"] + c["pending"]
        return c

    def _kda_launched(self) -> int:
        if not self.recurrent:
            return 0
        n = launches()
        return n.get("kda_chunk_prefill", 0) + n.get("kda_decode_step", 0)

    def _finish(self, slot: int, done: list) -> None:
        req = self.slot_req[slot]
        req.done = True
        self.slot_req[slot] = None
        self.counters["finished"] += 1
        done.append(req)

    def _prefill(self, req: Request, slot: int, tr, done: list) -> None:
        S = len(req.prompt)
        span = tr.start("lm_prefill", str(req.uid), uid=req.uid, tokens=S) if tr else None
        tokens = torch.from_numpy(np.asarray(req.prompt, np.int64)[None]).to(self.device)
        n0 = self._kda_launched()
        logits, _ = self.model.prefill(self.params, {"tokens": tokens}, cache=self.cache,
                                       slots=[slot], span=span)
        if self.recurrent:
            self.counters["state_resets"] += 1
            self.counters["kda_launches"] += self._kda_launched() - n0
        nxt = int(torch.argmax(logits[0, :self.cfg.vocab]))
        t = time.perf_counter()
        if span is not None:
            transformer.tag_expert_load(span)
            tr.end(span)
        if req.keep_logits:
            req.logits.append(logits[0])
        req.out.append(nxt)
        req.t_tokens.append(t)
        self.counters["prefills"] += 1
        self.counters["prefill_tokens"] += S
        self.work["prompts"].append(S)
        self.slot_req[slot] = req
        self.pos[slot] = S
        if len(req.out) >= req.max_new_tokens:
            self._finish(slot, done)

    def _decode(self, active: list[int], tr) -> None:
        n = active[-1] + 1
        tokens = np.zeros((n, 1), np.int64)
        pos = np.zeros(n, np.int64)
        for s in active:
            tokens[s, 0] = self.slot_req[s].out[-1]
            pos[s] = self.pos[s]
        span = tr.start("lm_decode", "engine", active=len(active),
                        max_pos=int(pos.max())) if tr else None
        cache = {k: v[:, :n] for k, v in self.cache.items()}
        n0 = self._kda_launched()
        logits, _ = self.model.decode_step(self.params, cache,
                                           torch.from_numpy(tokens).to(self.device), pos,
                                           span=span)
        if self.recurrent:
            self.counters["kda_launches"] += self._kda_launched() - n0
        t_sample = time.perf_counter()
        nxt = torch.argmax(logits[:, :self.cfg.vocab], dim=-1).cpu().numpy()
        t = time.perf_counter()
        if span is not None:
            tr.emit("sample", span.trace_id, t_sample, t, parent=span)
            transformer.tag_expert_load(span)
            tr.end(span)
        for s in active:
            req = self.slot_req[s]
            if req.keep_logits:
                req.logits.append(logits[s].clone())
            req.out.append(int(nxt[s]))
            req.t_tokens.append(t)
            self.pos[s] += 1
        self.counters["decode_tokens"] += len(active)
        self.work["steps"].append((len(active), int(pos[active].sum()) + len(active)))

    @torch.inference_mode()
    def step(self) -> list[Request]:
        """One step boundary: prefill what is queued into free slots, then
        one decode step over the active slots.  -> the requests it
        finished."""
        self._check_per_slot()
        t0 = time.perf_counter()
        tr = trace.get()
        done: list[Request] = []
        for slot in range(self.B):
            if not self.queue:
                break
            if self.slot_req[slot] is None:
                self._prefill(self.queue.popleft(), slot, tr, done)
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if active:
            self._decode(active, tr)
            for s in active:
                if len(self.slot_req[s].out) >= self.slot_req[s].max_new_tokens:
                    self._finish(s, done)
        self.counters["steps"] += 1
        self.counters["busy_s"] += time.perf_counter() - t0
        return done
