"""Batched LM serving engine: decode with continuous slot reuse.

Port of `repro.serving.engine`, step for step: requests stream in, a
batch slot is assigned, the prompt is fed token by token through
`decode_step`, the whole batch decodes in lockstep (one step per token),
finished slots are freed and refilled without draining the batch.  As in
the reference, every slot decodes at one shared position, the largest of
the slots' positions, and a refilled slot's cache is not cleared: its
tokens are written at the shared position and attend over the previous
request's K/V before it (`ROADMAP.md` §3).

The cache is updated in place (the reference donates it to the step).
Float weights that every use casts to `cfg.dtype` (linear and embedding
weights and biases) are cast once, when the engine is built: the same
values each step, without a cast a step.  `QuantTensor` params (the
paper's int8 deployment flow, `core/ptq.quantize_tree`) are served as
they are and dequantize on use.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.ptq import QuantTensor
from repro_torch.models import model as M
from repro_torch.models import transformer


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


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
