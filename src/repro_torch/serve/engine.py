"""LM serving with continuous batching: the LM half of the JAX package's
``serve/engine.py``.

A fixed pool of ``B`` decode slots; finished sequences are replaced from
the admission queue each step.  Per-slot state lives in one batched KV
cache; a joining request is prefilled alone (batch 1) and its cache is
copied into its slot.  As in the JAX engine, every slot decodes at one
shared position, the largest ``idx`` of the requests joined so far, so a
slot that joins later with a shorter prompt decodes past its own length.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..models.model import Model

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (P,) int32
    max_new: int = 16
    out: Optional[list] = None
    done: bool = False


class ServeEngine:
    def __init__(self, model: Model, params: dict, *, batch_slots: int = 4,
                 s_cache: int = 128, eos_id: int = -1):
        self.model = model
        self.params = params
        self.B = batch_slots
        self.s_cache = s_cache
        self.eos = eos_id
        self.queue: deque = deque()
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.remaining = np.zeros(batch_slots, np.int32)
        self._decode = model.decode_step
        self._prefill = lambda p, tokens: model.prefill(p, tokens, self.s_cache)
        self.cache = model.init_cache(batch_slots, s_cache)
        self.tokens = torch.zeros((batch_slots, 1), dtype=torch.long,
                                  device=model.device)
        self.steps = 0
        self.prefills = 0

    # -- admission ------------------------------------------------------------
    def submit(self, req: Request):
        req.out = []
        self.queue.append(req)

    def _join(self, slot: int, req: Request):
        """Prefill a single joining request and copy its cache into ``slot``
        of the batched cache."""
        prompt = torch.as_tensor(np.asarray(req.prompt)[None], dtype=torch.long,
                                 device=self.model.device)
        logits, cache1 = self._prefill(self.params, prompt)
        self.prefills += 1
        for big, small in zip(self.cache["layers"], cache1["layers"]):
            big["k"][slot] = small["k"][0]
            big["v"][slot] = small["v"][0]
        self.cache["idx"] = max(self.cache["idx"], cache1["idx"])
        tok = int(logits[0, -1].argmax())
        self.tokens[slot, 0] = tok
        self.slots[slot] = req
        self.remaining[slot] = req.max_new
        req.out.append(tok)

    # -- main loop -------------------------------------------------------------
    def step(self):
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                self._join(i, self.queue.popleft())
        if all(s is None for s in self.slots):
            return False
        logits, self.cache = self._decode(self.params, self.tokens, self.cache)
        nxt = logits[:, 0].argmax(-1)
        self.tokens = nxt[:, None]
        self.steps += 1
        for i, tok in enumerate(nxt.tolist()):
            req = self.slots[i]
            if req is None:
                continue
            req.out.append(tok)
            self.remaining[i] -= 1
            if self.remaining[i] <= 0 or tok == self.eos:
                req.done = True
                self.slots[i] = None
        return True

    def run(self, max_steps: int = 1000):
        while self.step() and self.steps < max_steps:
            pass
