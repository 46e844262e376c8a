"""Batched serving engine: prefill, then decode in lockstep.

The port of the reference's ``repro.serve.engine``, behaviour for
behaviour.  ``ServeEngine.prefill`` feeds the prompt token by token
through the decode step, as the reference does (the full-sequence prefill
step with the flash kernel is ``train.step.make_prefill_step``).
``ContinuousBatchingEngine`` admits requests into free slots between
decode steps; like the reference, ``admit`` feeds the new prompt through
full-batch decode steps, so every active slot's position advances and
takes a K/V row on each of them (ROADMAP queue 1 item 10 records it).
For a recurrent (xlstm) cache ``admit`` likewise resets only ``pos``, so a
request admitted into a freed slot starts from the recurrent state the
previous request left there: the reference does the same, and the port
keeps it as the spec (ROADMAP queue 1 item 10, faults of the reference).
The decode step updates the cache, K/V or recurrent state, in place.

The engine runs on the parameters' device; tokens cross to the host once
per step, for the argmax's bookkeeping.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models import api


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """[B, 1, V] logits -> [B, 1] int32 argmax tokens."""
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, batch: int, max_len: int):
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.device = params.device

    def _decode(self, tokens, cache):
        return api.decode_step(self.params, tokens, cache, self.cfg)

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int32)).to(self.device)

    def prefill(self, prompts: np.ndarray):
        """Sequential prefill through the decode path."""
        B, S = prompts.shape
        cache = api.init_cache(self.cfg, B, self.max_len,
                               device=self.device)
        logits = None
        for t in range(S):
            logits, cache = self._decode(self._tokens(prompts[:, t:t + 1]),
                                         cache)
        return logits, cache

    def generate(self, prompts: np.ndarray, gen_len: int) -> np.ndarray:
        logits, cache = self.prefill(prompts)
        tok = _greedy(logits)
        out = [tok.cpu().numpy()]
        for _ in range(gen_len - 1):
            logits, cache = self._decode(tok, cache)
            tok = _greedy(logits)
            out.append(tok.cpu().numpy())
        return np.concatenate(out, axis=1)


class ContinuousBatchingEngine(ServeEngine):
    """Slot-based continuous batching: new requests are admitted into freed
    slots between decode steps.  Per-slot position and done bookkeeping
    lives on the host."""

    def __init__(self, cfg: ArchConfig, params, batch: int, max_len: int,
                 eos_id: int = 0):
        super().__init__(cfg, params, batch, max_len)
        self.eos_id = eos_id
        self.cache = api.init_cache(cfg, batch, max_len, device=self.device)
        self.active = np.zeros(batch, bool)
        self.slot_tokens = np.zeros((batch, 1), np.int32)
        self.generated = [[] for _ in range(batch)]
        self.remaining = np.zeros(batch, np.int64)
        self.completed = []

    def _free_slots(self):
        return [i for i in range(self.batch) if not self.active[i]]

    def admit(self, prompt: np.ndarray, gen_len: int) -> bool:
        """Admit one request into a free slot; its prompt runs through
        full-batch decode steps (stale K/V past a slot's position is
        masked out by the causal validity test)."""
        free = self._free_slots()
        if not free:
            return False
        slot = free[0]
        self.cache["pos"][slot] = 0
        logits = None
        for t in prompt:
            self.slot_tokens[slot, 0] = t
            logits, self.cache = self._decode(self._tokens(self.slot_tokens),
                                              self.cache)
        self.generated[slot] = []
        self.remaining[slot] = gen_len
        self.active[slot] = True
        self.slot_tokens[slot, 0] = int(torch.argmax(logits[slot, -1]))
        return True

    def step(self) -> int:
        """One lockstep decode across all slots; returns #completed."""
        if not self.active.any():
            return 0
        logits, self.cache = self._decode(self._tokens(self.slot_tokens),
                                          self.cache)
        nxt = _greedy(logits)[:, 0].cpu().numpy()
        done_now = 0
        for i in range(self.batch):
            if not self.active[i]:
                continue
            self.generated[i].append(int(self.slot_tokens[i, 0]))
            self.remaining[i] -= 1
            self.slot_tokens[i, 0] = int(nxt[i])
            if self.remaining[i] <= 0:
                self.active[i] = False
                self.completed.append((i, list(self.generated[i])))
                done_now += 1
        return done_now

    def run(self, requests, gen_len: int):
        """Drive admission + decode until every request completes."""
        pending = list(requests)
        while pending or self.active.any():
            while pending and self._free_slots():
                self.admit(pending.pop(0), gen_len)
            self.step()
        return list(self.completed)
