"""Deterministic synthetic token pipeline — shard-aware and checkpointable.

A real deployment would stream tokenized shards from object storage; the
interface here is identical (``state()`` / ``restore()`` for exact resume,
per-host sharding by ``host_id``/``num_hosts``) but the source is a counter-
seeded PRNG so experiments are reproducible bit-for-bit and runnable offline.
The iterator yields host-local numpy batches; the port's
``launch/train.py`` moves them to its one device as tensors.

The PyTorch port's copy of ``repro.data.pipeline`` (numpy only): the same
seed, step and host give the reference's batches bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_tokens: int = 0
    d_model: int = 0


class SyntheticTokenStream:
    """Counter-based deterministic stream: batch i is a pure function of
    (seed, i, host), so restart-after-failure resumes exactly."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        self._step = 0

    # ---- checkpointable iterator state ----
    def state(self) -> Dict[str, int]:
        return {"step": self._step, "seed": self.cfg.seed,
                "host_id": self.host_id}

    def restore(self, state: Dict[str, int]) -> None:
        assert state["seed"] == self.cfg.seed, "seed mismatch on restore"
        self._step = int(state["step"])

    # ---- iteration ----
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 4096 + self.host_id)

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = self._rng(self._step)
        self._step += 1
        c = self.cfg
        tokens = rng.integers(0, c.vocab_size,
                              size=(self.local_batch, c.seq_len),
                              dtype=np.int32)
        batch = {
            "tokens": tokens,
            # next-token targets (synthetic stream: shifted tokens)
            "targets": np.roll(tokens, -1, axis=1),
        }
        if c.frontend_tokens:
            batch["frontend"] = rng.standard_normal(
                (self.local_batch, c.frontend_tokens, c.d_model),
                dtype=np.float32) * 0.02
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
