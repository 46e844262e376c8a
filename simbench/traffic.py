"""The one generator of the benchmark's traffic: depth rows and arrivals.

A traffic mix is a JSON file ``simbench/traffic/<mix>.json``. Its ``depths``
say how rows are drawn; every tenant of the mix, and the warm-up, draws from a
stream of its own, and the streams never share a row:

* ``{"kind": "grid", "lo": a, "hi": b}``: the grid of depths a..b on every
  FIFO, each row once, in an order permuted by the seed (a designer's
  exhaustive sweep, sent in random order). Stream j of J takes every J-th
  row of that order from its j-th, so no row repeats anywhere in a run
  that takes fewer rows than the grid has; a stream that has sent its
  share starts it over (the rows repeat, the streams still share none).
* ``{"kind": "latin", "lo": a, "hi": b}``: the same grid, each row once, in
  groups of ``b - a + 1`` rows in which every FIFO's column holds every
  depth once: each group is a Latin hypercube sample of the grid, as
  ``scipy.stats.qmc.LatinHypercube`` draws one. Which groups a stream gets,
  in what order, and how values pair up inside a group follow the seed; so
  every run of a group's length holds the same depths, whatever the seed.
  Stream j of J takes every J-th group from its j-th, and starts its share
  over as a grid stream does.
* ``{"kind": "box", "lo": [a_0, ...], "hi": [b_0, ...]}``: FIFO f's depth
  ranges over a_f..b_f (0 allowed; a number in place of a list stands for
  every FIFO), as a designer sizes each FIFO on a scale of its own. Each row
  of the box once, in an order permuted by the seed, which the generator
  never holds: position p of the order is the p-th index of the box through
  a seeded bijection of the box's index space (a Feistel network over its
  bits, cycle-walking back into the box), so a draw costs memory for the
  rows drawn, whatever the box's size. The streams share the order as grid
  streams do.

Open-loop arrivals (``arrivals(...)``) are the quantiles of an exponential
distribution at the tenant's rate, in an order permuted by the seed: every
seed offers the same gaps, so seeds change the order of the work and not
its amount.
"""
from __future__ import annotations

import hashlib
import math
import threading
from typing import Dict, List

import numpy as np

_SALT = {"rows": 0x5EED_0001, "arrivals": 0x5EED_0002, "check": 0x5EED_0003}


def rng_for(seed: int, what: str, index: int = 0) -> np.random.Generator:
    """A generator for one purpose of a run, from the run's seed (any
    non-negative integer, also past 2**32)."""
    return np.random.default_rng([int(seed), _SALT[what], int(index)])


class DepthRows:
    """Disjoint streams of depth rows for one run."""

    def __init__(self, spec: Dict, n_fifos: int, seed: int, n_streams: int):
        self.kind = spec["kind"]
        self.F = int(n_fifos)
        self.J = int(n_streams)
        self.taken = [0] * self.J
        self._lock = threading.Lock()
        if self.kind == "box":
            self._box(spec, seed)
            return
        self.lo, self.hi = int(spec["lo"]), int(spec["hi"])
        if not 1 <= self.lo <= self.hi:
            raise ValueError(f"depths need 1 <= lo <= hi, got {spec}")
        self.side = self.hi - self.lo + 1
        if self.kind not in ("grid", "latin"):
            raise ValueError(f"unknown depth kind {self.kind!r}")
        size = self.side ** self.F
        if size > 1 << 24:
            raise ValueError(f"a grid of {size} rows is too large to order")
        rng = rng_for(seed, "rows")
        if self.kind == "grid":
            self.size = size
            self.order = rng.permutation(size)
        else:
            self.groups = size // self.side
            self.order = rng.permutation(self.groups)
            self.sigma = np.stack([rng.permutation(self.side)
                                   for _ in range(self.F)])

    def take(self, stream: int, k: int) -> np.ndarray:
        """The next ``k`` rows of ``stream``, as a (k, F) int64 matrix."""
        with self._lock:
            start = self.taken[stream]
            self.taken[stream] = start + k
        if self.kind == "box":
            return self._box_rows(stream, start, k)
        pos = np.arange(start, start + k, dtype=np.int64)
        if self.kind == "grid":
            return self._grid(stream, pos)
        return self._latin(stream, pos)

    def _share(self, stream: int, pos: np.ndarray, n: int) -> np.ndarray:
        """Positions in an order of ``n`` of the ``pos``-th items of
        ``stream``'s share (every J-th from its ``stream``-th), round and
        round."""
        if stream >= n:
            raise ValueError(f"a grid of {n} items has none for stream "
                             f"{stream}")
        return stream + self.J * (pos % -(-(n - stream) // self.J))

    def _grid(self, stream: int, pos: np.ndarray) -> np.ndarray:
        idx = self.order[self._share(stream, pos, self.size)]
        rows = np.empty((len(idx), self.F), np.int64)
        for f in range(self.F - 1, -1, -1):     # the last FIFO's digit first
            idx, rows[:, f] = np.divmod(idx, self.side)
        return rows + self.lo

    def _latin(self, stream: int, pos: np.ndarray) -> np.ndarray:
        q, i = pos // self.side, pos % self.side
        g = self.order[self._share(stream, q, self.groups)]
        rows = np.empty((len(pos), self.F), np.int64)
        # row i of group g: column f holds sigma_f(i + h_f(g)), where
        # h_1.. are g's digits in base side and h_0 = 0
        for f in range(self.F):
            h = 0 if f == 0 else (g // self.side ** (f - 1)) % self.side
            rows[:, f] = self.sigma[f][(i + h) % self.side] + self.lo
        return rows

    # -- box ----------------------------------------------------------------
    _ROUNDS = 8

    def _box(self, spec: Dict, seed: int) -> None:
        lo, hi = (np.broadcast_to(np.asarray(spec[k], np.int64), (self.F,))
                  for k in ("lo", "hi"))
        if not (0 <= lo).all() or not (lo <= hi).all():
            raise ValueError(f"depths need 0 <= lo <= hi per FIFO, got {spec}")
        self.lo = [int(x) for x in lo]
        self.sides = [int(b - a + 1) for a, b in zip(lo, hi)]
        self.size = math.prod(self.sides)          # a Python int: any size
        if self.J > self.size:
            raise ValueError(f"a box of {self.size} rows cannot feed "
                             f"{self.J} streams")
        self.bits = max((self.size - 1).bit_length(), 2)
        key = rng_for(seed, "rows").bytes(16)
        self._keys = [key + bytes([i]) for i in range(self._ROUNDS)]

    def _feistel(self, x: int) -> int:
        """One pass of the seeded bijection of [0, 2**bits)."""
        lb = self.bits // 2
        widths = (lb, self.bits - lb)               # of (left, right)
        left, right = x >> widths[1], x & ((1 << widths[1]) - 1)
        for i, key in enumerate(self._keys):
            wl, wr = widths[i % 2], widths[1 - i % 2]
            h = hashlib.blake2b(right.to_bytes(wr // 8 + 1, "little"),
                                digest_size=wl // 8 + 1, key=key).digest()
            f = int.from_bytes(h, "little") & ((1 << wl) - 1)
            left, right = right, left ^ f
        return (left << widths[1 - self._ROUNDS % 2]) | right

    def _box_rows(self, stream: int, start: int, k: int) -> np.ndarray:
        share = -(-(self.size - stream) // self.J)
        rows = np.empty((k, self.F), np.int64)
        for i in range(k):
            idx = self._feistel(stream + self.J * ((start + i) % share))
            while idx >= self.size:                 # walk back into the box
                idx = self._feistel(idx)
            for f in range(self.F - 1, -1, -1):     # the last FIFO's digit
                idx, rows[i, f] = divmod(idx, self.sides[f])
        return rows + np.asarray(self.lo, np.int64)


def arrivals(rate_per_s: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (seconds from the window's start) of an open loop at
    ``rate_per_s`` that cover ``seconds`` with room to spare."""
    n = max(int(math.ceil(rate_per_s * seconds * 1.5)) + 16, 1)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate_per_s
    rng_for(seed, "arrivals").shuffle(gaps)
    return np.cumsum(gaps)


def streams(mix: Dict) -> List[str]:
    """Stream names of a mix: its tenants in order, then the warm-up."""
    return [t["name"] for t in mix.get("tenants", [{"name": "sweep"}])] + [
        "warmup"]
