"""FIFO read/write timing tables — data structure (D) of paper Fig. 7.

PyTorch-port copy of ``repro.core.fifo`` (host logic, numpy tables).
Each FIFO keeps the ordered sequence of committed write/read events (node
indices into the simulation graph) plus the value payloads in flight.  The
tables answer the Perf Sim orchestrator's resolution questions of Table 2:

  * NB write, w-th write, FIFO size S:  succeeds iff  w <= S  or the
    (w-S)-th read committed *strictly before* the write's cycle.
  * NB read, r-th read: succeeds iff the r-th write committed strictly
    before the read's cycle.

The strict-before rule is what makes functionality cycle-dependent for
Type C designs: comparing *hardware* cycles recorded here — not executor
scheduling order — is the paper's core correctness mechanism.

Storage is growable numpy arrays (amortized-doubling append) rather than
Python lists: commit times per FIFO side are nondecreasing (each side is
driven by a single module whose clock only advances), so occupancy queries
are ``searchsorted`` binary searches, and incremental/batched re-simulation
(``core/incremental.py``, ``core/dse.py``) reads the tables as numpy views
without per-element conversion.  The views are only valid until the next
commit (growth reallocates the buffer) — copy them to hold past one.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Optional

import numpy as np

_EMPTY_I64 = np.empty(0, dtype=np.int64)   # shared placeholder for shells


class FifoTable:
    """One FIFO's committed read/write event tables (paper Fig. 7, (D)).

    Units: ``*_times`` are hardware **cycles** (1-based commit cycles);
    sequence numbers (``w``/``r`` arguments) are 1-based **event** counts on
    this FIFO's side.  Node indices refer to the simulation graph.  Filled
    one commit at a time by the generator engine, or wholesale (vectorized)
    by the trace replay (``core/trace.py``) — both end states are
    identical.
    """

    __slots__ = ("fid", "name", "depth", "values",
                 "_w_nodes", "_w_times", "_r_nodes", "_r_times",
                 "_nw", "_nr")

    _INIT_CAP = 16

    def __init__(self, fid: int, name: str, depth: int):
        self.fid = fid
        self.name = name
        self.depth = depth
        self._w_nodes = np.empty(self._INIT_CAP, dtype=np.int64)
        self._w_times = np.empty(self._INIT_CAP, dtype=np.int64)
        self._r_nodes = np.empty(self._INIT_CAP, dtype=np.int64)
        self._r_times = np.empty(self._INIT_CAP, dtype=np.int64)
        self._nw = 0
        self._nr = 0
        self.values: deque = deque()      # payloads not yet consumed

    @classmethod
    def _shell(cls, fid: int, name: str, depth: int) -> "FifoTable":
        """Table whose event arrays are about to be installed wholesale.

        The trace replay (``core/trace.py``) assigns ``_w_nodes`` /
        ``_w_times`` / ``_r_nodes`` / ``_r_times`` for every FIFO right
        after construction, so the per-table ``_INIT_CAP`` allocations of
        ``__init__`` would be garbage on arrival.  The shared empty
        placeholder keeps the views well-defined (``_nw == _nr == 0``) if
        anything peeks before installation.
        """
        t = cls.__new__(cls)
        t.fid = fid
        t.name = name
        t.depth = depth
        t._w_nodes = t._w_times = t._r_nodes = t._r_times = _EMPTY_I64
        t._nw = 0
        t._nr = 0
        t.values = deque()
        return t

    # -- committed-event views (zero-copy numpy slices) ------------------------
    @property
    def writes(self) -> np.ndarray:
        """Node idx of each committed write, in commit order."""
        return self._w_nodes[:self._nw]

    @property
    def reads(self) -> np.ndarray:
        """Node idx of each committed read, in commit order."""
        return self._r_nodes[:self._nr]

    @property
    def write_times(self) -> np.ndarray:
        """Commit cycle of each write (nondecreasing: single writer module)."""
        return self._w_times[:self._nw]

    @property
    def read_times(self) -> np.ndarray:
        """Commit cycle of each read (nondecreasing: single reader module)."""
        return self._r_times[:self._nr]

    # -- commits -------------------------------------------------------------
    def commit_write(self, node_idx: int, time: int, value: Any) -> int:
        """Returns the 1-based write sequence number."""
        n = self._nw
        if n == len(self._w_nodes):
            if n == 0:                    # _shell() table: no capacity yet
                self._w_nodes = np.empty(self._INIT_CAP, dtype=np.int64)
                self._w_times = np.empty(self._INIT_CAP, dtype=np.int64)
            else:
                self._w_nodes = np.concatenate([self._w_nodes, self._w_nodes])
                self._w_times = np.concatenate([self._w_times, self._w_times])
        self._w_nodes[n] = node_idx
        self._w_times[n] = time
        self._nw = n + 1
        self.values.append(value)
        return self._nw

    def commit_read(self, node_idx: int, time: int) -> Any:
        """Record the next read committing at cycle ``time``; returns the
        payload popped from the in-flight value queue."""
        n = self._nr
        if n == len(self._r_nodes):
            if n == 0:                    # _shell() table: no capacity yet
                self._r_nodes = np.empty(self._INIT_CAP, dtype=np.int64)
                self._r_times = np.empty(self._INIT_CAP, dtype=np.int64)
            else:
                self._r_nodes = np.concatenate([self._r_nodes, self._r_nodes])
                self._r_times = np.concatenate([self._r_times, self._r_times])
        self._r_nodes[n] = node_idx
        self._r_times[n] = time
        self._nr = n + 1
        return self.values.popleft()

    # -- counters --------------------------------------------------------------
    @property
    def n_writes(self) -> int:
        """Committed write count (events so far; the next write is #n+1)."""
        return self._nw

    @property
    def n_reads(self) -> int:
        """Committed read count (events so far; the next read is #n+1)."""
        return self._nr

    # -- Table 2 resolution ----------------------------------------------------
    def write_target_read(self, w: int) -> Optional[int]:
        """Index (0-based into reads) of the read the w-th write must follow,
        or None if the write trivially fits (w <= S)."""
        if w <= self.depth:
            return None
        return w - self.depth - 1  # (w-S)-th read, 0-based

    def can_write_at(self, w: int, t: int) -> Optional[bool]:
        """Can the w-th write commit at cycle t?  None = target still unknown."""
        tgt = self.write_target_read(w)
        if tgt is None:
            return True
        if tgt >= self._nr:
            return None                      # target read not yet simulated
        return bool(self._r_times[tgt] < t)  # strictly after the target

    def can_read_at(self, r: int, t: int) -> Optional[bool]:
        """Can the r-th read commit at cycle t?  None = target still unknown."""
        tgt = r - 1                          # r-th write, 0-based
        if tgt >= self._nw:
            return None
        return bool(self._w_times[tgt] < t)

    def occupancy_at(self, t: int) -> Optional[int]:
        """Number of elements present at cycle t, or None if not yet decidable.

        Decidable when we know all writes/reads with time < t have been
        simulated — conservatively, the orchestrator only calls this at
        quiescence where the earliest-query rule guarantees decidability.
        Commit times are nondecreasing, so both counts are binary searches.
        """
        w = int(np.searchsorted(self._w_times[:self._nw], t, side="left"))
        r = int(np.searchsorted(self._r_times[:self._nr], t, side="left"))
        return w - r

    def earliest_write_time(self, r: int) -> Optional[int]:
        """Commit cycle of the r-th write (0-based tgt = r-1), if known."""
        if r - 1 < self._nw:
            return int(self._w_times[r - 1])
        return None

    def earliest_read_time(self, idx0: int) -> Optional[int]:
        """Commit cycle of the read at 0-based index ``idx0``, if known —
        the WAR target lookup of paper Table 2 (w-th write waits on the
        (w-S)-th read)."""
        if idx0 < self._nr:
            return int(self._r_times[idx0])
        return None
