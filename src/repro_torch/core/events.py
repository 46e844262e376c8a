"""Event, request and query records for the OmniSim engine.

PyTorch-port copy of ``repro.core.events``.

Mirrors the paper's Table 1 (requests emitted by Func Sim threads) and the
node/edge records of the partial simulation graph (Sec. 5/6).  Every FIFO
access becomes a *node* in the simulation graph; the node's ``time`` is the
hardware cycle at which the access commits.  Node creation order is a
topological order of the graph, which the finalization
pass (``core/graph.py``) and the max-plus kernels rely on.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional


class NodeKind(enum.Enum):
    """Kinds of simulation-graph nodes (events)."""

    START = "start"            # module start
    END = "end"                # module end
    FIFO_WRITE = "fifo_write"  # committed (blocking or successful NB) write
    FIFO_READ = "fifo_read"    # committed (blocking or successful NB) read
    NB_FAIL = "nb_fail"        # failed non-blocking access (occupies a cycle)
    PROBE = "probe"            # empty()/full() status check
    DELAY = "delay"            # explicit latency from the static schedule


class RequestType(enum.Enum):
    """Requests a Func Sim task can make — paper Table 1.

    The first group is informative (updates graph state); the last group are
    *queries* that must be resolved by the Perf Sim orchestrator against the
    FIFO tables before the task may resume.
    """

    TRACE_BLOCK = "TraceBlock"
    START_TASK = "StartTask"
    FIFO_READ = "FifoRead"          # blocking read
    FIFO_WRITE = "FifoWrite"        # blocking write
    AXI_READ = "AxiRead"            # modeled as FIFO pair; kept for parity
    AXI_WRITE = "AxiWrite"
    # ---- queries ----
    FIFO_CAN_READ = "FifoCanRead"   # empty() probe
    FIFO_CAN_WRITE = "FifoCanWrite" # full() probe
    FIFO_NB_READ = "FifoNbRead"
    FIFO_NB_WRITE = "FifoNbWrite"

    @property
    def is_query(self) -> bool:
        return self in (
            RequestType.FIFO_CAN_READ,
            RequestType.FIFO_CAN_WRITE,
            RequestType.FIFO_NB_READ,
            RequestType.FIFO_NB_WRITE,
        )


@dataclass
class Node:
    """A node of the (partial) simulation graph."""

    idx: int
    module: int                 # module index
    kind: NodeKind
    time: int                   # hardware cycle at which the event commits
    fifo: int = -1              # FIFO id (or -1)
    seq: int = -1               # 1-based sequence number of this access on its FIFO
    # incoming edges: list of (src node idx, weight).  src < idx holds for
    # engine-built graphs (creation order is topological); trace-replayed
    # graphs are chain-major, so use order-insensitive longest-path
    # backends (level-scheduled or fixpoint) on them.
    preds: list = field(default_factory=list)

    def add_edge(self, src: int, weight: int) -> None:
        self.preds.append((src, weight))


@dataclass
class Query:
    """A pending non-blocking query — paper Table 2.

    ``source_time`` is the hardware cycle of the NB access being queried.
    ``target`` identifies the committed access the source is compared against:
    for the w-th NB write with FIFO size S it is the (w-S)-th read; for the
    r-th NB read it is the r-th write.  ``None`` target means the access
    trivially succeeds (w <= S).
    """

    qid: int
    module: int
    rtype: RequestType
    fifo: int
    source_seq: int            # w for writes, r for reads (1-based, prospective)
    source_time: int
    payload: Any = None        # value being written, for NB writes

    def target_seq(self, depth: int) -> Optional[int]:
        if self.rtype in (RequestType.FIFO_NB_WRITE, RequestType.FIFO_CAN_WRITE):
            if self.source_seq <= depth:
                return None
            return self.source_seq - depth
        return self.source_seq


class Constraint(NamedTuple):
    """Outcome of a resolved query, recorded for incremental re-simulation.

    On a FIFO-depth change, finalization is re-run and every constraint is
    re-evaluated against the new node times; if any query would now resolve
    differently, the simulation graph is invalid and a full re-sim is needed
    (paper Sec. 7.2).  A NamedTuple rather than a dataclass: query-dominated
    designs materialize one record per query, and construction cost is on
    the hot path of both the generator engine and the hybrid replay.
    """

    rtype: RequestType
    fifo: int
    source_seq: int
    source_node: int            # node idx of the probe/NB event
    outcome: bool


@dataclass
class SimStats:
    """Bookkeeping counters, reported by benchmarks."""

    nodes: int = 0
    edges: int = 0
    queries: int = 0
    queries_forced_false: int = 0   # resolved by the earliest-query rule
    queries_periodized: int = 0     # resolved in bulk by query periodization
                                    # (hybrid engine poll-loop bursts; the
                                    # generator engine always reports 0)
    quiescence_rounds: int = 0
    resumes: int = 0
    skipped_probes: int = 0         # dead-query elimination (paper Sec. 7.3.2)


class DeadlockError(RuntimeError):
    """Raised when a true design-level deadlock is detected (paper Sec. 7.1)."""

    def __init__(self, blocked: list, cycle: int):
        self.blocked = blocked
        self.cycle = cycle
        super().__init__(
            f"unresolvable deadlock detected at cycle {cycle}: "
            f"all tasks blocked: {blocked}"
        )


class UnsupportedDesignError(RuntimeError):
    """Raised by the decoupled (LightningSim-style) baseline on Type B/C designs."""
