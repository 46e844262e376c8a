"""Dataflow-design DSL.

PyTorch-port copy of ``repro.core.program``: the DSL is host logic, kept
line for line so a design builds the same Program in both packages.

The paper consumes Vitis HLS LLVM bitcode plus the C-synthesis static
schedule.  We have no Vitis front-end, so designs are authored in this small
Python DSL carrying the *same information*: modules (dataflow tasks), FIFO
channels with depths, blocking / non-blocking accesses, status probes, and
explicit static-schedule latencies (``Delay``).  Every yielded op costs one
hardware cycle unless stated otherwise — i.e. loops have II=1 per op by
default, and extra latency is expressed with ``Delay`` (this mirrors the
dynamic-stage unrolling of the paper's Sec. 5.1).

A module body is a Python *generator function*; it yields ops and receives
results (read values, NB success flags) via ``send``.  Bodies must be
**pure and re-runnable**: the framework may invoke ``fn()`` more than once
per Program (incremental/DSE fallback re-simulation; in the reference
also trace recording and the RTL oracle), so a body must not mutate
state shared across invocations (e.g. popping from a closure list) or
perform external side effects.  Example::

    prog = Program("producer_consumer")
    data = prog.fifo("data", depth=2)

    @prog.module("producer")
    def producer():
        for i in range(N):
            yield Write(data, i)

    @prog.module("consumer")
    def consumer():
        total = 0
        for _ in range(N):
            v = yield Read(data)
            total += v
        yield Emit("sum", total)

Cycle-cost model (shared by the OmniSim engine, the cycle-stepped RTL oracle
and the decoupled baseline so that accuracy comparisons are apples-to-apples):

==============  =========================================================
op              cost
==============  =========================================================
Read            commits at u = max(t, time(matching write) + 1); next op
                at u+1.  Pauses while the matching write is unknown.
Write           commits at u = max(t, time((w-S)-th read) + 1); next op at
                u+1.  Pauses while the FIFO is full.
ReadNB          samples at t; success iff time(r-th write) < t. 1 cycle.
WriteNB         samples at t; success iff w <= S or time((w-S)-th read) < t.
                1 cycle.
Empty/Full      samples occupancy at t, 1 cycle.  ``used=False`` marks a
                probe whose result is dead (paper Sec. 7.3.2) — skipped.
Delay(n)        advances the local clock by n cycles.
Emit            records a functional output; zero cycles.
==============  =========================================================
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Generator, List, Optional, Tuple


# --------------------------------------------------------------------------
# Ops — slotted plain classes, not dataclasses: one op object is constructed
# per yielded operation, so __init__ is on the hot path of every engine
# (frozen-dataclass construction costs an object.__setattr__ per field).
# --------------------------------------------------------------------------
class Op:
    __slots__ = ()

    def __repr__(self) -> str:
        args = ", ".join(f"{s}={getattr(self, s)!r}" for s in self.__slots__)
        return f"{self.__class__.__name__}({args})"


class Read(Op):
    __slots__ = ("fifo",)

    def __init__(self, fifo: "Fifo"):
        self.fifo = fifo


class Write(Op):
    __slots__ = ("fifo", "value")

    def __init__(self, fifo: "Fifo", value: Any):
        self.fifo = fifo
        self.value = value


class ReadNB(Op):
    __slots__ = ("fifo",)

    def __init__(self, fifo: "Fifo"):
        self.fifo = fifo


class WriteNB(Op):
    __slots__ = ("fifo", "value")

    def __init__(self, fifo: "Fifo", value: Any):
        self.fifo = fifo
        self.value = value


class Empty(Op):
    __slots__ = ("fifo", "used")

    def __init__(self, fifo: "Fifo", used: bool = True):
        self.fifo = fifo
        self.used = used    # False → dead probe, eliminated (paper Sec. 7.3.2)


class Full(Op):
    __slots__ = ("fifo", "used")

    def __init__(self, fifo: "Fifo", used: bool = True):
        self.fifo = fifo
        self.used = used


class Delay(Op):
    __slots__ = ("cycles",)

    def __init__(self, cycles: int):
        self.cycles = cycles


class Emit(Op):
    __slots__ = ("key", "value")

    def __init__(self, key: str, value: Any):
        self.key = key
        self.value = value


# --------------------------------------------------------------------------
# Program structure
# --------------------------------------------------------------------------
@dataclass
class Fifo:
    name: str
    depth: int
    fid: int = -1

    def __hash__(self) -> int:
        return id(self)


@dataclass
class Module:
    name: str
    fn: Callable[[], Generator]
    mid: int = -1


GenFn = Callable[[], Generator]


class Program:
    """A dataflow design: FIFOs + modules, analogous to an HLS dataflow region."""

    def __init__(self, name: str, declared_type: Optional[str] = None):
        self.name = name
        self.fifos: List[Fifo] = []
        self.modules: List[Module] = []
        # Optional author-declared taxonomy type ("A" | "B" | "C"); the
        # classifier cross-checks the statically detectable features.
        self.declared_type = declared_type

    # -- construction ------------------------------------------------------
    def fifo(self, name: str, depth: int) -> Fifo:
        f = Fifo(name=name, depth=depth, fid=len(self.fifos))
        self.fifos.append(f)
        return f

    def module(self, name: str) -> Callable[[GenFn], GenFn]:
        def deco(fn: GenFn) -> GenFn:
            m = Module(name=name, fn=fn, mid=len(self.modules))
            self.modules.append(m)
            return fn

        return deco

    def add_module(self, name: str, fn: GenFn) -> Module:
        m = Module(name=name, fn=fn, mid=len(self.modules))
        self.modules.append(m)
        return m

    # -- depth overrides (for incremental re-simulation) --------------------
    def depths(self) -> Tuple[int, ...]:
        return tuple(f.depth for f in self.fifos)

    def with_depths(self, depths) -> "Program":
        assert len(depths) == len(self.fifos)
        for f, d in zip(self.fifos, depths):
            f.depth = int(d)
        return self

    # -- static structure for taxonomy ---------------------------------------
    def static_trace(self, max_ops_per_module: int = 100_000) -> Dict[str, Any]:
        """Dry-inspect module generators is impossible without running them;
        static features here are derived from a bounded functional probe run
        by the classifier (see core/taxonomy.py)."""
        raise NotImplementedError("use core.taxonomy.classify(program)")


@dataclass
class SimResult:
    """Result of a simulation run (any engine)."""

    program: str
    outputs: Dict[str, Any]
    cycles: int
    engine: str
    stats: Any = None
    graph: Any = None            # SimGraph for the OmniSim engine
    constraints: list = field(default_factory=list)
    depths: Tuple[int, ...] = ()
    deadlock: bool = False
    deadlock_cycle: int = -1

    def summary(self) -> str:
        out = ", ".join(f"{k}={v}" for k, v in sorted(self.outputs.items()))
        dl = f" DEADLOCK@{self.deadlock_cycle}" if self.deadlock else ""
        return f"[{self.engine}] {self.program}: cycles={self.cycles}{dl} {out}"
