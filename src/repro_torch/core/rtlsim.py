"""Cycle-stepped discrete-event reference simulator ("co-sim" stand-in).

PyTorch-port copy of ``repro.core.rtlsim`` (host logic, plain Python):
the oracle the port's engines are held against on the card's machine,
which has no JAX.

Vivado/Vitis RTL co-simulation is not available to this project; this module
is the ground-truth oracle instead: it advances a *global* clock one cycle at
a time and evaluates every module against exact registered-FIFO semantics:

  * a value written in cycle t becomes readable in cycle t+1 (strictly-after
    visibility — the same rule the OmniSim engine's FIFO tables encode);
  * occupancy observed in cycle t counts writes/reads committed in cycles < t;
  * a blocking access retries every cycle until feasible; NB accesses and
    probes sample the pre-cycle state exactly once.

Because it steps every cycle (including long idle stretches) it is orders of
magnitude slower than the event-driven OmniSim engine on the same design —
this is the honest speed baseline for the Fig. 8(b) reproduction, and its
outputs/cycle counts are the accuracy baseline for Table 3 / Fig. 8(a).
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional

from .program import (Delay, Emit, Empty, Full, Op, Program, Read, ReadNB,
                      SimResult, Write, WriteNB)


class _RtlFifo:
    """Registered FIFO with *staged* same-cycle accesses.

    All modules evaluated within cycle t observe the identical pre-cycle
    state (writes/reads committed in cycles < t); this makes module
    iteration order irrelevant — the property OmniSim's FIFO tables provide
    by comparing hardware cycles.
    """

    __slots__ = ("depth", "values", "writes_this_cycle", "reads_this_cycle")

    def __init__(self, depth: int):
        self.depth = depth
        self.values: deque = deque()       # visible (committed < current cycle)
        self.writes_this_cycle: List[Any] = []
        self.reads_this_cycle = 0

    # -- pre-cycle state queries ------------------------------------------
    def can_read(self) -> bool:
        return self.reads_this_cycle < len(self.values)

    def occupancy_for_write(self) -> int:
        # writers see pre-cycle occupancy: writes < t minus reads < t
        return len(self.values)

    # -- staged accesses -----------------------------------------------------
    def do_read(self) -> Any:
        v = self.values[self.reads_this_cycle]
        self.reads_this_cycle += 1
        return v

    def do_write(self, v: Any) -> None:
        self.writes_this_cycle.append(v)

    def end_cycle(self) -> None:
        for _ in range(self.reads_this_cycle):
            self.values.popleft()
        self.reads_this_cycle = 0
        self.values.extend(self.writes_this_cycle)
        self.writes_this_cycle.clear()


class _RtlTask:
    __slots__ = ("name", "gen", "ready_at", "pending", "done", "started",
                 "send_value", "end_time")

    def __init__(self, name: str, gen):
        self.name = name
        self.gen = gen
        self.ready_at = 1
        self.pending: Optional[Op] = None
        self.done = False
        self.started = False
        self.send_value: Any = None
        self.end_time = 1      # module end = cycle after last op (+ delays)


def simulate_rtl(program: Program, depths=None,
                 max_cycles: int = 5_000_000) -> SimResult:
    """Run the cycle-stepped oracle."""
    if depths is not None:
        program.with_depths(depths)
    fifos = {f: _RtlFifo(f.depth) for f in program.fifos}
    tasks = [_RtlTask(m.name, m.fn()) for m in program.modules]
    outputs: Dict[str, Any] = {}

    def fetch(task: _RtlTask) -> None:
        """Advance the generator to its next cycle-consuming op."""
        while True:
            try:
                if not task.started:
                    task.started = True
                    op = next(task.gen)
                else:
                    op = task.gen.send(task.send_value)
                task.send_value = None
            except StopIteration:
                task.done = True
                task.pending = None
                # module end = next-ready cycle (includes trailing delays),
                # matching the engine's END-node convention.
                task.end_time = task.ready_at
                return
            if isinstance(op, Emit):
                outputs[op.key] = op.value
                task.send_value = None
                continue
            if isinstance(op, Delay):
                task.ready_at += op.cycles
                task.send_value = None
                continue
            task.pending = op
            return

    for task in tasks:
        fetch(task)

    t = 0
    while True:
        t += 1
        if t > max_cycles:
            raise RuntimeError(f"cycle budget exceeded ({max_cycles})")
        if all(task.done for task in tasks):
            t -= 1
            break
        progress = False
        any_waiting = False
        for task in tasks:
            if task.done or task.ready_at > t:
                any_waiting |= (not task.done)
                progress |= (not task.done)   # delayed task will act later
                continue
            op = task.pending
            f = fifos[op.fifo]
            if isinstance(op, Read):
                if f.can_read():
                    task.send_value = f.do_read()
                    task.ready_at = t + 1
                    fetch(task)
                    progress = True
            elif isinstance(op, Write):
                if f.occupancy_for_write() < f.depth:
                    f.do_write(op.value)
                    task.ready_at = t + 1
                    fetch(task)
                    progress = True
            elif isinstance(op, ReadNB):
                if f.can_read():
                    task.send_value = (True, f.do_read())
                else:
                    task.send_value = (False, None)
                task.ready_at = t + 1
                fetch(task)
                progress = True
            elif isinstance(op, WriteNB):
                if f.occupancy_for_write() < f.depth:
                    f.do_write(op.value)
                    task.send_value = True
                else:
                    task.send_value = False
                task.ready_at = t + 1
                fetch(task)
                progress = True
            elif isinstance(op, Empty):
                task.send_value = not f.can_read()
                task.ready_at = t + 1
                fetch(task)
                progress = True
            elif isinstance(op, Full):
                task.send_value = f.occupancy_for_write() >= f.depth
                task.ready_at = t + 1
                fetch(task)
                progress = True
            else:  # pragma: no cover
                raise TypeError(f"unknown op {op!r}")
        for f in fifos.values():
            f.end_cycle()
        if not progress:
            # every live task is blocked on an infeasible B access and no
            # commit happened: the state is a fixpoint -> true deadlock.
            blocked = [task.name for task in tasks if not task.done]
            res = SimResult(program=program.name, outputs=dict(outputs),
                            cycles=t, engine="rtlsim",
                            depths=program.depths(), deadlock=True,
                            deadlock_cycle=t)
            res.outputs["__deadlock__"] = blocked
            return res

    total = max((task.end_time for task in tasks), default=0)
    return SimResult(program=program.name, outputs=dict(outputs), cycles=total,
                     engine="rtlsim", depths=program.depths())
