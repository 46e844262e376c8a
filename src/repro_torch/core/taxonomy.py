"""Dataflow-design taxonomy (paper Sec. 3, Figs. 3-4).

PyTorch-port copy of ``repro.core.taxonomy``.

Classification is by three defining features:

  * **module dependency** — acyclic vs. cyclic (derived from the FIFO
    endpoint graph observed during simulation);
  * **dataflow type** — blocking-only vs. non-blocking present;
  * **program behaviors** — whether the outcome of an NB access can alter
    subsequent behavior.  This is a *semantic* property (undecidable in
    general); designs declare it, and we *validate* the declaration
    dynamically by flipping each NB outcome class and checking divergence
    where cheap (`validate=True`).

Mapping to simulation-requirement levels (paper Fig. 3):

  Type A → Func L1 / Perf L1 : sequential single-pass simulation suffices.
  Type B → Func L2 / Perf L3 : concurrency-dependent functionality,
                                cycle-dependent performance.
  Type C → Func L3 / Perf L3 : functionality itself cycle-dependent.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

from .engine import simulate
from .events import NodeKind
from .program import Program


@dataclass
class Classification:
    dtype: str                  # "A" | "B" | "C"
    cyclic: bool
    has_nonblocking: bool
    func_sim_level: int
    perf_sim_level: int
    modules: int
    fifos: int
    declared: Optional[str]

    def __str__(self) -> str:
        return (f"Type {self.dtype} (cyclic={self.cyclic}, "
                f"NB={self.has_nonblocking}, Func L{self.func_sim_level}, "
                f"Perf L{self.perf_sim_level})")


def _module_graph_cyclic(endpoints: Dict[int, Tuple[Set[int], Set[int]]]) -> bool:
    """endpoints: fifo -> (writer mids, reader mids). Cycle in module DAG?"""
    adj: Dict[int, Set[int]] = {}
    for (ws, rs) in endpoints.values():
        for w in ws:
            adj.setdefault(w, set()).update(rs)
    WHITE, GREY, BLACK = 0, 1, 2
    color: Dict[int, int] = {}

    def dfs(u: int) -> bool:
        color[u] = GREY
        for v in adj.get(u, ()):
            c = color.get(v, WHITE)
            if c == GREY:
                return True
            if c == WHITE and dfs(v):
                return True
        color[u] = BLACK
        return False

    return any(dfs(u) for u in list(adj) if color.get(u, WHITE) == WHITE)


def classify_dynamic(builder, n_variants: int = 4,
                     cache=None) -> Classification:
    """Classification with *dynamic divergence validation*.

    The B-vs-C boundary is semantic ("does an NB outcome alter behavior?"),
    undecidable statically.  We probe it empirically: re-simulate under
    perturbed FIFO depths (halved / doubled / +1 / deep).  Any functional
    output divergence is a definitive WITNESS of cycle-dependent
    functionality => Type C.  Absence of a witness is NOT a Type B proof
    (e.g. fig2_timer's outputs happen to be depth-invariant although its
    timer value is cycle-dependent) — without a witness the declared /
    conservative static classification stands.

    ``builder`` is a zero-arg callable returning a fresh Program (generators
    are single-use).  All probe runs share one
    :class:`~repro_torch.core.trace.HybridCache` (pass ``cache`` to supply
    your own and inspect its hit/switch/divergence counters afterwards), so
    dynamic designs replay their memoized module streams across the depth
    variants — validated cached segments replay array-at-a-time, making the
    probe runs near-free — and only re-run generators past genuine
    control-flow divergences (the witnesses this probe is hunting for).
    """
    from .trace import HybridCache
    if cache is None:
        cache = HybridCache()
    base_prog = builder()
    base = simulate(base_prog, hybrid_cache=cache)
    c = classify(base_prog, base)
    if not c.has_nonblocking:
        return c                   # blocking-only cannot be Type C
    depths0 = base.depths
    variants = [
        tuple(max(1, d // 2) for d in depths0),
        tuple(2 * d for d in depths0),
        tuple(d + 1 for d in depths0),
        tuple(d + 64 for d in depths0),
    ][:n_variants]
    divergent = False
    for dv in variants:
        r = simulate(builder(), depths=dv, hybrid_cache=cache)
        if r.outputs != base.outputs or r.deadlock != base.deadlock:
            divergent = True
            break
    if not divergent:
        return c                   # no witness: static/declared type stands
    return Classification(dtype="C", cyclic=c.cyclic, has_nonblocking=True,
                          func_sim_level=3, perf_sim_level=3,
                          modules=c.modules, fifos=c.fifos,
                          declared=c.declared)


def classify(program: Program, sim_result=None) -> Classification:
    """Classify a design; runs the engine once if no result is supplied."""
    if sim_result is None:
        sim_result = simulate(program)
    engine = sim_result.graph
    endpoints: Dict[int, Tuple[Set[int], Set[int]]] = {
        f.fid: (set(), set()) for f in program.fifos}
    has_nb = False
    for node in engine.graph.nodes:
        if node.fifo < 0:
            continue
        if node.kind in (NodeKind.FIFO_WRITE,):
            endpoints[node.fifo][0].add(node.module)
        elif node.kind in (NodeKind.FIFO_READ,):
            endpoints[node.fifo][1].add(node.module)
        if node.kind in (NodeKind.NB_FAIL, NodeKind.PROBE):
            has_nb = True
    # NB also if any successful NB access occurred: count constraints
    has_nb = has_nb or bool(sim_result.constraints)
    cyclic = _module_graph_cyclic(endpoints)

    declared = program.declared_type
    if not has_nb and not cyclic:
        dtype = "A"
    elif declared == "C":
        dtype = "C"
    elif declared in ("A", "B"):
        dtype = "B" if (has_nb or cyclic) else "A"
    else:
        # undeclared: conservatively Type C when NB present (divergence
        # cannot be ruled out), else Type B (cyclic blocking-only)
        dtype = "C" if has_nb else "B"
    levels = {"A": (1, 1), "B": (2, 3), "C": (3, 3)}
    fl, pl = levels[dtype]
    return Classification(dtype=dtype, cyclic=cyclic, has_nonblocking=has_nb,
                          func_sim_level=fl, perf_sim_level=pl,
                          modules=len(program.modules),
                          fifos=len(program.fifos), declared=declared)
