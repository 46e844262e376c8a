"""Declarative constraint spec for the corpus generator.

Every parameter the generator samples — topology choice, FIFO depths, item
counts, fan-out arities, burst lengths, poll budgets, query density — is
drawn from a field of :class:`CorpusSpec` through one seeded
``random.Random``, in one fixed order.  That makes a corpus case a pure
function of ``(seed, scale, spec)``: re-running ``generate`` with the same
triple rebuilds a bit-identical Program (same fingerprint, same trace),
which is what lets the conformance suite pin digests by seed alone.

The spec is deliberately plain data (frozen dataclasses of ranges and
weighted choices, in the constrained-random style of SystemVerilog/zuspec
scenario solvers) rather than code: a test or benchmark that needs a
biased corpus — heavier AXI traffic, deeper trees, no dynamic modules —
passes a modified spec instead of forking the generator.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class IntRange:
    """Inclusive integer range; ``draw`` samples uniformly."""
    lo: int
    hi: int

    def __post_init__(self):
        if self.lo > self.hi:
            raise ValueError(f"empty IntRange({self.lo}, {self.hi})")

    def draw(self, rng) -> int:
        return rng.randint(self.lo, self.hi)


@dataclass(frozen=True)
class Choice:
    """Weighted finite choice; repeat an option to weight it (as the fuzz
    builders already do with ``rng.choice([0, 0, 1, 2])``)."""
    options: Tuple

    def draw(self, rng):
        return rng.choice(self.options)


@dataclass(frozen=True)
class CorpusSpec:
    # -- cluster mix: relative weights of each motif ---------------------
    # pipeline  : src -> relay* -> sink chain (optionally lossy/NB)
    # tree      : round-robin split tree -> leaf relays -> mirrored merge
    # diamond   : 1-level split/merge (a tree with levels=1)
    # ring      : cyclic feedback ring with k initial tokens
    # poll      : done-signal pollers (POLLV/PTR/NEST query loops)
    # axi       : AXI read-burst master + core.axi memory + sink
    motif_weights: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict(pipeline=4, tree=3, diamond=2,
                                     ring=2, poll=2, axi=2))

    # -- per-cluster shape parameters ------------------------------------
    items: IntRange = IntRange(4, 24)       # tokens emitted per source
    depth: IntRange = IntRange(1, 6)        # FIFO depths
    pipeline_stages: IntRange = IntRange(1, 6)
    fanout: IntRange = IntRange(2, 4)       # split/merge arity
    tree_levels: IntRange = IntRange(1, 3)
    ring_modules: IntRange = IntRange(2, 4)
    ring_rounds: IntRange = IntRange(2, 10)
    ring_tokens: IntRange = IntRange(1, 3)  # initial (primed) tokens
    n_pollers: IntRange = IntRange(1, 3)
    poll_budget: IntRange = IntRange(6, 48)
    burst_len: Choice = Choice((2, 4, 8))
    axi_bursts: IntRange = IntRange(2, 6)
    axi_read_latency: IntRange = IntRange(4, 16)
    delay: Choice = Choice((0, 0, 0, 1, 2))
    gap: Choice = Choice((0, 0, 1, 2))

    # -- dynamic-feature densities ---------------------------------------
    query_density: float = 0.25   # P(a pipeline relay/sink goes lossy/NB)
    bridge_prob: float = 0.4      # P(cluster chained to its predecessor)
    starve_prob: float = 0.0      # P(a pipeline source under-produces by
    #                               one item -> deterministic deadlock)

    def replace(self, **kw) -> "CorpusSpec":
        """Functional update (``dataclasses.replace`` sugar)."""
        return dataclasses.replace(self, **kw)


#: Default spec: mixed Type A/B/C corpus, every motif reachable.
DEFAULT_SPEC = CorpusSpec()

#: All-blocking variant: no NB/probe modules anywhere, so every design is
#: statically Type A/B and the straight-line trace path must engage.
BLOCKING_SPEC = CorpusSpec(
    motif_weights=dict(pipeline=4, tree=3, diamond=2, ring=2, poll=0,
                       axi=2),
    query_density=0.0,
)

#: Benchmark spec: like DEFAULT_SPEC but with a pinned item count so
#: per-engine throughput at different scales stays comparable.
BENCH_SPEC = CorpusSpec(items=IntRange(8, 8))
