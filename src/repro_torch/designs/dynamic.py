"""Dynamic (Type B/C) benchmark designs beyond the paper's Table 4.

Built on the PyTorch port's DSL (``repro_torch.core.program``): the same
design functions, parameters and registry as ``repro.designs.dynamic``.

The paper designs (``designs/paper.py``) are query-*dominated*: most of
their ops are NB accesses or probes, so every engine pays per-query
interpretation.  The designs here have the opposite profile — deep blocking
pipelines with *sparse* query points — which is exactly where the hybrid
segmented replay (``core/trace.py::simulate_hybrid``) shines: the blocking
segments compile to flat arrays and only the occasional query drops to the
generator protocol.

Module order matters for the ``trace="auto"`` probe cost: the NB module
comes first so the straight-line recorder aborts to the hybrid path after a
single op instead of replaying a whole pipeline stage.
"""
from __future__ import annotations

from ..core.program import Delay, Emit, Program, Read, ReadNB, Write


def watchdog_pipe(items: int = 2048, stages: int = 4, depth: int = 16,
                  poll_gap: int = 64) -> Program:
    """A skynet-like blocking pipeline supervised by a polling watchdog.

    ``stages`` blocking stages stream ``items`` elements (the Type A bulk of
    the design); the sink signals completion on a ``done`` FIFO, and a
    watchdog polls it with a non-blocking read every ``poll_gap`` cycles —
    the classic status-register pattern no decoupled simulator can time.
    Queries are ~``cycles / poll_gap`` of the op stream, so the hybrid
    engine compiles almost everything.
    """
    prog = Program("watchdog_pipe", declared_type="C")
    done = prog.fifo("done", 1)
    links = [prog.fifo(f"s{i}", depth) for i in range(stages + 1)]

    @prog.module("watchdog")          # first: auto-probe bails out fast
    def watchdog():
        polls = 0
        while True:
            ok, _ = yield ReadNB(done)
            polls += 1
            if ok:
                break
            yield Delay(poll_gap - 1)
        yield Emit("polls", polls)

    @prog.module("source")
    def source():
        for i in range(items):
            yield Write(links[0], (i * 7 + 3) % 251)

    def make_stage(k: int):
        def stage():
            acc = 0
            for _ in range(items):
                v = yield Read(links[k])
                acc = (acc + v) % 65521
                yield Write(links[k + 1], (v * 3 + k) % 251)
            yield Emit(f"stage{k}_acc", acc)
        return stage

    for k in range(stages):
        prog.add_module(f"stage{k}", make_stage(k))

    @prog.module("sink")
    def sink():
        total = 0
        for _ in range(items):
            total += (yield Read(links[stages]))
        yield Write(done, 1)
        yield Emit("checksum", total)

    return prog


def fig2_poll_burst(items: int = 2048, stages: int = 2, depth: int = 8,
                    gaps=(1, 1, 1, 1, 1, 2, 1, 1, 1, 7)) -> Program:
    """A ``fig2_timer``-class poller with *bursty, non-uniform* poll gaps.

    A small blocking pipeline streams ``items`` elements; the sink signals
    completion on ``done`` and a poller ReadNB-polls it, but with a gap that
    cycles through ``gaps`` instead of staying fixed — bursts of back-to-back
    polls separated by longer pauses, like a core that polls a status
    register hard right after issuing work and backs off in between.  The
    query periodizer's steady-state detector only fires inside the
    constant-gap runs and must fall back to per-query interpretation at
    every gap change, so this design exercises both the burst fast path and
    its divergence fallback (``benchmarks/tables.py::
    table_query_periodization`` reports the speedup for both profiles).
    """
    prog = Program("fig2_poll_burst", declared_type="C")
    done = prog.fifo("done", 1)
    links = [prog.fifo(f"q{i}", depth) for i in range(stages + 1)]

    @prog.module("poller")            # first: auto-probe bails out fast
    def poller():
        polls = 0
        i = 0
        while True:
            ok, _ = yield ReadNB(done)
            polls += 1
            if ok:
                break
            g = gaps[i % len(gaps)]
            i += 1
            if g > 1:
                yield Delay(g - 1)
        yield Emit("polls", polls)

    @prog.module("source")
    def source():
        for i in range(items):
            yield Write(links[0], (i * 5 + 1) % 241)

    def make_stage(k: int):
        def stage():
            acc = 0
            for _ in range(items):
                v = yield Read(links[k])
                acc = (acc + v * (k + 2)) % 65521
                yield Write(links[k + 1], (v * 7 + k) % 241)
            yield Emit(f"stage{k}_acc", acc)
        return stage

    for k in range(stages):
        prog.add_module(f"stage{k}", make_stage(k))

    @prog.module("sink")
    def sink():
        total = 0
        for _ in range(items):
            total += (yield Read(links[stages]))
        yield Write(done, 1)
        yield Emit("checksum", total)

    return prog


def multisite_poll(items: int = 1024, depth: int = 64,
                   pause: int = 2) -> Program:
    """One watcher round-robins ReadNB over *two* FIFOs fed at different
    rates — the multi-site periodic pattern.

    The watcher's loop body is ``ReadNB(a); ReadNB(b); Delay(pause)`` —
    ``pause + 2`` cycles per iteration.  ``feed_a`` produces exactly one
    value per iteration (every poll of site A succeeds) and ``feed_b``
    one value per *two* iterations (site B alternates hit/miss), so the
    steady state is a repeating four-step ``(site, gap, outcome)``
    tuple: A-hit, B-hit, A-hit, B-miss.  A single-site streak detector
    sees nothing periodic here; the generalized pattern periodizer arms
    on the tuple and commits whole windows of mixed-outcome queries
    against the feeders' run-ahead write tables (horizon = min over the
    two sites).
    """
    prog = Program("multisite_poll", declared_type="C")
    a = prog.fifo("a", depth)
    b = prog.fifo("b", depth)
    period = pause + 2                # cycles per watcher iteration
    total = items + items // 2

    @prog.module("watcher")           # first: auto-probe bails out fast
    def watcher():
        acc = 0
        got = 0
        polls = 0
        while got < total:
            ok, v = yield ReadNB(a)
            polls += 1
            if ok:
                acc = (acc + v) % 65521
                got += 1
            ok, v = yield ReadNB(b)
            polls += 1
            if ok:
                acc = (acc + 3 * v) % 65521
                got += 1
            if pause:
                yield Delay(pause)
        yield Emit("checksum", acc)
        yield Emit("polls", polls)

    def make_feed(fifo, n, gap, salt):
        def feed():
            for i in range(n):
                yield Write(fifo, (i * salt + 1) % 251)
                if gap > 1:
                    yield Delay(gap - 1)
        return feed

    prog.add_module("feed_a", make_feed(a, items, period, 7))
    prog.add_module("feed_b", make_feed(b, items // 2, 2 * period, 13))
    return prog


def nb_success_stream(items: int = 4096, depth: int = 64,
                      gap: int = 2) -> Program:
    """Steady-state *successful* NB stream: a run-ahead producer fills a
    deep FIFO while a ReadNB consumer drains it at the matched rate.

    Once the stream warms up every poll succeeds, so a fail-streak
    detector never fires — but the success pattern has a fixed period
    whose commit times are derivable from the producer's committed
    write table, and the periodizer verifies + commits reads in windows
    bounded by the producer's run-ahead (≈ ``depth`` rows at a time).
    """
    prog = Program("nb_success_stream", declared_type="C")
    data = prog.fifo("data", depth)

    @prog.module("drain")             # first: auto-probe bails out fast
    def drain():
        acc = 0
        got = 0
        misses = 0
        while got < items:
            ok, v = yield ReadNB(data)
            if ok:
                acc = (acc + v) % 65521
                got += 1
            else:
                misses += 1
            if gap > 1:
                yield Delay(gap - 1)
        yield Emit("checksum", acc)
        yield Emit("misses", misses)

    @prog.module("feed")
    def feed():
        for i in range(items):
            yield Write(data, (i * 11 + 5) % 257)
            if gap > 1:
                yield Delay(gap - 1)

    return prog


DYNAMIC_DESIGNS = {
    "watchdog_pipe": watchdog_pipe,
    "fig2_poll_burst": fig2_poll_burst,
    "multisite_poll": multisite_poll,
    "nb_success_stream": nb_success_stream,
}
