"""Seeded random dataflow Programs: the macro interpreter + fuzz builders.

``build_case(seed)`` deterministically derives a *builder* — a zero-arg
callable returning a fresh :class:`~repro_torch.core.program.Program` — plus a
feature summary.  Designs are assembled from macro scripts interpreted by a
shared generator body, so module bodies are pure and re-runnable (the DSL
contract) and every loop is statically bounded: a case either terminates or
blocks forever on FIFO waits, which the engines must *report* as deadlock,
never hang on.

Structure: a producer -> stage* -> sink pipeline over SPSC FIFOs (one
writer and one reader module per FIFO, by construction), randomly decorated
with the dynamic features the hybrid engine must preserve:

  * lossy producers (``WriteNB`` silent drop, ``Full``-probe-guarded
    writes) and bounded-retry NB polling readers (Type C material);
  * a watchdog module polling a done signal with bounded attempts;
  * a blocking ack/credit feedback FIFO (cyclic module graph, Type B);
  * an extra two-module ring that is live when primed and a true deadlock
    when not;
  * dead probes, delays, leftover (never consumed) writes.

Every received value, probe outcome and drop/poll count folds into each
module's emitted checksum, so any functional divergence between engines is
visible in ``SimResult.outputs``.

This module is the library home of what used to live in
``tests/fuzz_designs.py`` (which now re-exports from here); the corpus
generator (:mod:`repro_torch.corpus.generator`) composes the same ``_interp``
macro language into much larger topologies, so the interpreter also carries
the structural macros the fuzz pipelines never needed: round-robin
split/merge (``SPLIT``/``MERGE``), broadcast (``BCAST``), k-token feedback
rings (``RINGK``), single-token bridges (``R1``) and AXI burst masters
(``AXIWR``).
"""
from __future__ import annotations

import random

from ..core.program import (Delay, Emit, Empty, Full, Program, Read,
                                ReadNB, Write, WriteNB)

MOD = 1_000_003


def _interp(name: str, script, fifos):
    """Generator body interpreting an immutable macro script."""

    def body():
        acc, polls, drops = 0, 0, 0
        for ins in script:
            op = ins[0]
            if op == "SRC":
                (_, fid, n, style, ack_fid, ack_every, delay, deadp,
                 extra) = ins
                for i in range(n + extra):
                    if deadp and i % 3 == 0:
                        yield Full(fifos[fid], used=False)
                    v = (i * 7 + 11) % 251
                    if style == "B":
                        yield Write(fifos[fid], v)
                    elif style == "NB":
                        ok = yield WriteNB(fifos[fid], v)
                        if not ok:
                            drops += 1
                    else:                       # "FPW": probe-guarded write
                        full = yield Full(fifos[fid])
                        if not full:
                            yield Write(fifos[fid], v)
                        else:
                            drops += 1
                    if delay and i % 2 == 1:
                        yield Delay(delay)
                    if ack_every and i % ack_every == ack_every - 1:
                        a = yield Read(fifos[ack_fid])
                        acc = (acc * 31 + a + 7) % MOD
            elif op == "RELAY":
                _, fin, fout, n, tries, gap, lossy, delay = ins
                for i in range(n):
                    # lossy == 2: anchored — the first item is a blocking
                    # read, so the poll clock starts only once the cluster
                    # is actually live (bridged clusters start late)
                    if lossy and not (lossy == 2 and i == 0):
                        got = False
                        v = 0
                        for _ in range(tries):
                            ok, v = yield ReadNB(fifos[fin])
                            polls += 1
                            if ok:
                                got = True
                                break
                            if gap:
                                yield Delay(gap)
                        if not got:
                            acc = (acc * 17 + 3) % MOD
                            continue
                    else:
                        v = yield Read(fifos[fin])
                    acc = (acc * 31 + v + 7) % MOD
                    if delay and i % 3 == 2:
                        yield Delay(delay)
                    yield Write(fifos[fout], (v * 3 + 1) % 251)
            elif op == "SINK":
                _, fin, n, lossy, tries, gap, ack_fid, ack_every = ins
                for i in range(n):
                    if lossy and not (lossy == 2 and i == 0):
                        for _ in range(tries):
                            ok, v = yield ReadNB(fifos[fin])
                            polls += 1
                            if ok:
                                acc = (acc * 31 + v + 7) % MOD
                                break
                            if gap:
                                yield Delay(gap)
                    else:
                        v = yield Read(fifos[fin])
                        acc = (acc * 31 + v + 7) % MOD
                    if ack_every and i % ack_every == ack_every - 1:
                        yield Write(fifos[ack_fid], i % 97)
            elif op == "WATCH":
                _, fid, max_polls, gap = ins
                for _ in range(max_polls):
                    ok, _v = yield ReadNB(fifos[fid])
                    polls += 1
                    if ok:
                        acc = (acc * 13 + 1) % MOD
                        break
                    if gap:
                        yield Delay(gap)
            elif op == "RING":
                _, fin, fout, rounds, prime = ins
                if prime:
                    yield Write(fifos[fout], 1)
                for _ in range(rounds):
                    v = yield Read(fifos[fin])
                    acc = (acc * 31 + v + 7) % MOD
                    yield Write(fifos[fout], (v + 1) % 97)
            elif op == "PROBE":
                _, fid, kind, used = ins
                if kind == "E":
                    e = yield Empty(fifos[fid], used=used)
                    if used:
                        acc = (acc * 13 + (1 if e else 2)) % MOD
                else:
                    fl = yield Full(fifos[fid], used=used)
                    if used:
                        acc = (acc * 13 + (4 if fl else 5)) % MOD
            elif op == "POLLV":
                # poll loop with a (possibly non-uniform) gap pattern —
                # periodizer material: constant runs burst, gap changes and
                # the final success force the per-query fallback
                _, fid, max_polls, pattern = ins
                gi = 0
                for _ in range(max_polls):
                    ok, _v = yield ReadNB(fifos[fid])
                    polls += 1
                    if ok:
                        acc = (acc * 13 + 1) % MOD
                        break
                    g = pattern[gi % len(pattern)]
                    gi += 1
                    if g > 1:
                        yield Delay(g - 1)
            elif op == "PTR":
                # probe-then-read: a commit between queries breaks the
                # periodic pattern, so bursts must re-arm per probe run
                _, fid, n_items, tries, gap = ins
                got = 0
                for _ in range(tries):
                    if got >= n_items:
                        break
                    e = yield Empty(fifos[fid])
                    if not e:
                        v = yield Read(fifos[fid])
                        got += 1
                        acc = (acc * 31 + v + 7) % MOD
                    elif gap:
                        yield Delay(gap)
                acc = (acc * 7 + got) % MOD
            elif op == "NEST":
                # nested NB polling: two query sites alternate, so no
                # single-site streak forms unless the inner site is removed
                _, fid_done, fid_data, max_polls, gap = ins
                for _ in range(max_polls):
                    ok, _v = yield ReadNB(fifos[fid_done])
                    polls += 1
                    if ok:
                        acc = (acc * 13 + 1) % MOD
                        break
                    ok2, v2 = yield ReadNB(fifos[fid_data])
                    polls += 1
                    if ok2:
                        acc = (acc * 31 + v2 + 7) % MOD
                    if gap:
                        yield Delay(gap)
            elif op == "FEED":
                # uniform-rate producer: one write every `gap` cycles — the
                # steady clock the multi-site / NB-success periodizer
                # patterns are built against
                _, fid, n_items, fgap, salt = ins
                for i in range(n_items):
                    yield Write(fifos[fid], (i * salt + 1) % 251)
                    if fgap > 1:
                        yield Delay(fgap - 1)
            elif op == "MSPOLL":
                # multi-site round-robin NB poll: one watcher sweeps several
                # data FIFOs fed at different (commensurate) rates, so the
                # steady state is a repeating (site, gap, outcome) tuple no
                # single-site streak detector can see — the generalized
                # pattern periodizer's fuzz material.  Bounded by max_iters.
                _, fids_ms, total, max_iters, pause = ins
                got = 0
                for _ in range(max_iters):
                    for fid in fids_ms:
                        ok, v = yield ReadNB(fifos[fid])
                        polls += 1
                        if ok:
                            acc = (acc * 31 + v + 7) % MOD
                            got += 1
                    if got >= total:
                        break
                    if pause:
                        yield Delay(pause)
                acc = (acc * 7 + got) % MOD
            elif op == "NBDRAIN":
                # steady *successful* NB stream: drain a FIFO with ReadNB at
                # the producer's rate — after warmup every poll hits, which
                # a fail-streak detector never periodizes but the success-
                # pattern path commits in run-ahead-bounded windows
                _, fid, n_items, attempts, dgap = ins
                got = 0
                for _ in range(attempts):
                    ok, v = yield ReadNB(fifos[fid])
                    polls += 1
                    if ok:
                        acc = (acc * 31 + v + 7) % MOD
                        got += 1
                        if got >= n_items:
                            break
                    if dgap > 1:
                        yield Delay(dgap - 1)
                acc = (acc * 7 + got) % MOD
            elif op == "W1":
                yield Write(fifos[ins[1]], ins[2])
            elif op == "D":
                yield Delay(ins[1])
            elif op == "R1":
                # single-token bridge: block until an upstream cluster's
                # sink hands over its checksum, then fold it in — chains
                # otherwise-independent clusters into one dependency path
                v = yield Read(fifos[ins[1]])
                acc = (acc * 31 + v + 7) % MOD
            elif op == "SPLIT":
                # round-robin deal: n items from fin, item i to
                # fouts[i % len(fouts)] — the fan-out node of corpus trees
                _, fin, fouts, n, delay = ins
                for i in range(n):
                    v = yield Read(fifos[fin])
                    acc = (acc * 31 + v + 7) % MOD
                    if delay and i % 4 == 3:
                        yield Delay(delay)
                    yield Write(fifos[fouts[i % len(fouts)]], (v * 3 + 1) % 251)
            elif op == "MERGE":
                # round-robin collect: cycle over fins, reading until each
                # input's known count is exhausted — the fan-in node.  The
                # read order is fixed by construction, so every engine must
                # reproduce it exactly (blocking on an input whose producer
                # is slow is the interesting hybrid/trace stress).
                _, fins, counts, fout = ins
                rem = list(counts)
                i = 0
                for _ in range(sum(counts)):
                    while rem[i % len(fins)] <= 0:
                        i += 1
                    j = i % len(fins)
                    i += 1
                    v = yield Read(fifos[fins[j]])
                    rem[j] -= 1
                    acc = (acc * 31 + v + 7) % MOD
                    if fout >= 0:
                        yield Write(fifos[fout], (v * 5 + 2) % 251)
            elif op == "BCAST":
                # broadcast: n items from fin, each written to every fout
                _, fin, fouts, n = ins
                for _ in range(n):
                    v = yield Read(fifos[fin])
                    acc = (acc * 31 + v + 7) % MOD
                    for fo in fouts:
                        yield Write(fifos[fo], (v + 1) % 251)
            elif op == "RINGK":
                # k-token feedback ring node: prime k initial tokens, then
                # read/transform/forward for `rounds` iterations.  With the
                # primer doing R rounds and every other node R + k, the ring
                # terminates with exactly k leftover tokens parked on the
                # primer's input FIFO — live for any depths >= 1.
                _, fin, fout, rounds, prime_k = ins
                for t in range(prime_k):
                    yield Write(fifos[fout], (t * 11 + 5) % 97)
                for _ in range(rounds):
                    v = yield Read(fifos[fin])
                    acc = (acc * 31 + v + 7) % MOD
                    yield Write(fifos[fout], (v + 1) % 97)
            elif op == "AXIWR":
                # AXI burst master: read phase (AR requests, R beats) then
                # write phase (AW/W/B), phase-ordered to match
                # core.axi.make_memory's service order.  The write phase
                # stores back the values just read, unchanged — so the
                # memory's backing store is a fixpoint and the module stays
                # observably pure under re-execution (trace fallback,
                # resimulate fallback, classify probes all re-run bodies).
                (_, fid_ar, fid_r, fid_aw, fid_w, fid_b, n_bursts, burst,
                 base, fid_out) = ins
                vals = []
                for b in range(n_bursts):
                    yield Write(fifos[fid_ar], (base + b * burst, burst))
                    for _ in range(burst):
                        v = yield Read(fifos[fid_r])
                        vals.append(v)
                        acc = (acc * 31 + v + 7) % MOD
                        if fid_out >= 0:
                            yield Write(fifos[fid_out], (v * 3 + 1) % 251)
                for b in range(n_bursts):
                    yield Write(fifos[fid_aw], (base + b * burst, burst))
                    for i in range(burst):
                        yield Write(fifos[fid_w], vals[b * burst + i])
                    r = yield Read(fifos[fid_b])
                    acc = (acc * 13 + r + 4) % MOD
            else:
                raise AssertionError(f"unknown macro {op!r}")
        yield Emit(name, (acc, polls, drops))

    return body


def build_case(seed: int, scale: int = 1):
    """Derive (builder, meta) for ``seed``.  ``scale`` multiplies the item
    count (the slow-marked long tail runs bigger pipelines)."""
    rng = random.Random(seed * 0x9E3779B1 + 0x5EED)
    n_stages = rng.randint(0, 2)
    n = rng.randint(4, 18) * scale
    depths = [rng.randint(1, 6) for _ in range(n_stages + 1)]
    prod_style = rng.choice(["B", "B", "B", "NB", "FPW"])
    lossy = [prod_style != "B"]
    stage_tries = []
    for _ in range(n_stages):
        goes_lossy = lossy[-1] or rng.random() < 0.25
        lossy.append(goes_lossy)
        stage_tries.append(rng.randint(2, 5))
    sink_tries = rng.randint(2, 6)
    gap = rng.choice([0, 0, 1, 2])
    delay = rng.choice([0, 0, 0, 1, 2])
    extra = rng.choice([0, 0, 0, 1, 2])         # leftover writes
    deadp = rng.random() < 0.3
    feedback = prod_style == "B" and not any(lossy) and rng.random() < 0.3
    ack_every = rng.randint(2, 5) if feedback else 0
    ack_depth = rng.randint(1, 3)
    watchdog = rng.random() < 0.35
    max_polls = rng.randint(2, 40) * scale
    ring = rng.random() < 0.18
    ring_prime = rng.random() < 0.7
    ring_rounds = rng.randint(2, 6)
    ring_depth_xy = rng.randint(1, 3)
    ring_depth_yx = rng.randint(1, 3)
    probes_on_first = rng.random() < 0.25

    def builder() -> Program:
        prog = Program(f"fuzz_{seed}", declared_type=None)
        chain = [prog.fifo(f"c{i}", depths[i]) for i in range(n_stages + 1)]
        ack = prog.fifo("ack", ack_depth) if feedback else None
        done = prog.fifo("done", 1) if watchdog else None
        fifos = list(chain) + ([ack] if ack else []) + ([done] if done else [])
        fid_of = {f.name: i for i, f in enumerate(fifos)}

        src_script = [("SRC", 0, n, prod_style,
                       fid_of["ack"] if feedback else -1, ack_every,
                       delay, deadp, extra)]
        if probes_on_first:
            src_script.insert(0, ("PROBE", 0, "F", True))
        prog.add_module("src", _interp("src", src_script, fifos))

        for k in range(n_stages):
            sc = [("RELAY", k, k + 1, n, stage_tries[k], gap,
                   lossy[k], delay)]
            prog.add_module(f"st{k}", _interp(f"st{k}", sc, fifos))

        sink_script = [("SINK", n_stages, n, lossy[-1], sink_tries, gap,
                        fid_of["ack"] if feedback else -1,
                        ack_every if feedback else 0)]
        if watchdog:
            sink_script.append(("W1", fid_of["done"], 1))
        prog.add_module("sink", _interp("sink", sink_script, fifos))

        if watchdog:
            prog.add_module("watch", _interp(
                "watch", [("WATCH", fid_of["done"], max_polls, gap)], fifos))

        if ring:
            xy = prog.fifo("xy", ring_depth_xy)
            yx = prog.fifo("yx", ring_depth_yx)
            fifos2 = fifos + [xy, yx]
            i_xy, i_yx = len(fifos), len(fifos) + 1
            prog.add_module("rx", _interp(
                "rx", [("RING", i_yx, i_xy, ring_rounds, ring_prime)],
                fifos2))
            prog.add_module("ry", _interp(
                "ry", [("RING", i_xy, i_yx, ring_rounds, False)], fifos2))
        return prog

    meta = dict(n=n, stages=n_stages, prod=prod_style, lossy=any(lossy),
                feedback=feedback, watchdog=watchdog, ring=ring,
                ring_prime=ring_prime)
    return builder, meta


# ---------------------------------------------------------------------------
# Query-dominated poll-loop cases: exercise the hybrid engine's
# steady-state query periodizer — its burst fast path AND its divergence
# fallback — plus the provisional-times batch solver under parked writers.
# ---------------------------------------------------------------------------
_POLL_PATTERNS = (
    (1,),                      # tight uniform loop: one burst covers the run
    (2,), (3,), (5,),          # uniform with gap
    (1, 1, 1, 4),              # bursty: periodic runs + divergence per cycle
    (1, 1, 1, 1, 1, 2, 1, 7),  # long constant runs, two break points
    (1, 2, 3),                 # no run of >= 3 equal gaps: never bursts
)


def build_poll_case(seed: int, scale: int = 1):
    """Derive (builder, meta) for a poll-dominated design.

    A blocking source -> sink pipeline streams ``n`` items; the sink
    signals per-poller ``done`` FIFOs, and 1-3 pollers hammer them with
    seeded poll-loop shapes: uniform and bursty gap patterns (``POLLV``),
    probe-then-read consumption (``PTR``, commits between queries), nested
    NB reads (``NEST``, alternating query sites) — mid-run outcome
    divergence (the final successful poll, every gap-pattern change) comes
    with the territory.  A seeded subset additionally carries a multi-site
    round-robin watcher over two rate-commensurate feeds (``MSPOLL``, the
    repeating mixed-outcome (site, gap) tuple) and a matched-rate NB
    success drain (``FEED`` -> ``NBDRAIN``).  Bounded attempt budgets keep
    every module terminating, so under-drained pipelines surface as
    reported deadlocks, never hangs.
    """
    rng = random.Random(seed * 0x517CC1B7 + 0xB5EED)
    n = rng.randint(6, 24) * scale
    depth = rng.randint(1, 6)
    n_pollers = rng.randint(1, 3)
    sink_ptr = rng.random() < 0.35      # probe-then-read sink
    sink_tries = 4 * n + 16
    ptr_gap = rng.choice([0, 1, 2])
    nest = rng.random() < 0.4           # one poller also NB-reads a side FIFO
    side_extra = rng.randint(0, 3)
    patterns = [rng.choice(_POLL_PATTERNS) for _ in range(n_pollers)]
    max_polls = [rng.randint(4, 40) * scale for _ in range(n_pollers)]
    sink_delay = rng.choice([0, 0, 1, 2])
    # multi-site watcher: round-robin NB over two FIFOs fed at rates
    # period / 2*period, so the steady state is a repeating mixed-outcome
    # (site, gap) tuple — generalized-pattern periodizer material
    msite = rng.random() < 0.35
    ms_items = rng.randint(4, 12) * scale
    ms_pause = rng.choice([0, 1, 2])
    ms_depth = rng.randint(2, 8)
    # NB-success drain: a matched-rate FEED -> NBDRAIN pair where (after
    # warmup) every poll hits — the success-stream periodizer pattern
    nbdrain = rng.random() < 0.35
    nd_items = rng.randint(4, 16) * scale
    nd_gap = rng.choice([1, 2, 3])
    nd_depth = rng.randint(2, 8)

    def builder() -> Program:
        prog = Program(f"fuzz_poll_{seed}", declared_type=None)
        data = prog.fifo("data", depth)
        dones = [prog.fifo(f"done{i}", 1) for i in range(n_pollers)]
        side = prog.fifo("side", max(1, depth // 2)) if nest else None
        fifos = [data] + dones + ([side] if side else [])
        i_side = len(fifos) - 1
        if msite:
            fifos += [prog.fifo("ms_a", ms_depth), prog.fifo("ms_b", ms_depth)]
            i_ma, i_mb = len(fifos) - 2, len(fifos) - 1
        if nbdrain:
            fifos.append(prog.fifo("nd", nd_depth))
            i_nd = len(fifos) - 1

        # pollers first: trace="auto" aborts to the hybrid path immediately
        for i in range(n_pollers):
            if nest and i == 0:
                script = [("NEST", 1 + i, i_side, max_polls[i],
                           patterns[i][0] - 1)]
            else:
                script = [("POLLV", 1 + i, max_polls[i], patterns[i])]
            prog.add_module(f"poll{i}", _interp(f"poll{i}", script, fifos))

        if msite:
            ms_total = ms_items + ms_items // 2
            prog.add_module("watcher", _interp("watcher", [
                ("MSPOLL", (i_ma, i_mb), ms_total, 2 * ms_total + 16,
                 ms_pause)], fifos))
        if nbdrain:
            prog.add_module("drain", _interp("drain", [
                ("NBDRAIN", i_nd, nd_items, 3 * nd_items + 24, nd_gap)],
                fifos))

        src_script = [("SRC", 0, n, "B", -1, 0, 0, False, 0)]
        if nest:
            src_script.append(("SRC", i_side, side_extra + 1, "B",
                               -1, 0, 0, False, 0))
        prog.add_module("src", _interp("src", src_script, fifos))

        if msite:
            ms_period = ms_pause + 2    # cycles per watcher iteration
            prog.add_module("feed_a", _interp("feed_a", [
                ("FEED", i_ma, ms_items, ms_period, 7)], fifos))
            prog.add_module("feed_b", _interp("feed_b", [
                ("FEED", i_mb, ms_items // 2, 2 * ms_period, 13)], fifos))
        if nbdrain:
            prog.add_module("nd_feed", _interp("nd_feed", [
                ("FEED", i_nd, nd_items, nd_gap, 11)], fifos))

        if sink_ptr:
            sink_script = [("PTR", 0, n, sink_tries, ptr_gap)]
        else:
            sink_script = [("SINK", 0, n, False, 0, 0, -1, 0)]
        if sink_delay:
            sink_script.append(("D", sink_delay))
        sink_script += [("W1", 1 + i, 1) for i in range(n_pollers)]
        prog.add_module("sink", _interp("sink", sink_script, fifos))
        return prog

    meta = dict(n=n, depth=depth, pollers=n_pollers, patterns=patterns,
                sink_ptr=sink_ptr, nest=nest, msite=msite, nbdrain=nbdrain)
    return builder, meta
