"""Constrained-random corpus generator: 10-1000-module dataflow Programs.

``generate(seed, scale)`` derives a :class:`CorpusCase` — a zero-arg
Program builder plus structural metadata — by composing motif *clusters*
until the module budget ``scale`` is met:

  * ``pipeline`` — src -> relay* -> sink chains, optionally lossy/NB
    downstream of a randomly chosen stage (the fuzz-suite shape, scaled);
  * ``tree`` / ``diamond`` — round-robin SPLIT trees fanning a source out
    over ``b^L`` leaves, mirrored by MERGE fan-in back to one sink
    (multi-level fan-in/fan-out the hand corpus never reaches);
  * ``ring`` — an m-module feedback cycle primed with k initial tokens
    (live by token accounting: the primer runs R rounds, every other node
    R + k, leaving exactly k tokens parked at the end);
  * ``poll`` — done-signal pollers with POLLV/PTR/NEST query loops
    (the hybrid periodizer's diet);
  * ``axi`` — an AXIWR burst master against a ``core.axi.make_memory``
    model, streaming beats to a sink (request/data/response channels are
    ordinary SPSC FIFOs, so AXI timing rides the same engine paths).

Clusters are independent subgraphs except where a single-token *bridge*
chains one cluster's sink to the next cluster's source (R1/W1 macros),
building dependency paths as deep as the cluster count.  Every sampled
parameter comes from a :class:`~repro_torch.corpus.spec.CorpusSpec` through one
seeded ``random.Random`` in one fixed draw order, so a case is
reproducible — bit-identical Program, fingerprint and trace — from
``(seed, scale, spec)`` alone.

The plan is built as plain data (FIFO name/depth rows + per-module macro
scripts) and only turned into a Program inside the builder, which keeps
module bodies pure/re-runnable and lets :meth:`CorpusCase.validate` check
SPSC and connectivity invariants statically, without running an engine.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

from ..core.axi import AxiPort, make_memory
from ..core.program import Program

from .builders import _interp
from .spec import BLOCKING_SPEC, DEFAULT_SPEC, CorpusSpec

# macro -> (positions read from, positions written to); a position is an
# index into the instruction tuple holding a fid (or tuple of fids);
# negative fids mean "unused" and are skipped.  PROBE/WATCH-style
# query-only macros count as readers: the engine registers the polling
# module as the FIFO's consumer endpoint.
_MACRO_ROLES = {
    "SRC":   (lambda ins: [ins[4]], lambda ins: [ins[1]]),
    "RELAY": (lambda ins: [ins[1]], lambda ins: [ins[2]]),
    "SINK":  (lambda ins: [ins[1]], lambda ins: [ins[6]] if ins[7] else []),
    "WATCH": (lambda ins: [ins[1]], lambda ins: []),
    "RING":  (lambda ins: [ins[1]], lambda ins: [ins[2]]),
    "RINGK": (lambda ins: [ins[1]], lambda ins: [ins[2]]),
    "POLLV": (lambda ins: [ins[1]], lambda ins: []),
    "PTR":   (lambda ins: [ins[1]], lambda ins: []),
    "NEST":  (lambda ins: [ins[1], ins[2]], lambda ins: []),
    "W1":    (lambda ins: [], lambda ins: [ins[1]]),
    "R1":    (lambda ins: [ins[1]], lambda ins: []),
    "D":     (lambda ins: [], lambda ins: []),
    "SPLIT": (lambda ins: [ins[1]], lambda ins: list(ins[2])),
    "MERGE": (lambda ins: list(ins[1]), lambda ins: [ins[3]]),
    "BCAST": (lambda ins: [ins[1]], lambda ins: list(ins[2])),
    "AXIWR": (lambda ins: [ins[2], ins[5]],
              lambda ins: [ins[1], ins[3], ins[4], ins[9]]),
}


class _Plan:
    """Mutable plan: FIFO rows + module entries, later frozen into a
    builder closure."""

    def __init__(self):
        self.fifo_rows: List[Tuple[str, int]] = []
        self.modules: List[list] = []   # ["interp", name, script-list] or
        #                                 ["aximem", name, fids, size, lat]

    def fifo(self, name: str, depth: int) -> int:
        self.fifo_rows.append((name, depth))
        return len(self.fifo_rows) - 1

    def interp(self, name: str, script: list) -> list:
        """Add a macro-script module; returns the (mutable) script so
        bridges can splice R1/W1 instructions in later."""
        entry = ["interp", name, script]
        self.modules.append(entry)
        return script

    def aximem(self, name: str, fids, size: int, lat: int, n_bursts: int):
        self.modules.append(["aximem", name, tuple(fids), size, lat,
                             n_bursts])

    @property
    def n_modules(self) -> int:
        return len(self.modules)


@dataclass
class CorpusCase:
    """A generated corpus design: builder + metadata + static plan."""
    name: str
    seed: int
    scale: int
    spec: CorpusSpec
    builder: Callable[[], Program]
    meta: Dict = field(default_factory=dict)
    _plan: _Plan = field(default=None, repr=False)

    def validate(self) -> None:
        """Static structural invariants: every FIFO has exactly one writer
        module and exactly one reader module (SPSC + full connectivity)."""
        writers: Dict[int, List[str]] = {}
        readers: Dict[int, List[str]] = {}

        def note(table, fid, mname):
            if fid is None or fid < 0:
                return
            table.setdefault(fid, []).append(mname)

        for entry in self._plan.modules:
            if entry[0] == "interp":
                _, mname, script = entry
                for ins in script:
                    rd, wr = _MACRO_ROLES[ins[0]]
                    for fid in rd(ins):
                        note(readers, fid, mname)
                    for fid in wr(ins):
                        note(writers, fid, mname)
            else:
                _, mname, fids, _size, _lat, _nb = entry
                ar, r, aw, w, b = fids
                for fid in (ar, aw, w):
                    note(readers, fid, mname)
                for fid in (r, b):
                    note(writers, fid, mname)

        for fid, (fname, _depth) in enumerate(self._plan.fifo_rows):
            ws = sorted(set(writers.get(fid, [])))
            rs = sorted(set(readers.get(fid, [])))
            if len(ws) != 1 or len(rs) != 1:
                raise AssertionError(
                    f"{self.name}: FIFO {fname} (fid {fid}) violates "
                    f"SPSC/connectivity: writers={ws} readers={rs}")


# ---------------------------------------------------------------------------
# cluster builders: each appends FIFOs + modules to the plan and returns
# (head_script, tail_script, cluster_meta) — head/tail are the mutable
# scripts bridges splice into.
# ---------------------------------------------------------------------------
def _pipeline_cluster(plan, rng, spec, pfx):
    n = spec.items.draw(rng)
    stages = spec.pipeline_stages.draw(rng)
    delay = spec.delay.draw(rng)
    gap = spec.gap.draw(rng)
    chain = [plan.fifo(f"{pfx}_c{i}", spec.depth.draw(rng))
             for i in range(stages + 1)]
    # once a stage goes lossy every downstream stage (and the sink) must be
    # lossy too, or dropped items deadlock a blocking reader
    # a starved pipeline under-produces by one item: every stage blocks on
    # the missing token, a deterministic deadlock the conformance runner
    # must verdict identically on every engine path
    starved = rng.random() < spec.starve_prob
    lossy = [False]
    for _ in range(stages):
        lossy.append((not starved)
                     and (lossy[-1] or rng.random() < spec.query_density))
    # Lossy stages need a real poll window (gap >= 1, generous tries):
    # with gap 0 every NB retry lands on the same cycle, the stage drops
    # nearly every item, and the blocking producer wedges on a full FIFO.
    # A wide window makes drops rare, so most designs stay live and the
    # occasional genuine drop-induced deadlock remains in the corpus.
    if any(lossy):
        gap = max(1, gap)
    tries = [rng.randint(8, 16) for _ in range(stages)]
    sink_tries = 4 * n + 16

    head = plan.interp(f"{pfx}_src",
                       [("SRC", chain[0], n - 1 if starved else n, "B",
                         -1, 0, delay, False, 0)])
    for k in range(stages):
        plan.interp(f"{pfx}_st{k}",
                    [("RELAY", chain[k], chain[k + 1], n, tries[k], gap,
                      2 if lossy[k] else False, delay)])
    tail = plan.interp(f"{pfx}_sink",
                       [("SINK", chain[stages], n,
                         2 if lossy[-1] else False, sink_tries,
                         gap, -1, 0)])
    return head, tail, dict(motif="pipeline", has_nb=any(lossy),
                            cyclic=False, starved=starved)


def _tree_cluster(plan, rng, spec, pfx, budget, levels=None):
    b = spec.fanout.draw(rng)
    levels_drawn = spec.tree_levels.draw(rng)
    L = levels if levels is not None else levels_drawn
    n = spec.items.draw(rng)
    delay = spec.delay.draw(rng)

    def est(b, L):
        return 2 * ((b ** L - 1) // (b - 1)) + b ** L + 2

    while est(b, L) > max(10, budget) and (L > 1 or b > 2):
        if L > 1:
            L -= 1
        elif b > 2:
            b -= 1

    root = plan.fifo(f"{pfx}_root", spec.depth.draw(rng))
    head = plan.interp(f"{pfx}_src",
                       [("SRC", root, n, "B", -1, 0, delay, False, 0)])
    nid = [0]

    def rec(fid_in, count, level):
        k = nid[0]
        nid[0] += 1
        if level == 0:
            out = plan.fifo(f"{pfx}_lf{k}", spec.depth.draw(rng))
            plan.interp(f"{pfx}_leaf{k}",
                        [("RELAY", fid_in, out, count, 0, 0, False, delay)])
            return out, count
        fouts = [plan.fifo(f"{pfx}_s{k}_{j}", spec.depth.draw(rng))
                 for j in range(b)]
        plan.interp(f"{pfx}_split{k}",
                    [("SPLIT", fid_in, tuple(fouts), count, delay)])
        child = [rec(fouts[j],
                     count // b + (1 if j < count % b else 0),
                     level - 1)
                 for j in range(b)]
        mout = plan.fifo(f"{pfx}_m{k}", spec.depth.draw(rng))
        plan.interp(f"{pfx}_merge{k}",
                    [("MERGE", tuple(c[0] for c in child),
                      tuple(c[1] for c in child), mout)])
        return mout, count

    mout, total = rec(root, n, L)
    tail = plan.interp(f"{pfx}_sink",
                       [("SINK", mout, total, False, 0, 0, -1, 0)])
    return head, tail, dict(motif="tree" if L > 1 else "diamond",
                            has_nb=False, cyclic=False,
                            fanout=b, levels=L)


def _ring_cluster(plan, rng, spec, pfx):
    m = spec.ring_modules.draw(rng)
    rounds = spec.ring_rounds.draw(rng)
    k = spec.ring_tokens.draw(rng)
    # fids[i]: module i -> module (i+1) % m.  The primer stops reading k
    # tokens before its upstream stops writing (the primed tokens retire
    # in the primer's input FIFO), so that edge needs depth >= k or the
    # last node wedges on its final writes.
    fids = [plan.fifo(f"{pfx}_r{i}",
                      max(spec.depth.draw(rng), k if i == m - 1 else 1))
            for i in range(m)]
    head = tail = plan.interp(
        f"{pfx}_n0", [("RINGK", fids[m - 1], fids[0], rounds, k)])
    for i in range(1, m):
        plan.interp(f"{pfx}_n{i}",
                    [("RINGK", fids[i - 1], fids[i], rounds + k, 0)])
    return head, tail, dict(motif="ring", has_nb=False, cyclic=True,
                            modules=m, tokens=k)


def _poll_cluster(plan, rng, spec, pfx):
    n = spec.items.draw(rng)
    depth = spec.depth.draw(rng)
    n_pollers = spec.n_pollers.draw(rng)
    gap = spec.gap.draw(rng)
    data = plan.fifo(f"{pfx}_data", depth)
    dones = [plan.fifo(f"{pfx}_done{i}", 1) for i in range(n_pollers)]
    side_caps = {}

    for i in range(n_pollers):
        budget = spec.poll_budget.draw(rng)
        kind = rng.choice(["POLLV", "POLLV", "PTR", "NEST"])
        if kind == "POLLV":
            pat = tuple(rng.choice([1, 1, 2, 3])
                        for _ in range(rng.randint(1, 4)))
            script = [("POLLV", dones[i], budget, pat)]
        elif kind == "PTR":
            script = [("PTR", dones[i], 1, budget, gap)]
        else:
            sdepth = max(1, depth // 2)
            side = plan.fifo(f"{pfx}_side{i}", sdepth)
            script = [("NEST", dones[i], side, budget, gap)]
            side_caps[side] = sdepth
        plan.interp(f"{pfx}_poll{i}", script)

    src_script = [("SRC", data, n, "B", -1, 0, 0, False, 0)]
    for ins in [m[2][0] for m in plan.modules[-n_pollers:]]:
        if ins[0] == "NEST":
            # a NEST poller may exit (done token seen) before draining its
            # side FIFO, so never write more side items than the FIFO
            # holds — the source must be able to finish unassisted
            src_script.append(("SRC", ins[2],
                               rng.randint(1, side_caps[ins[2]]), "B",
                               -1, 0, 0, False, 0))
    head = plan.interp(f"{pfx}_src", src_script)
    sink_script = [("SINK", data, n, False, 0, 0, -1, 0)]
    sink_script += [("W1", d, 1) for d in dones]
    tail = plan.interp(f"{pfx}_sink", sink_script)
    return head, tail, dict(motif="poll", has_nb=True, cyclic=False,
                            pollers=n_pollers)


def _axi_cluster(plan, rng, spec, pfx):
    burst = spec.burst_len.draw(rng)
    n_bursts = spec.axi_bursts.draw(rng)
    lat = spec.axi_read_latency.draw(rng)
    depth = spec.depth.draw(rng)
    ar = plan.fifo(f"{pfx}_ar", depth)
    r = plan.fifo(f"{pfx}_r", depth)
    aw = plan.fifo(f"{pfx}_aw", depth)
    w = plan.fifo(f"{pfx}_w", depth)
    b = plan.fifo(f"{pfx}_b", depth)
    out = plan.fifo(f"{pfx}_out", spec.depth.draw(rng))
    head = plan.interp(f"{pfx}_master",
                       [("AXIWR", ar, r, aw, w, b, n_bursts, burst, 0,
                         out)])
    plan.aximem(f"{pfx}_mem", (ar, r, aw, w, b), n_bursts * burst, lat,
                n_bursts)
    tail = plan.interp(f"{pfx}_sink",
                       [("SINK", out, n_bursts * burst, False, 0, 0, -1,
                         0)])
    return head, tail, dict(motif="axi", has_nb=False, cyclic=True,
                            burst=burst, bursts=n_bursts)


_CLUSTERS = {
    "pipeline": _pipeline_cluster,
    "tree": _tree_cluster,
    "diamond": lambda plan, rng, spec, pfx, budget:
        _tree_cluster(plan, rng, spec, pfx, budget, levels=1),
    "ring": _ring_cluster,
    "poll": _poll_cluster,
    "axi": _axi_cluster,
}


def _builder_from_rows(name: str, declared: str,
                       fifo_rows: tuple,
                       module_rows: tuple) -> Callable[[], Program]:
    """Freeze immutable (fifo, module) row tuples into a Program builder.

    Both :func:`generate` and :func:`edit_pairs` close over this one
    function, so a design and a row-level transformation of it hash their
    module bodies through identical bytecode — ``program_fingerprint`` and
    the per-module delta fingerprints differ only where the *rows* differ.
    """
    def builder() -> Program:
        prog = Program(name, declared_type=declared)
        fifos = [prog.fifo(nm, d) for nm, d in fifo_rows]
        for entry in module_rows:
            if entry[0] == "interp":
                _, mname, script = entry
                prog.add_module(mname, _interp(mname, script, fifos))
            else:
                _, mname, fids, size, lat, n_bursts = entry
                port = AxiPort(ar=fifos[fids[0]], r=fifos[fids[1]],
                               aw=fifos[fids[2]], w=fifos[fids[3]],
                               b=fifos[fids[4]])
                data = [(i * 7 + 3) % 97 for i in range(size)]
                make_memory(prog, port, data, read_latency=lat,
                            write_latency=8, name=mname,
                            n_reads=n_bursts, n_writes=n_bursts)
        return prog
    return builder


def generate(seed: int, scale: int = 32,
             spec: CorpusSpec = DEFAULT_SPEC) -> CorpusCase:
    """Generate a corpus design with roughly ``scale`` modules.

    Deterministic: the same ``(seed, scale, spec)`` triple always yields a
    bit-identical Program (same ``program_fingerprint``).  Module count is
    ``scale`` to ``scale + ~12`` — the last cluster may overshoot by its
    own size.
    """
    if scale < 1:
        raise ValueError(f"scale must be >= 1, got {scale}")
    rng = random.Random(seed * 1_000_003 + scale * 7_919 + 0x5EED)
    plan = _Plan()
    motif_bag = [m for m, wgt in sorted(spec.motif_weights.items())
                 for _ in range(wgt)]
    if not motif_bag:
        raise ValueError("spec.motif_weights selects no motifs")

    clusters = []
    prev_tail = None
    ci = 0
    while plan.n_modules < scale:
        motif = rng.choice(motif_bag)
        pfx = f"c{ci}"
        budget = scale - plan.n_modules
        if motif in ("tree", "diamond"):
            head, tail, cmeta = _CLUSTERS[motif](plan, rng, spec, pfx,
                                                 budget)
        else:
            head, tail, cmeta = _CLUSTERS[motif](plan, rng, spec, pfx)
        bridged = (prev_tail is not None
                   and rng.random() < spec.bridge_prob)
        if bridged:
            bfid = plan.fifo(f"{pfx}_bridge", 1)
            prev_tail.append(("W1", bfid, (ci * 13 + 7) % 97))
            head.insert(0, ("R1", bfid))
        cmeta["bridged"] = bridged
        clusters.append(cmeta)
        prev_tail = tail
        ci += 1

    has_nb = any(c["has_nb"] for c in clusters)
    cyclic = any(c["cyclic"] for c in clusters)
    declared = "C" if has_nb else ("B" if cyclic else "A")
    name = f"corpus_s{seed}_m{scale}"

    # freeze the plan into immutable closures for the builder: scripts
    # become tuples so program_fingerprint hashes pure content
    fifo_rows = tuple(plan.fifo_rows)
    module_rows = tuple(
        ("interp", e[1], tuple(e[2])) if e[0] == "interp"
        else ("aximem", e[1], e[2], e[3], e[4], e[5])
        for e in plan.modules)

    builder = _builder_from_rows(name, declared, fifo_rows, module_rows)

    meta = dict(modules=plan.n_modules, fifos=len(plan.fifo_rows),
                clusters=[c["motif"] for c in clusters],
                declared=declared, has_nb=has_nb, cyclic=cyclic,
                bridges=sum(1 for c in clusters if c["bridged"]))
    return CorpusCase(name=name, seed=seed, scale=scale, spec=spec,
                      builder=builder, meta=meta, _plan=plan)


# ---------------------------------------------------------------------------
# edit pairs: (base, edited) designs spanning every structural-delta class
# ---------------------------------------------------------------------------
@dataclass
class EditPair:
    """One corpus edit: a base design, an edited variant, and what the
    delta subsystem is expected to do with it.

    ``expect`` is ``"patched"`` for edits the trace patcher must serve by
    per-module splicing (pure timing/body edits, FIFO re-depths) and
    ``"cold"`` for edits it must reject to a cold rebuild (value changes,
    renames, interface/topology changes).  Either way the served result
    must be bit-identical to a from-scratch simulation of ``edited()``.
    """
    kind: str
    name: str
    base: Callable[[], Program]
    edited: Callable[[], Program]
    expect: str
    detail: str = ""


#: every delta class the corpus can exercise, in emission order
EDIT_KINDS = ("delay", "retype", "value", "rename", "interface",
              "added", "removed")

#: kinds the patch layer must serve without a cold rebuild
PATCHABLE_KINDS = ("delay", "retype")


def _edit_script(module_rows: tuple, mi: int, fn) -> tuple:
    """Return ``module_rows`` with module ``mi``'s script rewritten by
    ``fn(list(script)) -> list``."""
    rows = list(module_rows)
    _, mname, script = rows[mi]
    rows[mi] = ("interp", mname, tuple(fn(list(script))))
    return tuple(rows)


def _find_w1(module_rows: tuple):
    """Locate a literal single-write macro: (module index, script index)."""
    for mi, entry in enumerate(module_rows):
        if entry[0] != "interp":
            continue
        for si, ins in enumerate(entry[2]):
            if ins[0] == "W1":
                return mi, si
    return None


def edit_pairs(seed: int, scale: int = 32,
               spec: CorpusSpec = BLOCKING_SPEC,
               kinds: Tuple[str, ...] = EDIT_KINDS,
               max_probes: int = 64) -> List[EditPair]:
    """Derive (base, edited) design pairs covering the delta taxonomy.

    Probes seeds ``seed, seed+1, ...`` (up to ``max_probes``) for a live,
    trace-recordable base design that has at least one macro-script module
    and one literal ``W1`` write (a cluster bridge), then emits one
    :class:`EditPair` per requested kind as a pure row-level
    transformation of the frozen plan:

      * ``delay``     — insert a ``("D", k)`` stall into one module body
        (BODY_EDITED; must patch);
      * ``retype``    — one FIFO depth + 1 (fifo RETYPED; must patch —
        deepening a FIFO never removes behavior);
      * ``value``     — bump a bridge's written constant (functional edit;
        the write-stream gate must reject to cold);
      * ``rename``    — rename a FIFO (not patchable by contract);
      * ``interface`` — add a FIFO, a write of it to an existing module
        and a fresh reader module (INTERFACE_CHANGED + ADDED);
      * ``added`` / ``removed`` — a standalone writer/reader pair over a
        new FIFO appears / disappears.

    Base and edited builders share the Program name — only content
    distinguishes their fingerprints, exactly like a user edit.
    """
    from ..core.trace import TraceUnsupported, record_trace

    unknown = set(kinds) - set(EDIT_KINDS)
    if unknown:
        raise ValueError(f"unknown edit kinds: {sorted(unknown)}")

    case = fifo_rows = module_rows = declared = w1 = None
    for off in range(max_probes):
        cand = generate(seed + off, scale=scale, spec=spec)
        rows = tuple(
            ("interp", e[1], tuple(e[2])) if e[0] == "interp"
            else ("aximem", e[1], e[2], e[3], e[4], e[5])
            for e in cand._plan.modules)
        w1_at = _find_w1(rows)
        if w1_at is None:
            continue
        try:
            record_trace(cand.builder())
        except TraceUnsupported:
            continue
        case, module_rows, w1 = cand, rows, w1_at
        fifo_rows = tuple(cand._plan.fifo_rows)
        declared = cand.meta["declared"]
        break
    if case is None:
        raise RuntimeError(
            f"no live editable base design within {max_probes} probes of "
            f"seed {seed} (scale {scale})")

    rng = random.Random(seed * 99_991 + scale * 101 + 0xED17)
    interp_idx = [i for i, e in enumerate(module_rows) if e[0] == "interp"]
    mk = lambda fr, mr: _builder_from_rows(case.name, declared, fr, mr)
    base = mk(fifo_rows, module_rows)
    pairs: List[EditPair] = []

    for kind in kinds:
        if kind == "delay":
            mi = rng.choice(interp_idx)
            k = 1 + rng.randrange(9)
            pos = rng.randrange(len(module_rows[mi][2]) + 1)
            edited_rows = _edit_script(
                module_rows, mi, lambda s: s[:pos] + [("D", k)] + s[pos:])
            pairs.append(EditPair(
                kind, case.name, base, mk(fifo_rows, edited_rows),
                "patched", f"+{k}-cycle stall in {module_rows[mi][1]}"))
        elif kind == "retype":
            fi = rng.randrange(len(fifo_rows))
            fr = list(fifo_rows)
            fr[fi] = (fr[fi][0], fr[fi][1] + 1)
            pairs.append(EditPair(
                kind, case.name, base, mk(tuple(fr), module_rows),
                "patched", f"FIFO {fifo_rows[fi][0]} depth +1"))
        elif kind == "value":
            mi, si = w1
            def bump(s, si=si):
                op, fid, v = s[si]
                s[si] = (op, fid, v + 1)
                return s
            edited_rows = _edit_script(module_rows, mi, bump)
            pairs.append(EditPair(
                kind, case.name, base, mk(fifo_rows, edited_rows),
                "cold", f"bridge value +1 in {module_rows[mi][1]}"))
        elif kind == "rename":
            fi = rng.randrange(len(fifo_rows))
            fr = list(fifo_rows)
            fr[fi] = (fr[fi][0] + "_rn", fr[fi][1])
            pairs.append(EditPair(
                kind, case.name, base, mk(tuple(fr), module_rows),
                "cold", f"FIFO {fifo_rows[fi][0]} renamed"))
        elif kind == "interface":
            nf = len(fifo_rows)
            fr = fifo_rows + (("xtra_if", 1),)
            mi = rng.choice(interp_idx)
            mr = _edit_script(module_rows, mi,
                              lambda s: s + [("W1", nf, 41)])
            mr = mr + (("interp", "xrd_if", (("R1", nf),)),)
            pairs.append(EditPair(
                kind, case.name, base, mk(fr, mr), "cold",
                f"new port on {module_rows[mi][1]} + reader module"))
        elif kind in ("added", "removed"):
            nf = len(fifo_rows)
            fr = fifo_rows + (("xtra_sb", 1),)
            mr = module_rows + (("interp", "xwr_sb", (("W1", nf, 9),)),
                                ("interp", "xrd_sb", (("R1", nf),)))
            big, small = mk(fr, mr), base
            if kind == "added":
                pairs.append(EditPair(kind, case.name, small, big, "cold",
                                      "standalone writer/reader pair added"))
            else:
                pairs.append(EditPair(kind, case.name, big, small, "cold",
                                      "standalone writer/reader pair removed"))
    return pairs
