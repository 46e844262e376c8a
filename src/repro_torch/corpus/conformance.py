"""Differential conformance runner for corpus designs (PyTorch port of
``repro.corpus.conformance``).

``check_conformance(builder)`` runs one design through every engine path
the repo ships —

  * ``generator``         — ``simulate(trace="never")``, the reference;
  * ``auto``              — whatever ``trace="auto"`` selects;
  * ``hybrid``            — ``simulate_hybrid(periodize=False)``;
  * ``periodized``        — ``simulate_hybrid(periodize=True)``;
  * ``resimulate``        — incremental re-finalization at variant depths;
  * ``resimulate_batch``  — the batched host solver (``backend="numpy"``,
    the reference's default lane) over [variant, base] rows;
  * ``sweep``             — ``repro_torch.sweep.SweepService`` over the
    same rows, on ``device``;
  * ``cuda``              — the sparse max-plus CUDA kernel's lane
    (``backend="cuda"`` on ``device``), bit-identical verdicts against
    numpy over [variant, base, all-ones] rows

— and demands a bit-identical record from each: cycles, deadlock verdict,
outputs, an order-insensitive digest of every FIFO table (commit times per
side + leftover payloads), constraint count and query/forced-false stats.
The record/digest layout is the reference's, so a port record equals the
reference's record of the same design and the checked-in corpus seed
list (``tests/golden/corpus_seeds.json``).

``rtl_crosscheck(builder)`` compares the default engine against the
cycle-stepped RTL oracle (``core.rtlsim.simulate_rtl``) — outputs AND
cycle counts must agree exactly; it is orders of magnitude slower, which
is why the corpus suite samples it instead of sweeping the full corpus.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..core import resimulate, resimulate_batch, simulate, simulate_rtl
from ..core.trace import TraceUnsupported, simulate_hybrid

#: every engine path the runner differential-checks, in check order
ENGINE_PATHS = ("generator", "auto", "hybrid", "periodized",
                "resimulate", "resimulate_batch", "sweep", "cuda")


def normalize(obj):
    """JSON-stable view: tuples -> lists, recursively, sorted dict keys."""
    if isinstance(obj, dict):
        return {str(k): normalize(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [normalize(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    return obj


def fifo_digest(result) -> str:
    """Order-insensitive digest of every FIFO table's end state (commit
    times per side + leftover payloads)."""
    h = hashlib.sha256()
    for tbl in result.graph.fifos:
        h.update(np.sort(np.asarray(tbl.write_times, np.int64)).tobytes())
        h.update(b"|")
        h.update(np.sort(np.asarray(tbl.read_times, np.int64)).tobytes())
        h.update(b"|")
        h.update(repr(list(tbl.values)).encode())
        h.update(b"#")
    return h.hexdigest()


def result_record(result) -> dict:
    """The conformance record every engine path must reproduce."""
    return {
        "cycles": int(result.cycles),
        "deadlock": bool(result.deadlock),
        "deadlock_cycle": int(result.deadlock_cycle),
        "outputs": normalize(result.outputs),
        "fifo_digest": fifo_digest(result),
        "n_constraints": len(result.constraints),
        "stats": {
            "nodes": int(result.stats.nodes),
            "edges": int(result.stats.edges),
            "queries": int(result.stats.queries),
            "queries_forced_false": int(result.stats.queries_forced_false),
            "skipped_probes": int(result.stats.skipped_probes),
        },
    }


def _diff(ref: dict, got: dict) -> str:
    keys = [k for k in ref if ref[k] != got.get(k)]
    parts = []
    for k in keys[:4]:
        r, g = ref[k], got.get(k)
        if isinstance(r, (dict, list)) and len(repr(r)) > 120:
            parts.append(f"{k} differs")
        else:
            parts.append(f"{k}: ref={r!r} got={g!r}")
    return "; ".join(parts) or "records differ"


@dataclass
class ConformanceReport:
    """Per-path verdicts plus the generator-engine reference record."""
    name: str
    reference: dict
    deadlock: bool
    hybrid_supported: bool
    paths: Dict[str, str] = field(default_factory=dict)  # path -> verdict

    @property
    def ok(self) -> bool:
        return not any(v.startswith("MISMATCH") for v in self.paths.values())

    def raise_on_mismatch(self) -> "ConformanceReport":
        bad = {p: v for p, v in self.paths.items()
               if v.startswith("MISMATCH")}
        if bad:
            detail = "; ".join(f"{p}: {v}" for p, v in bad.items())
            raise AssertionError(f"{self.name}: engine paths diverged — "
                                 f"{detail}")
        return self


def check_conformance(builder, *, name: str = "design",
                      service=None, paths=ENGINE_PATHS,
                      strict: bool = True,
                      device="cuda") -> ConformanceReport:
    """Differential-check ``builder`` across the selected engine paths.

    ``service`` may be a live :class:`repro_torch.sweep.SweepService`
    (reused across many designs to amortize worker startup); when omitted,
    the sweep path spins up an ephemeral in-process service on ``device``.
    ``device`` (default ``"cuda"``, which raises without a card) is where
    the ``"cuda"`` path and that service solve; ``device="cpu"`` runs the
    kernel's plain PyTorch version.  With ``strict``
    (default) any divergence raises ``AssertionError``; otherwise the
    report carries per-path ``MISMATCH: ...`` verdicts for the caller.
    """
    g = simulate(builder(), trace="never")
    ref = result_record(g)
    report = ConformanceReport(name=name, reference=ref,
                               deadlock=bool(g.deadlock),
                               hybrid_supported=True)
    report.paths["generator"] = "ok"

    def check(path, result):
        got = result_record(result)
        report.paths[path] = ("ok" if got == ref
                              else "MISMATCH: " + _diff(ref, got))

    if "auto" in paths:
        check("auto", simulate(builder(), trace="auto"))

    if "hybrid" in paths or "periodized" in paths:
        try:
            hp = simulate_hybrid(builder(), periodize=True)
            if "periodized" in paths:
                check("periodized", hp)
            if "hybrid" in paths:
                check("hybrid", simulate_hybrid(builder(), periodize=False))
        except TraceUnsupported as e:
            report.hybrid_supported = False
            for p in ("hybrid", "periodized"):
                if p in paths:
                    report.paths[p] = f"skipped: TraceUnsupported ({e})"

    variant_paths = [p for p in ("resimulate", "resimulate_batch", "sweep",
                                 "cuda") if p in paths]
    if variant_paths:
        if g.deadlock:
            for p in variant_paths:
                report.paths[p] = "skipped: base design deadlocks"
        else:
            dv = tuple(int(d) + 1 for d in g.depths)
            var = simulate(builder(), depths=dv, trace="never")
            vrec = (int(var.cycles), bool(var.deadlock),
                    normalize(var.outputs))

            if "resimulate" in paths:
                inc = resimulate(simulate(builder(), trace="auto"), dv)
                got = (int(inc.result.cycles), bool(inc.result.deadlock),
                       normalize(inc.result.outputs))
                report.paths["resimulate"] = (
                    "ok" if got == vrec else
                    f"MISMATCH: variant ref={vrec[:2]} got={got[:2]}")

            D = np.asarray([dv, [int(d) for d in g.depths]], dtype=np.int64)
            if "resimulate_batch" in paths:
                out = resimulate_batch(g, D, backend="numpy")
                ok = (int(out.cycles[0]) == vrec[0]
                      and int(out.cycles[1]) == ref["cycles"])
                report.paths["resimulate_batch"] = (
                    "ok" if ok else
                    f"MISMATCH: cycles={out.cycles.tolist()} "
                    f"want=[{vrec[0]}, {ref['cycles']}]")

            if "cuda" in paths:
                # sparse device-lane differential: the solver verdicts
                # (status / cycles / violated) must be bit-identical to
                # the numpy fixpoint — including a depth-1 row that may
                # starve writes (DEADLOCK) or invert event order (CYCLE)
                Dj = np.asarray([dv, [int(d) for d in g.depths],
                                 [1] * len(g.depths)], dtype=np.int64)
                o_np = resimulate_batch(g, Dj, backend="numpy",
                                        fallback=False)
                o_cu = resimulate_batch(g, Dj, backend="cuda",
                                        device=device, fallback=False)
                ok = (np.array_equal(o_np.status, o_cu.status)
                      and np.array_equal(o_np.cycles, o_cu.cycles)
                      and np.array_equal(o_np.violated, o_cu.violated))
                report.paths["cuda"] = (
                    "ok" if ok else
                    f"MISMATCH: cuda status={o_cu.status.tolist()} "
                    f"cycles={o_cu.cycles.tolist()} vs numpy "
                    f"status={o_np.status.tolist()} "
                    f"cycles={o_np.cycles.tolist()}")

            if "sweep" in paths:
                D3 = np.asarray([dv, [int(d) for d in g.depths], dv],
                                dtype=np.int64)
                svc = service
                owned = svc is None
                if owned:
                    from ..sweep import SweepService
                    svc = SweepService(block=8, shards=2, autostart=False,
                                       device=device)
                try:
                    s = svc.sweep(g, D3)
                    ok = (int(s.cycles[0]) == vrec[0]
                          and int(s.cycles[1]) == ref["cycles"]
                          and int(s.cycles[2]) == vrec[0]
                          and normalize(s.results[0].outputs) == vrec[2]
                          and bool(s.results[0].deadlock) == vrec[1])
                    report.paths["sweep"] = (
                        "ok" if ok else
                        f"MISMATCH: cycles={s.cycles.tolist()} "
                        f"want=[{vrec[0]}, {ref['cycles']}, {vrec[0]}]")
                finally:
                    if owned:
                        svc.close()

    if strict:
        report.raise_on_mismatch()
    return report


def rtl_crosscheck(builder, *, max_cycles: int = 2_000_000) -> dict:
    """Compare the default engine against the cycle-stepped RTL oracle.

    Returns a dict with ``agree`` (bool) and the per-engine verdicts.
    Agreement means: same deadlock verdict, and — for live designs — the
    same outputs and the exact same cycle count.  (Under deadlock the two
    report the blocked set differently, so only the verdict is compared.)
    """
    o = simulate(builder(), trace="auto")
    r = simulate_rtl(builder(), max_cycles=max_cycles)
    agree = bool(o.deadlock) == bool(r.deadlock)
    if agree and not o.deadlock:
        agree = (normalize(o.outputs) == normalize(r.outputs)
                 and int(o.cycles) == int(r.cycles))
    return dict(agree=agree, deadlock=bool(o.deadlock),
                cycles=int(o.cycles), rtl_cycles=int(r.cycles),
                engine=o.engine)
