"""Per-module structural fingerprints and the design-delta classifier.

``program_fingerprint`` (``core/trace.py``) gates the sweep service's warm
cache all-or-nothing: one edited module changes the whole-design key and
invalidates everything.  This module factors that key into a per-module
:class:`ModuleFingerprint` table so an *edit* can be classified
structurally — which modules changed, how, and whether the recorded trace
of everything else is still reusable (LightningSim's incremental
resimulation story, one level up: code deltas, not just depth deltas).

Hash flavors per module (all via ``core.trace._fp_update``):

* ``sig``   — FIFOs by name only (depth-insensitive, the ``HybridCache``
  flavor): equal ``sig`` ⇒ the module's recorded op stream and values are
  reusable verbatim under any depth vector.  This is the only *eagerly*
  computed flavor: the whole-design key composes per-FIFO (name, depth)
  rows with per-module ``sig`` digests and equals
  ``core.trace.program_fingerprint`` bit-for-bit, so fingerprinting a
  design costs one hash walk per module, not three.
* ``body``  — FIFOs as position-free placeholders: invariant under FIFO
  renames/re-depthing, so a ``sig`` change with an equal ``body`` is an
  *interface* change (re-wiring), not a code edit.  Computed lazily — the
  classifier only consults it for modules whose ``sig`` changed (a
  handful per edit), never for the unchanged bulk of the design.
* ``interface`` (a FIFO-name set, not a hash) — likewise lazy.

Classification is deliberately conservative: any module whose ``sig``
changed is re-recorded by ``repro_torch.delta.patch`` and its writes verified
against the original streams — the labels route work, the verifier
guarantees correctness.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.program import Fifo, Program
from ..core.trace import _fp_plain, _fp_update, module_content_hash

__all__ = [
    "UNCHANGED", "BODY_EDITED", "INTERFACE_CHANGED", "ADDED", "REMOVED",
    "KEPT", "RETYPED", "RENAMED",
    "ModuleFingerprint", "DesignFingerprint", "DesignDelta",
    "fingerprint_design", "diff",
]

# module labels
UNCHANGED = "unchanged"
BODY_EDITED = "body_edited"
INTERFACE_CHANGED = "interface_changed"
ADDED = "added"
REMOVED = "removed"
# FIFO labels (ADDED / REMOVED are shared with the module labels)
KEPT = "kept"
RETYPED = "retyped"
RENAMED = "renamed"


def _collect_fifos(obj, acc: set, depth: int = 0,
                   memo: Optional[dict] = None) -> None:
    """Best-effort static walk collecting ``Fifo`` names reachable from a
    module closure (mirrors ``_fp_update``'s traversal).

    ``memo`` caches per-container name sets keyed by ``(id, depth)`` so a
    capture shared between modules (generated designs close every module
    over one FIFO list) is walked once per design, not once per module.
    Entries must not outlive the walked objects.
    """
    if depth > 8:
        return
    import types
    if isinstance(obj, Fifo):
        acc.add(obj.name)
    elif isinstance(obj, types.FunctionType):
        if obj.__closure__:
            for cell in obj.__closure__:
                try:
                    _collect_fifos(cell.cell_contents, acc, depth + 1, memo)
                except ValueError:
                    pass
        for v in (obj.__defaults__ or ()):
            _collect_fifos(v, acc, depth + 1, memo)
        for v in (obj.__kwdefaults__ or {}).values():
            _collect_fifos(v, acc, depth + 1, memo)
        g = obj.__globals__
        gkey = (id(obj.__code__), id(g), "gnames") \
            if memo is not None else None
        if gkey is not None and gkey in memo:
            gnames = memo[gkey]
        else:
            gnames = set(obj.__code__.co_names) & set(g)
            if gkey is not None:
                memo[gkey] = gnames
        for name in gnames:
            v = g[name]
            if not isinstance(v, types.ModuleType):
                _collect_fifos(v, acc, depth + 1, memo)
    elif isinstance(obj, (list, tuple, set, frozenset)):
        if _fp_plain(obj, depth):
            return                  # pure primitive data: no FIFOs inside
        key = (id(obj), depth) if memo is not None else None
        if key is not None and key in memo:
            acc |= memo[key]
            return
        sub: set = set()
        for x in obj:
            _collect_fifos(x, sub, depth + 1, memo)
        if key is not None:
            memo[key] = frozenset(sub)
        acc |= sub
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _collect_fifos(k, acc, depth + 1, memo)
            _collect_fifos(v, acc, depth + 1, memo)
    elif type(obj).__repr__ is object.__repr__:
        try:
            _collect_fifos(vars(obj), acc, depth + 1, memo)
        except TypeError:
            pass


class ModuleFingerprint:
    """One module's structural identity: the eager ``sig`` content hash
    plus lazily computed ``body`` hash and FIFO-interface signature.

    ``sig`` (FIFOs by name, depth-insensitive) is computed when the
    design is fingerprinted; ``body`` (FIFO-blind) and ``interface``
    (sorted reachable FIFO names) are derived from the retained module
    function on first access and cached — the delta classifier only needs
    them for modules whose ``sig`` changed.  ``ctx`` is the per-design
    lazy-memo context (shared-capture digest caches), so even the lazy
    flavors stay linear when many modules are consulted.
    """

    __slots__ = ("name", "sig", "_fn", "_ctx", "_body", "_interface")

    def __init__(self, name: str, sig: str, fn=None, ctx: Optional[dict] = None):
        self.name = name
        self.sig = sig
        self._fn = fn
        self._ctx = ctx if ctx is not None else {"body": {}, "if": {},
                                                 "sort": {}}
        self._body: Optional[str] = None
        self._interface: Optional[Tuple[str, ...]] = None

    @property
    def body(self) -> str:
        """FIFO-blind content hash (lazy, cached)."""
        if self._body is None:
            self._body = module_content_hash(self._fn, fifo_depth="blind",
                                             memo=self._ctx["body"])
        return self._body

    @property
    def interface(self) -> Tuple[str, ...]:
        """Sorted statically reachable FIFO names (lazy, cached)."""
        if self._interface is None:
            names: set = set()
            _collect_fifos(self._fn, names, memo=self._ctx["if"])
            fs = frozenset(names)
            cached = self._ctx["sort"].get(fs)
            if cached is None:
                cached = self._ctx["sort"][fs] = tuple(sorted(fs))
            self._interface = cached
        return self._interface

    def __repr__(self) -> str:
        return f"ModuleFingerprint(name={self.name!r}, sig={self.sig!r})"


@dataclass(frozen=True)
class DesignFingerprint:
    """Per-module fingerprint table + FIFO rows; composes the same
    whole-design key as ``core.trace.program_fingerprint``."""

    program: str
    fifo_rows: Tuple[Tuple[str, int], ...]      # (name, depth) per position
    modules: Tuple[ModuleFingerprint, ...]
    key: str                                    # == program_fingerprint
    depth_hash: str                             # depth-vector hash alone

    @property
    def module_names(self) -> Tuple[str, ...]:
        return tuple(m.name for m in self.modules)


def fingerprint_design(program: Program) -> DesignFingerprint:
    """Build the per-module fingerprint table of ``program``.

    ``.key`` equals ``program_fingerprint(program)`` exactly — the table is
    a factored form of the warm-cache key, so an exact-key cache hit and a
    delta classification read the same structure.
    """
    fifo_rows = tuple((f.name, int(f.depth)) for f in program.fifos)
    mods: List[ModuleFingerprint] = []
    h = hashlib.sha256()
    h.update(program.name.encode())
    for f in program.fifos:
        h.update(b"|F")
        _fp_update(h, f)
    # one eager hash walk per module (``sig`` flavor), with a shared-
    # capture memo so the one FIFO list every generated module closes
    # over hashes once per design; the lazy flavors share a per-design
    # context of their own memos
    memo_sig: dict = {}
    ctx: dict = {"body": {}, "if": {}, "sort": {}}
    for m in program.modules:
        sig = module_content_hash(m.fn, fifo_depth=False, memo=memo_sig)
        mods.append(ModuleFingerprint(m.name, sig, fn=m.fn, ctx=ctx))
        h.update(b"|M")
        h.update(m.name.encode())
        h.update(sig.encode())
    dh = hashlib.sha256(repr(tuple(d for _, d in fifo_rows)).encode())
    return DesignFingerprint(program=program.name, fifo_rows=fifo_rows,
                             modules=tuple(mods), key=h.hexdigest(),
                             depth_hash=dh.hexdigest())


@dataclass
class DesignDelta:
    """Classified difference between two design fingerprints.

    ``modules`` maps every module name seen on either side to a label
    (UNCHANGED / BODY_EDITED / INTERFACE_CHANGED / ADDED / REMOVED);
    ``fifos`` lists per-position ``(name, label)`` rows (KEPT / RETYPED /
    RENAMED plus ADDED / REMOVED for count changes).  ``patchable`` means
    the trace-patching fast path may *attempt* reuse: same ordered module
    names, same FIFO count and names (depth changes allowed).  The patch
    layer still re-records and verifies every non-UNCHANGED module — a
    patchable delta can be rejected, never the other way around.
    """

    modules: Dict[str, str]
    fifos: List[Tuple[str, str]]
    patchable: bool
    reason: str = ""                # why not patchable (empty when it is)
    edited: Tuple[str, ...] = ()    # non-UNCHANGED common module names

    @property
    def n_unchanged(self) -> int:
        return sum(1 for v in self.modules.values() if v == UNCHANGED)

    @property
    def identical(self) -> bool:
        return (all(v == UNCHANGED for v in self.modules.values())
                and all(lbl == KEPT for _, lbl in self.fifos))

    def summary(self) -> Dict[str, int]:
        """Label histogram (modules and FIFOs), for stats/logging."""
        out: Dict[str, int] = {}
        for v in self.modules.values():
            out[f"module_{v}"] = out.get(f"module_{v}", 0) + 1
        for _, v in self.fifos:
            out[f"fifo_{v}"] = out.get(f"fifo_{v}", 0) + 1
        return out


def diff(old: DesignFingerprint, new: DesignFingerprint) -> DesignDelta:
    """Classify the structural delta from ``old`` to ``new``.

    Module labels (by name): missing from ``new`` → REMOVED, missing from
    ``old`` → ADDED; common modules compare hashes — equal ``sig`` →
    UNCHANGED (depth-only perturbations are invisible by construction),
    equal ``body`` but different ``sig`` or a changed interface set →
    INTERFACE_CHANGED (re-wiring / FIFO-table change), otherwise
    BODY_EDITED.  FIFO labels align by position: same name+depth → KEPT,
    same name → RETYPED, different name → RENAMED.
    """
    old_by = {m.name: m for m in old.modules}
    new_by = {m.name: m for m in new.modules}
    labels: Dict[str, str] = {}
    edited: List[str] = []
    for m in old.modules:
        if m.name not in new_by:
            labels[m.name] = REMOVED
    for m in new.modules:
        o = old_by.get(m.name)
        if o is None:
            labels[m.name] = ADDED
            continue
        if o.sig == m.sig:
            labels[m.name] = UNCHANGED
        elif o.body == m.body or o.interface != m.interface:
            labels[m.name] = INTERFACE_CHANGED
            edited.append(m.name)
        else:
            labels[m.name] = BODY_EDITED
            edited.append(m.name)

    fifo_lbls: List[Tuple[str, str]] = []
    n_common = min(len(old.fifo_rows), len(new.fifo_rows))
    for i in range(n_common):
        (on, od), (nn, nd) = old.fifo_rows[i], new.fifo_rows[i]
        if on != nn:
            fifo_lbls.append((nn, RENAMED))
        elif od != nd:
            fifo_lbls.append((nn, RETYPED))
        else:
            fifo_lbls.append((nn, KEPT))
    for (on, _d) in old.fifo_rows[n_common:]:
        fifo_lbls.append((on, REMOVED))
    for (nn, _d) in new.fifo_rows[n_common:]:
        fifo_lbls.append((nn, ADDED))

    reason = ""
    if old.module_names != new.module_names:
        if any(v == ADDED for v in labels.values()):
            reason = "module set changed (added modules)"
        elif any(v == REMOVED for v in labels.values()):
            reason = "module set changed (removed modules)"
        else:
            reason = "module order changed"
    elif any(lbl in (RENAMED, ADDED, REMOVED) for _, lbl in fifo_lbls):
        reason = "FIFO table changed (rename/add/remove)"
    return DesignDelta(modules=labels, fifos=fifo_lbls,
                       patchable=not reason, reason=reason,
                       edited=tuple(edited))
