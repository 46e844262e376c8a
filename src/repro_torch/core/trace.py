"""Content-addressed design keys (PyTorch port of part of
``repro.core.trace``).

The reference's ``core/trace.py`` holds trace-compiled replay, hybrid
replay and the design fingerprint that keys the sweep service's warm
cache.  This file holds the fingerprint (:func:`program_fingerprint`,
:func:`module_content_hash`); compiled and hybrid replay join it later
(ROADMAP queue 1, items 4 and 5).

Keys hash the port's own :class:`~repro_torch.core.program.Fifo` and
module bytecode, so they differ from the reference's keys for the same
design; nothing compares keys across the two packages.
"""
from __future__ import annotations

import hashlib
import types
from typing import Optional

import numpy as np

from .program import Fifo, Program

_FP_PRIM = (str, int, float, bool, bytes, complex, type(None))


def _fp_plain(obj, depth: int = 0) -> bool:
    """True when ``obj`` is pure primitive data (possibly nested in plain
    lists/tuples): its ``repr`` is then deterministic content, so the
    fingerprint walk can hash it in one C-level call instead of recursing
    per element.  Exact-type checks keep subclasses (enums, numpy scalars,
    repr-overriding wrappers) on the structural path.
    """
    t = type(obj)
    if t in _FP_PRIM:
        return True
    if (t is tuple or t is list) and depth <= 8:
        for x in obj:                    # plain loop: no genexpr frames —
            if not _fp_plain(x, depth + 1):   # this predicate runs per
                return False             # element of every macro script
        return True
    return False


def _fp_update(h, obj, depth: int = 0, fifo_depth: bool = True,
               memo: Optional[dict] = None) -> None:
    """Feed ``obj`` into hash ``h`` by *content*, not identity.

    Function objects are fingerprinted by bytecode + consts + defaults +
    closure contents (recursively), FIFOs by name/depth, arrays by bytes —
    so two Programs built by the same design function with the same
    arguments hash equal even though every call allocates fresh
    function/Fifo objects, while changing any captured argument
    (``items=512`` vs ``1024``) changes the key.  ``fifo_depth=False``
    hashes captured FIFOs by name only (the depth vector enters
    :func:`program_fingerprint` once, through its FIFO rows).

    Failure direction matters: unknown values must never make two
    *different* designs collide.  Past the recursion bound, and for
    objects with no content-based handling, we hash ``repr`` — plain
    containers stay content-addressed, and an object whose repr embeds
    its address merely produces an unstable key (a safe cache miss, never
    a false hit).  Default-``__repr__`` instances are recursed through
    ``vars()`` so ordinary config objects captured by closures still hash
    by content.

    Containers (list/tuple/dict) hash *Merkle-style*: the parent stream
    receives the sha256 digest of the container's own content stream.
    That makes ``memo`` — an optional per-top-level-call ``{(id, depth):
    digest}`` dict — sound: an object shared between modules (one FIFO
    list captured by every module closure) is walked once per design
    instead of once per module.  Memoized and memo-less calls produce
    identical bytes; memo entries must not outlive the hashed objects
    (callers build a fresh memo per design).
    """
    if depth > 8:                        # defensive bound on weird closures
        h.update(b"<deep>")
        h.update(repr(obj).encode())     # still content-based for data
        return
    if type(obj) in _FP_PRIM:
        # exact-type primitive leaf: same bytes the final ``repr`` branch
        # would produce, without walking the isinstance chain
        h.update(repr(obj).encode())
        return
    if isinstance(obj, types.FunctionType):
        def all_names(code):             # incl. nested lambdas/inner defs
            names = set(code.co_names)
            for c in code.co_consts:
                if isinstance(c, types.CodeType):
                    names |= all_names(c)
            return names

        code = obj.__code__
        h.update(b"fn(")
        h.update(code.co_code)
        _fp_update(h, code.co_consts, depth + 1, fifo_depth, memo)
        # every module a factory stamps out shares one code object, so the
        # names repr is worth caching across the design walk
        nkey = (id(code), "conames") if memo is not None else None
        names_b = memo.get(nkey) if nkey is not None else None
        if names_b is None:
            names_b = repr(code.co_names).encode()
            if nkey is not None:
                memo[nkey] = names_b
        h.update(names_b)
        _fp_update(h, obj.__defaults__, depth + 1, fifo_depth, memo)
        _fp_update(h, obj.__kwdefaults__, depth + 1, fifo_depth, memo)
        if obj.__closure__:
            for cell in obj.__closure__:
                try:
                    _fp_update(h, cell.cell_contents, depth + 1, fifo_depth,
                               memo)
                except ValueError:
                    h.update(b"<empty>")
        # module-level state the body reads is design content too (a
        # global `N` changing between builds changes the trace) — also
        # when the read happens inside a nested lambda/inner def; modules
        # hash by name only — importing numpy is not design identity
        g = obj.__globals__
        gkey = (id(code), id(g), "gnames") if memo is not None else None
        if gkey is not None and gkey in memo:
            gnames = memo[gkey]
        else:
            gnames = sorted(all_names(code) & set(g))
            if gkey is not None:
                memo[gkey] = gnames
        # Merkle-wrap the whole globals contribution unconditionally (so
        # the bytes don't depend on whether a memo is in use) and memoize
        # it per (code, globals, depth)
        gdkey = (id(code), id(g), depth, "gdig") if memo is not None else None
        gdig = memo.get(gdkey) if gdkey is not None else None
        if gdig is None:
            gh = hashlib.sha256()
            for name in gnames:
                gh.update(name.encode())
                v = g[name]
                if isinstance(v, types.ModuleType):
                    gh.update(v.__name__.encode())
                else:
                    vkey = (id(v), depth, "g") if memo is not None else None
                    digest = memo.get(vkey) if vkey is not None else None
                    if digest is None:
                        sub = hashlib.sha256()
                        _fp_update(sub, v, depth + 1, fifo_depth, memo)
                        digest = sub.digest()
                        if vkey is not None:
                            memo[vkey] = digest
                    gh.update(digest)
            gdig = gh.digest()
            if gdkey is not None:
                memo[gdkey] = gdig
        h.update(gdig)
        h.update(b")")
    elif isinstance(obj, types.CodeType):
        h.update(b"code(")
        h.update(obj.co_code)
        _fp_update(h, obj.co_consts, depth + 1, fifo_depth, memo)
        h.update(repr(obj.co_names).encode())
        h.update(b")")
    elif isinstance(obj, Fifo):
        if fifo_depth:
            h.update(f"Fifo({obj.name},{obj.depth})".encode())
        else:
            h.update(f"Fifo({obj.name})".encode())
    elif isinstance(obj, np.ndarray):
        h.update(obj.tobytes())
    elif isinstance(obj, (list, tuple)):
        key = (id(obj), depth) if memo is not None else None
        if key is not None and key in memo:
            h.update(memo[key])
            return
        if _fp_plain(obj, depth):
            # pure primitive data: one repr is deterministic content —
            # same bytes with or without memo
            data = repr(obj).encode()
            if key is not None:
                memo[key] = data
            h.update(data)
            return
        sub = hashlib.sha256()
        sub.update(b"(" if isinstance(obj, tuple) else b"[")
        for x in obj:
            _fp_update(sub, x, depth + 1, fifo_depth, memo)
            sub.update(b",")
        sub.update(b"]")
        digest = sub.digest()
        if key is not None:
            memo[key] = digest
        h.update(digest)
    elif isinstance(obj, dict):
        key = (id(obj), depth) if memo is not None else None
        if key is not None and key in memo:
            h.update(memo[key])
            return
        sub = hashlib.sha256()
        sub.update(b"{")
        for k in obj:
            _fp_update(sub, k, depth + 1, fifo_depth, memo)
            sub.update(b":")
            _fp_update(sub, obj[k], depth + 1, fifo_depth, memo)
        sub.update(b"}")
        digest = sub.digest()
        if key is not None:
            memo[key] = digest
        h.update(digest)
    elif type(obj).__repr__ is object.__repr__:
        # default repr would embed the instance address (a new key on
        # every call of the design function — the cache would never hit):
        # hash the class plus the attribute dict by content instead
        h.update(type(obj).__qualname__.encode())
        try:
            _fp_update(h, vars(obj), depth + 1, fifo_depth, memo)
        except TypeError:                # __slots__ etc.: accept misses
            h.update(repr(obj).encode())
    else:
        h.update(repr(obj).encode())


def module_content_hash(fn, fifo_depth: bool = True,
                        memo: Optional[dict] = None) -> str:
    """Content hash of one module generator function (sha256 hex digest).

    Hashes bytecode + constants + defaults + closure contents + referenced
    globals via :func:`_fp_update`.  ``fifo_depth`` selects how captured
    FIFOs enter the hash: ``True`` by name+depth, ``False`` by name only.
    ``memo`` is a per-design shared-capture digest cache (see
    :func:`_fp_update`); all modules of one design must share one memo per
    flavor.
    """
    h = hashlib.sha256()
    _fp_update(h, fn, fifo_depth=fifo_depth, memo=memo)
    return h.hexdigest()


def program_fingerprint(program: Program) -> str:
    """Stable content-addressed key of a design (sha256 hex digest).

    Module bodies are pure and re-runnable by the :class:`Program`
    contract, so the base simulation, the compiled graph and every
    ``resimulate``/``resimulate_batch`` verdict derived from them are a
    pure function of what this fingerprint hashes: FIFO names/depths plus
    each module generator's bytecode, constants, defaults, captured closure
    values and referenced globals.  Equal fingerprints ⇒ interchangeable
    base runs, the guarantee the sweep service's warm cache
    (:class:`repro_torch.sweep.cache.GraphCache`) needs to serve repeat
    requests for a design without re-simulating anything.

    The key composes per-FIFO ``(name, depth)`` rows with per-module
    depth-insensitive content digests (:func:`module_content_hash` with
    ``fifo_depth=False``): the depth vector is hashed exactly once, through
    the FIFO rows, not once per capturing module.
    """
    h = hashlib.sha256()
    h.update(program.name.encode())
    for f in program.fifos:
        h.update(b"|F")
        _fp_update(h, f)
    memo: dict = {}      # shared captures (e.g. one FIFO list) hash once
    for m in program.modules:
        h.update(b"|M")
        h.update(m.name.encode())
        h.update(module_content_hash(m.fn, fifo_depth=False,
                                     memo=memo).encode())
    return h.hexdigest()
