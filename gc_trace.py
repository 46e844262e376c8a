#!/usr/bin/env python3
"""Run a Python script with its full garbage collections logged.

Usage::

    python3 gc_trace.py SCRIPT [ARGS...]

Runs ``SCRIPT`` as ``__main__`` with ``ARGS`` (its directory first on
``sys.path``, as ``python3 SCRIPT`` would put it) and:

  * prefixes every line the script writes to standard output with
    ``+T``, its host-clock offset in seconds from the start;
  * writes one line ``+T [gc2] D s`` to standard error for every full
    (generation 2) collection of the main process, ``T`` being when the
    pass started and ``D`` how long it took;
  * ends with ``[gc2] N full collections, S s in all`` on standard error.

With both streams sent to one file, a pass can be placed in the timed
window of the script's output it fell in, for two checkouts of one script
alike: for example, to tell whether a host-timed phase of
``chip_smoke.py`` grew by its own work or by a collection that landed in
it.  Processes the script spawns are not traced.  The exit code is the
script's.
"""
import gc
import os
import runpy
import sys
import time

T0 = time.perf_counter()


class _Stamped:
    """Standard output with each line prefixed by its offset from T0."""

    def __init__(self, out):
        self._out = out
        self._at_line_start = True

    def write(self, s):
        for piece in s.splitlines(keepends=True):
            if self._at_line_start:
                self._out.write(f"+{time.perf_counter() - T0:.3f} ")
            self._out.write(piece)
            self._at_line_start = piece.endswith("\n")
        return len(s)

    def __getattr__(self, name):
        return getattr(self._out, name)


def main():
    script = os.path.abspath(sys.argv[1])
    passes = []                    # [start, seconds] of each full pass

    def on_gc(stage, info):
        if info["generation"] != 2:
            return
        now = time.perf_counter()
        if stage == "start":
            passes.append([now, None])
        elif passes:
            passes[-1][1] = now - passes[-1][0]
            # os.write: no Python-level buffer to re-enter mid-collection
            os.write(2, f"+{passes[-1][0] - T0:.3f} [gc2] "
                        f"{passes[-1][1]:.3f} s\n".encode())

    sys.argv = sys.argv[1:]
    sys.path[0] = os.path.dirname(script)
    sys.stdout = _Stamped(sys.stdout)
    gc.callbacks.append(on_gc)
    code = 0
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as exc:
        code = exc.code
    finally:
        gc.callbacks.remove(on_gc)
        sys.stdout.flush()
        done = [s for _, s in passes if s is not None]
        os.write(2, f"[gc2] {len(done)} full collections, {sum(done):.3f} s "
                    f"in all\n".encode())
    return code


if __name__ == "__main__":
    sys.exit(main())
