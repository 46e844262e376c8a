"""A designer's sweep: ``core.dse.resimulate_batch`` in a closed loop.

Each call sends the next ``rows`` depth rows of the mix and waits for every
answer before the next call; a row the solver could not reuse takes its
final answer from the call's fallback re-simulation. The window starts with
the first call and ends with the last answer of the last call that started
inside ``seconds``, so its rate covers all the work and all the time of the
window.
"""
from __future__ import annotations

import time

import numpy as np

from ..check import final_answers


class Driver:
    def __init__(self, run):
        self.run = run
        self.rec = run.record
        mix = run.mix
        self.rows = int(mix["rows"])
        self.kwargs = dict(mix.get("call", {}))

    def setup(self) -> None:
        from repro_torch.core import compile_graph, resimulate_batch, simulate

        self._resimulate_batch = resimulate_batch
        self.base = simulate(self.run.program())
        compile_graph(self.base.graph)
        # one warm-up block at the cell's own K, from rows the window never
        # sends
        self._call(self.run.rows.take(self.run.stream("warmup"), self.rows))
        self.run.sync()

    def _call(self, D: np.ndarray):
        return self._resimulate_batch(self.base, D, device=self.run.device,
                                      **self.kwargs)

    def window(self, seconds: float) -> None:
        rec, rows, stream = self.rec, self.run.rows, self.run.stream("sweep")
        t0 = time.perf_counter()
        rec.t0 = t0
        while time.perf_counter() - t0 < seconds:
            D = rows.take(stream, self.rows)
            rec.count_sent(len(D))
            out = self._call(D)
            rec.add_answers(D, out.status, out.cycles, out.violated,
                            at=time.perf_counter(),
                            final=final_answers(out.status, out.cycles,
                                                out.results))
            rec.solved += int(out.n_unique)
            rec.blocks += 1
            del out
        rec.t1 = time.perf_counter()

    def drain(self) -> None:
        pass

    def close(self) -> None:
        self.base = None
