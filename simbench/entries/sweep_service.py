"""Many users on one ``sweep.SweepService``: closed-loop and open-loop tenants.

The mix's ``service`` keys are passed to ``SweepService`` as they are. Each
tenant of the mix runs on a thread of its own and submits the base run of
the design with ``rows`` fresh depth rows a request:

* ``"loop": "closed"`` (a bulk sweep): the next request goes in when every
  row of the last one has come back;
* ``"loop": "open"`` (what-if probes): requests are due at ``rate_per_s``
  (seeded exponential gaps, ``traffic.arrivals``), whether or not earlier
  ones have come back. A request's latency runs from when it was due to its
  assembled outcome; the generator's lateness is kept beside it.

A row the solver could not reuse takes its final answer from the fallback
re-simulation it came back with. The window is ``seconds`` long. Rows count
for the rate when they come back inside it; every request sent inside it
must come back, within a minute of the drain's start, for the output check.
"""
from __future__ import annotations

import threading
import time
from typing import List

import numpy as np

from ..check import final_answers

DRAIN_S = 60.0


class Driver:
    def __init__(self, run):
        self.run = run
        self.rec = run.record
        self.mix = run.mix
        self.tenants = list(self.mix["tenants"])
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._errors: List[BaseException] = []
        self.svc = None

    def setup(self) -> None:
        from repro_torch.core import simulate
        from repro_torch.sweep import SweepService

        self.svc = SweepService(device=self.run.device,
                                **self.mix["service"])
        self.base = simulate(self.run.program())
        self.svc.warm(self.base)
        # one warm-up request of each tenant's size, from rows the window
        # never sends
        warm = self.run.stream("warmup")
        for t in self.tenants:
            self.svc.submit(self.base, self.run.rows.take(warm, t["rows"]),
                            tenant=t["name"]).result()
        self.run.sync()

    # ----------------------------------------------------------- tenants
    def _collect(self, handle, D: np.ndarray, due: float, lat: bool) -> None:
        status = np.full(len(D), -1, np.int64)
        cycles = np.full(len(D), -1, np.int64)
        violated = np.zeros(len(D), np.int64)
        arrived = np.full(len(D), np.inf)
        results = [None] * len(D)
        for cfg in handle.stream():
            i = cfg.index
            status[i], cycles[i], violated[i] = (cfg.status, cfg.cycles,
                                                 cfg.violated)
            if cfg.status:                  # not REUSED: keep the fallback
                results[i] = cfg.result
            arrived[i] = time.perf_counter()
        done = time.perf_counter()
        self.rec.add_answers(D, status, cycles, violated, at=arrived,
                             final=final_answers(status, cycles, results))
        if lat:
            self.rec.latencies.append((due, done - due))

    def _closed(self, t: dict, stream: int) -> None:
        while not self._stop.is_set():
            D = self.run.rows.take(stream, t["rows"])
            s = time.perf_counter()
            h = self.svc.submit(self.base, D, tenant=t["name"])
            self.rec.count_sent(len(D))
            self._collect(h, D, s, lat=False)

    def _open(self, t: dict, stream: int) -> None:
        due = self.rec.t0 + self.run.arrivals(t["rate_per_s"])
        due = due[due < self.rec.t0 + self.seconds]
        pending: List = []
        cv = threading.Condition()
        collector = threading.Thread(target=self._guard,
                                     args=(self._drain_open, pending, cv),
                                     name=f"simbench-{t['name']}-collect")
        collector.start()
        try:
            for d in due:
                wait = d - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                D = self.run.rows.take(stream, t["rows"])
                self.rec.lateness.append(time.perf_counter() - d)
                h = self.svc.submit(self.base, D, tenant=t["name"])
                self.rec.count_sent(len(D))
                with cv:
                    pending.append((h, D, float(d)))
                    cv.notify()
        finally:
            with cv:
                pending.append(None)
                cv.notify()
            collector.join()

    def _drain_open(self, pending: List, cv: threading.Condition) -> None:
        i = 0
        while True:
            with cv:
                while len(pending) <= i:
                    cv.wait()
                item = pending[i]
            if item is None:
                return
            h, D, d = item
            self._collect(h, D, d, lat=True)
            i += 1

    def _guard(self, fn, *args) -> None:
        try:
            fn(*args)
        except BaseException as exc:      # reported after the window
            self._errors.append(exc)

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> None:
        rec = self.rec
        self.seconds = seconds
        s0 = self.svc.stats()["scheduler"]
        rec.t0 = time.perf_counter()
        for t in self.tenants:
            fn = self._closed if t["loop"] == "closed" else self._open
            th = threading.Thread(target=self._guard,
                                  args=(fn, t, self.run.stream(t["name"])),
                                  name=f"simbench-{t['name']}")
            th.start()
            self._threads.append(th)
        time.sleep(max(rec.t0 + seconds - time.perf_counter(), 0.0))
        self._stop.set()
        rec.t1 = time.perf_counter()
        s1 = self.svc.stats()["scheduler"]
        rec.blocks = s1["blocks"] - s0["blocks"]
        rec.solved = s1["rows_unique"] - s0["rows_unique"]

    def drain(self) -> None:
        # a minute from now: a traced run stops its profiler first
        end = time.perf_counter() + DRAIN_S
        for th in self._threads:
            th.join(timeout=max(end - time.perf_counter(), 0.0))
        if any(th.is_alive() for th in self._threads):
            self.rec.notes.append("requests still open a minute past the "
                                  "window's close")
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        if self.svc is not None:
            # aborts what is still queued, so every tenant thread ends
            self.svc.close(drain=False)
            self.svc = None
        for th in self._threads:
            th.join()
        self.base = None
