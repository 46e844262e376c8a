"""Quickstart: simulate a Type C dataflow design three ways and compare.

    PYTHONPATH=src python examples_torch/quickstart.py

The PyTorch port's copy of ``examples/quickstart.py``: the same design,
the same four steps and the same printed lines, through
``repro_torch.core``.  All of it is host code, so it takes no device.

Shows the paper's core result in miniature: C-sim gets the functionality
wrong, the cycle-stepped RTL oracle is exact but slow, and OmniSim matches
the oracle exactly at a fraction of the cost — then re-simulates a FIFO
resize incrementally in microseconds.
"""
import time

from repro_torch.core import classify, csim, resimulate, simulate, simulate_rtl
from repro_torch.core.program import (Delay, Emit, Full, Program, Read,
                                      ReadNB, Write, WriteNB)


def congestion_router(n=500):
    """A little Type C design: drop-on-backpressure video pipeline."""
    prog = Program("quickstart_router", declared_type="C")
    frames = prog.fifo("frames", 3)

    @prog.module("camera")
    def camera():
        dropped = 0
        for i in range(1, n + 1):
            ok = yield WriteNB(frames, i)
            if not ok:
                dropped += 1           # frame dropped under backpressure
        yield Emit("dropped", dropped)

    @prog.module("encoder")               # 4 cycles per frame
    def encoder():
        total = frames_seen = 0
        for _ in range(n):
            ok, v = yield ReadNB(frames)
            if ok:
                frames_seen += 1
                total += v
            yield Delay(3)
        yield Emit("encoded", frames_seen)
        yield Emit("checksum", total)

    return prog


def main():
    print("=" * 64)
    print("1) Vitis-style C simulation (sequential, untimed)")
    r = csim(congestion_router())
    print("   ", {k: v for k, v in r.outputs.items() if k != "__warnings__"})
    print("    -> WRONG: no frame is ever dropped under C semantics\n")

    print("2) cycle-stepped RTL oracle (co-sim stand-in)")
    t0 = time.perf_counter()
    rtl = simulate_rtl(congestion_router())
    t_rtl = time.perf_counter() - t0
    print(f"    {rtl.outputs}  cycles={rtl.cycles}  ({t_rtl*1e3:.1f} ms)\n")

    print("3) OmniSim (coupled functionality+performance simulation)")
    t0 = time.perf_counter()
    omni = simulate(congestion_router())
    t_omni = time.perf_counter() - t0
    print(f"    {omni.outputs}  cycles={omni.cycles}  ({t_omni*1e3:.1f} ms)")
    assert omni.outputs == rtl.outputs and omni.cycles == rtl.cycles
    print(f"    == oracle exactly; {t_rtl/t_omni:.1f}x faster than "
          f"cycle-stepping")
    print("   ", classify(congestion_router(), omni), "\n")

    print("4) incremental re-simulation: frames FIFO 3 -> 64")
    inc = resimulate(omni, (64,))
    full = simulate(congestion_router(), depths=(64,))
    status = "graph reused" if inc.ok else f"full re-sim ({inc.reason})"
    print(f"    {status}; cycles={inc.result.cycles} "
          f"(verified == full re-sim: {inc.result.cycles == full.cycles}); "
          f"outputs now {full.outputs}")


if __name__ == "__main__":
    main()
