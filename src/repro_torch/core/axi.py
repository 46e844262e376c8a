"""AXI interface modeling (paper Table 1: AxiReadReq/WriteReq, AxiRead/
Write, AxiWriteResp).

PyTorch-port copy of ``repro.core.axi``: the same module factories and
demo designs, built on the port's DSL.

The paper's runtime library intercepts AXI intrinsics the same way it
intercepts FIFO accesses; each AXI channel *is* a FIFO with hardware timing.
We model an AXI master <-> memory subsystem as a module factory over the
existing DSL primitives — request/data/response channels are ordinary SPSC
FIFOs, so the engine's FIFO tables give AXI transactions exact hardware
timing with zero engine changes (the same observation the paper exploits).

Channels per port (AXI4 semantics, ID-less in-order per port):

    ar  : read-address requests  (burst_len encoded in the request)
    r   : read-data beats        (memory -> master)
    aw  : write-address requests
    w   : write-data beats       (master -> memory)
    b   : write responses        (memory -> master)

``make_memory`` spawns the memory model module: it services AR/AW queues
with a configurable first-beat latency and per-beat II of 1 — the standard
DDR/HBM abstraction used by HLS co-simulation testbenches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .program import Delay, Emit, Program, Read, ReadNB, Write


@dataclass
class AxiPort:
    ar: "Fifo"
    r: "Fifo"
    aw: "Fifo"
    w: "Fifo"
    b: "Fifo"


def make_axi_port(prog: Program, name: str, depth: int = 4) -> AxiPort:
    return AxiPort(
        ar=prog.fifo(f"{name}_ar", depth),
        r=prog.fifo(f"{name}_r", depth),
        aw=prog.fifo(f"{name}_aw", depth),
        w=prog.fifo(f"{name}_w", depth),
        b=prog.fifo(f"{name}_b", depth),
    )


def make_memory(prog: Program, port: AxiPort, data: List[int],
                read_latency: int = 12, write_latency: int = 8,
                name: str = "memory", n_reads: Optional[int] = None,
                n_writes: Optional[int] = None) -> None:
    """Memory model: services `n_reads` AR bursts then `n_writes` AW bursts.

    (A fully reactive memory would poll both queues with NB reads — that
    variant is `make_reactive_memory` below and is Type B.)
    """
    mem = list(data)

    def memory():
        for _ in range(n_reads if n_reads is not None else 0):
            addr, burst = yield Read(port.ar)        # AxiReadReq
            yield Delay(read_latency - 1)            # row activate / CAS
            for i in range(burst):                   # AxiRead beats, II=1
                yield Write(port.r, mem[addr + i])
        for _ in range(n_writes if n_writes is not None else 0):
            addr, burst = yield Read(port.aw)        # AxiWriteReq
            yield Delay(write_latency - 1)
            for i in range(burst):                   # AxiWrite beats
                mem[addr + i] = yield Read(port.w)
            yield Write(port.b, 0)                   # AxiWriteResp (OKAY)
        yield Emit(f"{name}_final", tuple(mem))

    prog.add_module(name, memory)


def make_reactive_memory(prog: Program, port: AxiPort, data: List[int],
                         read_latency: int = 12, write_latency: int = 8,
                         name: str = "memory") -> None:
    """Reactive memory: NB-polls AR and AW until a shutdown write lands at
    address 0 — a Type B module (infinite loop + NB accesses)."""
    mem = list(data)

    def memory():
        while True:
            ok, req = yield ReadNB(port.ar)
            if ok:
                addr, burst = req
                yield Delay(read_latency - 1)
                for i in range(burst):
                    yield Write(port.r, mem[addr + i])
                continue
            ok, req = yield ReadNB(port.aw)
            if ok:
                addr, burst = req
                yield Delay(write_latency - 1)
                for i in range(burst):
                    mem[addr + i] = yield Read(port.w)
                yield Write(port.b, 0)
                if addr == 0:                        # shutdown doorbell
                    break
        yield Emit(f"{name}_final", tuple(mem))

    prog.add_module(name, memory)


# --------------------------------------------------------------- demo design
def axi_master_design(n: int = 64, burst: int = 16,
                      read_latency: int = 12) -> Program:
    """The Vitis 'AXI4 master' pattern: burst-read n words, scale, burst-
    write them back, wait for the response.  Type A end to end."""
    prog = Program("axi_master", declared_type="A")
    port = make_axi_port(prog, "gmem")
    data = [(i * 7 + 3) % 97 for i in range(n)]
    n_bursts = n // burst

    @prog.module("master")
    def master():
        total = 0
        # read phase: issue AR per burst, consume R beats
        for b in range(n_bursts):
            yield Write(port.ar, (b * burst, burst))     # AxiReadReq
            vals = []
            for _ in range(burst):
                v = yield Read(port.r)                   # AxiRead
                vals.append(v)
                total += v
            # write phase for this burst: scale by 2
            yield Write(port.aw, (b * burst, burst))     # AxiWriteReq
            for v in vals:
                yield Write(port.w, 2 * v)               # AxiWrite
            yield Read(port.b)                           # AxiWriteResp
        yield Emit("checksum", total)

    mem = list(data)

    def memory():
        for _ in range(n_bursts):
            addr, bl = yield Read(port.ar)
            yield Delay(read_latency - 1)
            for i in range(bl):
                yield Write(port.r, mem[addr + i])
            addr, bl = yield Read(port.aw)
            yield Delay(7)
            for i in range(bl):
                mem[addr + i] = yield Read(port.w)
            yield Write(port.b, 0)
        yield Emit("memory_final", tuple(mem))

    prog.add_module("memory", memory)
    return prog


def axi_prefetch_design(n: int = 64, burst: int = 8) -> Program:
    """Type C: a prefetcher speculatively issues the next AR while compute
    drains the current burst; on backpressure (full AR queue, checked with a
    NB write) the prefetch is skipped and counted."""
    prog = Program("axi_prefetch", declared_type="C")
    port = make_axi_port(prog, "gmem", depth=2)
    data = [(i * 5 + 1) % 83 for i in range(2 * n)]
    n_bursts = n // burst
    from .program import WriteNB

    @prog.module("prefetcher")
    def prefetcher():
        issued = 0
        skipped = 0
        b = 0
        while issued < n_bursts:
            ok = yield WriteNB(port.ar, (b * burst, burst))
            if ok:
                issued += 1
                b += 1
            else:
                skipped += 1
                yield Delay(3)
        yield Emit("prefetch_skipped", skipped)

    @prog.module("compute")
    def compute():
        total = 0
        for _ in range(n_bursts * burst):
            v = yield Read(port.r)
            total += v
            yield Delay(1)                               # 2 cycles/beat
        yield Emit("checksum", total)

    make_reactive_memory(prog, port, data, name="memory")

    @prog.module("shutdown")
    def shutdown():
        # waits for compute's checksum? modeled as a fixed-time doorbell:
        # issue the shutdown write after draining is guaranteed.
        yield Delay(16 * n)
        yield Write(port.aw, (0, 1))
        yield Write(port.w, 0)
        yield Read(port.b)

    return prog
