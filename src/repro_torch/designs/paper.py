"""The paper's Type B / Type C benchmark designs (Table 4).

Built on the PyTorch port's DSL (``repro_torch.core.program``): the same
design functions, parameters and registry as ``repro.designs.paper``.

Eleven designs that no prior HLS tool simulates correctly at C level.  We
author them in the dataflow DSL with the same structure and — where the value
is analytically determined — the same expected outputs as the paper's Table 3:

  * fig4_ex2      sum_out = 2051325  (= sum(1..2025))
  * fig4_ex3      sum     = 4098600  (= 2 * sum(0..2024)); C-sim: sum=0 with
                  2025 'read while empty' warnings + leftover-data warning
  * fig4_ex4a/b   partial sums (timing-dependent; our deterministic values,
                  asserted identical between OmniSim and the cycle-stepped
                  RTL oracle — the paper's actual claim)
  * fig2_timer    internal timer counts 6075 cycles (= 3 x 2025)
  * deadlock      detected immediately, simulator never hangs
  * branch        downstream executor redirects the upstream fetcher
  * multicore     16 cores x (fetcher + executor) + dispatcher + collector
                  = 34 modules, 64 FIFOs

Minor deviations from Table 4's module/FIFO counts: we do not replicate the
Vitis testbench wrapper as a module.
"""
from __future__ import annotations

from ..core.program import (Delay, Emit, Full, Program, Read, ReadNB, Write,
                            WriteNB)

N = 2025  # the paper's element count (sum(1..2025) = 2051325)


# ---------------------------------------------------------------------------
# fig4_ex2 — Type B: NB accesses in infinite loops, done-signal termination.
# ---------------------------------------------------------------------------
def fig4_ex2(n: int = N) -> Program:
    prog = Program("fig4_ex2", declared_type="B")
    data = prog.fifo("data", 2)
    done = prog.fifo("done", 1)
    # hardware reads past the logical end of the buffer return garbage (0,
    # modeled by bounded slack); sequential C-sim instead overruns the array
    # unboundedly -> SIGSEGV (Table 3).
    input_arr = list(range(1, n + 1)) + [0] * (3 * n)

    @prog.module("producer")
    def producer():
        i = 0
        while True:
            ok, _ = yield ReadNB(done)
            if ok:
                break
            v = input_arr[i]
            ok = yield WriteNB(data, v)
            if ok:
                i += 1

    @prog.module("consumer")
    def consumer():
        total = 0
        for _ in range(n):
            v = yield Read(data)
            total += v
        yield Write(done, 1)
        yield Emit("sum_out", total)

    return prog


# ---------------------------------------------------------------------------
# fig4_ex3 — Type B: cyclic dependency over blocking FIFOs.
# ---------------------------------------------------------------------------
def fig4_ex3(n: int = N) -> Program:
    prog = Program("fig4_ex3", declared_type="B")
    cmd = prog.fifo("cmd", 2)
    resp = prog.fifo("resp", 2)

    @prog.module("controller")
    def controller():
        total = 0
        for i in range(n):
            yield Write(cmd, i)
            r = yield Read(resp)      # C-sim: empty -> warning x2025, r = 0
            total += r
        yield Emit("sum", total)

    @prog.module("processor")
    def processor():
        for _ in range(n):
            v = yield Read(cmd)
            yield Write(resp, 2 * v)

    return prog


# ---------------------------------------------------------------------------
# fig4_ex4a — Type C: silent drop when the FIFO is full (i++ regardless).
# ---------------------------------------------------------------------------
def fig4_ex4a(n: int = N) -> Program:
    prog = Program("fig4_ex4a", declared_type="C")
    data = prog.fifo("data", 2)

    @prog.module("producer")
    def producer():
        for i in range(1, n + 1):
            yield WriteNB(data, i)    # outcome ignored: dropped data is lost

    @prog.module("consumer")          # 3 cycles per element -> backpressure
    def consumer():
        total = 0
        for _ in range(n):
            ok, v = yield ReadNB(data)
            if ok:
                total += v
            yield Delay(2)
        yield Emit("sum_out", total)

    return prog


# ---------------------------------------------------------------------------
# fig4_ex4a_d — Type C: as ex4a but the producer runs an infinite loop
# terminated by a done signal (cyclic).  C-sim crashes (array overrun).
# ---------------------------------------------------------------------------
def fig4_ex4a_d(n: int = N) -> Program:
    prog = Program("fig4_ex4a_d", declared_type="C")
    data = prog.fifo("data", 2)
    done = prog.fifo("done", 1)
    input_arr = list(range(1, n + 1)) + [0] * (6 * n)

    @prog.module("producer")
    def producer():
        i = 0
        while True:
            ok, _ = yield ReadNB(done)
            if ok:
                break
            v = input_arr[i]          # overruns under C-sim -> SIGSEGV
            yield WriteNB(data, v)
            i += 1                    # silent drop: i++ even on failure

    @prog.module("consumer")
    def consumer():
        total = 0
        for _ in range(n):
            ok, v = yield ReadNB(data)
            if ok:
                total += v
            yield Delay(2)
        yield Write(done, 1)
        yield Emit("sum_out", total)

    return prog


# ---------------------------------------------------------------------------
# fig4_ex4b — Type C: if-else branch counts dropped elements explicitly.
# ---------------------------------------------------------------------------
def fig4_ex4b(n: int = N) -> Program:
    prog = Program("fig4_ex4b", declared_type="C")
    data = prog.fifo("data", 2)

    @prog.module("producer")
    def producer():
        dropped = 0
        for i in range(1, n + 1):
            ok = yield WriteNB(data, i)
            if not ok:
                dropped += 1
        yield Emit("Dropped", dropped)

    @prog.module("consumer")
    def consumer():
        total = 0
        for _ in range(n):
            ok, v = yield ReadNB(data)
            if ok:
                total += v
            yield Delay(2)
        yield Emit("sum_out", total)

    return prog


# ---------------------------------------------------------------------------
# fig4_ex4b_d — Type C: ex4b with done-signal termination (cyclic).
# ---------------------------------------------------------------------------
def fig4_ex4b_d(n: int = N) -> Program:
    prog = Program("fig4_ex4b_d", declared_type="C")
    data = prog.fifo("data", 2)
    done = prog.fifo("done", 1)
    input_arr = list(range(1, n + 1)) + [0] * (6 * n)

    @prog.module("producer")
    def producer():
        i = 0
        dropped = 0
        while True:
            ok, _ = yield ReadNB(done)
            if ok:
                break
            v = input_arr[i]
            ok = yield WriteNB(data, v)
            if ok:
                i += 1
            else:
                dropped += 1
                i += 1               # drop and move on
        yield Emit("Dropped", dropped)

    @prog.module("consumer")
    def consumer():
        total = 0
        for _ in range(n):
            ok, v = yield ReadNB(data)
            if ok:
                total += v
            yield Delay(2)
        yield Write(done, 1)
        yield Emit("sum_out", total)

    return prog


# ---------------------------------------------------------------------------
# fig4_ex5 — Type C: congestion-aware dispatch to the less-busy processor.
# ---------------------------------------------------------------------------
SENTINEL = -1


def fig4_ex5(n: int = N) -> Program:
    prog = Program("fig4_ex5", declared_type="C")
    f1 = prog.fifo("to_p1", 2)
    f2 = prog.fifo("to_p2", 2)

    @prog.module("controller")
    def controller():
        for i in range(1, n + 1):
            full1 = yield Full(f1)
            if not full1:
                yield Write(f1, i)   # preferred path
            else:
                yield Write(f2, i)   # overflow path (P2 is fast: no stall)
        yield Write(f1, SENTINEL)
        yield Write(f2, SENTINEL)

    @prog.module("P1")               # slow processor: 3 cycles per item
    def p1():
        count, total = 0, 0
        while True:
            v = yield Read(f1)
            if v == SENTINEL:
                break
            yield Delay(2)
            count += 1
            total += v
        yield Emit("processed_by_P1", count)
        yield Emit("sum_out_P1", total)

    @prog.module("P2")               # fast processor
    def p2():
        count, total = 0, 0
        while True:
            v = yield Read(f2)
            if v == SENTINEL:
                break
            count += 1
            total += v
        yield Emit("processed_by_P2", count)
        yield Emit("sum_out_P2", total)

    return prog


# ---------------------------------------------------------------------------
# fig2_timer — Type C: a timer module counts the cycles of a compute module.
# Calibrated so the timer reports exactly 3 cycles/item x 2025 items = 6075.
# ---------------------------------------------------------------------------
def fig2_timer(n: int = N) -> Program:
    prog = Program("fig2_timer", declared_type="C")
    result = prog.fifo("result", 4)
    done = prog.fifo("done", 1)

    @prog.module("sink")             # drains results (C-sim: reads empty x n)
    def sink():
        total = 0
        for _ in range(n):
            v = yield Read(result)
            total += v
        yield Emit("sink_sum", total)

    @prog.module("compute")          # 3 cycles per item: write + delay(2)
    def compute():
        yield Delay(1)               # schedule offset: item k commits at 3k-1
        for k in range(1, n + 1):
            yield Write(result, k)
            if k < n:
                yield Delay(2)
        yield Write(done, 1)         # committed at cycle 3n exactly

    @prog.module("timer")            # polls the done signal every cycle
    def timer():
        cycles = 0
        while True:
            ok, _ = yield ReadNB(done)
            if ok:
                break
            cycles += 1
        yield Emit("timer_cycles", cycles)

    return prog


# ---------------------------------------------------------------------------
# deadlock — Type B: two tasks blocking-read each other first.
# ---------------------------------------------------------------------------
def deadlock(n: int = N) -> Program:
    prog = Program("deadlock", declared_type="B")
    a2b = prog.fifo("a2b", 2)
    b2a = prog.fifo("b2a", 2)

    @prog.module("task_a")
    def task_a():
        total = 0
        for i in range(n):
            v = yield Read(b2a)      # waits for B ...
            total += v
            yield Write(a2b, i)
        yield Emit("sum", total)

    @prog.module("task_b")
    def task_b():
        total = 0
        for i in range(n):
            v = yield Read(a2b)      # ... while B waits for A
            total += v
            yield Write(b2a, i)
        yield Emit("sum_b", total)

    return prog


# ---------------------------------------------------------------------------
# branch — Type C: a downstream executor redirects the upstream fetcher.
# ---------------------------------------------------------------------------
def branch(prog_len: int = 1024, stride: int = 16) -> Program:
    prog = Program("branch", declared_type="C")
    instr = prog.fifo("instr", 4)
    redirect = prog.fifo("redirect", 2)

    @prog.module("fetcher")
    def fetcher():
        pc = 0
        fetched = 0
        while pc < prog_len:
            ok, target = yield ReadNB(redirect)
            if ok:
                pc = target           # squash wrong-path fetch stream
            yield Write(instr, pc)
            fetched += 1
            pc += 1
        yield Write(instr, SENTINEL)
        yield Emit("fetched", fetched)

    @prog.module("executor")
    def executor():
        expected = 0
        executed = 0
        while True:
            pc = yield Read(instr)
            if pc == SENTINEL:
                break
            if pc != expected:
                continue              # wrong-path instruction: discard
            executed += 1
            if pc % stride == 0:      # taken branch: jump ahead
                expected = pc + stride // 2
                yield WriteNB(redirect, expected)
            else:
                expected = pc + 1
        yield Emit("executed", executed)

    return prog


# ---------------------------------------------------------------------------
# multicore — Type C: 16 branch cores + dispatcher + collector
#             = 34 modules, 64 FIFOs (paper Table 4).
# ---------------------------------------------------------------------------
def multicore(cores: int = 16, prog_len: int = 128, stride: int = 8) -> Program:
    prog = Program("multicore", declared_type="C")
    work = [prog.fifo(f"work{c}", 2) for c in range(cores)]
    instr = [prog.fifo(f"instr{c}", 4) for c in range(cores)]
    redirect = [prog.fifo(f"redirect{c}", 2) for c in range(cores)]
    result = [prog.fifo(f"result{c}", 2) for c in range(cores)]

    @prog.module("dispatcher")
    def dispatcher():
        for c in range(cores):
            yield Write(work[c], prog_len + c * stride)

    def make_fetcher(c: int):
        def fetcher():
            limit = yield Read(work[c])
            pc = 0
            fetched = 0
            while pc < limit:
                ok, target = yield ReadNB(redirect[c])
                if ok:
                    pc = target
                yield Write(instr[c], pc)
                fetched += 1
                pc += 1
            yield Write(instr[c], SENTINEL)
            # fetched count travels through the instr FIFO so the result
            # FIFO keeps a single writer (SPSC, as synthesized hardware).
            yield Write(instr[c], fetched)
        return fetcher

    def make_executor(c: int):
        def executor():
            expected = 0
            executed = 0
            while True:
                pc = yield Read(instr[c])
                if pc == SENTINEL:
                    fetched = yield Read(instr[c])
                    break
                if pc != expected:
                    continue
                executed += 1
                if pc % stride == 0:
                    expected = pc + stride // 2
                    yield WriteNB(redirect[c], expected)
                else:
                    expected = pc + 1
            yield Write(result[c], fetched)
            yield Write(result[c], executed)
        return executor

    for c in range(cores):
        prog.add_module(f"fetcher{c}", make_fetcher(c))
        prog.add_module(f"executor{c}", make_executor(c))

    @prog.module("collector")
    def collector():
        total_fetched = 0
        total_executed = 0
        for c in range(cores):
            f = yield Read(result[c])
            e = yield Read(result[c])
            total_fetched += f
            total_executed += e
        yield Emit("total_fetched", total_fetched)
        yield Emit("total_executed", total_executed)

    return prog


PAPER_DESIGNS = {
    "fig4_ex2": fig4_ex2,
    "fig4_ex3": fig4_ex3,
    "fig4_ex4a": fig4_ex4a,
    "fig4_ex4a_d": fig4_ex4a_d,
    "fig4_ex4b": fig4_ex4b,
    "fig4_ex4b_d": fig4_ex4b_d,
    "fig4_ex5": fig4_ex5,
    "fig2_timer": fig2_timer,
    "deadlock": deadlock,
    "branch": branch,
    "multicore": multicore,
}
