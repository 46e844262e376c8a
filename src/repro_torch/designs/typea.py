"""Type A designs — analogues of the LightningSimV2 benchmark suite (Table 5).

Built on the PyTorch port's DSL (``repro_torch.core.program``): the same
design functions, parameters and registry as ``repro.designs.typea``.

All designs here use acyclic module graphs and blocking-only FIFO accesses,
so they are simulable by the decoupled two-phase baseline
(``core/lightningsim.py``); the OmniSim engine must produce byte-identical
outputs and cycle counts (tests assert this).  Workload sizes scale from the
small Vitis examples up to FlowGNN- and SkyNet-like deep pipelines used for
the speed comparison.

Each design function takes size parameters so benchmarks can sweep scale.
"""
from __future__ import annotations

from ..core.program import Delay, Emit, Program, Read, Write


# -------------------------------------------------------------------- basics
def producer_consumer(n: int = 256, depth: int = 2) -> Program:
    prog = Program("producer_consumer", declared_type="A")
    data = prog.fifo("data", depth)

    @prog.module("producer")
    def producer():
        for i in range(1, n + 1):
            yield Write(data, i)

    @prog.module("consumer")
    def consumer():
        total = 0
        for _ in range(n):
            total += (yield Read(data))
        yield Emit("sum", total)

    return prog


def fir_filter(n: int = 512, taps: int = 8) -> Program:
    """Streaming FIR: source -> MAC (II=1 after a `taps`-cycle ramp) -> sink."""
    prog = Program("fir_filter", declared_type="A")
    x = prog.fifo("x", 2)
    y = prog.fifo("y", 2)
    coeff = [(k % 5) + 1 for k in range(taps)]

    @prog.module("source")
    def source():
        for i in range(n):
            yield Write(x, i % 97)

    @prog.module("fir")
    def fir():
        window = [0] * taps
        for _ in range(n):
            v = yield Read(x)
            window = [v] + window[:-1]
            acc = sum(c * w for c, w in zip(coeff, window))
            yield Write(y, acc)

    @prog.module("sink")
    def sink():
        total = 0
        for _ in range(n):
            total += (yield Read(y))
        yield Emit("checksum", total)

    return prog


def window_conv(rows: int = 32, cols: int = 32, k: int = 3) -> Program:
    """Line-buffer 2D convolution pipeline (fixed-point window conv)."""
    prog = Program("window_conv", declared_type="A")
    pix = prog.fifo("pix", 4)
    out = prog.fifo("out", 4)

    @prog.module("reader")
    def reader():
        for r in range(rows):
            for c in range(cols):
                yield Write(pix, (r * 31 + c * 7) % 255)

    @prog.module("conv")
    def conv():
        linebuf = [[0] * cols for _ in range(k)]
        for r in range(rows):
            for c in range(cols):
                v = yield Read(pix)
                linebuf[r % k][c] = v
                if r >= k - 1 and c >= k - 1:
                    acc = 0
                    for i in range(k):
                        for j in range(k):
                            acc += linebuf[(r - i) % k][c - j]
                    yield Write(out, acc)

    @prog.module("writer")
    def writer():
        total = 0
        cnt = (rows - k + 1) * (cols - k + 1)
        for _ in range(cnt):
            total += (yield Read(out))
        yield Emit("checksum", total)

    return prog


def matmul_stream(m: int = 16, k: int = 16, n: int = 16) -> Program:
    """Streaming matmul: A-feeder and B-feeder into a MAC engine."""
    prog = Program("matmul_stream", declared_type="A")
    fa = prog.fifo("a", 8)
    fb = prog.fifo("b", 8)
    fc = prog.fifo("c", 8)

    @prog.module("feed_a")
    def feed_a():
        for i in range(m):
            for p in range(k):
                yield Write(fa, (i * k + p) % 13)

    @prog.module("feed_b")
    def feed_b():
        for i in range(m):            # B re-streamed per row of A
            for p in range(k):
                for j in range(n):
                    yield Write(fb, (p * n + j) % 11)

    @prog.module("mac")
    def mac():
        for i in range(m):
            acc = [0] * n
            for p in range(k):
                a = yield Read(fa)
                for j in range(n):
                    b = yield Read(fb)
                    acc[j] += a * b
            for j in range(n):
                yield Write(fc, acc[j])

    @prog.module("drain")
    def drain():
        total = 0
        for _ in range(m * n):
            total += (yield Read(fc))
        yield Emit("checksum", total)

    return prog


def sqrt_pipe(n: int = 256, latency: int = 12) -> Program:
    """Fixed-point square root: deep pipeline, II=1, latency `latency`."""
    prog = Program("sqrt_pipe", declared_type="A")
    xin = prog.fifo("xin", 2)
    xout = prog.fifo("xout", 2)

    @prog.module("source")
    def source():
        for i in range(n):
            yield Write(xin, i * i % 4096)

    @prog.module("isqrt")
    def isqrt():
        yield Delay(latency)          # pipeline fill
        for _ in range(n):
            v = yield Read(xin)
            yield Write(xout, int(v ** 0.5))

    @prog.module("sink")
    def sink():
        total = 0
        for _ in range(n):
            total += (yield Read(xout))
        yield Emit("checksum", total)

    return prog


def parallel_loops(n: int = 256) -> Program:
    """Two independent chains joined by an adder (parallel loops example)."""
    prog = Program("parallel_loops", declared_type="A")
    f1 = prog.fifo("f1", 2)
    f2 = prog.fifo("f2", 2)
    fo = prog.fifo("fo", 2)

    @prog.module("gen_a")
    def gen_a():
        for i in range(n):
            yield Write(f1, 3 * i)

    @prog.module("gen_b")
    def gen_b():
        for i in range(n):
            yield Delay(1)            # slower producer: joins stall
            yield Write(f2, 5 * i)

    @prog.module("join")
    def join():
        for _ in range(n):
            a = yield Read(f1)
            b = yield Read(f2)
            yield Write(fo, a + b)

    @prog.module("sink")
    def sink():
        total = 0
        for _ in range(n):
            total += (yield Read(fo))
        yield Emit("checksum", total)

    return prog


def nested_loops(outer: int = 24, inner: int = 24) -> Program:
    """Perfect nested loops with an II=2 inner body."""
    prog = Program("nested_loops", declared_type="A")
    f = prog.fifo("f", 2)

    @prog.module("compute")
    def compute():
        for i in range(outer):
            yield Delay(2)            # loop-entry overhead
            for j in range(inner):
                yield Write(f, i * j)
                yield Delay(1)        # II=2

    @prog.module("sink")
    def sink():
        total = 0
        for _ in range(outer * inner):
            total += (yield Read(f))
        yield Emit("checksum", total)

    return prog


def accumulators(n: int = 256, stages: int = 4) -> Program:
    """Chain of accumulate-and-forward stages (sequential accumulators)."""
    prog = Program("accumulators", declared_type="A")
    chans = [prog.fifo(f"c{i}", 2) for i in range(stages + 1)]

    @prog.module("source")
    def source():
        for i in range(n):
            yield Write(chans[0], i % 17)

    def make_stage(s: int):
        def stage():
            acc = 0
            for _ in range(n):
                v = yield Read(chans[s])
                acc += v
                yield Write(chans[s + 1], acc)
        return stage

    for s in range(stages):
        prog.add_module(f"acc{s}", make_stage(s))

    @prog.module("sink")
    def sink():
        total = 0
        for _ in range(n):
            total += (yield Read(chans[stages]))
        yield Emit("checksum", total)

    return prog


def vector_add_stream(n: int = 1024) -> Program:
    """Vitis accel example: two HBM streams added into an output stream."""
    prog = Program("vector_add_stream", declared_type="A")
    a = prog.fifo("a", 16)
    b = prog.fifo("b", 16)
    c = prog.fifo("c", 16)

    @prog.module("mm2s_a")
    def mm2s_a():
        for i in range(n):
            yield Write(a, i)

    @prog.module("mm2s_b")
    def mm2s_b():
        for i in range(n):
            yield Write(b, 2 * i)

    @prog.module("vadd")
    def vadd():
        for _ in range(n):
            x = yield Read(a)
            y = yield Read(b)
            yield Write(c, x + y)

    @prog.module("s2mm")
    def s2mm():
        total = 0
        for _ in range(n):
            total += (yield Read(c))
        yield Emit("checksum", total)

    return prog


def merge_sort_staged(log_n: int = 6) -> Program:
    """Parallelized merge sort: log_n merge stages connected by FIFOs."""
    n = 1 << log_n
    prog = Program("merge_sort_staged", declared_type="A")
    chans = [prog.fifo(f"s{i}", max(2, 1 << i)) for i in range(log_n + 1)]
    data = [(7919 * i + 13) % 1024 for i in range(n)]

    @prog.module("source")
    def source():
        for v in data:
            yield Write(chans[0], v)

    def make_stage(s: int):
        width = 1 << s

        def stage():
            for _ in range(n // (2 * width)):
                left, right = [], []
                for _ in range(width):
                    left.append((yield Read(chans[s])))
                for _ in range(width):
                    right.append((yield Read(chans[s])))
                i = j = 0
                while i < len(left) or j < len(right):
                    if j >= len(right) or (i < len(left) and left[i] <= right[j]):
                        yield Write(chans[s + 1], left[i])
                        i += 1
                    else:
                        yield Write(chans[s + 1], right[j])
                        j += 1
        return stage

    for s in range(log_n):
        prog.add_module(f"merge{s}", make_stage(s))

    @prog.module("sink")
    def sink():
        prev = -1
        ok = True
        checksum = 0
        for _ in range(n):
            v = yield Read(chans[log_n])
            ok = ok and (v >= prev)
            prev = v
            checksum = (checksum * 31 + v) % 1_000_000_007
        yield Emit("sorted", ok)
        yield Emit("checksum", checksum)

    return prog


def huffman_pipe(n: int = 512) -> Program:
    """Huffman-encoding-like pipeline: histogram -> code-assign -> encode."""
    prog = Program("huffman_pipe", declared_type="A")
    sym = prog.fifo("sym", 4)
    sym2 = prog.fifo("sym2", 1024)     # replay buffer
    bits = prog.fifo("bits", 4)
    data = [(i * 31 + 7) % 16 for i in range(n)]

    @prog.module("source")
    def source():
        for v in data:
            yield Write(sym, v)

    @prog.module("hist_replay")
    def hist_replay():
        hist = [0] * 16
        buf = []
        for _ in range(n):
            v = yield Read(sym)
            hist[v] += 1
            buf.append(v)
        # code length ~ rank by frequency (simplified canonical codes)
        order = sorted(range(16), key=lambda s: -hist[s])
        length = {s: 1 + r // 2 for r, s in enumerate(order)}
        for v in buf:
            yield Write(sym2, length[v])

    @prog.module("encoder")
    def encoder():
        total_bits = 0
        for _ in range(n):
            total_bits += (yield Read(sym2))
            yield Write(bits, total_bits)

    @prog.module("sink")
    def sink():
        last = 0
        for _ in range(n):
            last = yield Read(bits)
        yield Emit("total_bits", last)

    return prog


# ----------------------------------------------------- large-scale pipelines
def flowgnn_like(n_nodes: int = 128, layers: int = 4) -> Program:
    """FlowGNN-style: per-layer gather/scatter/update modules in a chain."""
    prog = Program("flowgnn_like", declared_type="A")
    chans = [prog.fifo(f"h{i}", 8) for i in range(2 * layers + 1)]

    @prog.module("loader")
    def loader():
        for v in range(n_nodes):
            yield Write(chans[0], (v * 17 + 3) % 256)

    def make_gather(layer: int):
        def gather():
            prev = 0
            for _ in range(n_nodes):
                v = yield Read(chans[2 * layer])
                yield Write(chans[2 * layer + 1], v + prev)   # neighbor mix
                prev = v
        return gather

    def make_update(layer: int):
        def update():
            for _ in range(n_nodes):
                v = yield Read(chans[2 * layer + 1])
                yield Delay(1)                                # MLP latency
                yield Write(chans[2 * layer + 2], (3 * v + 1) % 65536)
        return update

    for L in range(layers):
        prog.add_module(f"gather{L}", make_gather(L))
        prog.add_module(f"update{L}", make_update(L))

    @prog.module("readout")
    def readout():
        total = 0
        for _ in range(n_nodes):
            total += (yield Read(chans[2 * layers]))
        yield Emit("checksum", total % 1_000_000_007)

    return prog


def skynet_like(items: int = 2048, depth: int = 24) -> Program:
    """SkyNet-style deep CNN pipeline: `depth` stages, large item count.

    The heavyweight speed benchmark: ~items*depth FIFO events.
    """
    prog = Program("skynet_like", declared_type="A")
    chans = [prog.fifo(f"l{i}", 4) for i in range(depth + 1)]

    @prog.module("dma_in")
    def dma_in():
        for i in range(items):
            yield Write(chans[0], i % 251)

    def make_layer(s: int):
        def layer():
            for _ in range(items):
                v = yield Read(chans[s])
                yield Write(chans[s + 1], (v * 5 + s) % 65521)
        return layer

    for s in range(depth):
        prog.add_module(f"conv{s}", make_layer(s))

    @prog.module("dma_out")
    def dma_out():
        total = 0
        for _ in range(items):
            total += (yield Read(chans[depth]))
        yield Emit("checksum", total % 1_000_000_007)

    return prog


def high_latency_pipe(items: int = 200, stages: int = 6, ii: int = 64) -> Program:
    """Deep pipeline with high-II stages: cycle count >> event count.

    The regime where event-driven simulation structurally beats
    cycle-stepping (the paper's co-sim weakness): the oracle must step every
    idle cycle while OmniSim's cost scales with FIFO events only.
    """
    prog = Program(f"latency_pipe_ii{ii}", declared_type="A")
    chans = [prog.fifo(f"c{i}", 2) for i in range(stages + 1)]

    @prog.module("src")
    def src():
        for i in range(items):
            yield Write(chans[0], i)

    def mk(s):
        def stage():
            for _ in range(items):
                v = yield Read(chans[s])
                yield Delay(ii - 2)
                yield Write(chans[s + 1], v + 1)
        return stage

    for s in range(stages):
        prog.add_module(f"st{s}", mk(s))

    @prog.module("sink")
    def sink():
        tot = 0
        for _ in range(items):
            tot += (yield Read(chans[stages]))
        yield Emit("sum", tot)

    return prog


TYPEA_DESIGNS = {
    "producer_consumer": producer_consumer,
    "fir_filter": fir_filter,
    "window_conv": window_conv,
    "matmul_stream": matmul_stream,
    "sqrt_pipe": sqrt_pipe,
    "parallel_loops": parallel_loops,
    "nested_loops": nested_loops,
    "accumulators": accumulators,
    "vector_add_stream": vector_add_stream,
    "merge_sort_staged": merge_sort_staged,
    "huffman_pipe": huffman_pipe,
    "flowgnn_like": flowgnn_like,
    "skynet_like": skynet_like,
    "latency_pipe": high_latency_pipe,
}
