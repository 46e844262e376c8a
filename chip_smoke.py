#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Usage, from the repository root on a machine with one CUDA card and the
CUDA toolkit::

    python3 chip_smoke.py

Phases, each printing its own line:

  1. environment: Python, torch and CUDA versions, the card's name and
     power limit (``nvidia-smi``), and the timed ``nvcc`` build of both
     hand-written kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
     source, started together);
  2. each kernel against its plain PyTorch version on the card, on seeded
     synthetic inputs (kernel 1: random chains and edges exported with
     ``export_chain_flat``, K = 256; kernel 2: a random [4, 2048, 2048]
     int32 batch), bit for bit;
  3-6. the main path — simulate a design, compile its graph, re-solve it
     under a block of depth configs — through the entry points a user
     calls (``solve_block_status`` / ``resimulate_batch`` with
     ``backend="cuda"`` or ``"cuda_dense"``):
       3. ``skynet_like()`` at its defaults (102 452 nodes), K = 4096;
       4. ``matmul_stream()`` and ``merge_sort_staged(8)``, K = 1024;
       5. ``fig4_ex5()`` at K = 128 with the engine fallback, and the
          burst ping-pong whose shrunk rows form WAR cycles;
       6. ``merge_sort_staged()`` at K = 64 through the dense lane, and
          ``finalize_times`` on its simulation graph.
     Launch counts are zeroed just before and read just after these
     phases.  Their verdicts are then held against the plain versions on
     the card (all rows) and the port's exact host solver
     ``backend="numpy"`` (a prefix of rows);
  7. timings: the wall time of each main-path call (median of 3 after
     the counted run), each kernel's time beside its plain version's and
     its memory bound, and peak device memory.  The bound counts the
     rounds (sweeps) the fixpoint needs, up to and including the first
     that changes nothing; the loop launches more, because the host reads
     the flag only every few rounds, and those are reported apart.

The last two lines are the card's name and power limit, then one JSON
object ``{"ok": true, "device": {...}}``; the line before them is the
``{"kernels": [...]}`` record.  Any failure exits non-zero and prints no
result.  Depth rows come from ``numpy.random.default_rng(0)``.
"""
import concurrent.futures
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data sheet: HBM3 at 3.35 TB/s; the kernels move int32 bytes
# and use no tensor cores, so bytes bound them
HBM_BYTES_PER_S = 3.35e12
FAILURES = []


def log(msg):
    print(msg, flush=True)


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    try:
        yield
    except Exception:                     # noqa: BLE001 — report, go on
        FAILURES.append(name)
        log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
        traceback.print_exc()
        sys.stdout.flush()
    else:
        log(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def synthetic_chain_graph(rng, chains=16, fifos=6):
    """Seeded random chain graph in the shape the simulator exports: every
    node gets a recorded commit time (increasing along its chain); FIFO
    writes and reads pair up in time order between two chains (RAW edge
    write -> read), and extra RAW edges run forward in time, so the graph
    without WAR edges is acyclic.  Regenerated WAR edges (read ``w-S-1``
    -> write ``w``) may run against the recorded times, so small depths
    can form cycles, as in real designs.  Returns ``(n, args)`` for
    ``export_chain_flat(*args, neg=...)``."""
    lens = rng.integers(50, 400, size=chains)
    slices, off = [], 0
    for ln in lens:
        slices.append((off, off + int(ln)))
        off += int(ln)
    n = off
    when = np.concatenate([np.cumsum(rng.integers(1, 4, size=int(ln)))
                           for ln in lens])
    seq_w = rng.integers(0, 4, size=n)
    seq_w[[lo for lo, _ in slices]] = 0
    cw = np.concatenate([np.cumsum(seq_w[lo:hi]) for lo, hi in slices])
    c_seed = np.full(n, -(1 << 40), np.int64)
    c_seed[[lo for lo, _ in slices]] = 0
    pick = rng.choice(n, size=n // 20, replace=False)
    c_seed[pick] = rng.integers(0, 50, size=len(pick))
    used = np.zeros(n, bool)
    raw_dst, raw_src, w_cols, r_cols = [], [], [], []
    for _ in range(fifos):
        a, b = rng.choice(chains, size=2, replace=False)
        wc, rc = [], []
        cand = np.arange(*slices[b])
        for w in np.sort(rng.choice(np.arange(*slices[a]),
                                    int(lens[a]) // 3, replace=False)):
            if used[w]:
                continue
            later = cand[(when[cand] > when[w]) & ~used[cand]]
            if rc:
                later = later[later > rc[-1]]
            if not len(later):
                break
            r = int(later[min(int(rng.integers(0, 3)), len(later) - 1)])
            used[[w, r]] = True
            wc.append(int(w))
            rc.append(r)
        raw_dst += rc
        raw_src += wc
        w_cols.append(np.asarray(wc, np.int64))
        r_cols.append(np.asarray(rc, np.int64))
    for _ in range(n // 10):
        s_, d_ = rng.integers(0, n, size=2)
        if not used[d_] and when[s_] < when[d_] and \
                np.searchsorted([hi for _, hi in slices], s_, "right") != \
                np.searchsorted([hi for _, hi in slices], d_, "right"):
            used[d_] = True
            raw_dst.append(int(d_))
            raw_src.append(int(s_))
    raw_w = np.ones(len(raw_dst), np.int64)
    blocking = [np.ones(len(w), bool) for w in w_cols]
    bound = int(c_seed.max() + seq_w.sum() + raw_w.sum()
                + sum(len(w) for w in w_cols) + 1)
    return n, (slices, cw, c_seed, np.asarray(raw_dst, np.int64),
               np.asarray(raw_src, np.int64), raw_w, w_cols, r_cols,
               blocking, bound)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import (Emit, Program, Read, Write, compile_graph,
                                  resimulate_batch, simulate,
                                  solve_block_status)
    from repro_torch.core import dse
    from repro_torch.core.graph import export_chain_flat, longest_path_numpy
    from repro_torch.designs.paper import fig4_ex5
    from repro_torch.designs.typea import (matmul_stream, merge_sort_staged,
                                           skynet_like)
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.maxplus import kernel, ops, ref, sparse

    dev = torch.device("cuda")
    card = smi()

    # ---------------------------------------------------------------- 1
    with phase("1 environment"):
        log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
            f"cuda {torch.version.cuda}  device "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        log(f"card: {card}")
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(_cuda.LIBS)) as ex:
            list(ex.map(lambda lib: lib.lib(), _cuda.LIBS))
        log(f"kernel build (nvcc, one per source, in parallel): "
            f"{time.perf_counter() - t0:.2f} s")
    if FAILURES:
        return 1

    def sync():
        torch.cuda.synchronize()

    def cuda_time(fn, reps):
        """Median ms of ``reps`` runs of fn (after one warm-up run)."""
        fn()
        sync()
        ms = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            sync()
            ms.append(a.elapsed_time(b))
        return statistics.median(ms)

    def same_solve(kern, plain):
        """Kernel and plain (times, converged) agree bit for bit: the
        converged mask, and the times of converged rows.  Returns the max
        absolute difference (0)."""
        (tk, ck), (tp, cp) = kern[:2], plain[:2]
        check(torch.equal(ck, cp), "converged masks differ")
        if not bool(ck.any()):
            return 0
        d = (tk[:, ck].long() - tp[:, cp].long()).abs().max()
        check(int(d) == 0, f"times differ by up to {int(d)}")
        return int(d)

    @contextlib.contextmanager
    def plain_kernels():
        """Route the device lanes through the plain PyTorch versions (on
        the same card) — the comparison, never the main path."""
        saved = (sparse.solve_chains, kernel.maxplus_sweep,
                 ops.maxplus_sweep)
        sparse.solve_chains = ref.solve_chains_ref
        kernel.maxplus_sweep = ops.maxplus_sweep = ref.maxplus_sweep_ref
        try:
            yield
        finally:
            (sparse.solve_chains, kernel.maxplus_sweep,
             ops.maxplus_sweep) = saved

    def same_status(a, b, what):
        for x, y, f in zip(a[:3], b[:3], ("status", "cycles", "violated")):
            check(np.array_equal(x, y), f"{what}: {f} differs")

    def same_outcome(a, b, what):
        same_status((a.status, a.cycles, a.violated),
                    (b.status, b.cycles, b.violated), what)
        check(a.reasons == b.reasons, f"{what}: reasons differ")
        for ra, rb in zip(a.results, b.results):
            check((ra is None) == (rb is None), f"{what}: fallback differs")
            if ra is not None:
                check(ra.cycles == rb.cycles and ra.outputs == rb.outputs
                      and ra.deadlock == rb.deadlock,
                      f"{what}: fallback result differs")

    rng = np.random.default_rng(0)

    # ---------------------------------------------------------------- 2
    with phase("2 kernels vs plain versions (synthetic inputs)"):
        # kernel 1: seeded random chains and edges, exported like a real
        # graph (see synthetic_chain_graph)
        n, args = synthetic_chain_graph(rng)
        arr = sparse.to_device(export_chain_flat(*args, neg=sparse.NEG), dev)
        D2 = torch.from_numpy(rng.integers(1, 9, size=(256, 6))
                              .astype(np.int32)).to(dev)
        got = sparse.solve_chains(arr, D2)
        want = ref.solve_chains_ref(arr, D2)
        same_solve(got, want)
        check(want[2] <= got[2] < want[2] + _cuda.CHECK_CAP,
              f"kernel launched {got[2]} rounds, plain needed {want[2]}")
        log(f"  kernel 1: n={n} E={arr.raw_dst.shape[0]} K=256 rounds={got[2]} "
            f"converged={int(got[1].sum())}/256, equal to plain")
        # kernel 2: one sweep on a random batch
        A2 = rng.integers(-8, 8, size=(4, 2048, 2048)).astype(np.int32)
        A2[rng.random(A2.shape) < 0.5] = kernel.NEG
        t2 = rng.integers(-99, 99, size=(4, 2048)).astype(np.int32)
        b2 = rng.integers(-99, 99, size=2048).astype(np.int32)
        A2, t2, b2 = (torch.from_numpy(x).to(dev) for x in (A2, t2, b2))
        s_k = kernel.maxplus_sweep(A2, t2, b2)
        s_p = ref.maxplus_sweep_ref(A2, t2, b2)
        check(torch.equal(s_k, s_p), "dense sweep differs from plain")
        log("  kernel 2: [4, 2048, 2048] sweep equal to plain")

    # ------------------------------------------------ main path (3 - 6)
    designs = {}
    for lib in _cuda.LIBS:
        lib.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with phase("main path: simulate + compile"):
        for key, build in (("skynet", skynet_like),
                           ("matmul", matmul_stream),
                           ("msort8", lambda: merge_sort_staged(8)),
                           ("fig4_ex5", fig4_ex5),
                           ("msort6", merge_sort_staged)):
            t0 = time.perf_counter()
            res = simulate(build())
            g = compile_graph(res.graph)
            designs[key] = (res, g)
            log(f"  {key}: n={g.n} fifos={len(g.fifos)} "
                f"cycles={res.cycles} ({time.perf_counter() - t0:.2f} s)")

    def pingpong():
        prog = Program("burst_pingpong", declared_type="A")
        cmd = prog.fifo("cmd", 8)
        resp = prog.fifo("resp", 8)

        @prog.module("ctrl")
        def ctrl():
            for i in range(8):
                yield Write(cmd, i)
            tot = 0
            for _ in range(8):
                tot += (yield Read(resp))
            yield Emit("sum", tot)

        @prog.module("proc")
        def proc():
            for _ in range(8):
                v = yield Read(cmd)
                yield Write(resp, 2 * v)

        return prog

    if FAILURES:
        return 1

    def rows(key, K, hi):
        return rng.integers(1, hi + 1, size=(K, len(designs[key][0].depths)))

    Dm = {"skynet": rows("skynet", 4096, 16),
          "matmul": rows("matmul", 1024, 8),
          "msort8": rows("msort8", 1024, 8),
          "fig4_ex5": rows("fig4_ex5", 128, 8),
          "pingpong": np.array([(1, 1), (2, 2), (1, 8), (8, 1), (4, 4),
                                (8, 8)]),
          "msort6": rows("msort6", 64, 8)}
    pp_res = simulate(pingpong())

    def run3():
        return solve_block_status(designs["skynet"][1], Dm["skynet"],
                                  backend="cuda", device=dev)

    def run4m():
        return solve_block_status(designs["matmul"][1], Dm["matmul"],
                                  backend="cuda", device=dev)

    def run4s():
        return solve_block_status(designs["msort8"][1], Dm["msort8"],
                                  backend="cuda", device=dev)

    def run5f():
        return resimulate_batch(designs["fig4_ex5"][0], Dm["fig4_ex5"],
                                backend="cuda", device=dev)

    def run5p():
        return resimulate_batch(pp_res, Dm["pingpong"], backend="cuda",
                                device=dev)

    def run6d():
        return resimulate_batch(designs["msort6"][0], Dm["msort6"],
                                backend="cuda_dense", device=dev)

    def run6f():
        return ops.finalize_times(designs["msort6"][0].graph.graph,
                                  device=dev)

    calls = {"3 skynet_like K=4096": run3,
             "4 matmul_stream K=1024": run4m,
             "4 merge_sort_staged(8) K=1024": run4s,
             "5 fig4_ex5 K=128 fallback": run5f,
             "5 burst_pingpong K=6": run5p,
             "6 merge_sort_staged() K=64 dense": run6d,
             "6 finalize_times merge_sort_staged()": run6f}
    out, first_s = {}, {}
    with phase("main path: device re-solves (counted)"):
        for name, fn in calls.items():
            t0 = time.perf_counter()
            out[name] = fn()
            sync()
            first_s[name] = time.perf_counter() - t0
            log(f"  {name}: {first_s[name]:.3f} s")
    launches = {lib.name: lib.launches for lib in _cuda.LIBS}
    peak_bytes = torch.cuda.max_memory_allocated()
    log(f"launches on the main path: {launches}")
    if FAILURES or len(out) != len(calls):
        return 1

    with phase("3 skynet_like K=4096 vs plain (all rows) and numpy (64)"):
        g, D = designs["skynet"][1], Dm["skynet"]
        st = out["3 skynet_like K=4096"]
        with plain_kernels():
            same_status(st, solve_block_status(g, D, backend="cuda",
                                               device=dev), "plain")
        same_status([x[:64] for x in st[:3]],
                    solve_block_status(g, D[:64], backend="numpy"), "numpy")
        log(f"  status counts {np.bincount(st[0], minlength=4).tolist()} "
            f"cycles {sorted(set(st[1].tolist()))[:6]}")

    with phase("4 matmul_stream / merge_sort_staged(8) K=1024 vs plain "
               "and numpy"):
        for key, name, n_np in (("matmul", "4 matmul_stream K=1024", 16),
                                ("msort8", "4 merge_sort_staged(8) K=1024",
                                 64)):
            g, D = designs[key][1], Dm[key]
            st = out[name]
            with plain_kernels():
                same_status(st, solve_block_status(g, D, backend="cuda",
                                                   device=dev), key)
            same_status([x[:n_np] for x in st[:3]],
                        solve_block_status(g, D[:n_np], backend="numpy"),
                        key + " numpy")
            log(f"  {key}: rounds {st[3]}, status counts "
                f"{np.bincount(st[0], minlength=4).tolist()}, "
                f"{len(set(st[1].tolist()))} distinct cycle counts")

    with phase("5 verdicts + fallback vs numpy"):
        o = out["5 fig4_ex5 K=128 fallback"]
        check(int((o.status == dse.VIOLATED).sum()) > 0, "no VIOLATED rows")
        same_outcome(o, resimulate_batch(designs["fig4_ex5"][0],
                                         Dm["fig4_ex5"], backend="numpy"),
                     "fig4_ex5")
        p = out["5 burst_pingpong K=6"]
        check(p.status[:2].tolist() == [dse.CYCLE] * 2,
              f"ping-pong rows 0-1 not CYCLE: {p.status}")
        same_outcome(p, resimulate_batch(pp_res, Dm["pingpong"],
                                         backend="numpy"), "pingpong")
        log(f"  fig4_ex5 status counts "
            f"{np.bincount(o.status, minlength=4).tolist()}; ping-pong "
            f"{p.status.tolist()}")

    with phase("6 dense lane vs numpy; finalize_times vs numpy"):
        o = out["6 merge_sort_staged() K=64 dense"]
        same_outcome(o, resimulate_batch(designs["msort6"][0], Dm["msort6"],
                                         backend="numpy"), "msort6 dense")
        sg = designs["msort6"][0].graph.graph
        want = longest_path_numpy(*sg.to_csr())
        check(np.array_equal(out["6 finalize_times merge_sort_staged()"]
                             .cpu().numpy(), want), "finalize_times differs")
        log(f"  status counts {np.bincount(o.status, minlength=4).tolist()}")

    with phase("launch counts"):
        for name, count in launches.items():
            check(count > 0, f"kernel {name} was not launched on the main "
                  f"path")

    # ---------------------------------------------------------------- 7
    kernels = []
    with phase("7 timings"):
        for name, fn in calls.items():
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                sync()
                walls.append(time.perf_counter() - t0)
            log(f"  wall {name}: median {statistics.median(walls):.4f} s "
                f"(first {first_s[name]:.4f} s) [{card}]")
        log(f"  peak device memory on the main path: "
            f"{peak_bytes / 2**30:.3f} GiB [{card}]")

        # kernel 1 at the shapes of phases 3 and 4
        by_shape = []
        for key, K_label in (("matmul", "matmul_stream K=1024"),
                             ("msort8", "merge_sort_staged(8) K=1024"),
                             ("skynet", "skynet_like K=4096")):
            g, D = designs[key][1], Dm[key]
            ba = dse._batch_arrays(g)
            Da = D[~(D < ba.fifo_need[None, :]).any(axis=1)]
            arr = dse._sparse_arrays(ba, dev)
            Dt = torch.from_numpy(np.minimum(Da, 1 << 30).astype(np.int32)
                                  ).to(dev)
            res = {}
            k_ms = cuda_time(lambda: res.__setitem__(
                "k", sparse.solve_chains(arr, Dt)), 3)
            p_ms = cuda_time(lambda: res.__setitem__(
                "p", ref.solve_chains_ref(arr, Dt)), 1)
            err = same_solve(res["k"], res["p"])
            # the plain version stops at the first round that changes
            # nothing; the kernel's loop launches more (flag read per batch)
            rounds, launched, K = res["p"][2], res["k"][2], Dt.shape[0]
            check(rounds <= launched < rounds + _cuda.CHECK_CAP,
                  f"kernel launched {launched} rounds, plain needed {rounds}")
            E, m = arr.raw_dst.shape[0], arr.war_dst.shape[0]
            bytes_ = 4 * K * (2 * g.n + 2 * (E + m)) * rounds
            by_shape.append({
                "shape": f"{K_label} (n={g.n}, E={E}, m={m}, K={K})",
                "rounds": rounds, "launched": launched, "ms": k_ms,
                "plain_ms": p_ms,
                "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3,
                "max_abs_err": err})
            log(f"  kernel 1 {by_shape[-1]} [{card}]")
        top = by_shape[0]
        kernels.append({
            "name": "maxplus_sparse_fixpoint", "route": "cuda",
            "source": "src/repro_torch/csrc/maxplus_sparse.cu",
            "replaces": "src/repro/kernels/maxplus/sparse.py:140",
            "launches": launches["maxplus_sparse"],
            "max_abs_err": max(s["max_abs_err"] for s in by_shape),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shape": top["shape"],
            "rounds": top["rounds"], "launched": top["launched"],
            "by_shape": by_shape})

        # kernel 2 at the shape of phase 6, and the synthetic batch
        by_shape = []
        g6, D6 = designs["msort6"][1], Dm["msort6"]
        n6 = g6.n
        A6, b6 = dse._dense_skeleton(g6, dev)
        AK = dse._dense_adjacency(g6, A6, D6)
        res = {}
        k_ms = cuda_time(lambda: res.__setitem__(
            "k", ops.longest_path(AK, b6)), 3)
        with plain_kernels():
            p_ms = cuda_time(lambda: res.__setitem__(
                "p", ops.longest_path(AK, b6)), 1)
        check(torch.equal(res["k"], res["p"]), "dense fixpoint differs")
        # sweeps the loop launched, by the kernel's counter
        before = _cuda.DENSE.launches
        ops.longest_path(AK, b6)
        sync()
        launched = _cuda.DENSE.launches - before
        # sweeps the fixpoint needs: up to and including the first that
        # changes nothing, with the flag read after every sweep
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        t6 = b6.expand(AK.shape[:-1]).contiguous()
        for sweeps in range(1, n6 + 1):
            t6 = kernel.maxplus_sweep(AK, t6, b6, flag)
            if not int(flag.item()):
                break
        check(torch.equal(t6, res["k"]), "stepped dense fixpoint differs")
        K6 = len(D6)
        sweep_bytes = 4 * (K6 * n6 * n6 + 2 * K6 * n6 + n6)
        by_shape.append({
            "shape": f"merge_sort_staged() K=64 fixpoint (N={n6})",
            "sweeps": sweeps, "launched": launched, "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": sweep_bytes * sweeps / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": int((res["k"].long() - res["p"].long()).abs()
                               .max())})
        log(f"  kernel 2 {by_shape[-1]} [{card}]")
        s_ms = cuda_time(lambda: kernel.maxplus_sweep(A2, t2, b2), 10)
        sp_ms = cuda_time(lambda: ref.maxplus_sweep_ref(A2, t2, b2), 3)
        by_shape.append({
            "shape": "random [4, 2048, 2048] one sweep", "sweeps": 1,
            "launched": 1, "ms": s_ms, "plain_ms": sp_ms,
            "bound_ms": 4 * (4 * 2048 * 2048 + 2 * 4 * 2048 + 2048)
            / HBM_BYTES_PER_S * 1e3, "max_abs_err": 0})
        log(f"  kernel 2 {by_shape[-1]} [{card}]")
        top = by_shape[0]
        kernels.append({
            "name": "maxplus_dense_sweep", "route": "cuda",
            "source": "src/repro_torch/csrc/maxplus_dense.cu",
            "replaces": "src/repro/kernels/maxplus/kernel.py:58",
            "launches": launches["maxplus_dense"],
            "max_abs_err": max(s["max_abs_err"] for s in by_shape),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shape": top["shape"],
            "sweeps": top["sweeps"], "launched": top["launched"],
            "by_shape": by_shape})

    if FAILURES:
        log(f"FAILED phases: {FAILURES}")
        return 1
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:                     # noqa: BLE001 — fail loudly
        traceback.print_exc()
        code = 1
    sys.exit(code)
