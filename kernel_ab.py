#!/usr/bin/env python3
"""Time the port's flash-attention, chunked-mLSTM and sparse max-plus
kernels from two checkouts on one card, in turns.

Usage, from the repository root on a machine with one CUDA card::

    python3 kernel_ab.py --other DIR

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive``).  The script runs four timing
passes in separate processes, this checkout and ``DIR`` in the order
other, this, this, other, so that a drift of the card's clock shows as a
difference between the two passes of one version.  Each pass builds the
checkout's own kernels and times, with CUDA events:

  * flash attention on bf16 inputs at smollm-135m's prefill shape (B 4,
    S 4096, 9 heads over 3, hd 64, causal) and at prefill_32k (B 1,
    S 32 768), median of 5 and of 3 calls;
  * the chunked-mLSTM kernel on f32 inputs (as ``chip_smoke.py``'s phase
    12 draws them) at xlstm-1.3b's prefill shape (B 4, S 2048, H 4,
    P 1024, Pv 1025, chunk 256) and at prefill_32k (B 1, S 32 768),
    median of 5 and of 3 calls;
  * one sparse fixpoint solve (``sparse.solve_chains``) of
    ``matmul_stream()`` and ``merge_sort_staged(8)`` at K = 1024 and of
    ``skynet_like()`` at K = 4096, the depth rows of ``chip_smoke.py``'s
    phases 3-4 (``numpy.random.default_rng(0)``), median of 3.

It prints one JSON line per pass, then the card's name and power limit
and a JSON summary: each kernel's median over the two passes of each
version.  Any failure exits non-zero.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def time_pass(root):
    """Time the kernels of the checkout at ``root``; returns a dict."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.core import compile_graph, dse, simulate
    from repro_torch.designs.typea import (matmul_stream, merge_sort_staged,
                                           skynet_like)
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.maxplus import sparse
    from repro_torch.kernels.mlstm_chunk import kernel as mc_kernel

    dev = torch.device("cuda")

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return statistics.median(ms)

    out = {"root": root}
    rng = np.random.default_rng(0)
    for label, B, S, reps in (("flash smollm-135m 4x4096", 4, 4096, 5),
                              ("flash prefill_32k", 1, 32768, 3)):
        H, Hkv, hd = 9, 3, 64
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B * h, S, hd), dtype=np.float32)).to(dev, torch.bfloat16)
            for h in (H, Hkv, Hkv))
        out[label] = cuda_ms(lambda: fa_kernel.flash_attention_bhsd(
            q, k, v, group_size=H // Hkv), reps)
        del q, k, v
    rng = np.random.default_rng(0)
    for label, B, S, reps in (("mlstm xlstm-1.3b 4x2048", 4, 2048, 5),
                              ("mlstm prefill_32k", 1, 32768, 3)):
        H, P, Pv, chunk = 4, 1024, 1025, 256
        q = rng.standard_normal((B * H, S, P), dtype=np.float32) / np.sqrt(P)
        k = rng.standard_normal((B * H, S, P), dtype=np.float32)
        v = rng.standard_normal((B * H, S, Pv), dtype=np.float32)
        g = rng.standard_normal((2, B * H, S), dtype=np.float32)
        xs = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
              for x in (q, k, v, 1 / (1 + np.exp(-g[0])),
                        -np.logaddexp(0, -(g[1] + 1.0)))]
        out[label] = cuda_ms(lambda: mc_kernel.mlstm_chunk_bhsd(
            *xs, chunk=chunk), reps)
        del q, k, v, xs
    rng = np.random.default_rng(0)
    for label, build, K, hi in (
            ("sparse matmul_stream K=1024", matmul_stream, 1024, 8),
            ("sparse merge_sort_staged(8) K=1024",
             lambda: merge_sort_staged(8), 1024, 8),
            ("sparse skynet_like K=4096", skynet_like, 4096, 16)):
        g = compile_graph(simulate(build()).graph)
        ba = dse._batch_arrays(g)
        D = rng.integers(1, hi + 1, size=(K, len(g.fifos)))
        D = D[~(D < ba.fifo_need[None, :]).any(axis=1)]
        arr = dse._sparse_arrays(ba, dev)
        Dt = torch.from_numpy(np.minimum(D, 1 << 30).astype(np.int32)).to(dev)
        out[label] = cuda_ms(lambda: sparse.solve_chains(arr, Dt), 3)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout to time against")
    ap.add_argument("--pass-root", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.pass_root:
        print(json.dumps(time_pass(os.path.abspath(args.pass_root))))
        return 0
    if not args.other or not os.path.isdir(os.path.join(args.other, "src")):
        print("kernel_ab: --other must name a checkout", file=sys.stderr)
        return 1
    other = os.path.abspath(args.other)
    passes = []
    for root in (other, ROOT, ROOT, other):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--pass-root", root],
            capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        passes.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(passes[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    summary = {}
    for key in passes[0]:
        if key == "root":
            continue
        summary[key] = {
            "other_ms": [passes[0][key], passes[3][key]],
            "this_ms": [passes[1][key], passes[2][key]],
            "speedup": statistics.median([passes[0][key], passes[3][key]])
            / statistics.median([passes[1][key], passes[2][key]])}
    print(json.dumps({"card": card, "other": other, "this": ROOT,
                      "kernels": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
