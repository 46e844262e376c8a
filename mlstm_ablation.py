#!/usr/bin/env python3
"""Ablations of the chunked-mLSTM CUDA kernel: where its time goes.

Usage, from the repository root on a machine with one CUDA card and the
CUDA toolkit::

    python3 mlstm_ablation.py

Builds ``src/repro_torch/csrc/mlstm_chunk.cu`` and variants of it, each a
text patch of the source, with ``nvcc`` (all at once) into
``build/ablation/``, and times one call of each (CUDA events, median of 3
after a warm-up) at xlstm-1.3b's shape (B 4, S 2048, H 4, P 1024,
Pv 1025, chunk 256) and at prefill_32k (B 1, S 32 768), on f32 inputs
drawn as ``chip_smoke.py``'s phase 12 draws them:

  base                   the kernel as it is;
  no_products            every mma removed (the copies, fragment loads,
                         carry sums and barriers kept);
  two_stages             a ring of two shared-memory stages, not three;
  head0_tiles            every block streams head 0's tiles (L2 hits);
  no_copies              the tile copies made zero-fills (no reads);
  no_products_no_copies  both: the steps' own cost.

Only ``base`` computes the readout; the others are for timing.  Also
prints the four kernels' device times of one ``base`` call
(``torch.profiler``), the registers and spills ``ptxas`` reports, and, last,
the card's name and power limit and one JSON line with every number.
"""
import concurrent.futures
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "csrc", "mlstm_chunk.cu")
OUT = os.path.join(ROOT, "build", "ablation")

NO_MMA = ('  asm volatile(\n      "mma.sync', '  if (false) asm volatile(\n      "mma.sync')
NO_COPY = ('"l"(src), "r"(in ? 16 : 0));', '"l"(src), "r"(0));')
VARIANTS = {
    "base": [],
    "no_products": [NO_MMA],
    "two_stages": [("  if (recurrent_smem(d, 3) <= (size_t)kMaxSmem)",
                    "  if (false)")],
    "head0_tiles": [("  const int64_t z = (int64_t)bh * d.nC + u.n;\n"
                     "  if (u.phase == 0) {",
                     "  const int64_t z = u.n;\n  if (u.phase == 0) {")],
    "no_copies": [NO_COPY],
    "no_products_no_copies": [NO_MMA, NO_COPY],
}


def build(name, text, nvcc):
    """Patch the source (every occurrence of each anchor), compile it with
    ``nvcc`` (the command and flags); returns (name, library path, ptxas
    lines of the recurrent kernel)."""
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"{name}: patch anchor not found: {old!r}")
        text = text.replace(old, new)
    src = os.path.join(OUT, f"{name}.cu")
    lib = os.path.join(OUT, f"lib{name}.so")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run([*nvcc, "-Xptxas", "-v", "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    lines = proc.stderr.splitlines()
    info = [lines[i + 1].strip() + "; " + lines[i + 2].strip()
            for i, line in enumerate(lines)
            if "chunk_recurrent" in line and i + 2 < len(lines)]
    return name, lib, info


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mlstm_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _cuda

    os.makedirs(OUT, exist_ok=True)
    with open(SOURCE) as f:
        text = f.read()
    nvcc = [_cuda._nvcc(), *_cuda.ARCH_FLAGS, *_cuda.NVCC_FLAGS]
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(lambda n: build(n, text, nvcc), VARIANTS))
    P_, I_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name, path, info in built:
        lib = ctypes.CDLL(path)
        lib.mlstm_chunk_workspace.argtypes = [I_, I_, I_, I_, P_]
        lib.mlstm_chunk_fwd.argtypes = [P_] * 7 + [L_] + [I_] * 5 + [P_]
        libs[name] = lib
        print(f"{name}: chunk_recurrent {info}", flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def cuda_ms(fn, reps=3):
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

    result = {}
    for label, B, S in (("a xlstm-1.3b", 4, 2048), ("prefill_32k", 1, 32768)):
        H, P, Pv, chunk = 4, 1024, 1025, 256
        BH = B * H
        q = rng.standard_normal((BH, S, P), dtype=np.float32) / np.sqrt(P)
        k = rng.standard_normal((BH, S, P), dtype=np.float32)
        v = rng.standard_normal((BH, S, Pv), dtype=np.float32)
        g = rng.standard_normal((2, BH, S), dtype=np.float32)
        xs = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
              for x in (q, k, v, 1 / (1 + np.exp(-g[0])),
                        -np.logaddexp(0, -(g[1] + 1.0)))]
        y = torch.empty(BH, S, Pv, device=dev)
        nbytes = ctypes.c_longlong()
        if libs["base"].mlstm_chunk_workspace(BH, S, P, chunk,
                                              ctypes.addressof(nbytes)):
            raise RuntimeError("mlstm_chunk_workspace failed")
        ws = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def call(lib):
            code = lib.mlstm_chunk_fwd(*(x.data_ptr() for x in xs),
                                       y.data_ptr(), ws.data_ptr(),
                                       nbytes.value, BH, S, P, Pv, chunk,
                                       stream)
            if code:
                raise RuntimeError(f"mlstm_chunk_fwd: CUDA error {code}")

        row = {name: cuda_ms(lambda: call(lib)) for name, lib in libs.items()}
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call(libs["base"])
            torch.cuda.synchronize()
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0) or getattr(
                e, "self_cuda_time_total", 0)
            for kern in ("chunk_cumsum", "split_operands", "chunk_scores",
                         "chunk_recurrent"):
                if kern in e.key and t:
                    row[f"base {kern}"] = t / 1e3
        result[label] = row
        print(f"{label}: " + ", ".join(f"{n} {t:.3f} ms"
                                       for n, t in row.items()), flush=True)
        del xs, y, ws
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"card": card, "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
