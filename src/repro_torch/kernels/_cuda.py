"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``.  The build happens at first use, from the package's own
sources, into ``build/kernels/`` at the repository root (listed in
``.gitignore``); the library's file name carries a digest of its source
and flags, so an edited source is rebuilt and never mixed with a stale
binary.

:func:`check_batches` is the host side of every device fixpoint loop: how
many rounds to launch before reading the one word that says whether the
last round changed anything.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Iterator, List, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")
# a fixpoint loop reads its flag after 1, 2, 4, ... rounds, then every
# CHECK_CAP rounds.  Each read costs a host sync; a larger cap launches
# more rounds past the fixpoint (up to CHECK_CAP - 1, half that on
# average).  32 keeps both small on the bundled designs' 450-8200 rounds.
CHECK_CAP = 32

P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
            "are built from source at first use on a machine with the CUDA "
            "toolkit")
    return path


class CudaLib:
    """One kernel source, its shared library and its launch counters.

    ``launches`` is an integer that the kernel's Python wrapper raises by
    one (:meth:`count`) each time it launches the kernel, and nowhere
    else.  A source with more than one kernel route also counts each
    launch under its route's name in ``route_launches``, and a wrapper
    that passes a key (flash attention: the window) counts it under that
    key in ``launches_by``.
    """

    def __init__(self, name: str, signatures: Dict[str, Sequence],
                 routes: Sequence[str] = ()):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.signatures = signatures
        self.launches = 0
        self.route_launches = dict.fromkeys(routes, 0)
        self.launches_by: Counter = Counter()
        self._lib = None
        self._lock = threading.Lock()

    def reset_counts(self) -> None:
        """Set every launch counter to 0."""
        with self._lock:
            self.launches = 0
            self.route_launches = dict.fromkeys(self.route_launches, 0)
            self.launches_by = Counter()

    def count(self, route=None, key=None, n: int = 1) -> None:
        """Count ``n`` launches (and as many of ``route``, and under
        ``key``): under the lock, so wrappers called from several threads
        lose no count."""
        with self._lock:
            self.launches += n
            if route is not None:
                self.route_launches[route] += n
            if key is not None:
                self.launches_by[key] += n

    # -- build -----------------------------------------------------------
    def target(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:12]}.so"

    def build(self) -> None:
        """Compile the source with ``nvcc`` unless its library exists."""
        out = self.target()
        if out.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
             str(self.source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)

    # -- bind ------------------------------------------------------------
    def lib(self):
        """The loaded library (built first if needed)."""
        with self._lock:
            if self._lib is None:
                self.build()
                lib = ctypes.CDLL(str(self.target()))
                for fn, argtypes in self.signatures.items():
                    f = getattr(lib, fn)
                    f.argtypes = list(argtypes)
                    f.restype = I
                err = getattr(lib, f"{self.name}_error_string")
                err.argtypes = [I]
                err.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def call(self, fn: str, *args) -> None:
        """Call launcher ``fn``; raise if it reports a CUDA error."""
        lib = self.lib()
        code = getattr(lib, fn)(*args)
        if code != 0:
            msg = getattr(lib, f"{self.name}_error_string")(code).decode()
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {code}: {msg}")


SPARSE = CudaLib("maxplus_sparse", {
    "maxplus_sparse_rounds": [P, P, P, P, P, P, I, P, P, P, P, I, P, P, P,
                              P, P, P, I, P, I, I, P, P, I, P],
    "maxplus_sparse_live": [P, P, I, P, P, P],
})
DENSE = CudaLib("maxplus_dense", {
    "maxplus_dense_sweep": [P, P, P, I, P, I, I, P, P],
})
FLASH = CudaLib("flash_attention", {
    "flash_attention_fwd": [P, P, P, P, I, I, I, I, I, I, F, I, P],
}, routes=("tensor_core_bf16", "fma_f32"))
MLSTM = CudaLib("mlstm_chunk", {
    "mlstm_chunk_workspace": [I, I, I, I, P],
    "mlstm_chunk_fwd": [P, P, P, P, P, P, P, L, I, I, I, I, I, P],
})
LIBS: List[CudaLib] = [SPARSE, DENSE, FLASH, MLSTM]


def check_batches(limit: int) -> Iterator[int]:
    """Batch sizes 1, 2, 4, ... up to :data:`CHECK_CAP`, summing to
    ``limit``: a fixpoint loop launches one batch of rounds, then reads its
    flag, and stops at the first batch whose last round changed nothing."""
    done, every = 0, 1
    while done < limit:
        step = min(every, limit - done)
        yield step
        done += step
        every = min(2 * every, CHECK_CAP)


def resolve_device(device):
    """``device`` as a ``torch.device``; a CUDA device must exist.

    The port's entry points default to ``"cuda"`` and never carry on on
    the CPU by themselves: without a card the caller must ask for
    ``device="cpu"`` (the plain PyTorch versions of the kernels).
    """
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; pass "
            f"device='cpu' to run the plain PyTorch versions of the kernels")
    return dev


def stream_of(tensor) -> int:
    """The raw handle of PyTorch's current stream on ``tensor``'s device."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


def refuse_grad(kernel: str, tensors) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad.  The
    hand-written kernels have no backward (nor have the reference's Pallas
    kernels): a kernel's output would carry no ``grad_fn``, and the
    gradients of everything before it would come out ``None`` without a
    word.  The plain versions that stand in for them on the CPU refuse the
    same tensors, so both devices take one path."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {kernel} kernel has no backward, and an input requires "
            f"grad: train through the models' lane='train' (plain torch "
            f"under autograd), or call it under torch.no_grad()")
