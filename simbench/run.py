"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 simbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout that holds the port (``src/repro_torch``).
The last line of standard output is the result as one JSON object; the
numbers that decide ``correct`` are also the last lines of standard error.
The run exits with a code other than 0, and prints no result, when there is
no CUDA device (or fewer than the cell asks for), when the output check
cannot be made, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the run stays inside the checkout, at fixed
# paths, so a second run of a cell finds what the first one built
# (the port's own CUDA kernels build into build/kernels/ by themselves)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "nv_compute_cache")
sys.path[:1] = [str(ROOT), str(ROOT / "src")]

from simbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], ROOT, T_START))
