"""Hand-written CUDA kernels of the PyTorch port, each beside its plain
PyTorch version (``<name>/ref.py``) and its dispatcher (``<name>/ops.py``).

``maxplus`` carries the batched max-plus longest-path fixpoint, the only
device work on the simulator's main path.  Sources live in
``repro_torch/csrc/``; ``_cuda.CudaLib.lib()`` compiles each with ``nvcc``
at its first use.
"""
