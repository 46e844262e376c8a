"""Hand-written CUDA kernels of the PyTorch port, each beside its plain
PyTorch version (``<name>/ref.py``) and its dispatcher (``<name>/ops.py``).

``maxplus`` carries the batched max-plus longest-path fixpoint, the only
device work on the simulator's main path; ``flash_attention`` carries
full-sequence attention on the LM serving path (the prefill step);
``mlstm_chunk`` carries the chunked mLSTM recurrence of xlstm's prefill.
Sources live in
``repro_torch/csrc/``; ``_cuda.CudaLib.lib()`` compiles each with ``nvcc``
at its first use.
"""
