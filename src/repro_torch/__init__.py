"""PyTorch/CUDA port of the OmniSim reproduction (``repro``).

Grows beside the JAX package, mirroring its layout and public names:
``repro_torch.core`` (simulator and batched depth re-solve),
``repro_torch.designs`` (the benchmark designs) and
``repro_torch.kernels`` (hand-written CUDA kernels for the H100).  It
imports ``torch`` and ``numpy``, never ``jax`` nor ``repro``.
"""
