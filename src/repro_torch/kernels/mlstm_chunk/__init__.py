"""Chunked mLSTM: the hand-written CUDA kernel (``kernel``), its plain
PyTorch version (``ref``) and the model-facing dispatcher (``ops``)."""
from .kernel import mlstm_chunk_bhsd
from .ops import mlstm_chunk
from .ref import mlstm_ref

__all__ = ["mlstm_chunk_bhsd", "mlstm_chunk", "mlstm_ref"]
