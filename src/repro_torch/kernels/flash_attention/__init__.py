"""Flash attention: the hand-written CUDA kernel (``kernel``), its plain
PyTorch version (``ref``) and the model-facing dispatcher (``ops``)."""
from .kernel import flash_attention_bhsd
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["flash_attention_bhsd", "flash_attention", "attention_ref"]
