"""minicpm-2b — llama-like dense; trained with the WSD schedule (which our
optim/schedules.py implements as the default for this arch).
[arXiv:2404.06395; hf]  40L d_model=2304 36H (kv=36, i.e. MHA) d_ff=5760
vocab=122753.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753, head_dim=64,
    tie_embeddings=True,
    subquadratic=False,
    # §Perf hillclimb: MHA (kv=36) at 32k context needs int8 KV to fit
    # 16 GB/chip (22.0 -> 11.0 GB measured); logit error < 5e-3.
    kv_quant=True,
)
