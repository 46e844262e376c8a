"""gemma2-2b — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]  26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4,
    d_ff=9216, vocab_size=256_000, head_dim=256,
    logit_softcap=30.0, attn_softcap=50.0,
    sliding_window=4096, local_global_pattern=True, post_norms=True,
    tie_embeddings=True,
    subquadratic=False,   # global layers are full attention -> skip long_500k
)
