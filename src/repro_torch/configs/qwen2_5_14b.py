"""qwen2.5-14b — dense GQA with QKV bias.
[hf:Qwen/Qwen2.5-14B; hf]  48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064, head_dim=128,
    rope_theta=1_000_000.0, qkv_bias=True, tie_embeddings=False,
    subquadratic=False,
)
