"""internvl2-1b — InternViT frontend (stub) + InternLM2 backbone.
[arXiv:2404.16821; hf]  24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64,
    rope_theta=1_000_000.0, tie_embeddings=True,
    frontend_tokens=256,          # ViT patch embeddings provided by stub
    subquadratic=False,
)
