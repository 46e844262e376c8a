"""granite-moe-3b-a800m — 40-expert top-8 MoE.
[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]  32L d_model=1536 24H (kv=8)
d_ff=512(expert) vocab=49155.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=40, top_k=8, d_expert=512, impl="ep"),
    subquadratic=False,
)
