"""qwen3-moe-30b-a3b — 128-expert top-8 MoE.
[hf:Qwen/Qwen3-30B-A3B; hf]  48L d_model=2048 32H (GQA kv=4) d_ff=768(expert)
vocab=151936.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    rope_theta=1_000_000.0, tie_embeddings=False,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=768, impl="ep"),
    subquadratic=False,
)
