"""hymba-1.5b — hybrid: parallel attention + Mamba heads in every block.
[arXiv:2411.13676; hf]  32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16.
"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm=SSMConfig(state_dim=16, conv_kernel=4, expand=2, chunk=256),
    sliding_window=1024,          # hymba: most layers use SWA + meta tokens
    tie_embeddings=True,
    subquadratic=True,            # SSM path carries long-range state
)
