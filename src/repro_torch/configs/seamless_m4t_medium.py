"""seamless-m4t-medium — encoder-decoder, multimodal (audio frontend stub).
[arXiv:2308.11596; hf]  12L(enc)+12L(dec) d_model=1024 16H d_ff=4096
vocab=256206.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    encoder_layers=12,
    frontend_tokens=512,          # speech frame embeddings from the stub
    tie_embeddings=True,
    subquadratic=False,
)
