"""smollm-135m — llama-architecture small model.
[hf:HuggingFaceTB/SmolLM-135M; hf]  30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m", family="dense",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    d_ff=1536, vocab_size=49152, head_dim=64,
    tie_embeddings=True,
    subquadratic=False,
    # §Perf iteration F: at 135M params a 16-way TP slice is ~2 MB per
    # matrix — all-gather latency dominates.  Pure DP replicates the model
    # per chip and leaves only the gradient all-reduce.
    tp_degree=1,
)
