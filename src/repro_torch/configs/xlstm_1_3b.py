"""xlstm-1.3b — sLSTM + mLSTM blocks (xLSTM[7:1]); d_ff=0: the up-projection
lives inside the mLSTM/sLSTM blocks.
[arXiv:2405.04517; unverified]  48L d_model=2048 4H vocab=50304.
"""
from .base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=512,
    xlstm=XLSTMConfig(slstm_every=8, mlstm_expand=2, conv_kernel=4, chunk=256),
    tie_embeddings=True,
    subquadratic=True,            # recurrent state: O(1) per decode step
)
