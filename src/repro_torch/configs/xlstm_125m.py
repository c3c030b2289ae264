"""xLSTM-125M — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

12 blocks, d_model 768, 4 heads, vocab 50304, d_ff 0 (mixer-only blocks).
One sLSTM per 4 blocks (rest mLSTM), xLSTM[3:1]-style.  Sub-quadratic:
runs long_500k with O(1)/token matrix-memory decode.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, slstm_every=4,
    subquadratic=True,
)
