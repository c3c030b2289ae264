"""Whisper-medium backbone — enc-dec, conv frontend STUB.
[arXiv:2212.04356; unverified]

24 encoder + 24 decoder layers, d_model 1024, 16 heads, d_ff 4096,
vocab 51865.  The assigned seq_len is ENCODER frames (precomputed frame
embeddings from the stub frontend); decoder capped at 448 tokens.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_dec_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, dec_len=448,
    subquadratic=False,
)
