"""Mistral-Large-123B. [hf:mistralai/Mistral-Large-Instruct-2407; unverified]

88L, d_model 12288, 96 heads (GQA kv=8), d_ff 28672, vocab 32768.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=28672,
    vocab=32768, rope_theta=1e6, accum=2,
    subquadratic=False,
)
