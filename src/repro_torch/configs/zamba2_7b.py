"""Zamba2-7B — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]

81 Mamba2 layers, d_model 3584, ssm_state 64; a shared transformer block
(32 heads GQA kv=32, d_ff 14336) applied every 6 layers, alternating
between 2 shared weight sets (Zamba2's weight-shared attention).
Sub-quadratic: runs long_500k.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, ssm_state=64, ssm_headdim=64, ssm_expand=2,
    attn_every=6, n_shared_attn=2,
    subquadratic=True,
    # perf (EXPERIMENTS §Perf iter 5): SSD decay-tile traffic scales with
    # S*L -> chunk 64 halves it; accum=2 halves activation residency.
    ssm_chunk=64, accum=2,
)
