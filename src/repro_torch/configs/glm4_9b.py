"""GLM-4-9B — RoPE + extreme GQA (kv=2). [hf:THUDM/glm-4-9b; hf]

40L, d_model 4096, 32 heads (kv=2), d_ff 13696, vocab 151552.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=151552, rope_theta=1e4,
    subquadratic=False,
)
