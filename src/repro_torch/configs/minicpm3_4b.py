"""MiniCPM3-4B — Multi-head Latent Attention. [hf:openbmb/MiniCPM3-4B; hf]

62L, d_model 2560, 40 heads, d_ff 6400, vocab 73448.  MLA: q_lora 768,
kv_lora 256, qk_nope 64, qk_rope 32, v_head 64 (per HF config.json).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense", attn="mla",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab=73448, head_dim=64,
    q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64,
    subquadratic=False,
)
