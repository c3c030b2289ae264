"""LLaVA-NeXT (Mistral-7B backbone) — anyres tiling, stub vision tower.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
Backbone = Mistral-7B: 32L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336,
vocab 32000.  ``input_specs`` provides precomputed anyres patch embeddings
(the vision tower + projector are the stub frontend per the brief).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, rope_theta=1e6,
    n_img_patches=2880,     # 5 anyres tiles x 576 patches (24x24 @ CLIP-L)
    subquadratic=False,
)
