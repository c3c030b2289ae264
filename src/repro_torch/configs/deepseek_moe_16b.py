"""DeepSeekMoE-16B — fine-grained MoE. [arXiv:2401.06066; hf]

28L, d_model 2048, 16 heads (MHA), vocab 102400.  FFN: 2 shared experts +
64 routed experts (top-6), expert d_ff 1408; first layer dense (d_ff
10944 per HF config).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
    vocab=102400,
    n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408, first_dense=1,
    subquadratic=False,
)
