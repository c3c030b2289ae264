"""DeepSeek-V2-236B — MLA + fine-grained MoE. [arXiv:2405.04434; hf]

60L, d_model 5120, 128 heads, vocab 102400.  MLA: q_lora 1536, kv_lora
512, qk_nope 128, qk_rope 64, v_head 128.  FFN: 2 shared + 160 routed
top-6 experts, expert d_ff 1536; first layer dense (d_ff 12288).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe", attn="mla",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_ff=12288,
    vocab=102400, head_dim=128,
    q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128,
    n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536, first_dense=1,
    accum=4,
    subquadratic=False,
)
