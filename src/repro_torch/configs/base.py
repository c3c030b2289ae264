"""Architecture configuration schema and registry for the PyTorch port.

A field-for-field copy of ``repro/configs/base.py`` (the JAX package's
config modules import ``jax.numpy`` for one property, so the port keeps
its own copy).  Two differences:

* ``torch_dtype`` gives the activation dtype as a ``torch.dtype``;
* ``attn_impl`` takes ``"full" | "chunked" | "kernel"``, where
  ``"kernel"`` is the port's name for the JAX package's ``"pallas"``:
  prefill attention through the hand-written flash-attention kernel.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 => d_model // n_heads
    attn: str = "gqa"            # gqa | mla
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # --- MLA ---
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_expert: int = 0
    first_dense: int = 0
    capacity_factor: float = 1.25
    # --- hybrid (Mamba2 + shared attention) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0
    n_shared_attn: int = 2
    # --- xLSTM ---
    slstm_every: int = 0
    # --- encoder-decoder ---
    n_dec_layers: int = 0
    dec_len: int = 448
    # --- VLM ---
    n_img_patches: int = 0
    # --- execution ---
    subquadratic: bool = False
    accum: int = 1
    remat: str = "full"
    act_shard: str = "seq"
    attn_chunk: int = 1024
    ssm_chunk: int = 128
    attn_impl: str = "chunked"   # chunked | full | kernel
    scan_layers: bool = True

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256, as in the JAX package (pad logits
        are masked)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.dtype]

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU tests (same as the JAX one)."""
        kw = dict(
            n_layers=min(self.n_layers, 4), d_model=128,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 2) or 1,
            d_ff=256 if self.d_ff else 0, vocab=512, head_dim=32,
            dtype="float32", attn_chunk=64, ssm_chunk=16,
        )
        if self.attn == "mla":
            kw.update(q_lora=64 if self.q_lora else 0, kv_lora=32,
                      qk_nope=16, qk_rope=16, v_head=32, head_dim=32)
        if self.family == "moe":
            kw.update(n_experts=8, top_k=2, n_shared=min(self.n_shared, 1),
                      d_ff_expert=64, first_dense=min(self.first_dense, 1))
        if self.family == "hybrid":
            kw.update(n_layers=7, ssm_state=16, ssm_headdim=16,
                      attn_every=3, n_shared_attn=2, n_kv_heads=4)
        if self.family == "ssm":
            kw.update(n_layers=4, slstm_every=4)
        if self.family == "encdec":
            kw.update(n_layers=2, n_dec_layers=2, dec_len=16)
        if self.family == "vlm":
            kw.update(n_img_patches=8)
        return self.replace(name=self.name + "-smoke", **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "llava_next_mistral_7b", "minicpm3_4b", "glm4_9b", "mistral_large_123b",
    "deepseek_7b", "deepseek_moe_16b", "deepseek_v2_236b", "whisper_medium",
    "zamba2_7b", "xlstm_125m",
]


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_')}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def cell_supported(cfg: ArchConfig, shape: InputShape) -> Tuple[bool, str]:
    """Is (arch x shape) a runnable dry-run cell? (brief's skip rules)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode is quadratic-cost; skipped per brief"
    return True, ""
