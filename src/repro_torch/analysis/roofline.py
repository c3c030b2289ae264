"""Three-term roofline from the dry run's counted step, after
``repro/analysis/roofline.py``.

  compute term    = HLO_FLOPs_per_device / peak_FLOP/s
  memory term     = HBM_bytes_per_device / HBM_bw
  collective term = collective_bytes_per_device / link_bw

(The counter reports per-device numbers, so no further division by chip
count is needed; multiplying back by `chips` gives the global figures
the brief's formulas express.)

Hardware constants: TPU v5e-class per the brief (kept for parity with the
JAX package's keys), and the H100 SXM's from NVIDIA's data sheet (dense
bf16 and fp32 peaks, HBM3 rate, NVLink rate one direction, 80 GB), not
measured.  A roofline is ``roofline_from_report(..., hw=H100)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .hlo import HLOCostReport


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "tpu-v5e-class"
    peak_flops_bf16: float = 197e12      # FLOP/s per chip
    hbm_bw: float = 819e9                # B/s per chip
    ici_bw_per_link: float = 50e9        # B/s per link
    ici_links: int = 4                   # usable links per chip (2D torus)
    hbm_gb: float = 16.0
    peak_flops_fp32: float = 0.0         # FLOP/s per chip, 0 = not listed


HW = Hardware()

H100 = Hardware(name="h100-sxm", peak_flops_bf16=989e12, hbm_bw=3.35e12,
                ici_bw_per_link=450e9, ici_links=1, hbm_gb=80.0,
                peak_flops_fp32=67e12)


@dataclasses.dataclass
class RooflineTerms:
    t_compute: float
    t_memory: float              # Pallas-kernel path (flash tiles in VMEM)
    t_collective: float
    flops: float                 # per device
    hbm_bytes: float             # per device (kernel path)
    collective_bytes: float      # per device
    model_flops: float = 0.0     # global useful FLOPs (6ND-style)
    chips: int = 1
    t_memory_xla_path: float = 0.0   # score tiles materialized to HBM
    hw: Hardware = HW
    peak_flops: float = HW.peak_flops_bf16   # the peak t_compute uses

    @property
    def bound(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of peak at the bound step time.

        MODEL_FLOPS/(chips · peak · t_bound): the MFU-style score the
        perf loop is hill-climbing.
        """
        if self.t_bound <= 0:
            return 0.0
        return (self.model_flops / self.chips / self.peak_flops
                / self.t_bound)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global HLO FLOPs (remat/redundancy waste)."""
        total = self.flops * self.chips
        return self.model_flops / total if total > 0 else 0.0

    def as_dict(self) -> Dict:
        return {
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bound": self.bound,
            "t_bound": self.t_bound, "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "model_flops": self.model_flops, "chips": self.chips,
            "roofline_fraction": self.roofline_fraction,
            "useful_flops_ratio": self.useful_flops_ratio,
            "t_memory_xla_path": self.t_memory_xla_path,
            "hardware": self.hw.name, "peak_flops": self.peak_flops,
        }


def roofline_from_report(report: HLOCostReport, *, chips: int,
                         model_flops: float = 0.0,
                         hw: Hardware = HW,
                         dtype: str = "bfloat16") -> RooflineTerms:
    """The three terms at ``hw``'s HBM rate, link rate (``ici_bw_per_link``
    x ``ici_links``) and bf16 peak, or its fp32 peak for a ``"float32"``
    step where the data sheet lists one."""
    ici_bw = hw.ici_bw_per_link * hw.ici_links
    peak = hw.peak_flops_fp32 if dtype == "float32" and hw.peak_flops_fp32 \
        else hw.peak_flops_bf16
    return RooflineTerms(
        t_compute=report.flops / peak,
        t_memory=report.hbm_bytes_kernel_path / hw.hbm_bw,
        t_collective=report.total_collective_bytes / ici_bw,
        flops=report.flops,
        hbm_bytes=report.hbm_bytes_kernel_path,
        collective_bytes=report.total_collective_bytes,
        model_flops=model_flops,
        chips=chips,
        t_memory_xla_path=report.hbm_bytes / hw.hbm_bw,
        hw=hw,
        peak_flops=peak,
    )


# ---------------------------------------------------------------------------
# MODEL_FLOPS (6ND-style useful flops) per (arch x shape)
# ---------------------------------------------------------------------------


def active_params(cfg) -> float:
    """Active parameters per token (MoE counts shared + top-k experts)."""
    from ..models import api
    from ..models.common import count_params

    spec = api.param_spec(cfg)
    if cfg.family != "moe":
        return float(count_params(spec))
    # replace the full expert count by (shared + top_k) experts
    total = float(count_params(spec))
    expert_params = 3 * cfg.d_model * cfg.d_ff_expert
    moe_layers = cfg.n_layers - cfg.first_dense
    routed_all = moe_layers * cfg.n_experts * expert_params
    routed_active = moe_layers * cfg.top_k * expert_params
    return total - routed_all + routed_active


def model_flops(cfg, shape) -> float:
    """Useful FLOPs of one step: 6·N_active·D (train) / 2·N_active·D (fwd).

    decode shapes process global_batch tokens; prefill/train process
    global_batch·seq tokens.  Attention FLOPs beyond the 6ND rule are
    intentionally excluded (the brief's definition).
    """
    n_act = active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.family == "encdec":
            tokens = shape.global_batch * (shape.seq_len + cfg.dec_len)
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens
    # decode: one token per sequence
    return 2.0 * n_act * shape.global_batch
