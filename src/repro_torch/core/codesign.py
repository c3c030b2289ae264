"""Accelerator co-design bridge (beyond-paper extension).

The paper's decision method, applied to the accelerators this framework
trains on: price TPU-class accelerator packages (monolithic vs chiplet)
with the faithful Chiplet Actuary model, then combine with the multi-pod
dry-run's roofline terms to get cost-per-step / perf-per-dollar for every
assigned architecture.

An accelerator die is modeled as compute area + SRAM/uncore area + HBM-PHY
area (PHY/analog does not scale well -> candidate for a mature-node center
die, the paper's OCME insight).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .batch import SystemBatch
from .engine import CostEngine
from .system import Module, System, make_chip

_ENGINE = CostEngine()

# TPU v5e-class peak per chip, the JAX package's hardware constants.
PEAK_FLOPS_BF16 = 197e12       # FLOP/s
HBM_BW = 819e9                 # B/s
ICI_BW_PER_LINK = 50e9         # B/s


@dataclasses.dataclass(frozen=True)
class AcceleratorSpec:
    """Silicon contents of one accelerator package (areas in mm^2)."""

    name: str
    compute_area: float = 300.0     # MXU/VPU arrays + SRAM
    uncore_area: float = 60.0       # NoC, scheduler, scalar cores
    phy_area: float = 80.0          # HBM + ICI PHYs ('unscalable' analog)
    process: str = "5nm"
    phy_process: Optional[str] = None  # heterogeneous variant
    peak_flops: float = PEAK_FLOPS_BF16


def accelerator_systems(spec: AcceleratorSpec, quantity: float = 1e6
                        ) -> Dict[str, System]:
    """Candidate packagings of one accelerator: monolithic SoC, 2-chiplet
    MCM (compute split), 2.5D compute+IO split (OCME-style), heterogeneous
    2.5D with the PHY die on a mature node."""
    p = spec.process
    pp = spec.phy_process or p
    total = spec.compute_area + spec.uncore_area + spec.phy_area

    def mod(nm, area, proc):
        return Module(name=f"{spec.name}_{nm}_{proc}", area_mm2=area, process=proc)

    out: Dict[str, System] = {}
    # Monolithic SoC (PHY forced onto the advanced node).
    soc_die = make_chip(f"{spec.name}_soc", [mod("all", total, p)], p,
                        integration="SoC")
    out["SoC"] = System(f"{spec.name}_SoC", (soc_die,), "SoC", quantity)

    # Homogeneous 2-chiplet MCM: compute sliced in half, uncore+phy on each.
    half = total / 2.0
    c = make_chip(f"{spec.name}_half", [mod("half", half, p)], p,
                  integration="MCM")
    out["MCM-2x"] = System(f"{spec.name}_MCM2", (c, c), "MCM", quantity)

    # 2.5D compute-die + IO-die split (same node).
    cd = make_chip(f"{spec.name}_compute", [mod("compute", spec.compute_area, p)],
                   p, integration="2.5D")
    io = make_chip(f"{spec.name}_io",
                   [mod("io", spec.uncore_area + spec.phy_area, p)], p,
                   integration="2.5D")
    out["2.5D-CIO"] = System(f"{spec.name}_25D", (cd, io), "2.5D", quantity)

    # Heterogeneous: PHY/uncore die on the mature node (OCME insight).
    io_h = make_chip(f"{spec.name}_io_{pp}",
                     [mod("io", spec.uncore_area + spec.phy_area, pp)], pp,
                     integration="2.5D")
    out["2.5D-hetero"] = System(f"{spec.name}_25Dh", (cd, io_h), "2.5D", quantity)
    return out


def price_accelerators(spec: AcceleratorSpec, quantity: float = 1e6,
                       device=None) -> Dict[str, Dict[str, float]]:
    """Amortized unit cost of every packaging candidate of one accelerator.

    All candidates are priced in one :class:`CostEngine` call on
    ``device`` (the GPU unless the caller names another), with one copy
    of the results to the host; ``share_nre=False`` keeps each candidate
    its own product group (the candidates are alternatives, not
    co-produced systems).
    """
    candidates = accelerator_systems(spec, quantity)
    batch = SystemBatch.from_systems(list(candidates.values()),
                                     share_nre=False, device=device)
    tc = _ENGINE.total(batch)
    total, re, nre, die, pkg = torch.stack(
        [tc.total, tc.re.total, tc.nre.total, tc.re.die_cost,
         tc.re.packaging_cost]).cpu().tolist()
    out: Dict[str, Dict[str, float]] = {}
    for i, label in enumerate(candidates):
        out[label] = {
            "unit_cost": total[i],
            "re": re[i],
            "nre_per_unit": nre[i],
            "die_cost": die[i],
            "packaging_cost": pkg[i],
            "usd_per_pflops": total[i] / (spec.peak_flops / 1e15),
        }
    return out


def cost_per_step(roofline_cell: Dict, chip_unit_cost: float,
                  n_chips: int,
                  lifetime_seconds: float = 3 * 365 * 86400.0
                  ) -> Dict[str, float]:
    """Price one training/serving step of a dry-run cell.

    ``roofline_cell`` must carry ``t_compute/t_memory/t_collective``
    seconds (from benchmarks.roofline); step time is their max
    (perfect-overlap lower bound).  Silicon cost is amortized over the
    fleet's useful life in *seconds*, so a slower step on the same
    fleet costs proportionally more — the quantity the partitioning /
    packaging decision actually trades against (paper Sec. 4.2's
    amortization logic applied to accelerator time instead of units).
    """
    t_step = max(roofline_cell["t_compute"], roofline_cell["t_memory"],
                 roofline_cell["t_collective"])
    fleet = chip_unit_cost * n_chips
    usd_per_step = fleet * t_step / lifetime_seconds
    return {
        "t_step_bound_s": t_step,
        "fleet_cost_usd": fleet,
        "usd_per_step": usd_per_step,
        "usd_per_exaflop": usd_per_step
        / max(roofline_cell.get("hlo_flops", 1.0), 1.0) * 1e18,
    }
