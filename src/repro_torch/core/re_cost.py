"""RE (recurring engineering) cost model — paper Sec. 3.2, Eqs. (4)-(5).

The total RE cost of a system is broken into the paper's five itemized
components:

  1. cost of raw chips,
  2. cost of chip defects,
  3. cost of raw packages (substrate + interposer/RDL + bonding + assembly),
  4. cost of package defects,
  5. cost of wasted known-good-dies (KGDs) destroyed by packaging defects.

Bumping / wafer sort / package test are folded into the raw-chip and
raw-package terms (the paper includes but does not itemize them).

Two packaging flows (Eq. 5) are modeled; chip-last is the default, as in
the paper's experiments.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .system import Chip, System
from .technology import IntegrationTech, node
from .yield_model import (dies_per_wafer, raw_die_cost,
                          yield_negative_binomial)


@dataclasses.dataclass
class REBreakdown:
    """Itemized RE cost of one unit of a system (USD)."""

    raw_chips: float
    chip_defects: float
    raw_package: float
    package_defects: float
    wasted_kgd: float

    @property
    def total(self) -> float:
        return (self.raw_chips + self.chip_defects + self.raw_package
                + self.package_defects + self.wasted_kgd)

    @property
    def die_cost(self) -> float:
        """Cost attributable to silicon (what AMD's Fig. 5 compares)."""
        return self.raw_chips + self.chip_defects

    @property
    def packaging_cost(self) -> float:
        """Footnote 2: raw package + package defects + wasted KGDs."""
        return self.raw_package + self.package_defects + self.wasted_kgd

    def as_dict(self) -> Dict[str, float]:
        return {
            "raw_chips": self.raw_chips,
            "chip_defects": self.chip_defects,
            "raw_package": self.raw_package,
            "package_defects": self.package_defects,
            "wasted_kgd": self.wasted_kgd,
            "total": self.total,
        }

    def scaled(self, f: float) -> "REBreakdown":
        return REBreakdown(*(f * x for x in dataclasses.astuple(self)))


# ---------------------------------------------------------------------------
# Per-chip silicon cost
# ---------------------------------------------------------------------------


def chip_costs(chip: Chip) -> Dict[str, float]:
    """Raw die cost, defect overhead and KGD cost for one die."""
    n = chip.node
    area = chip.area_mm2
    raw = float(raw_die_cost(area, n.wafer_cost))
    # sort + bump folded into the raw die (not itemized, per the paper)
    raw += n.wafer_sort_cost / float(dies_per_wafer(area))
    raw += n.bump_cost_per_mm2 * area
    y_die = float(yield_negative_binomial(area, chip.defect_density,
                                          n.cluster_param)) * n.wafer_yield
    kgd = raw / y_die
    return {"raw": raw, "defect": kgd - raw, "kgd": kgd, "yield": y_die}


# ---------------------------------------------------------------------------
# Package-level model
# ---------------------------------------------------------------------------


def _interposer_cost(system: System) -> tuple[float, float]:
    """(raw interposer cost, interposer yield y1) for InFO/2.5D, else (0,1).

    When a package design is reused (``package_area_mm2`` forced), the
    interposer is sized for the *design's* silicon capacity, not for the
    chips actually bonded — Sec. 5.1: reusing a 4x interposer in a 1x
    system pays the full 4x interposer.
    """
    t = system.tech
    if t.interposer_area_factor <= 0.0:
        return 0.0, 1.0
    design_silicon = system.package_area / t.package_area_factor
    area = design_silicon * t.interposer_area_factor
    inode = node(t.interposer_node)
    raw = area * t.interposer_cost_per_mm2
    y1 = float(yield_negative_binomial(area, t.interposer_defect_density,
                                       inode.cluster_param))
    return raw, y1


def _substrate_cost(system: System) -> float:
    t = system.tech
    return (system.package_area * t.substrate_cost_per_mm2
            * t.substrate_layer_factor)


def re_cost(system: System, flow: str = "chip-last") -> REBreakdown:
    """Full Eq. (4)/(5) RE breakdown for one unit of ``system``.

    flow: 'chip-last' (default, paper's choice) or 'chip-first'.
    """
    t: IntegrationTech = system.tech
    n_chips = system.n_chips

    per_chip = [chip_costs(c) for c in system.chips]
    raw_chips = sum(c["raw"] for c in per_chip)
    chip_defects = sum(c["defect"] for c in per_chip)
    kgd_total = sum(c["kgd"] for c in per_chip)

    c_interposer, y1 = _interposer_cost(system)
    c_substrate = _substrate_cost(system)
    c_bond = t.bond_cost_per_chip * n_chips

    y2n = t.y2_chip_bond ** n_chips
    y3 = t.y3_substrate_bond * t.assembly_yield

    if flow == "chip-last":
        # Eq. (4): the interposer/RDL ("package") is fabricated and yielded
        # first, then KGDs are bonded (y2 each), then the assembly is mated
        # to the substrate (y3).
        raw_package = c_interposer + c_substrate + c_bond
        package_defects = (c_interposer * (1.0 / (y1 * y2n * y3) - 1.0)
                           + (c_substrate + c_bond) * (1.0 / y3 - 1.0))
        wasted_kgd = kgd_total * (1.0 / (y2n * y3) - 1.0)
    elif flow == "chip-first":
        # Eq. (5) top: everything rides through the whole flow; KGDs are
        # exposed to interposer-fab losses as well.
        y_all = y1 * y2n * y3
        raw_package = c_interposer + c_substrate + c_bond
        package_defects = raw_package * (1.0 / y_all - 1.0)
        wasted_kgd = kgd_total * (1.0 / y_all - 1.0)
    else:
        raise ValueError(f"unknown flow {flow!r}")

    return REBreakdown(
        raw_chips=raw_chips,
        chip_defects=chip_defects,
        raw_package=raw_package,
        package_defects=package_defects,
        wasted_kgd=wasted_kgd,
    )


# ---------------------------------------------------------------------------
# Deprecated shim — the old homogeneous-even-split kernel.  Its math lives in
# engine.re_split_relaxed (shared primitives with CostEngine), which takes
# the node's real wafer yield.
# ---------------------------------------------------------------------------


def re_cost_split(module_area_mm2, n_chiplets, *, wafer_cost, defect_density,
                  cluster, tech_params, d2d_overhead=None, wafer_yield=0.99,
                  device=None):
    """Deprecated: use :class:`repro_torch.core.engine.CostEngine` on a
    :class:`repro_torch.core.batch.SystemBatch` (heterogeneous, batched),
    or :func:`repro_torch.core.engine.re_split_relaxed` for the
    continuous-n relaxation.

    A thin wrapper of :func:`re_split_relaxed` with the interposer's
    cluster parameter set to ``cluster``; it computes on ``device`` as
    that function does.
    """
    import warnings

    from .engine import re_split_relaxed

    warnings.warn(
        "re_cost_split is deprecated; use CostEngine on a SystemBatch or "
        "engine.re_split_relaxed", DeprecationWarning, stacklevel=2)
    return re_split_relaxed(
        module_area_mm2, n_chiplets, wafer_cost=wafer_cost,
        defect_density=defect_density, cluster=cluster,
        tech_params=tech_params, wafer_yield=wafer_yield,
        interposer_cluster=cluster, d2d_overhead=d2d_overhead,
        device=device)
