"""NRE (non-recurring engineering) cost model — paper Sec. 3.3, Eqs. (6)-(8).

Design entities (modules, chip designs, package designs, D2D interfaces)
are identified by name: an entity appearing in several systems is designed
once and its NRE is amortized over every unit that uses it —

    per-unit share of entity e in system j =
        NRE_e * n_{j,e} / sum_j' quantity_j' * n_{j',e}

This single rule specializes to Eq. (7) (module reuse only: each SoC die is
its own chip design) and Eq. (8) (chiplet reuse: chips shared across
systems), and also covers package reuse (Sec. 5.1/5.2).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Sequence

from .re_cost import REBreakdown, re_cost
from .system import System
from .technology import node


@dataclasses.dataclass
class NREEntities:
    """Group-level NRE, itemized by design entity kind (USD)."""

    modules: Dict[str, float]
    chips: Dict[str, float]      # chip-level only (K_c*S_c + C), Eq. (6)
    packages: Dict[str, float]
    d2d: Dict[str, float]        # per process node

    @property
    def total(self) -> float:
        return (sum(self.modules.values()) + sum(self.chips.values())
                + sum(self.packages.values()) + sum(self.d2d.values()))


def group_nre(systems: Sequence[System]) -> NREEntities:
    """Total NRE of a group of systems with entity de-duplication."""
    modules: Dict[str, float] = {}
    chips: Dict[str, float] = {}
    packages: Dict[str, float] = {}
    d2d: Dict[str, float] = {}

    for s in systems:
        t = s.tech
        # package design NRE: K_p * S_p + C_p
        packages.setdefault(
            s.package_id,
            t.nre_package_per_mm2 * s.package_area + t.nre_fixed_per_package)
        for c in s.chips:
            n = c.node
            for m in c.modules:
                if m.is_d2d:
                    # D2D interface: one design effort per process node.
                    d2d.setdefault(m.process, node(m.process).nre_d2d)
                else:
                    modules.setdefault(m.name, m.node.nre_module_per_mm2 * m.area_mm2)
            # chip-level NRE (physical design + system verification + masks)
            chips.setdefault(c.name, n.nre_chip_per_mm2 * c.area_mm2
                             + n.nre_fixed_per_chip)
    return NREEntities(modules=modules, chips=chips, packages=packages, d2d=d2d)


@dataclasses.dataclass
class UnitCost:
    """Amortized per-unit cost of one system within a group."""

    system: str
    re: REBreakdown
    nre_modules: float
    nre_chips: float
    nre_packages: float
    nre_d2d: float

    @property
    def nre_total(self) -> float:
        return self.nre_modules + self.nre_chips + self.nre_packages + self.nre_d2d

    @property
    def total(self) -> float:
        return self.re.total + self.nre_total

    def as_dict(self) -> Dict[str, float]:
        d = self.re.as_dict()
        d = {f"re_{k}": v for k, v in d.items()}
        d.update(nre_modules=self.nre_modules, nre_chips=self.nre_chips,
                 nre_packages=self.nre_packages, nre_d2d=self.nre_d2d,
                 total=self.total)
        return d


def _uses(systems: Sequence[System]):
    """Count per-system and total uses of every shared design entity."""
    mod_uses = defaultdict(float); chip_uses = defaultdict(float)
    pkg_uses = defaultdict(float); d2d_uses = defaultdict(float)
    per_system: Dict[str, dict] = {}
    for s in systems:
        counts = {"modules": defaultdict(int), "chips": defaultdict(int),
                  "packages": defaultdict(int), "d2d": defaultdict(int)}
        counts["packages"][s.package_id] += 1
        for c in s.chips:
            counts["chips"][c.name] += 1
            for m in c.modules:
                if m.is_d2d:
                    counts["d2d"][m.process] += 1
                else:
                    counts["modules"][m.name] += 1
        per_system[s.name] = counts
        for k, v in counts["modules"].items():
            mod_uses[k] += v * s.quantity
        for k, v in counts["chips"].items():
            chip_uses[k] += v * s.quantity
        for k, v in counts["packages"].items():
            pkg_uses[k] += v * s.quantity
        for k, v in counts["d2d"].items():
            d2d_uses[k] += v * s.quantity
    return per_system, mod_uses, chip_uses, pkg_uses, d2d_uses


def amortized_costs(systems: Sequence[System],
                    flow: str = "chip-last") -> Dict[str, UnitCost]:
    """Per-unit RE + amortized-NRE cost for every system in the group."""
    names = [s.name for s in systems]
    if len(set(names)) != len(names):
        raise ValueError("system names must be unique within a group")
    ent = group_nre(systems)
    per_system, mod_uses, chip_uses, pkg_uses, d2d_uses = _uses(systems)

    out: Dict[str, UnitCost] = {}
    for s in systems:
        cnt = per_system[s.name]
        nre_m = sum(ent.modules[k] * v / mod_uses[k]
                    for k, v in cnt["modules"].items())
        nre_c = sum(ent.chips[k] * v / chip_uses[k]
                    for k, v in cnt["chips"].items())
        nre_p = sum(ent.packages[k] * v / pkg_uses[k]
                    for k, v in cnt["packages"].items())
        nre_d = sum(ent.d2d[k] * v / d2d_uses[k]
                    for k, v in cnt["d2d"].items())
        out[s.name] = UnitCost(system=s.name, re=re_cost(s, flow=flow),
                               nre_modules=nre_m, nre_chips=nre_c,
                               nre_packages=nre_p, nre_d2d=nre_d)
    return out
