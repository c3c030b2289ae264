"""Module / Chip / Package abstraction (paper Sec. 3.1, Eq. (3)).

    m_i in {m_1, ..., m_D2D} = M
    c_i  = Chip({m_i, m_D2D})
    SoC_j = Package(Chip({m_k1, m_k2, ...}))
    MCM_j = Package({c_k1, c_k2, ...})

A :class:`Module` is an indivisible group of functional units; the D2D
interface is a special module automatically attached to every chiplet (its
area is a technology-dependent fraction of the chiplet, Sec. 3.2).  A
:class:`Chip` is a set of modules fabricated on one process node.  A
:class:`System` is a package holding one chip (SoC) or several chiplets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from .technology import IntegrationTech, ProcessNode, node, tech

D2D_MODULE_PREFIX = "__d2d__"


@dataclasses.dataclass(frozen=True)
class Module:
    """An indivisible functional block, tied to a process node."""

    name: str
    area_mm2: float
    process: str  # key into PROCESS_NODES

    @property
    def node(self) -> ProcessNode:
        return node(self.process)

    @property
    def is_d2d(self) -> bool:
        return self.name.startswith(D2D_MODULE_PREFIX)


def d2d_module(process: str, area_mm2: float) -> Module:
    """The D2D interface module for one process node (Sec. 3.1: D2D
    interfaces under different nodes are diverse modules)."""
    return Module(name=f"{D2D_MODULE_PREFIX}{process}", area_mm2=area_mm2,
                  process=process)


@dataclasses.dataclass(frozen=True)
class Chip:
    """A die: a tuple of modules on a single node.

    ``name`` identifies the *design* — two systems containing chips of the
    same name reuse one NRE effort (chiplet reuse).
    """

    name: str
    modules: Tuple[Module, ...]
    process: str
    early_defects: bool = False  # use early-ramp defect density (AMD study)

    def __post_init__(self):
        for m in self.modules:
            if m.process != self.process:
                raise ValueError(
                    f"module {m.name} on {m.process} cannot sit on a "
                    f"{self.process} chip {self.name}")

    @property
    def node(self) -> ProcessNode:
        return node(self.process)

    @property
    def area_mm2(self) -> float:
        return float(sum(m.area_mm2 for m in self.modules))

    @property
    def module_area_mm2(self) -> float:
        """Area of functional (non-D2D) modules."""
        return float(sum(m.area_mm2 for m in self.modules if not m.is_d2d))

    @property
    def defect_density(self) -> float:
        n = self.node
        return n.defect_density_early if self.early_defects else n.defect_density


def make_chip(name: str, modules: Sequence[Module], process: str,
              integration: str = "SoC", early_defects: bool = False,
              d2d_overhead: Optional[float] = None) -> Chip:
    """Build a chip, automatically attaching the D2D module for multi-chip
    integration technologies (Sec. 3.2: D2D takes a fixed share of the chip
    area, 10% in the paper's EPYC-calibrated experiments)."""
    t = tech(integration)
    overhead = t.d2d_area_overhead if d2d_overhead is None else d2d_overhead
    mods = tuple(modules)
    if overhead > 0.0:
        func_area = sum(m.area_mm2 for m in mods)
        # D2D occupies `overhead` fraction of the final chip area:
        # d2d = overhead/(1-overhead) * functional area.
        d2d_area = func_area * overhead / (1.0 - overhead)
        mods = mods + (d2d_module(process, d2d_area),)
    return Chip(name=name, modules=mods, process=process,
                early_defects=early_defects)


@dataclasses.dataclass(frozen=True)
class System:
    """One product: a package with chips inside, made in some quantity."""

    name: str
    chips: Tuple[Chip, ...]
    integration: str            # key into INTEGRATION_TECHS
    quantity: float = 1.0       # production quantity (for NRE amortization)
    package_name: Optional[str] = None  # shared name => package reuse
    package_area_mm2: Optional[float] = None  # forced area (package reuse)

    @property
    def tech(self) -> IntegrationTech:
        return tech(self.integration)

    @property
    def silicon_area_mm2(self) -> float:
        return float(sum(c.area_mm2 for c in self.chips))

    @property
    def package_area(self) -> float:
        if self.package_area_mm2 is not None:
            return self.package_area_mm2
        return self.silicon_area_mm2 * self.tech.package_area_factor

    @property
    def package_id(self) -> str:
        """Identity of the package *design* for NRE sharing."""
        return self.package_name or f"pkg:{self.name}"

    @property
    def n_chips(self) -> int:
        return len(self.chips)


# ---------------------------------------------------------------------------
# Declarative spec builder — the canonical constructor behind the public API.
# ---------------------------------------------------------------------------


def spec(d: Dict) -> System:
    """Build a :class:`System` from a declarative dict.

    Three shapes are accepted (``kind`` is inferred when omitted):

    * ``{"kind": "soc", "name": ..., "area": mm2, "process": node,
       "quantity": q, "early": bool}`` — monolithic SoC.
    * ``{"kind": "split", "name": ..., "area": mm2, "process": node,
       "n": k, "integration": tech, "fractions": [...], "processes": [...],
       "quantity": q, "early": bool, "d2d_overhead": f,
       "reuse_chiplet": bool}`` — `area` partitioned into chiplets.
       ``fractions`` (normalized internally) makes the slices unequal and
       ``processes`` gives each slice its own node — heterogeneous splits.
    * ``{"kind": "chips", "name": ..., "chips": [{"name":..., "area": mm2,
       "process": node, "early": bool, "d2d_overhead": f}, ...],
       "integration": tech, "quantity": q, "package_name": ...,
       "package_area": mm2}`` — fully general heterogeneous system.

    This is what :func:`soc_system` / :func:`split_system` now wrap, and
    what ``SystemBatch.from_specs`` consumes.
    """
    d = dict(d)
    kind = d.pop("kind", None)
    if kind is None:
        if "chips" in d:
            kind = "chips"
        elif "n" in d or "fractions" in d or "processes" in d:
            kind = "split"
        else:
            kind = "soc"

    name = d.pop("name", "sys")
    quantity = float(d.pop("quantity", 1.0))
    early = bool(d.pop("early", d.pop("early_defects", False)))

    if kind == "soc":
        area = _required_area(kind, d)
        process = d.pop("process")
        node(process)   # fail at spec time, not at batch-pack time
        _reject_extra(kind, d)
        m = Module(name=f"{name}_modules", area_mm2=area, process=process)
        chip = make_chip(f"{name}_die", [m], process, integration="SoC",
                         early_defects=early)
        return System(name=name, chips=(chip,), integration="SoC",
                      quantity=quantity)

    if kind == "split":
        area = _required_area(kind, d)
        process = d.pop("process", None)
        integration = d.pop("integration")
        fractions = d.pop("fractions", None)
        processes = d.pop("processes", None)
        n = int(d.pop("n", d.pop("n_chiplets",
                                 len(fractions) if fractions is not None
                                 else len(processes) if processes else 0)))
        d2d_overhead = d.pop("d2d_overhead", None)
        reuse_chiplet = bool(d.pop("reuse_chiplet", False))
        _reject_extra(kind, d)
        if n <= 0:
            raise ValueError("split spec needs n >= 1 (or fractions/processes)")
        if fractions is None:
            fractions = [1.0 / n] * n
        if len(fractions) != n:
            raise ValueError(f"{len(fractions)} fractions for n={n} chiplets")
        total_f = float(sum(fractions))
        fractions = [f / total_f for f in fractions]
        if processes is None:
            processes = [process] * n
        if len(processes) != n or any(p is None for p in processes):
            raise ValueError("need a process for every chiplet")
        for p in processes:
            node(p)     # fail at spec time, not at batch-pack time
        if reuse_chiplet and (len(set(processes)) > 1
                              or max(fractions) - min(fractions) > 1e-12):
            raise ValueError("reuse_chiplet requires identical slices")
        chips = []
        for i, (f, p) in enumerate(zip(fractions, processes)):
            cname = f"{name}_slice" if reuse_chiplet else f"{name}_slice{i}"
            m = Module(name=f"{cname}_modules", area_mm2=area * f, process=p)
            chips.append(make_chip(cname, [m], p, integration=integration,
                                   early_defects=early,
                                   d2d_overhead=d2d_overhead))
        return System(name=name, chips=tuple(chips), integration=integration,
                      quantity=quantity)

    if kind == "chips":
        chip_specs = d.pop("chips")
        integration = d.pop("integration")
        package_name = d.pop("package_name", None)
        package_area = d.pop("package_area", d.pop("package_area_mm2", None))
        _reject_extra(kind, d)
        chips = []
        for i, c in enumerate(chip_specs):
            if isinstance(c, Chip):
                chips.append(c)
                continue
            c = dict(c)
            cname = c.pop("name", f"{name}_chip{i}")
            carea = _required_area("chip", c)
            cproc = c.pop("process")
            node(cproc)     # fail at spec time, not at batch-pack time
            cearly = bool(c.pop("early", c.pop("early_defects", early)))
            covh = c.pop("d2d_overhead", None)
            _reject_extra("chip", c)
            m = Module(name=f"{cname}_modules", area_mm2=carea, process=cproc)
            chips.append(make_chip(cname, [m], cproc, integration=integration,
                                   early_defects=cearly, d2d_overhead=covh))
        return System(name=name, chips=tuple(chips), integration=integration,
                      quantity=quantity, package_name=package_name,
                      package_area_mm2=package_area)

    raise ValueError(f"unknown spec kind {kind!r}")


def _reject_extra(kind: str, leftover: Dict):
    if leftover:
        raise ValueError(f"unknown keys in {kind!r} spec: {sorted(leftover)}")


def _required_area(kind: str, d: Dict) -> float:
    area = d.pop("area", d.pop("area_mm2", d.pop("module_area_mm2", None)))
    if area is None:
        raise ValueError(f"{kind!r} spec needs an 'area' (mm^2)")
    return float(area)


def soc_system(name: str, module_area_mm2: float, process: str,
               quantity: float = 1.0, early_defects: bool = False) -> System:
    """Monolithic SoC holding `module_area` worth of modules on one die.

    Thin wrapper over :func:`spec`.
    """
    return spec({"kind": "soc", "name": name, "area": module_area_mm2,
                 "process": process, "quantity": quantity,
                 "early": early_defects})


def split_system(name: str, module_area_mm2: float, process: str,
                 n_chiplets: int, integration: str, quantity: float = 1.0,
                 early_defects: bool = False,
                 d2d_overhead: Optional[float] = None,
                 reuse_chiplet: bool = False) -> System:
    """Partition `module_area` evenly into n chiplets (Fig. 4 experiments).

    ``reuse_chiplet=True`` gives every chiplet the same design name so NRE
    is paid once (homogeneous split); otherwise each slice is its own design
    (the paper's Fig. 4/6 'no reuse' assumption).  Thin wrapper over
    :func:`spec`; pass ``fractions``/``processes`` there for heterogeneous
    splits.
    """
    return spec({"kind": "split", "name": name, "area": module_area_mm2,
                 "process": process, "n": n_chiplets,
                 "integration": integration, "quantity": quantity,
                 "early": early_defects, "d2d_overhead": d2d_overhead,
                 "reuse_chiplet": reuse_chiplet})
