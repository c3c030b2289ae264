"""Chiplet-reuse scheme builders — paper Sec. 5 (Figs. 7-10).

Three schemes:

* SCMS  (Single Chiplet, Multiple Systems)   — Fig. 7(a) / Fig. 8
* OCME  (One Center, Multiple Extensions)    — Fig. 7(b) / Fig. 9
* FSMC  (A Few Sockets, Multiple Collocations) — Fig. 7(c) / Fig. 10

Each builder returns a list of :class:`System` groups ready for
:func:`repro_torch.core.nre_cost.amortized_costs`.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .system import Chip, Module, System, make_chip
from .technology import tech


# ---------------------------------------------------------------------------
# SCMS — one chiplet design, systems of 1x/2x/4x chiplets (Sec. 5.1)
# ---------------------------------------------------------------------------


def scms_systems(module_area_mm2: float = 200.0, process: str = "7nm",
                 counts: Sequence[int] = (1, 2, 4), integration: str = "MCM",
                 quantity: float = 500_000.0,
                 package_reuse: bool = False) -> List[System]:
    """Build the Fig. 8 scenario: one chiplet reused in `counts`-sized systems."""
    m = Module(name=f"scms_mod_{process}", area_mm2=module_area_mm2,
               process=process)
    chiplet = make_chip("scms_chiplet", [m], process, integration=integration)
    max_count = max(counts)
    systems = []
    for k in counts:
        pkg_name = f"scms_pkg_{integration}" if package_reuse else None
        pkg_area = None
        if package_reuse:
            # The shared package is sized for the largest system.
            pkg_area = (chiplet.area_mm2 * max_count
                        * tech(integration).package_area_factor)
        systems.append(System(
            name=f"scms_{k}x_{integration}",
            chips=tuple([chiplet] * k), integration=integration,
            quantity=quantity, package_name=pkg_name,
            package_area_mm2=pkg_area))
    return systems


def scms_soc_equivalents(module_area_mm2: float = 200.0, process: str = "7nm",
                         counts: Sequence[int] = (1, 2, 4),
                         quantity: float = 500_000.0) -> List[System]:
    """Monolithic SoCs with the same module content (the Fig. 8 baseline).

    Per Eq. (7), the SoC flow still reuses *modules*: every SoC die holds k
    copies of the same module design, so module NRE is paid once across the
    group while each die's chip-level NRE is paid per system.
    """
    m = Module(name=f"scms_mod_{process}", area_mm2=module_area_mm2,
               process=process)
    out = []
    for k in counts:
        die = make_chip(f"scms_{k}x_soc_die", [m] * k, process,
                        integration="SoC")
        out.append(System(name=f"scms_{k}x_soc", chips=(die,),
                          integration="SoC", quantity=quantity))
    return out


# ---------------------------------------------------------------------------
# OCME — center die + same-footprint extensions (Sec. 5.2)
# ---------------------------------------------------------------------------


def ocme_systems(socket_area_mm2: float = 160.0, process: str = "7nm",
                 center_process: Optional[str] = None,
                 integration: str = "MCM", quantity: float = 500_000.0,
                 package_reuse: bool = False,
                 n_sockets: int = 4) -> List[System]:
    """Fig. 9: center chip C + extensions X/Y in a 4-socket package.

    Four systems: [C], [C,X], [C,X,Y], [C,X,X,Y].  ``center_process``
    overrides C's node for the heterogeneous variant (e.g. '14nm' —
    'unscalable' IO/analog modules kept on a mature node).
    """
    cp = center_process or process
    c_mod = Module(name=f"ocme_C_mod_{cp}", area_mm2=socket_area_mm2, process=cp)
    x_mod = Module(name=f"ocme_X_mod_{process}", area_mm2=socket_area_mm2, process=process)
    y_mod = Module(name=f"ocme_Y_mod_{process}", area_mm2=socket_area_mm2, process=process)
    C = make_chip("ocme_C", [c_mod], cp, integration=integration)
    X = make_chip("ocme_X", [x_mod], process, integration=integration)
    Y = make_chip("ocme_Y", [y_mod], process, integration=integration)

    combos: List[Tuple[Chip, ...]] = [(C,), (C, X), (C, X, Y), (C, X, X, Y)]
    combos = [c for c in combos if len(c) <= n_sockets]
    pkg_area = None
    pkg_name = None
    if package_reuse:
        pkg_area = (C.area_mm2 * n_sockets
                    * tech(integration).package_area_factor)
        pkg_name = f"ocme_pkg_{integration}"
    out = []
    for chips in combos:
        label = "".join(ch.name[-1] for ch in chips)
        out.append(System(name=f"ocme_{label}_{integration}",
                          chips=chips, integration=integration,
                          quantity=quantity, package_name=pkg_name,
                          package_area_mm2=pkg_area))
    return out


def ocme_soc_equivalents(socket_area_mm2: float = 160.0, process: str = "7nm",
                         quantity: float = 500_000.0) -> List[System]:
    """Monolithic equivalents of the four OCME systems (all on `process`).

    Modules C/X/Y are shared across the group (Eq. 7 module reuse); each
    system still pays its own chip-level NRE.
    """
    c = Module(name=f"ocme_C_mod_{process}", area_mm2=socket_area_mm2, process=process)
    x = Module(name=f"ocme_X_mod_{process}", area_mm2=socket_area_mm2, process=process)
    y = Module(name=f"ocme_Y_mod_{process}", area_mm2=socket_area_mm2, process=process)
    out = []
    for label, mods in (("C", [c]), ("CX", [c, x]), ("CXY", [c, x, y]),
                        ("CXXY", [c, x, x, y])):
        die = make_chip(f"ocme_{label}_soc_die", mods, process,
                        integration="SoC")
        out.append(System(name=f"ocme_{label}_soc", chips=(die,),
                          integration="SoC", quantity=quantity))
    return out


# ---------------------------------------------------------------------------
# FSMC — n chiplet designs, k sockets (Sec. 5.3)
# ---------------------------------------------------------------------------


def fsmc_num_systems(n_chiplets: int, k_sockets: int) -> int:
    """Paper's count: sum_{i=1..k} C(n+i-1, i) (multisets of size 1..k).

    NOTE: the paper quotes "6 chiplets and one 4-socket package -> up to
    119 systems", but the formula gives 209 for (n=6, k=4); 119 matches
    (n=7, k=3).  We implement the formula; the fig10 benchmark flags the
    discrepancy.
    """
    return sum(math.comb(n_chiplets + i - 1, i) for i in range(1, k_sockets + 1))


def fsmc_enumerate(n_chiplets: int = 6, k_sockets: int = 4,
                   chiplet_area_mm2: float = 100.0, process: str = "7nm",
                   integration: str = "MCM", quantity: float = 500_000.0,
                   package_reuse: bool = True,
                   limit: Optional[int] = None) -> List[System]:
    """Enumerate multiset collocations of n chiplets into <=k sockets."""
    chips = []
    for i in range(n_chiplets):
        m = Module(name=f"fsmc_mod{i}_{process}", area_mm2=chiplet_area_mm2,
                   process=process)
        chips.append(make_chip(f"fsmc_chip{i}", [m], process,
                               integration=integration))
    pkg_area = (chips[0].area_mm2 * k_sockets
                * tech(integration).package_area_factor) if package_reuse else None
    systems = []
    for size in range(1, k_sockets + 1):
        for combo in itertools.combinations_with_replacement(range(n_chiplets), size):
            name = "fsmc_" + "".join(str(i) for i in combo)
            systems.append(System(
                name=name, chips=tuple(chips[i] for i in combo),
                integration=integration, quantity=quantity,
                package_name=f"fsmc_pkg_{k_sockets}s" if package_reuse else None,
                package_area_mm2=pkg_area))
            if limit is not None and len(systems) >= limit:
                return systems
    return systems


# ---------------------------------------------------------------------------
# Portfolio reuse — SCMS generalized to per-SKU socket counts
# ---------------------------------------------------------------------------


def portfolio_reuse_systems(slice_area_mm2: float, process: str,
                            integration: str, counts: Sequence[int],
                            quantities: Sequence[float],
                            names: Optional[Sequence[str]] = None,
                            package_reuse: bool = False,
                            chip_name: Optional[str] = None) -> List[System]:
    """One shared chiplet design collocated ``counts[i]`` times per SKU.

    The SCMS scheme (Fig. 8) generalized to a product portfolio: SKU ``i``
    is a package of ``counts[i]`` copies of a single ``slice_area_mm2``
    chiplet on ``process``, produced in ``quantities[i]`` units.  Because
    every system names the same chip design, packing the group with
    ``SystemBatch.from_systems(..., share_nre=True)`` (or one dse group)
    amortizes the chiplet NRE over the whole portfolio volume.
    ``package_reuse`` additionally shares one package design sized for the
    largest SKU (the smaller SKUs pay the oversized package, Sec. 5.1).
    """
    if len(counts) != len(quantities):
        raise ValueError("counts and quantities must have equal length")
    if min(counts) < 1:
        raise ValueError("every SKU needs at least one chiplet")
    if names is None:
        names = [f"sku{i}" for i in range(len(counts))]
    elif len(names) != len(counts):
        raise ValueError("names and counts must have equal length")
    if chip_name is None:
        chip_name = f"reuse_{process}_{integration}_{slice_area_mm2:g}mm2"
    m = Module(name=f"{chip_name}_modules", area_mm2=slice_area_mm2,
               process=process)
    chiplet = make_chip(chip_name, [m], process, integration=integration)
    pkg_name = pkg_area = None
    if package_reuse:
        pkg_name = f"{chip_name}_pkg{max(counts)}s"
        pkg_area = (chiplet.area_mm2 * max(counts)
                    * tech(integration).package_area_factor)
    return [System(name=nm, chips=tuple([chiplet] * k),
                   integration=integration, quantity=float(q),
                   package_name=pkg_name, package_area_mm2=pkg_area)
            for nm, k, q in zip(names, counts, quantities)]


def fsmc_situations(n_chiplets: int = 6, k_sockets: int = 4,
                    n_situations: int = 5, **kw) -> Dict[int, List[System]]:
    """Five situations from low to high reuse: build the first N systems of
    the enumeration for N log-spaced between n_chiplets and the maximum."""
    total = fsmc_num_systems(n_chiplets, k_sockets)
    lo, hi = math.log(n_chiplets), math.log(total)
    sizes = sorted({int(round(math.exp(lo + (hi - lo) * i / (n_situations - 1))))
                    for i in range(n_situations)})
    return {n: fsmc_enumerate(n_chiplets, k_sockets, limit=n, **kw)
            for n in sizes}
