"""Technology database for the Chiplet Actuary cost model.

Every number the model consumes lives here, with provenance:

* wafer prices           -- CSET "AI Chips: What They Are and Why They Matter"
                            (Khan & Mann 2020), paper reference [3].
* defect densities       -- TSMC public statements via AnandTech (paper ref [2]);
                            the paper's AMD validation explicitly uses the
                            "early ramp" values 0.13 (7nm) / 0.12 (12nm).
* packaging parameters   -- calibrated so the model reproduces the paper's
                            stated results (Figs. 4-10); the paper's own
                            in-house/IC-Knowledge numbers are not public.
* NRE parameters         -- magnitudes anchored on IBS/CSET design-cost
                            estimates (~$540M full 5nm design, ~$300M 7nm),
                            split into module/chip/fixed shares and
                            calibrated to the paper's Fig. 6 ratios.

Units: areas mm^2, defect density defects/cm^2, money in USD.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# --------------------------------------------------------------------------
# Process nodes
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProcessNode:
    """Parameters of one silicon process node."""

    name: str
    wafer_cost: float          # USD per 300 mm wafer (processed)  [CSET]
    defect_density: float      # defects / cm^2 (mature)           [TSMC/AnandTech]
    defect_density_early: float  # defects / cm^2 (early ramp)     [TSMC/AnandTech]
    cluster_param: float       # c in Eq.(1) (negative binomial)
    # ---- NRE (USD) ----
    nre_module_per_mm2: float  # K_m: module RTL + block verification
    nre_chip_per_mm2: float    # K_c: physical design + system verification
    nre_fixed_per_chip: float  # C : full mask set, IP licensing, tapeout
    nre_d2d: float             # one-time D2D interface design for this node
    # ---- misc RE ----
    wafer_yield: float = 0.99  # Y_wafer in Eq.(2)
    wafer_sort_cost: float = 500.0   # USD per wafer (probe/sort; folded, not itemized)
    bump_cost_per_mm2: float = 0.005  # C4 bumping, per die mm^2


# 300 mm wafer prices from CSET (Khan & Mann 2020), Table "wafer price".
# Mature defect densities ~0.05-0.10 def/cm^2; early values per AnandTech.
PROCESS_NODES: Dict[str, ProcessNode] = {
    "5nm": ProcessNode(
        name="5nm", wafer_cost=16988.0,
        defect_density=0.11, defect_density_early=0.13, cluster_param=3.0,
        nre_module_per_mm2=0.34e6, nre_chip_per_mm2=0.30e6,
        nre_fixed_per_chip=55.0e6, nre_d2d=15.0e6,
    ),
    "7nm": ProcessNode(
        name="7nm", wafer_cost=9346.0,
        defect_density=0.09, defect_density_early=0.13, cluster_param=3.0,
        nre_module_per_mm2=0.19e6, nre_chip_per_mm2=0.15e6,
        nre_fixed_per_chip=15.0e6, nre_d2d=8.0e6,
    ),
    "10nm": ProcessNode(
        name="10nm", wafer_cost=5992.0,
        defect_density=0.10, defect_density_early=0.13, cluster_param=3.0,
        nre_module_per_mm2=0.12e6, nre_chip_per_mm2=0.10e6,
        nre_fixed_per_chip=10.0e6, nre_d2d=6.0e6,
    ),
    "12nm": ProcessNode(
        name="12nm", wafer_cost=3984.0,
        defect_density=0.09, defect_density_early=0.12, cluster_param=3.0,
        nre_module_per_mm2=0.06e6, nre_chip_per_mm2=0.05e6,
        nre_fixed_per_chip=6.0e6, nre_d2d=5.0e6,
    ),
    "14nm": ProcessNode(
        name="14nm", wafer_cost=3984.0,
        defect_density=0.08, defect_density_early=0.12, cluster_param=3.0,
        nre_module_per_mm2=0.05e6, nre_chip_per_mm2=0.04e6,
        nre_fixed_per_chip=5.0e6, nre_d2d=5.0e6,
    ),
    "28nm": ProcessNode(
        name="28nm", wafer_cost=2891.0,
        defect_density=0.06, defect_density_early=0.09, cluster_param=3.0,
        nre_module_per_mm2=0.02e6, nre_chip_per_mm2=0.015e6,
        nre_fixed_per_chip=2.0e6, nre_d2d=3.0e6,
    ),
    # 65 nm exists mostly as the silicon-interposer process.
    "65nm": ProcessNode(
        name="65nm", wafer_cost=1937.0,
        defect_density=0.04, defect_density_early=0.06, cluster_param=3.0,
        nre_module_per_mm2=0.005e6, nre_chip_per_mm2=0.004e6,
        nre_fixed_per_chip=0.5e6, nre_d2d=1.0e6,
    ),
}

# --------------------------------------------------------------------------
# Integration technologies (packaging)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IntegrationTech:
    """Parameters of one integration/packaging technology.

    The paper's three multi-chip schemes (MCM, InFO, 2.5D) plus the SoC
    single-die flip-chip baseline.  Interposer-bearing technologies (InFO's
    RDL counts as a thin interposer; 2.5D a full silicon interposer) follow
    Eq.(4)/(5); MCM/SoC have no interposer term.
    """

    name: str
    # Substrate (organic, FC-BGA style)
    substrate_cost_per_mm2: float     # USD / mm^2 of package substrate
    substrate_layer_factor: float     # MCM growth factor on substrate RE cost
    package_area_factor: float        # package area / total silicon area
    # Interposer (silicon 2.5D or RDL InFO); zero-cost for SoC / MCM
    interposer_cost_per_mm2: float    # fabricated, incl. TSV/RDL adders
    interposer_defect_density: float  # defects / cm^2
    interposer_area_factor: float     # interposer area / total silicon area
    interposer_node: str = "65nm"     # process used for NRE of the interposer
    # Yields (Eq. 4 notation)
    y1_interposer: float = 1.0        # interposer fab yield handled via defects; extra scalar
    y2_chip_bond: float = 1.0         # per-chip bonding yield
    y3_substrate_bond: float = 1.0    # interposer/module <-> substrate bond yield
    assembly_yield: float = 0.99      # final assembly / package test yield
    bond_cost_per_chip: float = 0.5   # USD per placed die (chip-last bond step)
    # D2D interface area overhead (fraction of each chiplet's area),
    # EPYC-calibrated 10% default per the paper Sec. 4.1.  SoC has none.
    d2d_area_overhead: float = 0.10
    # NRE
    nre_package_per_mm2: float = 1.0e3   # K_p
    nre_fixed_per_package: float = 1.0e6  # C_p


INTEGRATION_TECHS: Dict[str, IntegrationTech] = {
    # Monolithic SoC in a standard flip-chip package.
    "SoC": IntegrationTech(
        name="SoC",
        substrate_cost_per_mm2=0.005, substrate_layer_factor=1.0,
        package_area_factor=2.0,
        interposer_cost_per_mm2=0.0, interposer_defect_density=0.0,
        interposer_area_factor=0.0,
        y2_chip_bond=0.99, y3_substrate_bond=1.0, assembly_yield=0.99,
        d2d_area_overhead=0.0,
        nre_package_per_mm2=0.5e3, nre_fixed_per_package=0.5e6,
    ),
    # Classic multi-chip module: flip chips on a (thicker) organic substrate.
    "MCM": IntegrationTech(
        name="MCM",
        substrate_cost_per_mm2=0.008, substrate_layer_factor=2.0,
        package_area_factor=2.2,
        interposer_cost_per_mm2=0.0, interposer_defect_density=0.0,
        interposer_area_factor=0.0,
        y2_chip_bond=0.975, y3_substrate_bond=1.0, assembly_yield=0.99,
        bond_cost_per_chip=3.0,
        nre_package_per_mm2=1.0e3, nre_fixed_per_package=1.0e6,
    ),
    # Integrated fan-out, chip-first (dies placed, then RDL built on top).
    "InFO": IntegrationTech(
        name="InFO",
        substrate_cost_per_mm2=0.005, substrate_layer_factor=1.5,
        package_area_factor=2.0,
        interposer_cost_per_mm2=0.02,   # RDL, no TSV
        interposer_defect_density=0.05, interposer_area_factor=1.2,
        y2_chip_bond=0.98, y3_substrate_bond=0.99, assembly_yield=0.99,
        nre_package_per_mm2=2.0e3, nre_fixed_per_package=2.0e6,
    ),
    # 2.5D CoWoS: full silicon interposer with TSVs on a 65nm-class line.
    "2.5D": IntegrationTech(
        name="2.5D",
        substrate_cost_per_mm2=0.005, substrate_layer_factor=1.5,
        package_area_factor=2.4,
        interposer_cost_per_mm2=0.07,   # 65nm wafer + TSV + uBump adders
        interposer_defect_density=0.06, interposer_area_factor=1.15,
        y2_chip_bond=0.97, y3_substrate_bond=0.98, assembly_yield=0.99,
        nre_package_per_mm2=3.0e3, nre_fixed_per_package=5.0e6,
    ),
}


def node(name: str) -> ProcessNode:
    try:
        return PROCESS_NODES[name]
    except KeyError as e:
        raise KeyError(f"unknown process node {name!r}; have {sorted(PROCESS_NODES)}") from e


def tech(name: str) -> IntegrationTech:
    try:
        return INTEGRATION_TECHS[name]
    except KeyError as e:
        raise KeyError(f"unknown integration tech {name!r}; have {sorted(INTEGRATION_TECHS)}") from e
