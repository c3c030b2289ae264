"""Chiplet Actuary — quantitative cost model (Feng & Ma, DAC 2022) in PyTorch.

The counterpart of ``repro.core``, module for module:

  technology   -- process-node / integration-technology parameter DB
  yield_model  -- Eq. (1) yield curves + wafer geometry
  system       -- module / chip / package algebra (Eq. 3) + spec() builder
  batch        -- SystemBatch: N heterogeneous systems as one struct of tensors
  engine       -- CostEngine: batched, autograd-able Eqs. (4)-(8)
  re_cost      -- scalar reference RE path, Eqs. (4)-(5), five-way breakdown
  nre_cost     -- scalar reference NRE path, Eqs. (6)-(8), amortization
  reuse        -- SCMS / OCME / FSMC scheme builders (Sec. 5)
  explorer     -- engine-backed design-space sweeps and partition search
  gradient     -- (beyond paper) differentiable chiplet count and
                  uneven split
  codesign     -- (beyond paper) accelerator perf-per-dollar bridge

The batched path (``SystemBatch`` + ``CostEngine``) is the primary API and
runs on the GPU unless the caller names the CPU (``device="cpu"``); the
scalar ``re_cost``/``amortized_costs`` path is the readable reference
implementation, runs on the host and is pinned to the engine by parity
tests.  ``re_cost_split`` is deprecated (use the engine, or
``engine.re_split_relaxed`` for the continuous relaxation).
"""
from .technology import (INTEGRATION_TECHS, PROCESS_NODES, IntegrationTech,
                         ProcessNode, node, tech)
from .yield_model import (dies_per_wafer, good_die_cost, raw_die_cost,
                          yield_murphy, yield_negative_binomial, yield_poisson)
from .system import (Chip, Module, System, d2d_module, make_chip, soc_system,
                     spec, split_system)
from .batch import SystemBatch, pad_batch
from .engine import (CostEngine, NREBreakdown, TotalCost, package_flow_terms,
                     re_split_relaxed, silicon_unit_costs)
from .re_cost import REBreakdown, chip_costs, re_cost, re_cost_split
from .nre_cost import NREEntities, UnitCost, amortized_costs, group_nre
from .reuse import (fsmc_enumerate, fsmc_num_systems, fsmc_situations,
                    ocme_soc_equivalents, ocme_systems,
                    portfolio_reuse_systems, scms_soc_equivalents,
                    scms_systems)
from .explorer import (best_partition, cost_area_curve, pareto_front,
                       sweep_hetero_partitions, sweep_partitions, sweep_specs)
from .codesign import (AcceleratorSpec, accelerator_systems, cost_per_step,
                       price_accelerators)
from .gradient import (PartitionResult, optimize_chiplet_count,
                       optimize_uneven_split)

__all__ = [
    "INTEGRATION_TECHS", "PROCESS_NODES", "IntegrationTech", "ProcessNode",
    "node", "tech", "dies_per_wafer", "good_die_cost", "raw_die_cost",
    "yield_murphy", "yield_negative_binomial", "yield_poisson", "Chip",
    "Module", "System", "d2d_module", "make_chip", "soc_system", "spec",
    "split_system", "SystemBatch", "pad_batch", "CostEngine", "NREBreakdown",
    "TotalCost",
    "package_flow_terms", "re_split_relaxed", "silicon_unit_costs",
    "REBreakdown", "chip_costs", "re_cost", "re_cost_split",
    "NREEntities", "UnitCost", "amortized_costs", "group_nre",
    "fsmc_enumerate", "fsmc_num_systems", "fsmc_situations",
    "ocme_soc_equivalents", "ocme_systems", "portfolio_reuse_systems",
    "scms_soc_equivalents",
    "scms_systems", "best_partition", "cost_area_curve", "pareto_front",
    "sweep_hetero_partitions", "sweep_partitions", "sweep_specs",
    "AcceleratorSpec", "accelerator_systems", "cost_per_step",
    "price_accelerators", "PartitionResult", "optimize_chiplet_count",
    "optimize_uneven_split",
]
