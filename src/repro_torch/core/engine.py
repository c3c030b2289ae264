"""Unified, batchable cost engine — one torch implementation of Eqs. (4)-(8).

:class:`CostEngine` evaluates the paper's full RE model (five-way
breakdown, both chip-last and chip-first flows) and NRE amortization for a
whole :class:`~repro_torch.core.batch.SystemBatch` of *heterogeneous*
systems, on the batch's device.  It mirrors the scalar reference path
``re_cost.re_cost`` / ``nre_cost.amortized_costs`` to 1e-5 relative.

The engine reads nothing back to the host: every branch depends on
shapes only, so a call queues its kernels and returns, and it runs under
``torch.cuda.set_sync_debug_mode("error")``.

The shared primitives (:func:`silicon_unit_costs`,
:func:`package_flow_terms`) are also the building blocks of the
continuous relaxation :func:`re_split_relaxed` behind
:mod:`repro_torch.core.gradient`, so every consumer of the model draws on
one source of truth for wafer yield, sort/bump costs and the flow
formulas.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from .. import resolve_device
from ..obs import torchhooks
from .batch import SystemBatch
from .re_cost import REBreakdown
from .yield_model import dies_per_wafer, raw_die_cost, yield_negative_binomial

_EPS = 1e-30


# ---------------------------------------------------------------------------
# Shared primitives (Eq. 2 silicon terms, Eq. 4/5 flow terms)
# ---------------------------------------------------------------------------


def silicon_unit_costs(area_mm2, wafer_cost, defect_density, cluster,
                       wafer_yield, sort_cost, bump_cost):
    """Per-die (raw, defect overhead, KGD, die yield) — Eqs. (1)-(2).

    Matches ``re_cost.chip_costs``: sort and bump are folded into the raw
    die and the die yield includes the per-node wafer yield.
    """
    dpw = dies_per_wafer(area_mm2)
    raw = raw_die_cost(area_mm2, wafer_cost) + sort_cost / dpw \
        + bump_cost * area_mm2
    y_die = yield_negative_binomial(area_mm2, defect_density,
                                    cluster) * wafer_yield
    kgd = raw / y_die
    return raw, kgd - raw, kgd, y_die


def package_flow_terms(flow: str, *, c_interposer, y1, c_substrate, c_bond,
                       kgd_total, y2n, y3):
    """(raw_package, package_defects, wasted_kgd) under one flow — Eq. (4)/(5)."""
    raw_package = c_interposer + c_substrate + c_bond
    if flow == "chip-last":
        package_defects = (c_interposer * (1.0 / (y1 * y2n * y3) - 1.0)
                           + (c_substrate + c_bond) * (1.0 / y3 - 1.0))
        wasted_kgd = kgd_total * (1.0 / (y2n * y3) - 1.0)
    elif flow == "chip-first":
        y_all = y1 * y2n * y3
        package_defects = raw_package * (1.0 / y_all - 1.0)
        wasted_kgd = kgd_total * (1.0 / y_all - 1.0)
    else:
        raise ValueError(f"unknown flow {flow!r}")
    return raw_package, package_defects, wasted_kgd


def _segment_sum(values: torch.Tensor, ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: the sum of ``values`` over each id, the
    same bits every call.  The CPU's ``index_add`` adds serially in input
    order; on CUDA its atomics land in any order, so the sums there go
    through :func:`_sorted_segment_sum`, which adds in that same order."""
    if values.device.type == "cpu":
        out = torch.zeros((num_segments,), dtype=values.dtype)
        return out.index_add(0, ids, values)
    return _sorted_segment_sum(values, ids, num_segments)


def _sorted_segment_sum(values: torch.Tensor, ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Segment sums in input order, with no atomics and no host sync.

    A stable sort groups each id's values in input order; a binary search
    of the sorted ids gives each segment's length; ``segment_reduce``
    then sums every segment serially, one thread a segment, from 0 — the
    additions of a serial ``index_add``, so the bits equal the CPU's.
    Zeros add nothing to a sum, so they take a key past the last segment
    and are never read: the zeros of padded slots (every padded chip
    points at entity 0) would otherwise make one long serial segment.
    """
    key = torch.where(values == 0.0, num_segments, ids.to(torch.int32))
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=torch.int32,
                          device=values.device)
    starts = torch.searchsorted(sorted_key, bounds)
    # (n, 1) data: segment_reduce's one-thread-a-segment loop, not a block
    # a segment; unsafe: lengths summing below n leave the zeros unread,
    # and the check would read the device
    out = torch.segment_reduce(values[order][:, None], "sum",
                               lengths=starts.diff(), unsafe=True)
    return out[:, 0]


# ---------------------------------------------------------------------------
# Batched RE / NRE implementations
# ---------------------------------------------------------------------------


def _re_impl(b: SystemBatch, flow: str) -> REBreakdown:
    mask = b.chip_mask
    raw, defect, kgd, _ = silicon_unit_costs(
        b.chip_area, b.chip_wafer_cost, b.chip_defect, b.chip_cluster,
        b.chip_wafer_yield, b.chip_sort_cost, b.chip_bump_cost)
    raw_chips = (raw * mask).sum(-1)
    chip_defects = (defect * mask).sum(-1)
    kgd_total = (kgd * mask).sum(-1)
    n_chips = mask.sum(-1)

    # Interposer sized for the package *design*'s silicon capacity (Sec. 5.1:
    # a reused oversized package pays its full interposer).
    design_silicon = b.package_area / b.package_area_factor
    int_area = design_silicon * b.interposer_area_factor
    c_interposer = int_area * b.interposer_cost
    y1 = torch.where(
        b.interposer_area_factor > 0.0,
        yield_negative_binomial(int_area, b.interposer_defect,
                                b.interposer_cluster),
        1.0)
    c_substrate = b.package_area * b.substrate_cost * b.substrate_layer
    c_bond = b.bond_cost_per_chip * n_chips
    y2n = b.y2_chip_bond ** n_chips
    y3 = b.y3_substrate_bond * b.assembly_yield

    raw_package, package_defects, wasted_kgd = package_flow_terms(
        flow, c_interposer=c_interposer, y1=y1, c_substrate=c_substrate,
        c_bond=c_bond, kgd_total=kgd_total, y2n=y2n, y3=y3)
    return REBreakdown(raw_chips=raw_chips, chip_defects=chip_defects,
                       raw_package=raw_package,
                       package_defects=package_defects,
                       wasted_kgd=wasted_kgd)


@dataclasses.dataclass
class NREBreakdown:
    """Per-unit amortized NRE of every system in a batch (tensor fields)."""

    modules: torch.Tensor
    chips: torch.Tensor
    packages: torch.Tensor
    d2d: torch.Tensor

    @property
    def total(self):
        return self.modules + self.chips + self.packages + self.d2d

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {"nre_modules": self.modules, "nre_chips": self.chips,
                "nre_packages": self.packages, "nre_d2d": self.d2d,
                "nre_total": self.total}


def _nre_impl(b: SystemBatch) -> NREBreakdown:
    q = b.quantity
    n_sys = b.chip_area.shape[0]

    # Chip designs: per-use share = NRE_e / sum_j q_j * n_{j,e}  (Eq. 8).
    chip_nre = b.chip_entity_k * b.chip_entity_area + b.chip_entity_fixed
    flat_id = b.chip_entity_id.reshape(-1)
    flat_q = (q[:, None] * b.chip_mask).reshape(-1)
    denom = _segment_sum(flat_q, flat_id, b.chip_entity_area.shape[0])
    share = chip_nre / denom.clamp_min(_EPS)
    chips = (share[b.chip_entity_id] * b.chip_mask).sum(-1)

    # Package designs (one instance per system).
    pkg_nre = b.pkg_entity_k * b.pkg_entity_area + b.pkg_entity_fixed
    pdenom = _segment_sum(q, b.pkg_entity_id, b.pkg_entity_area.shape[0])
    packages = (pkg_nre / pdenom.clamp_min(_EPS))[b.pkg_entity_id]

    # Modules (Eq. 7) and D2D interfaces: flat instance lists.  The
    # branches test shapes, which the host knows without a sync.
    if b.mod_sys.shape[0]:
        mod_nre = b.mod_entity_k * b.mod_entity_area
        mdenom = _segment_sum(q[b.mod_sys], b.mod_entity,
                              b.mod_entity_area.shape[0])
        per_inst = (mod_nre / mdenom.clamp_min(_EPS))[b.mod_entity]
        modules = _segment_sum(per_inst, b.mod_sys, n_sys)
    else:
        modules = torch.zeros((n_sys,), dtype=q.dtype, device=q.device)
    if b.d2d_sys.shape[0]:
        ddenom = _segment_sum(q[b.d2d_sys], b.d2d_entity,
                              b.d2d_entity_nre.shape[0])
        per_inst = (b.d2d_entity_nre / ddenom.clamp_min(_EPS))[b.d2d_entity]
        d2d = _segment_sum(per_inst, b.d2d_sys, n_sys)
    else:
        d2d = torch.zeros((n_sys,), dtype=q.dtype, device=q.device)
    return NREBreakdown(modules=modules, chips=chips, packages=packages,
                        d2d=d2d)


@dataclasses.dataclass
class TotalCost:
    """RE + amortized NRE for a batch; all fields tensor-valued."""

    re: REBreakdown
    nre: NREBreakdown

    @property
    def total(self):
        return self.re.total + self.nre.total


def _total_impl(b: SystemBatch, flow: str) -> TotalCost:
    return TotalCost(re=_re_impl(b, flow), nre=_nre_impl(b))


# The module-level probe every CostEngine.total and the pricing service's
# raw lane call (see repro_torch.obs.torchhooks).
_TOTAL_PROBE = torchhooks.instrument(_total_impl, "engine.total")


def portfolio_totals(unit_totals, quantities):
    """Reduce per-unit totals to per-group portfolio costs.

    ``unit_totals`` is ``(K * S,)`` or ``(K, S)`` per-unit costs of K
    groups of S systems each (e.g. K candidate portfolios of S SKUs);
    ``quantities`` is the ``(S,)`` production volume of each group
    member.  Returns ``(K,)`` USD totals.
    """
    u = torch.as_tensor(unit_totals)
    q = torch.as_tensor(quantities, device=u.device)
    return (u.reshape(-1, q.shape[0]) * q[None, :]).sum(-1)


def finite_rows(*arrays) -> torch.Tensor:
    """(K,) bool mask: True where every given per-row output is finite.

    Each tensor is ``(K,)`` or ``(K, ...)`` (trailing axes are reduced) —
    the guardrail that lets a caller fail exactly the rows whose cost math
    produced NaN/Inf instead of the whole batch.
    """
    mask = None
    for a in arrays:
        m = torch.isfinite(a)
        if m.ndim > 1:
            m = m.reshape(m.shape[0], -1).all(-1)
        mask = m if mask is None else mask & m
    return mask


def re_split_relaxed(module_area_mm2, n_chiplets, *, wafer_cost,
                     defect_density, cluster, tech_params, wafer_yield=0.99,
                     sort_cost=0.0, bump_cost=0.0, d2d_overhead=None,
                     interposer_cluster=3.0, flow: str = "chip-last",
                     device=None):
    """Continuous-relaxation RE total for an even n-way split.

    ``n_chiplets`` may be a float tensor that requires grad — this is the
    differentiable objective behind
    :func:`repro_torch.core.gradient.optimize_chiplet_count`.  It computes
    on ``device``: by default a tensor's own device, and for a Python
    number the GPU unless the caller names another.  Built from the same
    primitives as :class:`CostEngine` (real wafer yield, sort/bump folded
    in, Eq. 4/5 flow terms).  Returns a dict of 0-d tensors matching
    ``REBreakdown`` fields plus ``total``.
    """
    t = tech_params
    ovh = t.d2d_area_overhead if d2d_overhead is None else d2d_overhead
    if device is None and isinstance(n_chiplets, torch.Tensor):
        device = n_chiplets.device
    n = torch.as_tensor(n_chiplets, dtype=torch.float32,
                        device=resolve_device(device))
    chip_area = module_area_mm2 / n
    chip_area = chip_area * torch.where(n > 1.0, 1.0 / (1.0 - ovh), 1.0)
    silicon = chip_area * n

    raw1, defect1, kgd1, _ = silicon_unit_costs(
        chip_area, wafer_cost, defect_density, cluster, wafer_yield,
        sort_cost, bump_cost)
    raw_chips = raw1 * n
    chip_defects = defect1 * n
    kgd_total = kgd1 * n

    interposer_area = silicon * t.interposer_area_factor
    c_interposer = interposer_area * t.interposer_cost_per_mm2
    # The technology is a Python constant: branch on the host, so the
    # unselected yield never enters the graph (nor its gradient).
    if t.interposer_area_factor > 0:
        y1 = yield_negative_binomial(interposer_area,
                                     t.interposer_defect_density,
                                     interposer_cluster)
    else:
        y1 = 1.0
    c_substrate = (silicon * t.package_area_factor * t.substrate_cost_per_mm2
                   * t.substrate_layer_factor)
    c_bond = t.bond_cost_per_chip * n
    y2n = t.y2_chip_bond ** n
    y3 = t.y3_substrate_bond * t.assembly_yield

    raw_package, package_defects, wasted_kgd = package_flow_terms(
        flow, c_interposer=c_interposer, y1=y1, c_substrate=c_substrate,
        c_bond=c_bond, kgd_total=kgd_total, y2n=y2n, y3=y3)
    total = (raw_chips + chip_defects + raw_package + package_defects
             + wasted_kgd)
    return {"raw_chips": raw_chips, "chip_defects": chip_defects,
            "raw_package": raw_package, "package_defects": package_defects,
            "wasted_kgd": wasted_kgd, "total": total}


class CostEngine:
    """Single entry point for the batched cost model.

    >>> batch = SystemBatch.from_specs([
    ...     {"kind": "soc", "area": 800.0, "process": "5nm"},
    ...     {"kind": "split", "area": 800.0, "process": "5nm", "n": 3,
    ...      "integration": "MCM"},
    ... ])                              # on the GPU; device="cpu" for the CPU
    >>> engine = CostEngine()
    >>> engine.re(batch).total          # (2,) RE totals
    >>> engine.total(batch).total       # (2,) RE + amortized NRE

    Every method computes on the batch's device, which its constructor
    chose.
    """

    def __init__(self, flow: str = "chip-last"):
        self.flow = flow

    def re(self, batch: SystemBatch, flow: str = None) -> REBreakdown:
        """Itemized RE breakdown, Eqs. (4)-(5); fields are (N,) tensors."""
        return _re_impl(batch, self.flow if flow is None else flow)

    def nre(self, batch: SystemBatch) -> NREBreakdown:
        """Per-unit amortized NRE with entity dedup, Eqs. (6)-(8)."""
        return _nre_impl(batch)

    def total(self, batch: SystemBatch, flow: str = None) -> TotalCost:
        """RE + amortized NRE per unit for every system in the batch."""
        return _TOTAL_PROBE(batch, self.flow if flow is None else flow)

    def as_rows(self, batch: SystemBatch, flow: str = None) -> List[Dict]:
        """Host-side list of per-system dicts (benchmark/report helper);
        one device-to-host copy for the whole batch."""
        tc = self.total(batch, flow=flow)
        cols = {k: v for k, v in tc.re.as_dict().items() if k != "total"}
        cols["re_total"] = tc.re.total
        cols.update(tc.nre.as_dict())
        cols["total"] = tc.total
        host = torch.stack(list(cols.values())).detach().cpu().tolist()
        names = batch.names or tuple(f"sys{i}" for i in range(len(batch)))
        rows = []
        for i, name in enumerate(names):
            row = {"system": name}
            row.update({k: host[j][i] for j, k in enumerate(cols)})
            rows.append(row)
        return rows
