"""Vectorized design-space exploration over the Chiplet Actuary model.

Sweeps are expressed as declarative spec dicts, packed into one
:class:`~repro_torch.core.batch.SystemBatch`, and priced by
:class:`~repro_torch.core.engine.CostEngine` in one call — the engine
behind the Fig. 2/4 benchmarks and the partitioning decision method
(Sec. 6 takeaway 1: "splitting into two or three chiplets is usually
sufficient").  They cover *heterogeneous* partitions: unequal slices,
mixed process nodes, mixed integration technologies, all in one batch.

Every sweep takes ``device=None``: the GPU unless the caller names
another device (``"cpu"``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence

import torch

from .. import resolve_device
from .batch import SystemBatch
from .engine import CostEngine
from .technology import node
from .yield_model import raw_die_cost, yield_negative_binomial

_ENGINE = CostEngine()


def cost_area_curve(process: str, areas_mm2, early: bool = False,
                    device=None):
    """Fig. 2: yield and normalized cost/area vs die area for one node.

    Cost is normalized to the cost-per-area of the raw wafer, as in the
    paper's Fig. 2.
    """
    areas = torch.as_tensor(areas_mm2, dtype=torch.float32,
                            device=resolve_device(device))
    n = node(process)
    d0 = n.defect_density_early if early else n.defect_density
    y = yield_negative_binomial(areas, d0, n.cluster_param)
    raw = raw_die_cost(areas, n.wafer_cost)
    # raw wafer cost per mm^2 (ideal full utilization of a 300mm wafer)
    per_mm2 = n.wafer_cost / (math.pi * 150.0 ** 2)
    norm_cost = (raw / y) / (areas * per_mm2)
    return {"area": areas, "yield": y, "norm_cost_per_area": norm_cost}


def sweep_specs(specs: Sequence[Mapping], flow: str = "chip-last",
                share_nre: bool = False, device=None):
    """Price arbitrary spec dicts in one engine call.

    Returns ``(batch, total_cost)`` where ``total_cost`` is the engine's
    :class:`~repro_torch.core.engine.TotalCost` with (N,)-tensor fields.
    """
    batch = SystemBatch.from_specs(specs, share_nre=share_nre, device=device)
    return batch, _ENGINE.total(batch, flow=flow)


def sweep_partitions(process: str, integration: str,
                     areas_mm2: Sequence[float],
                     n_chiplets: Sequence[int], early: bool = False,
                     flow: str = "chip-last", device=None):
    """RE-cost surface over (module area x number of chiplets) — Fig. 4 data.

    ``n = 1`` means the unsplit module (no D2D overhead) placed in the
    given integration technology's package.
    """
    specs = []
    for a in areas_mm2:
        for n in n_chiplets:
            specs.append({
                "kind": "split", "area": float(a), "process": process,
                "n": int(n), "integration": integration, "early": early,
                "d2d_overhead": 0.0 if int(n) == 1 else None,
            })
    batch = SystemBatch.from_specs(specs, device=device)
    totals = _ENGINE.re(batch, flow=flow).total.reshape(
        len(areas_mm2), len(n_chiplets))
    return {"areas": torch.as_tensor(areas_mm2, dtype=torch.float32,
                                     device=batch.device),
            "n_chiplets": torch.as_tensor(n_chiplets, dtype=torch.float32,
                                          device=batch.device),
            "total": totals}


def sweep_hetero_partitions(area_mm2: float, partitions: Sequence[Sequence],
                            integration: str, early: bool = False,
                            flow: str = "chip-last",
                            device=None) -> List[Dict]:
    """Price heterogeneous partitions of one module area.

    Each partition is a sequence of ``(fraction, process)`` slices — e.g.
    ``[(0.5, "5nm"), (0.25, "7nm"), (0.25, "7nm")]`` puts half the module
    on 5nm and the rest on two 7nm chiplets.  Fractions are normalized.
    Returns one row per partition with the RE breakdown.
    """
    specs = []
    for i, part in enumerate(partitions):
        fracs = [float(f) for f, _ in part]
        procs = [p for _, p in part]
        specs.append({"kind": "split", "name": f"part{i}",
                      "area": float(area_mm2), "fractions": fracs,
                      "processes": procs, "integration": integration,
                      "early": early,
                      # a single-slice partition is the unsplit module
                      "d2d_overhead": 0.0 if len(part) == 1 else None})
    batch = SystemBatch.from_specs(specs, device=device)
    br = _ENGINE.re(batch, flow=flow)
    total, die, pkg = torch.stack(
        [br.total, br.die_cost, br.packaging_cost]).cpu().tolist()
    return [{"partition": list(part), "total": total[i],
             "die_cost": die[i], "packaging_cost": pkg[i]}
            for i, part in enumerate(partitions)]


def best_partition(process: str, integration: str, area_mm2: float,
                   max_chiplets: int = 8, early: bool = False,
                   device=None) -> Dict:
    """Integer argmin over chiplet count for one (node, tech, area)."""
    ns = list(range(1, max_chiplets + 1))
    res = sweep_partitions(process, integration, [area_mm2], ns, early=early,
                           device=device)
    totals = res["total"][0].cpu()
    i = int(totals.argmin())
    totals = totals.tolist()
    return {"best_n": ns[i], "best_cost": totals[i],
            "soc_cost": totals[0],
            "saving": 1.0 - totals[i] / totals[0]}


def pareto_front(points: Sequence[Dict], x_key: str, y_key: str) -> List[Dict]:
    """Lower-left Pareto front (minimize both keys), deterministically.

    Points are sorted by ``(x, y)`` (stable, so equal keys keep input
    order) and a point is kept iff its y is *strictly* below every
    previously kept point's y.  Consequences of the strict ``<``: the
    first point of an equal-``(x, y)`` duplicate group wins, and a
    y-tie at larger x is treated as dominated and dropped — ties never
    produce a nondeterministic front.
    """
    pts = sorted(points, key=lambda p: (p[x_key], p[y_key]))
    front, best_y = [], float("inf")
    for p in pts:
        if p[y_key] < best_y:
            front.append(p)
            best_y = p[y_key]
    return front
