"""Differentiable chiplet partitioning (beyond-paper extension).

The paper sweeps integer chiplet counts; here the RE model is
differentiated with ``torch.autograd`` and gradient descent runs on

  * a continuous relaxation of the chiplet count ``n`` (rounded at the
    end), via :func:`repro_torch.core.engine.re_split_relaxed` — the same
    primitives the batched :class:`~repro_torch.core.engine.CostEngine`
    uses, so the relaxed objective and the faithful model share one
    source of truth (real wafer yield, sort/bump costs, Eq. 4/5 flow
    terms);
  * uneven split fractions (softmax-parameterized) optimized against the
    *full* engine RE objective by swapping chip areas that require grad
    into a :class:`~repro_torch.core.batch.SystemBatch` template —
    heterogeneous partitions, not just even splits.

This is an extension, clearly separated from the faithful model: the
faithful integer sweep (explorer.best_partition) is always reported next
to the relaxed optimum.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from .. import random as prng
from .. import resolve_device
from .batch import SystemBatch
from .engine import CostEngine, _re_impl, re_split_relaxed
from .system import spec
from .technology import node, tech

_ENGINE = CostEngine()


@dataclasses.dataclass
class PartitionResult:
    n_relaxed: float
    n_rounded: int
    cost_relaxed: float
    cost_rounded: float
    cost_soc: float
    iterations: int


def _total(n, area, nd, d0, t):
    return re_split_relaxed(
        area, n, wafer_cost=nd.wafer_cost, defect_density=d0,
        cluster=nd.cluster_param, tech_params=t,
        wafer_yield=nd.wafer_yield, sort_cost=nd.wafer_sort_cost,
        bump_cost=nd.bump_cost_per_mm2,
        interposer_cluster=node(t.interposer_node).cluster_param)["total"]


def optimize_chiplet_count(process: str, integration: str, area_mm2: float,
                           early: bool = False, lr: float = 0.05,
                           steps: int = 300, n0: float = 2.0,
                           device=None) -> PartitionResult:
    """Gradient descent on log(n) to minimize the continuous RE total.

    Runs on ``device`` (the GPU unless the caller names another); the
    steps read nothing back to the host, only the result does.
    """
    dev = resolve_device(device)
    nd = node(process)
    t = tech(integration)
    d0 = nd.defect_density_early if early else nd.defect_density

    def scalar(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    soc_cost = _total(scalar(1.0), area_mm2, nd, d0, t)

    def loss(log_n):
        n = torch.exp(log_n) + 1.0  # n >= 1
        # normalized: O(1) gradients for any node/area (raw $ costs give
        # log-space SGD steps of ~e^80 and the descent diverges)
        return _total(n, area_mm2, nd, d0, t) / soc_cost

    log_n = torch.log(scalar(n0 - 1.0 + 1e-3))
    for _ in range(steps):
        x = log_n.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(x), x)
        log_n = log_n - lr * g
    with torch.no_grad():
        n_rel = float(torch.exp(log_n) + 1.0)
        cost_rel = float(loss(log_n) * soc_cost)
        n_round = max(1, int(round(n_rel)))
        cost_round = float(_total(scalar(float(n_round)), area_mm2, nd, d0, t))
    return PartitionResult(n_relaxed=n_rel, n_rounded=n_round,
                           cost_relaxed=cost_rel, cost_rounded=cost_round,
                           cost_soc=float(soc_cost), iterations=steps)


def optimize_uneven_split(process: str, integration: str,
                          module_areas_mm2: Sequence[float],
                          n_chiplets: int, early: bool = False,
                          lr: float = 0.1, steps: int = 500,
                          device=None) -> Dict:
    """Assign m modules to n chiplets via a relaxed (softmax) assignment.

    The soft assignment induces chip areas that are swapped into a
    :class:`SystemBatch` template and priced by the *full* engine RE
    model — interposer, bonding, defect and wasted-KGD terms included.
    The logits start from ``0.01 * normal(PRNGKey(0), (m, n))`` of
    :mod:`repro_torch.random`, the JAX package's draw, so both packages
    descend from the same point.  Returns the hard assignment recovered by
    argmax plus its faithfully re-evaluated cost.  Runs on ``device``
    (the GPU unless the caller names another).
    """
    dev = resolve_device(device)
    t = tech(integration)
    areas = torch.tensor(list(module_areas_mm2), dtype=torch.float32,
                         device=dev)
    m = areas.shape[0]
    ovh = t.d2d_area_overhead
    total_area = float(areas.sum())

    # Template: even n-way split of the right total; its chip_area /
    # package_area leaves are replaced during descent.
    template = SystemBatch.from_systems([spec({
        "kind": "split", "name": "uneven", "area": total_area,
        "process": process, "n": n_chiplets, "integration": integration,
        "early": early})], device=dev)

    def loss(logits):
        p = torch.softmax(logits, dim=1)            # (m, n) soft assignment
        chip_areas = (p.T @ areas) / (1.0 - ovh)    # + D2D share per chiplet
        batch = template.replace(
            chip_area=chip_areas[None, :],
            package_area=(chip_areas.sum() * t.package_area_factor)[None])
        return _re_impl(batch, "chip-last").total[0]

    logits = 0.01 * prng.normal(prng.PRNGKey(0, device=dev), (m, n_chiplets))
    for _ in range(steps):
        x = logits.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(x), x)
        logits = logits - lr * g
    with torch.no_grad():
        soft_cost = float(loss(logits))
    hard = torch.argmax(logits, dim=1).cpu()
    host_areas = areas.cpu()
    chip_areas = [float(host_areas[hard == i].sum())
                  for i in range(n_chiplets)]
    occupied = [a for a in chip_areas if a > 0.0]
    hard_batch = SystemBatch.from_systems([spec({
        "kind": "chips", "name": "uneven_hard",
        "chips": [{"area": a, "process": process, "early": early}
                  for a in occupied],
        "integration": integration})], device=dev)
    hard_cost = float(_ENGINE.re(hard_batch).total[0])
    return {"assignment": hard.tolist(), "chip_areas": chip_areas,
            "soft_cost": soft_cost, "hard_cost": hard_cost}
