"""Differentiable chiplet partitioning (beyond-paper extension).

The paper sweeps integer chiplet counts; here the RE model is
differentiated with ``torch.autograd`` and gradient descent runs on a
continuous relaxation of the chiplet count ``n`` (rounded at the end),
via :func:`repro_torch.core.engine.re_split_relaxed` — the same
primitives the batched :class:`~repro_torch.core.engine.CostEngine`
uses, so the relaxed objective and the faithful model share one source
of truth (real wafer yield, sort/bump costs, Eq. 4/5 flow terms).

This is an extension, clearly separated from the faithful model: the
faithful integer sweep (explorer.best_partition) is always reported next
to the relaxed optimum.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from .engine import re_split_relaxed
from .technology import node, tech


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
