"""Yield models (paper Sec. 2.2, Eq. (1)) and wafer geometry.

All functions are torch, so they run on any device and under autograd
for design-space sweeps and the differentiable partitioner.  They take
tensors or Python floats; a value that is not a tensor becomes a float32
tensor on the CPU, as ``jnp.asarray`` makes float32 values of them.

Conventions: die area ``s`` in mm^2, defect density ``d0`` in defects/cm^2
(hence the /100 conversion), wafer diameter in mm.
"""
from __future__ import annotations

import math

import torch

MM2_PER_CM2 = 100.0


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, dtype=torch.float32)


def yield_negative_binomial(area_mm2, d0_per_cm2, cluster=3.0):
    """Eq. (1): Y = (1 + D*S/c)^(-c) — Seeds / negative-binomial model."""
    area_cm2 = _tensor(area_mm2) / MM2_PER_CM2
    return (1.0 + d0_per_cm2 * area_cm2 / cluster) ** (-cluster)


def yield_poisson(area_mm2, d0_per_cm2):
    """Poisson yield Y = exp(-D*S); the c -> inf limit of Eq. (1)."""
    area_cm2 = _tensor(area_mm2) / MM2_PER_CM2
    return torch.exp(-d0_per_cm2 * area_cm2)


def yield_murphy(area_mm2, d0_per_cm2):
    """Murphy's model Y = ((1 - e^-DS)/DS)^2 — kept for cross-checking.

    Uses expm1 to avoid the 1-exp(-x) cancellation blowing past 1.0 for
    tiny DS in float32.
    """
    ds = _tensor(area_mm2) / MM2_PER_CM2 * d0_per_cm2
    ds = ds.clamp_min(1e-12)
    return ((-torch.expm1(-ds) / ds) ** 2).clamp_max(1.0)


def dies_per_wafer(area_mm2, wafer_diameter_mm=300.0, edge_exclusion_mm=3.0,
                   scribe_mm=0.1):
    """Standard die-per-wafer estimate with edge loss correction.

    DPW = pi*(d/2)^2/S - pi*d/sqrt(2*S), with the diameter shrunk by the
    edge exclusion and the die grown by the scribe lane.
    """
    d = wafer_diameter_mm - 2.0 * edge_exclusion_mm
    s = _tensor(area_mm2)
    # Grow die by scribe lane on each side (approx: sqrt area + scribe)^2.
    s = (torch.sqrt(s) + scribe_mm) ** 2
    dpw = math.pi * (d / 2.0) ** 2 / s - math.pi * d / torch.sqrt(2.0 * s)
    return dpw.clamp_min(1.0)


def raw_die_cost(area_mm2, wafer_cost, wafer_diameter_mm=300.0):
    """Cost of an un-yielded die: wafer price / dies-per-wafer."""
    return wafer_cost / dies_per_wafer(area_mm2, wafer_diameter_mm)


def good_die_cost(area_mm2, wafer_cost, d0_per_cm2, cluster=3.0,
                  wafer_yield=0.99):
    """Cost of a known-good die (raw cost inflated by die + wafer yield)."""
    y = yield_negative_binomial(area_mm2, d0_per_cm2, cluster) * wafer_yield
    return raw_die_cost(area_mm2, wafer_cost) / y
