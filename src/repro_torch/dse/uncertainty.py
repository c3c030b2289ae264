"""Uncertainty-aware pricing: Monte Carlo distributions + sensitivities.

The counterpart of ``repro.dse.uncertainty``.  The technology numbers
behind the cost model (defect densities, wafer prices, bond yields) are
estimates, and the *ranking* of candidate architectures can flip within
their error bars — big monolithic dies are exposed to defect-density
risk, many-chiplet systems to bonding-yield risk.  This module prices
that exposure:

* :func:`mc_totals` prices ``n_draws`` sampled parameter scenarios in one
  pass: the scenario keys are a batch (``repro_torch.random`` takes a
  batch of keys where the reference vmaps over ``split(key, n)``), so
  the perturbed leaves carry a leading draws axis and the engine
  broadcasts over it — a (draws, N) matrix of per-unit totals.  Draws
  are *systematic* by default (one multiplier per scenario applied
  batch-wide, i.e. "what if 7nm defect density is 20% worse than
  assumed"), which is the correlated, ranking-relevant kind of
  uncertainty; ``correlated=False`` switches to per-element
  idiosyncratic jitter.  Lognormal multipliers are median-preserving,
  so the q50 scenario reproduces the nominal model.  The draws are JAX's
  draws for the same key (``repro_torch.random``).
* :func:`mc_summary` reduces the draw matrix to mean/std/quantiles.
* :func:`sensitivities` reuses the engine's differentiability: one
  reverse-mode gradient (``torch.func.grad``) gives per-system
  elasticities d(cost)/d(ln p) for every uncertain parameter — the
  local, deterministic complement to the Monte Carlo picture.

Everything runs on the batch's device and reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from .. import random as prng
from .. import upload
from ..core.batch import SystemBatch
from ..core.engine import _re_impl, _total_impl


@dataclasses.dataclass(frozen=True)
class Uncertainty:
    """Lognormal sigmas of the uncertain technology parameters.

    ``defect_sigma`` scales chip defect densities, ``wafer_cost_sigma``
    wafer prices, ``bond_sigma`` the *failure rates* ``1 - y2`` /
    ``1 - y3`` (so yields stay <= 1), ``interposer_sigma`` the
    interposer defect density.
    """

    defect_sigma: float = 0.20
    wafer_cost_sigma: float = 0.10
    bond_sigma: float = 0.25
    interposer_sigma: float = 0.20

    def as_array(self, device="cpu") -> torch.Tensor:
        return upload([self.defect_sigma, self.wafer_cost_sigma,
                       self.bond_sigma, self.interposer_sigma], device,
                      torch.float32)


def perturb_batch(batch: SystemBatch, key: torch.Tensor, sig: torch.Tensor,
                  correlated: bool = True) -> SystemBatch:
    """Sampled parameter scenarios: lognormal multipliers on the uncertain
    RE parameters (median-preserving; yields perturbed via their failure
    rates so they stay in (0, 1]).

    ``key`` is one key ``(2,)`` or a batch of keys ``(D, 2)``; with a
    batch, the perturbed leaves carry a leading axis of D scenarios and
    the rest of the batch broadcasts against them.
    """
    lead = tuple(key.shape[:-1])
    kd, kw, kb, ks, ki = prng.split(key, 5).unbind(-2)

    def mult(kk, like, s):
        if correlated:
            z = prng.normal(kk, ()).reshape(lead + (1,) * like.ndim)
        else:
            z = prng.normal(kk, tuple(like.shape))
        return torch.exp(s * z)

    def fail(kk, y, s):
        # perturb the failure rate so yields stay in (0, 1]
        return torch.clamp(1.0 - (1.0 - y) * mult(kk, y, s), 1e-3, 1.0)

    return batch.replace(
        chip_defect=batch.chip_defect * mult(kd, batch.chip_defect, sig[0]),
        chip_wafer_cost=batch.chip_wafer_cost
        * mult(kw, batch.chip_wafer_cost, sig[1]),
        y2_chip_bond=fail(kb, batch.y2_chip_bond, sig[2]),
        y3_substrate_bond=fail(ks, batch.y3_substrate_bond, sig[2]),
        interposer_defect=batch.interposer_defect
        * mult(ki, batch.interposer_defect, sig[3]),
    )


def _mc_impl(batch: SystemBatch, key, sig, flow: str, n_draws: int,
             correlated: bool) -> torch.Tensor:
    scen = perturb_batch(batch, prng.split(key, n_draws), sig, correlated)
    return _total_impl(scen, flow).total


def mc_re_totals_impl(batch: SystemBatch, key, sig, flow: str,
                      n_draws: int, correlated: bool = True) -> torch.Tensor:
    """(n_draws, N) *RE-only* totals under sampled scenarios.

    None of the perturbed parameters enters the NRE model, so the fused
    pipeline prices uncertainty as ``re_draws + nre[None, :]`` — the
    amortization runs once per batch instead of once per draw."""
    scen = perturb_batch(batch, prng.split(key, n_draws), sig, correlated)
    return _re_impl(scen, flow).total


def mc_totals(batch: SystemBatch, key, *, n_draws: int = 128,
              flow: str = "chip-last", sigmas: Uncertainty = None,
              correlated: bool = True) -> torch.Tensor:
    """(n_draws, N) per-unit totals under sampled parameter scenarios."""
    key = prng.as_key(key, batch.device)
    sig = (sigmas or Uncertainty()).as_array(batch.device)
    return _mc_impl(batch, key, sig, flow, int(n_draws), bool(correlated))


def _stats(draws: torch.Tensor, quantiles: Sequence[float]
           ) -> Dict[str, torch.Tensor]:
    """mean, population std and linear-interpolation quantiles over the
    leading axis: ``jnp.mean``/``std``/``quantile``'s defaults."""
    out = {"mean": draws.mean(dim=0), "std": draws.std(dim=0, correction=0)}
    qs = torch.quantile(draws, upload(list(quantiles), draws.device,
                                      draws.dtype), dim=0,
                        interpolation="linear")
    for i, q in enumerate(quantiles):
        out[f"q{int(round(q * 100))}"] = qs[i]
    return out


def mc_summary(batch: SystemBatch, key, *, n_draws: int = 128,
               flow: str = "chip-last", sigmas: Uncertainty = None,
               correlated: bool = True,
               quantiles: Sequence[float] = (0.05, 0.5, 0.95),
               ) -> Dict[str, torch.Tensor]:
    """Per-system cost distribution stats: mean/std + requested quantiles."""
    draws = mc_totals(batch, key, n_draws=n_draws, flow=flow, sigmas=sigmas,
                      correlated=correlated)
    return _stats(draws, quantiles)


# Parameters whose local elasticity we report: every (N, C) chip leaf is
# reduced over the chip axis to a per-system number.
SENSITIVITY_PARAMS: Tuple[str, ...] = (
    "chip_defect", "chip_wafer_cost", "y2_chip_bond", "y3_substrate_bond",
    "interposer_defect", "substrate_cost", "assembly_yield",
)


def _sens_impl(batch: SystemBatch, flow: str, params: Tuple[str, ...]):
    def f(leaves):
        # Each system's cost depends only on its own rows of these RE
        # parameters, so the gradient of the sum is the per-system grad.
        return _total_impl(batch.replace(**leaves), flow).total.sum()

    leaves = {p: getattr(batch, p) for p in params}
    g = torch.func.grad(f)(leaves)
    out = {}
    for p in sorted(g):                 # the key order of a jit's output
        elast = g[p] * leaves[p]        # d cost / d ln(p)
        out[p] = elast.sum(-1) if elast.ndim == 2 else elast
    return out


def sensitivities(batch: SystemBatch, flow: str = "chip-last",
                  params: Sequence[str] = SENSITIVITY_PARAMS,
                  ) -> Dict[str, torch.Tensor]:
    """Per-system elasticities d(total)/d(ln p) — USD per 100% parameter
    move, from one reverse-mode gradient through the engine."""
    return _sens_impl(batch, flow, tuple(params))


def portfolio_draws(draws, quantities, n_skus: int) -> torch.Tensor:
    """Fold (draws, K*S) per-unit totals into (draws, K) portfolio costs."""
    d = torch.as_tensor(draws)
    n = d.shape[1] // n_skus
    q = torch.as_tensor(quantities, dtype=d.dtype, device=d.device)
    return (d[:, :n * n_skus].reshape(d.shape[0], n, n_skus)
            * q[None, None, :]).sum(-1)


def portfolio_risk_stats(pf_draws, quantiles: Sequence[float]
                         ) -> Dict[str, torch.Tensor]:
    """Reduction of (draws, K) portfolio costs to per-candidate risk stats
    (mean/std + requested quantiles), each a (K,) tensor on the draws'
    device.

    This is the Monte-Carlo tail of the fused DSE pipeline: the quantile
    objective is computed on the device with the candidate decode and
    pricing, so risk-aware search never ships the draw matrix to the
    host (see :mod:`repro_torch.dse.evaluate` / ``search``)."""
    return _stats(torch.as_tensor(pf_draws), quantiles)
