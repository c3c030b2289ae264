"""Portfolio search: cheapest multi-chiplet architecture for a product line.

  PYTHONPATH=src python -m repro_torch.launch.portfolio_search   # the GPU
  PYTHONPATH=src python -m repro_torch.launch.portfolio_search --device cpu

The port's counterpart of ``examples/portfolio_search.py``, in the same
four steps.  A vendor ships three SKUs (laptop / desktop / server parts)
at very different volumes.  Should each get its own silicon?  One shared
chiplet design collocated 1x/2x/4x (the paper's SCMS scheme)?  Which
node, which packaging?  ``repro_torch.dse`` prices the whole candidate
space through the batched CostEngine and searches it — also with Monte
Carlo risk, so the answer is "cheapest at the 90th percentile", not just
at nominal parameters.  Without ``--device cpu`` it runs on the GPU and
raises when there is none.
"""
from __future__ import annotations

import argparse

from .. import random as prng
from .. import resolve_device
from ..core import SystemBatch
from ..dse import (DesignSpace, RiskConfig, SKU, candidate_systems,
                   detail_rows, exhaustive_search, format_table,
                   portfolio_search, result_rows, sensitivities)

SPACE = DesignSpace(
    skus=(SKU("laptop", 150.0, 2e6),       # 150 mm^2 of modules, 2M units
          SKU("desktop", 300.0, 1e6),
          SKU("server", 600.0, 3e5)),
    processes=("5nm", "7nm"),
    integrations=("MCM", "2.5D"),
    chiplet_counts=(1, 2, 3, 4),
    allow_reuse=True,                      # SCMS-style shared chiplet
    reuse_package_options=(False, True))   # optionally share the package


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where to price (default: the GPU)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    space = SPACE
    print(f"design space: {space.size()} candidate portfolio "
          f"architectures; pricing on {dev}")

    # 1. Nominal search: evolutionary loop, deterministic in the key.
    key = prng.PRNGKey(args.seed, device=dev)
    res = portfolio_search(space, key, population=48, generations=10,
                           elite=8, device=dev)
    print(f"\nevaluated {res.n_evaluated} candidates; cheapest portfolio:")
    print(format_table(result_rows(res.top(5))))

    # 2. The space is small enough to brute-force — confirm the optimum.
    ex = exhaustive_search(space, device=dev)
    print(f"\nexhaustive best ({ex.n_evaluated} candidates): "
          f"{ex.best.label}  ${ex.best.portfolio_cost:,.0f}")
    gap = res.best.portfolio_cost / ex.best.portfolio_cost - 1.0
    print("search found the exact optimum"
          if ex.best.label == res.best.label else
          f"search came within {gap:.2%} of the optimum "
          f"(heuristic — evaluated {res.n_evaluated}/{space.size()})")

    # 3. Uncertainty-aware: optimize the 90th-percentile portfolio cost
    #    under defect-density / wafer-price / bond-yield uncertainty.
    risky = portfolio_search(space, key, population=48, generations=6,
                             elite=8, risk=RiskConfig(n_draws=256,
                                                      quantile=0.9),
                             device=dev)
    r = risky.best
    print(f"\nrisk-aware winner (q90 objective): {r.label}")
    print(f"  mean ${r.risk['mean']:,.0f}   q50 ${r.risk['q50']:,.0f}   "
          f"q90 ${r.risk['q90']:,.0f}")
    print("cost-vs-risk Pareto front:")
    for p in risky.pareto:
        print(f"  {p['label']:40s} mean ${p['mean']:,.0f}  "
              f"q90 ${p['q90']:,.0f}")

    # 4. Itemized per-SKU economics of the winner (engine as_rows columns)
    #    and its local parameter sensitivities.
    print("\nwinner per-SKU breakdown:")
    print(format_table(detail_rows(space, res.best.candidate, device=dev)))
    batch = SystemBatch.from_systems(
        candidate_systems(space, res.best.candidate), share_nre=True,
        device=dev)
    sens = {k: v.cpu().tolist() for k, v in sensitivities(batch).items()}
    print("\nelasticities d(cost)/d(ln p) per SKU unit (USD per 100% move):")
    for p in ("chip_defect", "chip_wafer_cost", "y2_chip_bond"):
        vals = "  ".join(f"{float(v):8.2f}" for v in sens[p])
        print(f"  {p:18s} {vals}")


if __name__ == "__main__":
    main()
