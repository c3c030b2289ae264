"""Actuary-as-a-service walkthrough on the port's pricing service.

  PYTHONPATH=src python -m repro_torch.launch.pricing_service   # the GPU
  PYTHONPATH=src python -m repro_torch.launch.pricing_service --device cpu

The port's counterpart of ``examples/pricing_service.py``: one in-process
``PricingService`` answering a packaging/node what-if sweep (MCM vs InFO
vs 2.5D across nodes), an evolutionary portfolio search, a Monte-Carlo
risk sweep and a raw ``spec()``-list group — all submitted CONCURRENTLY,
coalesced into shared device ticks, and merged into one report.  Every
answer is bit-exact against the direct ``ChunkedEvaluator`` /
``portfolio_search`` call for the same inputs on the same device.
Without ``--device cpu`` it runs on the GPU and raises when there is
none.
"""
from __future__ import annotations

import argparse
import asyncio

from ..dse import DesignSpace, SKU, Uncertainty
from ..dse.report import format_table, result_rows, search_summary
from ..service import (McSpec, MCRiskRequest, PriceSystemsRequest,
                       PricingService, SearchRequest, SearchWarmup,
                       ServiceConfig, WhatIfRequest)

SPACE = DesignSpace(
    skus=(SKU("laptop", 300.0, 2e6), SKU("desktop", 600.0, 1e6),
          SKU("server", 900.0, 3e5)),
    processes=("5nm", "7nm", "12nm"),
    integrations=("MCM", "InFO", "2.5D"),
    chiplet_counts=(1, 2, 3, 4, 6),
    allow_reuse=True, reuse_package_options=(False, True))


async def run(device=None):
    svc = PricingService(SPACE, ServiceConfig(
        chunk=128, split=32,
        warm_mc=((128, (0.5, 0.9)),),
        warm_search=(SearchWarmup(population=64, elite=12),)),
        device=device)
    await svc.start()

    # a mid-range candidate to interrogate: 2-way split at 7nm, MCM
    base = next(i for i in range(SPACE.size())
                if SPACE.candidate_at(i).label()
                == "2x/7nm/MCM | 2x/7nm/MCM | 2x/7nm/MCM")

    # four clients, one service: the scheduler coalesces whatever is
    # pending into each tick, so the sweep, the search, the risk query
    # and the raw group interleave instead of queueing head-to-tail.
    what_if, search, risk, raw = await asyncio.gather(
        svc.submit(WhatIfRequest(base=base)),          # full tech grid
        svc.submit(SearchRequest(seed=0, population=64, generations=10,
                                 elite=12)),
        svc.submit(MCRiskRequest(
            indices=[base],
            mc=McSpec(draws=128, quantiles=(0.5, 0.9),
                      sigmas=Uncertainty(defect_sigma=0.3)))),
        svc.submit(PriceSystemsRequest(specs=(
            {"kind": "soc", "name": "mono_server", "area": 900.0,
             "process": "5nm", "quantity": 3e5},
            {"kind": "split", "name": "quad_server", "area": 900.0,
             "n_chiplets": 4, "process": "5nm", "integration": "2.5D",
             "quantity": 3e5},))))
    await svc.stop()
    for r in (what_if, search, risk, raw):
        assert r.ok, r.error

    wi = what_if.result
    print(f"\n== what-if grid around {wi.base_label} "
          f"(${wi.base_cost:,.0f} portfolio) ==")
    print(format_table(sorted(wi.rows, key=lambda r: r["portfolio_cost"]),
                       columns=("process", "integration", "candidate",
                                "portfolio_cost", "delta_vs_base")))
    if wi.skipped:
        print(f"({len(wi.skipped)} combinations outside the space)")

    sr = search.result
    summ = search_summary(sr, top=5)
    print(f"\n== portfolio search: best {summ['best']['candidate']} "
          f"(${summ['best']['portfolio_cost']:,.0f}, "
          f"{summ['n_evaluated']} candidates priced) ==")
    print(format_table(result_rows(sr.top(5)),
                       columns=("candidate", "reuse", "portfolio_cost")))

    stats = risk.result.risk
    print(f"\n== MC risk at the base point ({wi.base_label}) ==")
    print(format_table([{"stat": k, "portfolio_cost": float(v[0])}
                        for k, v in stats.items()]))

    print("\n== raw spec()-group (priced outside the DesignSpace) ==")
    print(format_table(raw.result.rows))

    snap = svc.snapshot()
    print(f"\nservice on {svc.device}: {snap['ticks']} ticks "
          f"({snap['device_gets']} device-to-host copies), "
          f"occupancy {snap['slot_occupancy']:.0%}, "
          f"{snap['recompiles_after_warmup']} hot-path first calls, "
          f"p95 latency {snap['latency_s']['p95']*1e3:.1f} ms")
    return snap


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where to price (default: the GPU)")
    args = ap.parse_args(argv)
    asyncio.run(run(args.device))


if __name__ == "__main__":
    main()
