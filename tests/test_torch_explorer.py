"""The port's explorer, gradient partitioner, codesign pricer and reuse
builders (repro_torch.core) against the JAX package's, on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import codesign as jax_codesign
from repro.core import gradient as jax_gradient
from repro_torch.core import codesign as torch_codesign
from repro_torch.core import gradient as torch_gradient
from torch_parity import ENGINE_RTOL, close

torch.set_num_threads(1)

CPU = "cpu"
# Fig. 4's grid (benchmarks/fig4_re_integration.py), with the unsplit n = 1
FIG4_AREAS = (300.0, 500.0, 800.0, 900.0)
FIG4_NS = (1, 2, 3, 5)


@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("process", ["5nm", "28nm"])
def test_cost_area_curve_matches_jax(process, early):
    areas = np.linspace(10.0, 900.0, 64, dtype=np.float32)
    want = R.cost_area_curve(process, areas, early=early)
    got = T.cost_area_curve(process, areas, early=early, device=CPU)
    for k in ("area", "yield", "norm_cost_per_area"):
        close(want[k], got[k], rtol=ENGINE_RTOL, what=k)


@pytest.mark.parametrize("flow", ["chip-last", "chip-first"])
@pytest.mark.parametrize("integration", ["MCM", "InFO", "2.5D"])
def test_sweep_partitions_fig4_grid_matches_jax(integration, flow):
    for process in ("14nm", "5nm"):
        want = R.sweep_partitions(process, integration, FIG4_AREAS, FIG4_NS,
                                  flow=flow)
        got = T.sweep_partitions(process, integration, FIG4_AREAS, FIG4_NS,
                                 flow=flow, device=CPU)
        assert got["total"].shape == (len(FIG4_AREAS), len(FIG4_NS))
        for k in ("areas", "n_chiplets", "total"):
            close(want[k], got[k], rtol=ENGINE_RTOL, what=f"{process} {k}")


def test_sweep_specs_matches_jax():
    specs = [{"kind": "soc", "area": 800.0, "process": "5nm"},
             {"kind": "split", "area": 800.0, "process": "5nm", "n": 3,
              "integration": "MCM", "quantity": 2e6},
             {"kind": "split", "name": "het", "area": 700.0,
              "fractions": [0.5, 0.3, 0.2],
              "processes": ["5nm", "7nm", "12nm"], "integration": "2.5D"}]
    for share in (False, True):
        jb, want = R.sweep_specs(specs, share_nre=share)
        tb, got = T.sweep_specs(specs, share_nre=share, device=CPU)
        assert tb.names == jb.names
        close(want.total, got.total, rtol=ENGINE_RTOL, what="total")
        close(want.nre.total, got.nre.total, rtol=ENGINE_RTOL, what="nre")


def test_sweep_hetero_partitions_matches_jax():
    parts = [[(1.0, "5nm")], [(0.5, "5nm"), (0.5, "5nm")],
             [(0.5, "5nm"), (0.5, "7nm")],
             [(0.5, "5nm"), (0.25, "7nm"), (0.25, "12nm")]]
    want = R.sweep_hetero_partitions(800.0, parts, integration="MCM")
    got = T.sweep_hetero_partitions(800.0, parts, integration="MCM",
                                    device=CPU)
    for w, g in zip(want, got, strict=True):
        assert g["partition"] == w["partition"]
        for k in ("total", "die_cost", "packaging_cost"):
            close(w[k], g[k], rtol=ENGINE_RTOL, what=k)


@pytest.mark.parametrize("process,integration,area", [
    ("5nm", "MCM", 800.0), ("5nm", "2.5D", 800.0), ("7nm", "InFO", 400.0),
    ("14nm", "MCM", 150.0)])
def test_best_partition_matches_jax(process, integration, area):
    want = R.best_partition(process, integration, area)
    got = T.best_partition(process, integration, area, device=CPU)
    assert got["best_n"] == want["best_n"]
    for k in ("best_cost", "soc_cost", "saving"):
        close(want[k], got[k], rtol=ENGINE_RTOL, what=k)


def test_pareto_front_ties_and_reference():
    pts = [{"x": 1.0, "y": 5.0, "tag": "keep-first"},
           {"x": 1.0, "y": 5.0, "tag": "dup-dropped"},
           {"x": 2.0, "y": 5.0, "tag": "ytie-dropped"},
           {"x": 2.0, "y": 3.0, "tag": "keep"},
           {"x": 3.0, "y": 4.0, "tag": "dominated"}]
    front = T.pareto_front(pts, "x", "y")
    assert [p["tag"] for p in front] == ["keep-first", "keep"]
    front2 = T.pareto_front(list(reversed(pts[2:])) + pts[:2], "x", "y")
    assert [(p["x"], p["y"]) for p in front2] == [(1.0, 5.0), (2.0, 3.0)]
    rng = np.random.default_rng(7)
    cloud = [{"x": float(x), "y": float(y)}
             for x, y in rng.integers(0, 6, (60, 2))]
    assert T.pareto_front(cloud, "x", "y") == R.pareto_front(cloud, "x", "y")


@pytest.mark.parametrize("process,integration,area,early", [
    ("5nm", "MCM", 800.0, False), ("7nm", "MCM", 800.0, False),
    ("5nm", "2.5D", 600.0, True)])
def test_optimize_chiplet_count_matches_jax(process, integration, area,
                                            early):
    want = jax_gradient.optimize_chiplet_count(process, integration, area,
                                               early=early)
    got = torch_gradient.optimize_chiplet_count(process, integration, area,
                                                early=early, device=CPU)
    assert got.n_rounded == want.n_rounded
    assert got.iterations == want.iterations
    close(want.n_relaxed, got.n_relaxed, rtol=1e-4, what="n_relaxed")
    for k in ("cost_relaxed", "cost_rounded", "cost_soc"):
        close(getattr(want, k), getattr(got, k), rtol=ENGINE_RTOL, what=k)


@pytest.mark.parametrize("phy_process", [None, "14nm"])
def test_price_accelerators_and_cost_per_step_match_jax(phy_process):
    want_spec = jax_codesign.AcceleratorSpec("acc", phy_process=phy_process)
    got_spec = torch_codesign.AcceleratorSpec("acc", phy_process=phy_process)
    want = R.price_accelerators(want_spec)
    got = T.price_accelerators(got_spec, device=CPU)
    assert list(got) == list(want) == ["SoC", "MCM-2x", "2.5D-CIO",
                                       "2.5D-hetero"]
    for label in want:
        assert list(got[label]) == list(want[label])
        close(list(want[label].values()), list(got[label].values()),
              rtol=ENGINE_RTOL, what=label)
    cell = {"t_compute": 0.8, "t_memory": 1.1, "t_collective": 0.3,
            "hlo_flops": 3e15}
    unit = got["2.5D-hetero"]["unit_cost"]
    assert T.cost_per_step(cell, unit, 256) == \
        R.cost_per_step(cell, unit, 256)


def test_accelerator_systems_equal():
    a = R.accelerator_systems(jax_codesign.AcceleratorSpec("x",
                                                           phy_process="7nm"))
    b = T.accelerator_systems(torch_codesign.AcceleratorSpec("x",
                                                             phy_process="7nm"))
    assert {k: dataclasses.asdict(v) for k, v in b.items()} == \
        {k: dataclasses.asdict(v) for k, v in a.items()}


REUSE_BUILDERS = {
    "scms": lambda c: c.scms_systems(integration="2.5D", package_reuse=True),
    "scms_soc": lambda c: c.scms_soc_equivalents(counts=(1, 3)),
    "ocme": lambda c: c.ocme_systems(center_process="14nm",
                                     package_reuse=True),
    "ocme_soc": lambda c: c.ocme_soc_equivalents(),
    "fsmc": lambda c: c.fsmc_enumerate(n_chiplets=4, k_sockets=3),
    "fsmc_situations": lambda c: [s for _, grp in sorted(
        c.fsmc_situations(n_chiplets=4, k_sockets=3, n_situations=3).items())
        for s in grp],
    "portfolio": lambda c: c.portfolio_reuse_systems(
        120.0, "7nm", "MCM", [1, 2, 4], [1e6, 5e5, 1e5], package_reuse=True),
}


@pytest.mark.parametrize("builder", sorted(REUSE_BUILDERS))
def test_reuse_builders_give_equal_systems(builder):
    want, got = REUSE_BUILDERS[builder](R), REUSE_BUILDERS[builder](T)
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    if builder != "fsmc_situations":    # names repeat across situations
        w, g = R.amortized_costs(want), T.amortized_costs(got)
        close([w[s.name].total for s in want], [g[s.name].total for s in got],
              rtol=ENGINE_RTOL, what=builder)
