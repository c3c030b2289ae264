"""The port's cost model (repro_torch.core) against the JAX package's
(repro.core): technology tables, yield curves, the spec builder, the
packing of ``SystemBatch``, the batched engine (RE in both flows, NRE,
total) and its gradients.

Both packages get the same inputs; the port runs on the CPU
(``device="cpu"``).  Tolerances are ``tests/torch_parity.py``'s: the
engine at the reference's own 1e-5 relative, packing bit-equal.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import jax_engine_reference
import repro.core as R
import repro_torch.core as T
from benchmarks.engine_bench import make_specs
from repro.core.engine import _re_impl as jax_re_impl
from repro.resilience.guards import validate_packed_arrays as jax_validate
from repro_torch.core.engine import _re_impl as torch_re_impl
from repro_torch.resilience.guards import \
    validate_packed_arrays as torch_validate
from torch_parity import ENGINE_ATOL, ENGINE_RTOL, close, equal

torch.set_num_threads(1)

CPU = "cpu"
RE_FIELDS = ("raw_chips", "chip_defects", "raw_package", "package_defects",
             "wasted_kgd")
NRE_FIELDS = ("modules", "chips", "packages", "d2d")
SPECS = make_specs(500)


def test_chip_smoke_prices_engine_bench_specs():
    """chip_smoke.py keeps its own copy of the benchmark's design points."""
    assert chip_smoke.make_specs(2000) == make_specs(2000)


def hetero_group(core):
    """``tests/test_engine.py``'s SoC / MCM / InFO / 2.5D fixture, built by
    one package's own builders."""
    return [
        core.soc_system("soc", 800.0, "5nm", quantity=1e6),
        core.split_system("mcm", 800.0, "5nm", 3, "MCM", quantity=1e6),
        core.split_system("info", 600.0, "7nm", 2, "InFO", quantity=5e5),
        core.split_system("d25", 600.0, "5nm", 4, "2.5D", quantity=1e6),
        core.spec({"kind": "split", "name": "het", "area": 700.0,
                   "fractions": [0.5, 0.3, 0.2],
                   "processes": ["5nm", "7nm", "12nm"],
                   "integration": "2.5D", "quantity": 1e6}),
        core.spec({"kind": "chips", "name": "forced_pkg",
                   "chips": [{"area": 150.0, "process": "7nm"},
                             {"area": 90.0, "process": "12nm"}],
                   "integration": "MCM", "quantity": 2e5,
                   "package_area": 1200.0}),
    ]


def assert_batches_equal(jb, tb):
    assert tb.names == jb.names
    assert tb.device == torch.device(CPU)
    for f in R.SystemBatch._LEAVES:
        equal(getattr(jb, f), getattr(tb, f), what=f)


# -- technology, yield, spec ---------------------------------------------------


@pytest.mark.parametrize("name", sorted(R.PROCESS_NODES))
def test_process_nodes_equal(name):
    assert dataclasses.asdict(T.node(name)) == \
        dataclasses.asdict(R.node(name))


@pytest.mark.parametrize("name", sorted(R.INTEGRATION_TECHS))
def test_integration_techs_equal(name):
    assert dataclasses.asdict(T.tech(name)) == \
        dataclasses.asdict(R.tech(name))
    assert sorted(T.INTEGRATION_TECHS) == sorted(R.INTEGRATION_TECHS)
    assert sorted(T.PROCESS_NODES) == sorted(R.PROCESS_NODES)


@pytest.mark.parametrize("lookup", ["node", "tech"])
def test_unknown_technology_messages_equal(lookup):
    with pytest.raises(KeyError) as want:
        getattr(R, lookup)("3nm")
    with pytest.raises(KeyError) as got:
        getattr(T, lookup)("3nm")
    assert str(got.value) == str(want.value)


def _yield_grid():
    rng = np.random.default_rng(0)
    areas = rng.uniform(1.0, 900.0, 256).astype(np.float32)
    d0 = rng.uniform(0.01, 0.3, 256).astype(np.float32)
    return areas, d0


YIELD_CALLS = {
    "negative_binomial": lambda m, a, d: m.yield_negative_binomial(a, d, 3.0),
    "negative_binomial_c2": lambda m, a, d: m.yield_negative_binomial(a, d,
                                                                      2.0),
    "poisson": lambda m, a, d: m.yield_poisson(a, d),
    "murphy": lambda m, a, d: m.yield_murphy(a, d),
    "murphy_tiny": lambda m, a, d: m.yield_murphy(a * 1e-9, d),
    "dies_per_wafer": lambda m, a, d: m.dies_per_wafer(a),
    "dies_per_wafer_huge": lambda m, a, d: m.dies_per_wafer(a * 100.0),
    "raw_die_cost": lambda m, a, d: m.raw_die_cost(a, 9346.0),
    "good_die_cost": lambda m, a, d: m.good_die_cost(a, 9346.0, d),
}


@pytest.mark.parametrize("fn", sorted(YIELD_CALLS))
def test_yield_functions_match_reference(fn):
    areas, d0 = _yield_grid()
    want = YIELD_CALLS[fn](R, jnp.asarray(areas), jnp.asarray(d0))
    got = YIELD_CALLS[fn](T, torch.from_numpy(areas), torch.from_numpy(d0))
    assert got.dtype == torch.float32
    close(want, got, rtol=1e-6, what=fn)


def test_yield_functions_take_python_floats():
    for fn in YIELD_CALLS:
        want = YIELD_CALLS[fn](R, 420.0, 0.11)
        got = YIELD_CALLS[fn](T, 420.0, 0.11)
        assert got.dtype == torch.float32 and got.device.type == CPU
        close(want, got, rtol=1e-6, what=fn)
    assert float(T.yield_murphy(1e-9, 1e-9)) <= 1.0
    assert float(T.dies_per_wafer(1e7)) == 1.0


SPEC_CASES = [
    {"kind": "soc", "name": "a", "area": 640.0, "process": "7nm",
     "quantity": 2e5},
    {"area": 300.0, "process": "5nm", "early": True},
    {"name": "y", "area": 640.0, "process": "7nm", "n": 4,
     "integration": "InFO", "quantity": 2e5},
    {"kind": "split", "name": "r", "area": 500.0, "process": "7nm", "n": 3,
     "integration": "MCM", "reuse_chiplet": True, "d2d_overhead": 0.2},
    {"name": "h", "area": 700.0, "fractions": [0.5, 0.3, 0.2],
     "processes": ["5nm", "7nm", "12nm"], "integration": "2.5D"},
    {"kind": "chips", "name": "c", "integration": "MCM",
     "chips": [{"area": 150.0, "process": "7nm", "early": True},
               {"name": "io", "area": 90.0, "process": "12nm",
                "d2d_overhead": 0.0}],
     "package_name": "shared", "package_area": 1200.0},
]


@pytest.mark.parametrize("d", SPEC_CASES, ids=range(len(SPEC_CASES)))
def test_spec_builds_equal_systems(d):
    want, got = R.spec(d), T.spec(d)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.package_id == want.package_id
    assert got.silicon_area_mm2 == want.silicon_area_mm2


BAD_SPECS = [
    {"kind": "soc", "area": 100.0, "process": "7nm", "typo": 1},
    {"kind": "split", "area": 100.0, "process": "7nm", "n": 3,
     "fractions": [0.5, 0.5], "integration": "MCM"},
    {"kind": "soc", "process": "7nm"},
    {"kind": "split", "area": 100.0, "integration": "MCM", "n": 0},
    {"kind": "split", "area": 100.0, "integration": "MCM", "n": 2},
    {"kind": "split", "area": 100.0, "process": "7nm", "integration": "MCM",
     "fractions": [0.6, 0.4], "reuse_chiplet": True},
    {"kind": "chips", "integration": "MCM",
     "chips": [{"area": 10.0, "process": "7nm", "bad": 1}]},
    {"kind": "wafer", "area": 1.0},
]


@pytest.mark.parametrize("d", BAD_SPECS, ids=range(len(BAD_SPECS)))
def test_spec_errors_equal(d):
    with pytest.raises(ValueError) as want:
        R.spec(d)
    with pytest.raises(ValueError) as got:
        T.spec(d)
    assert str(got.value) == str(want.value)


# -- SystemBatch packing -------------------------------------------------------


@pytest.mark.parametrize("share", [True, False, "groups"])
def test_from_systems_packs_bit_equal(share):
    groups = [i % 3 for i in range(len(SPECS[:60]))]
    mode = groups if share == "groups" else share
    jb = R.SystemBatch.from_systems([R.spec(d) for d in SPECS[:60]],
                                    share_nre=mode)
    tb = T.SystemBatch.from_systems([T.spec(d) for d in SPECS[:60]],
                                    share_nre=mode, device=CPU)
    assert_batches_equal(jb, tb)


def test_from_systems_fixture_and_max_chips_bit_equal():
    jb = R.SystemBatch.from_systems(hetero_group(R), max_chips=6)
    tb = T.SystemBatch.from_systems(hetero_group(T), max_chips=6, device=CPU)
    assert_batches_equal(jb, tb)
    assert (tb.n_systems, tb.max_chips, len(tb)) == (6, 6, 6)
    equal(jb.n_chips, tb.n_chips, what="n_chips")


@pytest.mark.parametrize("share", [False, True])
def test_from_specs_packs_bit_equal(share):
    specs = [{k: v for k, v in d.items() if k != "name"} for d in SPECS[:40]]
    assert_batches_equal(R.SystemBatch.from_specs(specs, share_nre=share),
                         T.SystemBatch.from_specs(specs, share_nre=share,
                                                  device=CPU))


def test_from_specs_defaults_to_standalone_groups():
    specs = [SPECS[1], SPECS[5]]
    assert_batches_equal(R.SystemBatch.from_specs(specs),
                         T.SystemBatch.from_specs(specs, device=CPU))
    assert_batches_equal(R.SystemBatch.from_systems([R.spec(d) for d in specs]),
                         T.SystemBatch.from_systems([T.spec(d) for d in specs],
                                                    device=CPU))


def test_from_arrays_takes_a_jax_batch():
    jb = R.SystemBatch.from_specs(SPECS[:30])
    leaves = {f: np.asarray(jax.device_get(getattr(jb, f)))
              for f in R.SystemBatch._LEAVES}
    tb = T.SystemBatch.from_arrays(names=jb.names, device=CPU, **leaves)
    assert_batches_equal(jb, tb)
    # tensors already on the device in their type are taken as they are
    again = T.SystemBatch.from_arrays(
        device=CPU, **{f: getattr(tb, f) for f in T.SystemBatch._LEAVES})
    assert again.chip_area is tb.chip_area


@pytest.mark.parametrize("bad", ["missing", "extra", "rank", "shape", "1d"])
def test_from_arrays_errors_equal(bad):
    jb = R.SystemBatch.from_specs(SPECS[:4])
    leaves = {f: np.asarray(getattr(jb, f)) for f in R.SystemBatch._LEAVES}
    if bad == "missing":
        del leaves["quantity"]
    elif bad == "extra":
        leaves["typo"] = leaves["quantity"]
    elif bad == "rank":
        leaves["chip_area"] = leaves["chip_area"][0]
    elif bad == "shape":
        leaves["quantity"] = leaves["quantity"][:2]
    else:
        leaves["mod_sys"] = leaves["mod_sys"][:, None]
    with pytest.raises(ValueError) as want:
        R.SystemBatch.from_arrays(**leaves)
    with pytest.raises(ValueError) as got:
        T.SystemBatch.from_arrays(device=CPU, **leaves)
    assert str(got.value) == str(want.value)


PAD_CASES = [
    dict(n_systems=9),
    dict(n_systems=9, max_chips=7, chip_entities=40, pkg_entities=12,
         mod_entities=40, mod_instances=40, d2d_entities=30,
         d2d_instances=30),
    dict(mod_entities=30, mod_instances=30, d2d_entities=20,
         d2d_instances=40),
]


@pytest.mark.parametrize("kw", PAD_CASES, ids=range(len(PAD_CASES)))
def test_pad_batch_bit_equal_and_cost_neutral(kw):
    jb = R.pad_batch(R.SystemBatch.from_specs(SPECS[:6]), **kw)
    tb = T.pad_batch(T.SystemBatch.from_specs(SPECS[:6], device=CPU), **kw)
    assert_batches_equal(jb, tb)
    close(R.CostEngine().total(jb).total, T.CostEngine().total(tb).total,
          rtol=ENGINE_RTOL, atol=ENGINE_ATOL, what="padded total")


@pytest.mark.parametrize("kw", [dict(n_systems=2), dict(mod_instances=99)])
def test_pad_batch_errors_equal(kw):
    with pytest.raises(ValueError) as want:
        R.pad_batch(R.SystemBatch.from_specs(SPECS[:6]), **kw)
    with pytest.raises(ValueError) as got:
        T.pad_batch(T.SystemBatch.from_specs(SPECS[:6], device=CPU), **kw)
    assert str(got.value) == str(want.value)


def _bad_system(core, what):
    good = core.split_system("x", 400.0, "7nm", 2, "MCM")
    if what == "quantity":
        return dataclasses.replace(good, quantity=-1.0)
    if what == "nan_area":
        m = core.Module("nan_mod", float("nan"), "7nm")
        chip = core.make_chip("nan_chip", [m], "7nm", integration="MCM")
        return dataclasses.replace(good, chips=(chip, good.chips[0]))
    if what == "package_area":
        return dataclasses.replace(good, package_area_mm2=-5.0)
    raise AssertionError(what)


@pytest.mark.parametrize("what", ["quantity", "nan_area", "package_area"])
def test_from_systems_validation_messages_equal(what):
    with pytest.raises(ValueError) as want:
        R.SystemBatch.from_systems([_bad_system(R, what)])
    with pytest.raises(ValueError) as got:
        T.SystemBatch.from_systems([_bad_system(T, what)], device=CPU)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["groups_len", "dup", "dup_group",
                                  "wide", "empty"])
def test_from_systems_argument_errors_equal(case):
    def build(core):
        s = [core.soc_system("a", 100.0, "7nm"),
             core.soc_system("b" if case == "groups_len" else "a", 100.0,
                             "7nm")]
        return {"groups_len": dict(systems=s, share_nre=[0]),
                "dup": dict(systems=s, share_nre=True),
                "dup_group": dict(systems=s, share_nre=[1, 1]),
                "wide": dict(systems=s, max_chips=0),
                "empty": dict(systems=[])}[case]
    with pytest.raises(ValueError) as want:
        R.SystemBatch.from_systems(**build(R))
    with pytest.raises(ValueError) as got:
        T.SystemBatch.from_systems(device=CPU, **build(T))
    assert str(got.value) == str(want.value)


def test_validate_packed_arrays_messages_equal():
    rng = np.random.default_rng(3)
    n, c = 5, 3
    chip = {k: rng.uniform(0.1, 0.9, (n, c)).astype(np.float32) for k in
            ("area", "defect", "wafer_cost", "cluster", "wafer_yield",
             "sort_cost", "bump_cost")}
    chip["mask"] = np.ones((n, c), np.float32)
    system = {k: rng.uniform(0.1, 0.9, n).astype(np.float32) for k in
              ("package_area", "package_area_factor", "substrate_cost",
               "substrate_layer", "interposer_cost", "interposer_defect",
               "interposer_area_factor", "interposer_cluster",
               "y2_chip_bond", "y3_substrate_bond", "assembly_yield",
               "bond_cost_per_chip", "quantity")}
    names = [f"n{i}" for i in range(n)]
    assert torch_validate(chip, system, names) == [] == \
        jax_validate(chip, system, names)
    chip["area"][1, 2] = -3.0
    chip["wafer_yield"][2, 0] = 1.5
    chip["defect"][4, 1] = -1.0
    chip["mask"][4, 1] = 0.0            # a padded slot is never an offender
    system["assembly_yield"][3] = 0.0
    system["package_area_factor"][0] = 0.0
    system["quantity"][:] = -1.0        # two offenders a key are reported,
    system["substrate_cost"][:] = -2.0  # eight in all
    system["y2_chip_bond"][1] = 2.0
    want = jax_validate(chip, system, names)
    assert len(want) == 8
    assert torch_validate(chip, system, names) == want
    chip["cluster"][0, 0] = np.nan      # non-finite values are reported first
    want = jax_validate(chip, system, names)
    assert want == ["system 'n0': cluster[0] = nan"]
    assert torch_validate(chip, system, names) == want


# -- the engine ----------------------------------------------------------------


def _both(systems_fn, **kw):
    return (R.SystemBatch.from_systems(systems_fn(R), **kw),
            T.SystemBatch.from_systems(systems_fn(T), device=CPU, **kw))


def _bench_systems(share):
    def build(core):
        return [core.spec(d) for d in SPECS]
    return _both(build, share_nre=share)


@pytest.mark.parametrize("flow", ["chip-last", "chip-first"])
@pytest.mark.parametrize("case", ["bench_standalone", "bench_shared",
                                  "fixture"])
def test_engine_re_matches_jax_and_scalar_path(case, flow):
    if case == "fixture":
        jb, tb = _both(hetero_group)
        systems = hetero_group(T)
    else:
        jb, tb = _bench_systems(case == "bench_shared")
        systems = [T.spec(d) for d in SPECS[::25]]
    want = R.CostEngine(flow=flow).re(jb)
    got = T.CostEngine(flow=flow).re(tb)
    for f in RE_FIELDS + ("total", "die_cost", "packaging_cost"):
        close(getattr(want, f), getattr(got, f), rtol=ENGINE_RTOL,
              atol=ENGINE_ATOL, what=f)
    step = 1 if case == "fixture" else 25
    for i, s in enumerate(systems):
        ref = T.re_cost(s, flow=flow)
        for f in RE_FIELDS:
            close(getattr(ref, f), getattr(got, f)[i * step],
                  rtol=ENGINE_RTOL, atol=ENGINE_ATOL, what=f"{s.name} {f}")


@pytest.mark.parametrize("case", ["bench_standalone", "bench_shared",
                                  "fixture", "scms_package_reuse"])
def test_engine_nre_and_total_match_jax_and_scalar_path(case):
    if case == "fixture":
        jb, tb = _both(hetero_group)
    elif case == "scms_package_reuse":
        jb, tb = _both(lambda c: c.scms_systems(integration="2.5D",
                                                package_reuse=True))
    else:
        jb, tb = _bench_systems(case == "bench_shared")
    want, got = R.CostEngine().total(jb), T.CostEngine().total(tb)
    for f in NRE_FIELDS + ("total",):
        close(getattr(want.nre, f), getattr(got.nre, f), rtol=ENGINE_RTOL,
              atol=ENGINE_ATOL, what=f"nre.{f}")
    close(want.total, got.total, rtol=ENGINE_RTOL, what="total")
    nre = T.CostEngine().nre(tb)
    for f in NRE_FIELDS:
        equal(getattr(got.nre, f), getattr(nre, f), what=f)
    # the scalar path: one group when shared, else each system alone
    if case == "bench_standalone":
        picks = [T.spec(d) for d in SPECS[::25]]
        ref = {s.name: T.amortized_costs([s])[s.name] for s in picks}
        rows = range(0, len(SPECS), 25)
    else:
        systems = hetero_group(T) if case == "fixture" else (
            T.scms_systems(integration="2.5D", package_reuse=True)
            if case == "scms_package_reuse" else [T.spec(d) for d in SPECS])
        ref = T.amortized_costs(systems)
        rows = range(len(systems)) if len(systems) < 50 \
            else range(0, len(systems), 25)
    names = list(tb.names)
    for i in rows:
        r = ref[names[i]]
        for f, v in (("modules", r.nre_modules), ("chips", r.nre_chips),
                     ("packages", r.nre_packages), ("d2d", r.nre_d2d)):
            close(v, getattr(got.nre, f)[i], rtol=ENGINE_RTOL, atol=1e-6,
                  what=f"{names[i]} nre.{f}")
        close(r.total, got.total[i], rtol=ENGINE_RTOL, what=names[i])


@pytest.mark.parametrize("shared", [False, True])
def test_engine_on_engine_bench_10k_matches_jax(shared):
    """engine_bench's whole 10^4-system sweep, the reference's packing
    carried across through ``from_arrays``.  Shared, each D2D volume sum
    runs over thousands of systems, in float32 as the reference's does."""
    leaves, want = jax_engine_reference.reference(10_000, shared)
    tc = T.CostEngine().total(T.SystemBatch.from_arrays(device=CPU, **leaves))
    got = {f: getattr(tc.re, f) for f in RE_FIELDS}
    got.update({f"nre_{f}": getattr(tc.nre, f) for f in NRE_FIELDS})
    got["total"] = tc.total
    assert sorted(got) == sorted(want)
    for f, w in want.items():
        close(w, got[f], rtol=ENGINE_RTOL, atol=ENGINE_ATOL, what=f)


def test_engine_as_rows_match_jax():
    jb, tb = _both(hetero_group)
    want = R.CostEngine().as_rows(jb)
    got = T.CostEngine().as_rows(tb)
    assert [list(r) for r in got] == [list(r) for r in want]
    for w, g in zip(want, got):
        assert g["system"] == w["system"]
        close([w[k] for k in w if k != "system"],
              [g[k] for k in g if k != "system"], rtol=ENGINE_RTOL,
              atol=1e-6, what=w["system"])


def test_engine_portfolio_totals_and_finite_rows_match_jax():
    rng = np.random.default_rng(5)
    u = rng.uniform(1.0, 100.0, 12).astype(np.float32)
    q = rng.uniform(1e3, 1e6, 4).astype(np.float32)
    close(R.engine.portfolio_totals(u, q),
          T.engine.portfolio_totals(torch.from_numpy(u), torch.from_numpy(q)),
          rtol=ENGINE_RTOL, what="portfolio_totals")
    a = np.array([1.0, np.nan, 3.0, np.inf], np.float32)
    b = np.ones((4, 2), np.float32)
    b[2, 1] = np.nan
    equal(R.engine.finite_rows(a, b),
          T.engine.finite_rows(torch.from_numpy(a), torch.from_numpy(b)),
          what="finite_rows")


def test_batch_to_and_replace_keep_leaves():
    tb = T.SystemBatch.from_specs(SPECS[:3], device=CPU)
    moved = tb.to(CPU)
    assert moved.names == tb.names and moved.device == tb.device
    doubled = tb.replace(quantity=tb.quantity * 2.0)
    assert doubled.chip_area is tb.chip_area
    equal(tb.quantity * 2.0, doubled.quantity, what="quantity")


# -- gradients -----------------------------------------------------------------

RELAXED_CASES = [("5nm", "MCM", 800.0, 2.7, "chip-last"),
                 ("7nm", "InFO", 500.0, 3.2, "chip-last"),
                 ("5nm", "2.5D", 650.0, 1.6, "chip-first"),
                 ("14nm", "SoC", 300.0, 1.0, "chip-last")]


def _relaxed(core, n, process, integration, area, flow):
    nd, t = core.node(process), core.tech(integration)
    return core.re_split_relaxed(
        area, n, wafer_cost=nd.wafer_cost, defect_density=nd.defect_density,
        cluster=nd.cluster_param, tech_params=t, wafer_yield=nd.wafer_yield,
        sort_cost=nd.wafer_sort_cost, bump_cost=nd.bump_cost_per_mm2,
        interposer_cluster=core.node(t.interposer_node).cluster_param,
        flow=flow)


@pytest.mark.parametrize("process,integration,area,n,flow", RELAXED_CASES)
def test_re_split_relaxed_and_its_gradient_match_jax(process, integration,
                                                     area, n, flow):
    args = (process, integration, area, flow)
    want = _relaxed(R, jnp.float32(n), *args)
    x = torch.tensor(n, requires_grad=True)
    got = _relaxed(T, x, *args)
    for k in RE_FIELDS + ("total",):
        close(want[k], got[k], rtol=ENGINE_RTOL, what=k)
    want_g = jax.grad(lambda v: _relaxed(R, v, *args)["total"])(
        jnp.float32(n))
    (got_g,) = torch.autograd.grad(got["total"], x)
    close(want_g, got_g, rtol=1e-4, what="d total / d n")
    assert torch.isfinite(got_g)


def test_re_cost_split_deprecated_shim_matches_jax():
    kw = dict(wafer_cost=R.node("5nm").wafer_cost, defect_density=0.11,
              cluster=3.0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = R.re_cost_split(800.0, 3.0, tech_params=R.tech("MCM"), **kw)
        got = T.re_cost_split(800.0, 3.0, tech_params=T.tech("MCM"),
                              device=CPU, **kw)
    assert sum(issubclass(w.category, DeprecationWarning)
               for w in caught) == 2
    for k in RE_FIELDS + ("total",):
        close(want[k], got[k], rtol=ENGINE_RTOL, what=k)


@pytest.mark.parametrize("flow", ["chip-last", "chip-first"])
def test_engine_gradient_in_chip_area_matches_jax(flow):
    jb, tb = _both(hetero_group)

    def jax_total(areas):
        return jax_re_impl(jb.replace(chip_area=areas), flow).total.sum()

    want = jax.grad(jax_total)(jb.chip_area)
    areas = tb.chip_area.clone().requires_grad_(True)
    total = torch_re_impl(tb.replace(chip_area=areas), flow).total.sum()
    close(jax_total(jb.chip_area), total, rtol=ENGINE_RTOL, what="total")
    (got,) = torch.autograd.grad(total, areas)
    close(want, got, rtol=1e-4, atol=1e-6, what="d total / d chip_area")
    assert bool((got[tb.chip_mask > 0] > 0).all())


@pytest.mark.parametrize("n, segments", [(50_000, 20_000), (1_000, 10),
                                         (5, 100), (0, 4)])
def test_sorted_segment_sums_equal_index_add_bit_for_bit(n, segments):
    """The card's deterministic segment sums (sort, counts,
    segment_reduce), run here on the CPU: bit-equal to the serial
    index_add, zeros, empty segments and one long segment included."""
    from repro_torch.core.engine import _sorted_segment_sum
    g = torch.Generator().manual_seed(n)
    ids = torch.randint(0, segments, (n,), generator=g, dtype=torch.int32)
    ids[: n // 4] = 0                      # one long segment
    values = torch.rand(n, generator=g) * 1e5
    values[::3] = 0.0                      # padded slots' zeros
    want = torch.zeros(segments).index_add(0, ids, values)
    got = _sorted_segment_sum(values, ids, segments)
    assert got.dtype == want.dtype and torch.equal(got, want)
