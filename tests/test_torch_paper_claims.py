"""The paper's stated numbers (``tests/test_paper_claims.py``) through both
packages: every quantity those 15 tests assert is computed by the JAX
package and by the port, held together at the engine's 1e-5 relative, and
the claim's own assertion is then made on the port's values.
"""
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from torch_parity import ENGINE_RTOL, close

torch.set_num_threads(1)


def _amd(c, cores, n_ccd, iod_area):
    ccd = c.make_chip("amd_ccd", [c.Module("amd_ccd_mod", 74.0, "7nm")],
                      "7nm", integration="MCM", early_defects=True)
    iod = c.make_chip(f"amd_iod_{iod_area}",
                      [c.Module(f"amd_iod_mod_{iod_area}", iod_area, "12nm")],
                      "12nm", integration="MCM", early_defects=True)
    mcm = c.System(f"amd{cores}_mcm", tuple([ccd] * n_ccd + [iod]), "MCM")
    mono = c.soc_system(f"amd{cores}_soc", 74.0 * n_ccd + iod_area, "7nm",
                        early_defects=True)
    return c.re_cost(mcm), c.re_cost(mono)


def amd_die_cost_savings(c):
    out = []
    for cores, n_ccd, iod in ((8, 1, 125.0), (16, 2, 125.0), (32, 4, 416.0)):
        mcm, soc = _amd(c, cores, n_ccd, iod)
        out.append(1.0 - mcm.die_cost / soc.die_cost)
    return out


def check_amd_die_cost_savings(s):
    assert 0.42 <= max(s) <= 0.60 and all(x > 0 for x in s)


def amd_16core_packaging_share(c):
    mcm, _ = _amd(c, 16, 2, 125.0)
    return [mcm.packaging_cost / mcm.total]


def check_amd_16core_packaging_share(s):
    assert 0.22 <= s[0] <= 0.38


def defect_share_5nm_800mm2(c):
    soc = c.re_cost(c.soc_system("s", 800.0, "5nm"))
    return [soc.chip_defects / soc.total]


def check_defect_share_5nm_800mm2(s):
    assert s[0] > 0.50


def multichip_overhead_14nm(c):
    mcm3 = c.re_cost(c.split_system("m", 900.0, "14nm", 3, "MCM"))
    d25 = c.re_cost(c.split_system("d", 900.0, "14nm", 3, "2.5D"))
    return [mcm3.packaging_cost / mcm3.total
            + 0.10 * mcm3.die_cost / mcm3.total,
            d25.packaging_cost / d25.total + 0.10]


def check_multichip_overhead_14nm(s):
    assert s[0] > 0.25 and s[1] > 0.50


def granularity_marginal_utility(c):
    m3 = c.re_cost(c.split_system("m3", 800.0, "5nm", 3, "MCM"))
    m5 = c.re_cost(c.split_system("m5", 800.0, "5nm", 5, "MCM"))
    return [(m3.chip_defects - m5.chip_defects) / m3.total,
            (m3.total - m5.total) / m3.total]


def check_granularity_marginal_utility(s):
    assert s[0] < 0.12 and s[1] < s[0]


def benefit_grows_with_area(c):
    def saving(area):
        soc = c.re_cost(c.soc_system("s", area, "5nm")).total
        mcm = c.re_cost(c.split_system("m", area, "5nm", 3, "MCM")).total
        return 1 - mcm / soc
    return [saving(800.0), saving(400.0), saving(200.0)]


def check_benefit_grows_with_area(s):
    assert s[0] > s[1] > s[2]


def nre_shares_fig6(c):
    cm = c.amortized_costs(
        [c.split_system("m", 800.0, "5nm", 2, "MCM", quantity=5e5)])["m"]
    return [cm.nre_d2d / cm.total, cm.nre_packages / cm.total,
            cm.nre_chips / cm.total]


def check_nre_shares_fig6(s):
    assert s[0] <= 0.025 and s[1] <= 0.09 and 0.25 <= s[2] <= 0.45


def soc_vs_multichip_payback(c):
    def ratio(q):
        s = c.amortized_costs(
            [c.soc_system("s", 800.0, "5nm", quantity=q)])["s"].total
        m = c.amortized_costs(
            [c.split_system("m", 800.0, "5nm", 2, "MCM",
                            quantity=q)])["m"].total
        return s / m
    return [ratio(5e5), ratio(4e6)]


def check_soc_vs_multichip_payback(s):
    assert s[0] < 1.0 < s[1]


def scms_chip_nre_saving(c):
    cm = c.amortized_costs(c.scms_systems(integration="MCM"))
    cs = c.amortized_costs(c.scms_soc_equivalents())
    return [1 - cm["scms_4x_MCM"].nre_chips / cs["scms_4x_soc"].nre_chips]


def check_scms_chip_nre_saving(s):
    assert 0.6 <= s[0] <= 0.9


def scms_package_reuse_tradeoff(c):
    plain = c.amortized_costs(c.scms_systems(integration="MCM"))
    reused = c.amortized_costs(
        c.scms_systems(integration="MCM", package_reuse=True))
    return [1 - reused["scms_4x_MCM"].nre_packages
            / plain["scms_4x_MCM"].nre_packages,
            reused["scms_1x_MCM"].total / plain["scms_1x_MCM"].total - 1]


def check_scms_package_reuse_tradeoff(s):
    assert 0.5 <= s[0] <= 0.8 and s[1] > 0.10


def scms_25d_interposer_reuse(c):
    reused = c.amortized_costs(
        c.scms_systems(integration="2.5D", package_reuse=True))
    r = reused["scms_1x_2.5D"].re
    return [r.packaging_cost / r.total]


def check_scms_25d_interposer_reuse(s):
    assert s[0] > 0.50


def ocme_nre_saving(c):
    om = c.amortized_costs(c.ocme_systems())
    os_ = c.amortized_costs(c.ocme_soc_equivalents())
    return [1 - om["ocme_CXXY_MCM"].nre_total / os_["ocme_CXXY_soc"].nre_total]


def check_ocme_nre_saving(s):
    assert 0.0 < s[0] < 0.55


def ocme_heterogeneity(c):
    het = c.amortized_costs(
        c.ocme_systems(center_process="14nm", package_reuse=True))
    hom = c.amortized_costs(c.ocme_systems(package_reuse=True))
    return [1 - het["ocme_CXXY_MCM"].total / hom["ocme_CXXY_MCM"].total,
            1 - het["ocme_C_MCM"].total / hom["ocme_C_MCM"].total]


def check_ocme_heterogeneity(s):
    assert s[0] >= 0.05 and s[1] >= 0.25


def fsmc_count_formula(c):
    return [c.fsmc_num_systems(6, 4), c.fsmc_num_systems(7, 3)]


def check_fsmc_count_formula(s):
    assert s == [209, 119]


def fsmc_reuse_lowers_nre(c):
    sits = c.fsmc_situations(n_chiplets=4, k_sockets=3, n_situations=3,
                             quantity=500_000.0)
    out = []
    for _, systems in sorted(sits.items()):
        costs = c.amortized_costs(systems)
        out.append(sum(u.nre_total for u in costs.values()) / len(costs))
    return out


def check_fsmc_reuse_lowers_nre(s):
    assert s == sorted(s, reverse=True)


CLAIMS = [amd_die_cost_savings, amd_16core_packaging_share,
          defect_share_5nm_800mm2, multichip_overhead_14nm,
          granularity_marginal_utility, benefit_grows_with_area,
          nre_shares_fig6, soc_vs_multichip_payback, scms_chip_nre_saving,
          scms_package_reuse_tradeoff, scms_25d_interposer_reuse,
          ocme_nre_saving, ocme_heterogeneity, fsmc_count_formula,
          fsmc_reuse_lowers_nre]


@pytest.mark.parametrize("claim", CLAIMS, ids=lambda f: f.__name__)
def test_paper_claim_holds_in_the_port(claim):
    want, got = claim(R), claim(T)
    assert len(got) == len(want)
    close(want, got, rtol=ENGINE_RTOL, what=claim.__name__)
    globals()["check_" + claim.__name__](got)


def test_port_engine_prices_the_claims_systems_like_the_scalar_path():
    """The SCMS / OCME groups of Figs. 8-9 through the port's batched
    engine, against its own scalar path."""
    for systems in (T.scms_systems(integration="MCM", package_reuse=True),
                    T.ocme_systems(center_process="14nm"),
                    T.scms_soc_equivalents()):
        tc = T.CostEngine().total(T.SystemBatch.from_systems(systems,
                                                             device="cpu"))
        ref = T.amortized_costs(systems)
        close([ref[s.name].total for s in systems], tc.total,
              rtol=ENGINE_RTOL, what=systems[0].name)
