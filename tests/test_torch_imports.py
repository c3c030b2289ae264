"""Guards of the port's boundaries: it imports neither JAX nor the JAX
package, and its entry points do not fall back to the CPU."""
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pathlib, sys
sys.path[:0] = [{root!r}, {src!r}]
pkg = pathlib.Path({src!r}) / "repro_torch"
for f in sorted(pkg.rglob("*.py")):
    mod = ".".join(f.relative_to(pkg.parent).with_suffix("").parts)
    importlib.import_module(mod.removesuffix(".__init__"))
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    code = _IMPORT_ALL.format(root=str(ROOT), src=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_serve_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="GPU"):
        serve.main(["--smoke", "--requests", "1"])


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_repo(alone, tmp_path):
    """chip_smoke.py exits nonzero and prints no result without a card, and
    when it stands in a directory without the rest of the repository."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("with a GPU here the script would run in full")
    script = ROOT / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path))
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _cost_model_entry(name):
    from repro_torch import core
    from repro_torch.core.gradient import optimize_chiplet_count
    return {
        "SystemBatch.from_specs": lambda: core.SystemBatch.from_specs(
            [{"kind": "soc", "area": 100.0, "process": "7nm"}]),
        "SystemBatch.from_systems": lambda: core.SystemBatch.from_systems(
            [core.soc_system("a", 100.0, "7nm")]),
        "sweep_partitions": lambda: core.sweep_partitions(
            "5nm", "MCM", [800.0], [1, 2]),
        "best_partition": lambda: core.best_partition("5nm", "MCM", 800.0),
        "cost_area_curve": lambda: core.cost_area_curve("5nm", [100.0]),
        "optimize_chiplet_count": lambda: optimize_chiplet_count(
            "5nm", "MCM", 800.0),
        "price_accelerators": lambda: core.price_accelerators(
            core.AcceleratorSpec("acc")),
        "re_split_relaxed": lambda: core.re_split_relaxed(
            800.0, 3.0, wafer_cost=1.0, defect_density=0.1, cluster=3.0,
            tech_params=core.tech("MCM")),
    }[name]


@pytest.mark.parametrize("entry", [
    "SystemBatch.from_specs", "SystemBatch.from_systems", "sweep_partitions",
    "best_partition", "cost_area_curve", "optimize_chiplet_count",
    "price_accelerators", "re_split_relaxed"])
def test_cost_model_entry_points_raise_without_a_card(entry):
    """The cost model's entry points default to the GPU and raise without
    one; only device="cpu" prices on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    with pytest.raises(RuntimeError, match="GPU"):
        _cost_model_entry(entry)()
