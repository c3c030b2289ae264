"""Guards of the port's boundaries: it imports neither JAX nor the JAX
package, its entry points do not fall back to the CPU, and chip_smoke.py
fails without a card (its DSE phase rehearses with the CPU in the card's
place)."""
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


def _dse_entry(name):
    import numpy as np
    from repro_torch import dse
    from repro_torch import random as prng
    from repro_torch.core import optimize_uneven_split
    from repro_torch.launch import portfolio_search as launch
    space = dse.DesignSpace(skus=(dse.SKU("a", 100.0, 1e5),))
    return {
        "PRNGKey": lambda: prng.PRNGKey(0),
        "ChunkedEvaluator": lambda: dse.ChunkedEvaluator(space),
        "encode_batch": lambda: dse.encode_batch(space, np.arange(2)),
        "evaluate_direct": lambda: dse.evaluate_direct(
            space, space.candidate_at(0)),
        "exhaustive_search": lambda: dse.exhaustive_search(space),
        "portfolio_search": lambda: dse.portfolio_search(
            space, np.zeros(2, np.uint32)),
        "detail_rows": lambda: dse.detail_rows(space, space.candidate_at(0)),
        "optimize_uneven_split": lambda: optimize_uneven_split(
            "5nm", "MCM", [100.0, 50.0], 2),
        "launch.portfolio_search": lambda: launch.main([]),
    }[name]


@pytest.mark.parametrize("entry", [
    "PRNGKey", "ChunkedEvaluator", "encode_batch", "evaluate_direct",
    "exhaustive_search", "portfolio_search", "detail_rows",
    "optimize_uneven_split", "launch.portfolio_search"])
def test_dse_entry_points_raise_without_a_card(entry):
    """The design-space exploration defaults to the GPU too and raises
    without one: no step of it falls back to the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    with pytest.raises(RuntimeError, match="GPU"):
        _dse_entry(entry)()


def test_chip_smoke_phase_12_rehearses_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 12 with the CPU in the card's place (CUDA
    events, syncs and the profiler stubbed): every step runs and holds."""
    import time

    import chip_smoke

    class Event:
        def __init__(self, **_):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "median_event_ms",
                        lambda fn, **_: chip_smoke.cpu_ms(fn))
    monkeypatch.setattr(chip_smoke, "device_busy",
                        lambda fn: (fn(), 0, 0.0, [])[1:])
    out = chip_smoke.phase_dse(0, "CPU rehearsal", card_dev="cpu")
    assert out["winner"] == "reuse[150mm2/12nm/MCM]"
    assert "history as on the CPU" in capsys.readouterr().out


def _service_entry(name):
    from repro_torch import dse, service
    from repro_torch.launch import pricing_service as launch
    space = dse.DesignSpace(skus=(dse.SKU("a", 100.0, 1e5),))
    return {
        "PricingService": lambda: service.PricingService(space),
        "serve": lambda: service.serve(
            space, [service.PriceRequest(indices=[0])]),
        "launch.pricing_service": lambda: launch.main([]),
    }[name]


@pytest.mark.parametrize("entry", ["PricingService", "serve",
                                   "launch.pricing_service"])
def test_service_entry_points_raise_without_a_card(entry):
    """The pricing service defaults to the GPU and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    with pytest.raises(RuntimeError, match="GPU"):
        _service_entry(entry)()


NEW_MODULES = [
    "repro_torch.resilience.faults", "repro_torch.resilience.retry",
    "repro_torch.resilience.watchdog", "repro_torch.resilience.guards",
    "repro_torch.obs.registry", "repro_torch.obs.flight",
    "repro_torch.obs.ledger", "repro_torch.obs.slo",
    "repro_torch.obs.torchhooks", "repro_torch.service",
    "repro_torch.service.protocol", "repro_torch.service.scheduler",
    "repro_torch.service.cache", "repro_torch.service.durability",
    "repro_torch.service.metrics", "repro_torch.service.server",
    "repro_torch.launch.pricing_service"]


def test_service_slice_modules_are_ported():
    """Every module of the service slice exists and imports; that none of
    them imports JAX is held by test_port_and_chip_smoke_import_no_jax,
    which imports every module of the port in one fresh interpreter."""
    import importlib
    for mod in NEW_MODULES:
        path = ROOT / "src" / (mod.replace(".", "/") + ".py")
        assert path.exists() or (path.with_suffix("") / "__init__.py"
                                 ).exists(), mod
        importlib.import_module(mod)


def test_chip_smoke_phase_13_rehearses_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 13 with the CPU in the card's place (syncs,
    sync debug mode and the profiler stubbed): the full diet, the direct
    APIs, the chaos schedule and the crash replay all hold."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "device_busy",
                        lambda fn: (fn(), 0, 0.0, [])[1:])
    out = chip_smoke.phase_service(0, "CPU rehearsal", card_dev="cpu")
    assert out["vs_single_client"] >= 0.5
    assert set(out["ticks_by_lane"]) == {"chunk", "mc", "gen", "raw"}
    text = capsys.readouterr().out
    assert "bit-equal to the direct APIs" in text
    assert "every answer equal to an uncrashed run's" in text


TRAIN_MODULES = [
    "repro_torch.data", "repro_torch.data.pipeline", "repro_torch.optim",
    "repro_torch.optim.adamw", "repro_torch.optim.schedule",
    "repro_torch.optim.compression", "repro_torch.parallel",
    "repro_torch.parallel.steps", "repro_torch.tree",
    "repro_torch.launch.train"]


def test_training_slice_modules_are_ported():
    """Every module of the training slice exists and imports; the import
    test above holds that none of them (nor the additions to models/,
    convert.py and checkpoint/) imports JAX or the JAX package."""
    import importlib
    for mod in TRAIN_MODULES:
        path = ROOT / "src" / (mod.replace(".", "/") + ".py")
        assert path.exists() or (path.with_suffix("") / "__init__.py"
                                 ).exists(), mod
        importlib.import_module(mod)
    from repro_torch.models import api, transformer
    from repro_torch import convert
    assert callable(api.loss_fn) and callable(api.input_spec)
    assert callable(transformer.lm_loss)
    assert callable(convert.train_state_from_numpy)


def _train_entry(name):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import train
    from repro_torch.parallel import steps
    cfg = get_config("glm4_9b").reduced()
    return {
        "launch.train": lambda: train.main(["--smoke", "--steps", "1"]),
        "materialize_batch": lambda: steps.materialize_batch(
            cfg, InputShape("x", 16, 2, "train")),
    }[name]


@pytest.mark.parametrize("entry", ["launch.train", "materialize_batch"])
def test_training_entry_points_raise_without_a_card(entry):
    """The trainer defaults to the GPU and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    with pytest.raises(RuntimeError, match="GPU"):
        _train_entry(entry)()


def test_chip_smoke_phase_14_rehearses_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 14 with the CPU in the card's place and the
    reduced configs (syncs and memory statistics stubbed): the cut against
    the CPU, the training run, the launcher's run and resume and the resume
    property all hold."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    out = chip_smoke.phase_train(0, "CPU rehearsal", card_dev="cpu",
                                 smoke=True)
    assert len(out["full"]["losses"]) == chip_smoke.TRAIN_STEPS
    assert out["launcher"]["returns"] == [0, 0]
    assert out["resume_worst"] <= 1e-6
    text = capsys.readouterr().out
    assert "[resume] restored step 8" in text


def test_chip_smoke_new_family_phases_rehearse_on_the_cpu(monkeypatch,
                                                          capsys):
    """chip_smoke.py's phases 17-20 on the CPU at the reduced configs
    (syncs and memory statistics stubbed): the VLM cut with image patches
    (both sides on the CPU), the image request through the API, and
    Whisper's cut, served run and training; phase 15's MLA cut is phase
    3's code on another config."""
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.common import init_params

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    cfg = get_config("llava_next_mistral_7b").reduced().replace(
        dtype="float32", attn_impl="kernel")
    params = init_params(api.param_spec(cfg), torch.Generator().manual_seed(
        0), "cpu")
    prompt = torch.randint(0, cfg.vocab, (12,)).numpy()
    img = torch.randn(1, cfg.n_img_patches, cfg.d_model).numpy()
    logits, tokens = chip_smoke.run_greedy(cfg, params, prompt, 40, 3, img)
    assert len(logits) == 4 and len(tokens) == 3
    launched = chip_smoke.vlm_image_request(cfg, params, text=12)
    assert launched == chip_smoke.structure_launches(cfg, 0, 0)  # CPU: none
    chip_smoke.phase_whisper_cut(0, card_dev="cpu", smoke=True)
    out = chip_smoke.phase_whisper(0, "CPU rehearsal", card_dev="cpu",
                                   smoke=True)
    assert len(out["losses"]) == 2 and out["losses"][1] < out["losses"][0]
    text = capsys.readouterr().out
    assert "tokens equal" in text and "AdamW" in text


MESH_MODULES = [
    "repro_torch.parallel.comm", "repro_torch.parallel.sharding",
    "repro_torch.parallel.collectives", "repro_torch.parallel.pipeline",
    "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
    "repro_torch.analysis", "repro_torch.analysis.hlo",
    "repro_torch.analysis.roofline"]


def test_mesh_slice_modules_are_ported():
    """Every module of the mesh slice exists and imports;
    test_port_and_chip_smoke_import_no_jax holds that none of them (nor the
    additions to configs/, models/common.py, parallel/steps.py,
    checkpoint/ and launch/train.py) imports JAX or the JAX package."""
    import importlib
    for mod in MESH_MODULES:
        path = ROOT / "src" / (mod.replace(".", "/") + ".py")
        assert path.exists() or (path.with_suffix("") / "__init__.py"
                                 ).exists(), mod
        importlib.import_module(mod)
    from repro_torch.configs import SHAPES, cell_supported
    from repro_torch.models.common import abstract_params, param_axes
    assert set(SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                           "long_500k"}
    assert callable(cell_supported) and callable(abstract_params) \
        and callable(param_axes)


_DRYRUN_NO_JAX = r"""
import sys
sys.path[:0] = [{src!r}]
from repro_torch.launch import dryrun
rc = dryrun.main(["--arch", "xlstm_125m", "--shape", "decode_32k",
                  "--out", {out!r}])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad)
sys.exit(rc or (1 if bad else 0))
"""


def test_dryrun_entry_point_runs_without_jax(tmp_path):
    """The dry run's entry point traces a cell in a fresh interpreter and
    loads no JAX module on the way; it needs no card (fake tensors)."""
    code = _DRYRUN_NO_JAX.format(src=str(ROOT / "src"),
                                 out=str(tmp_path / "dr.json"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_make_mesh_raises_without_a_card():
    """A mesh is on the card (NCCL) unless device="cpu" names gloo."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    from repro_torch.launch.mesh import make_mesh
    with pytest.raises(RuntimeError, match="GPU"):
        make_mesh((1, 1), ("data", "model"))


def test_production_mesh_is_abstract_without_its_ranks():
    from repro_torch.launch.mesh import describe, make_production_mesh
    single = make_production_mesh()
    multi = make_production_mesh(multi_pod=True)
    assert (single.shape, single.mesh_dim_names) == ((16, 16),
                                                     ("data", "model"))
    assert multi.size() == 512
    assert describe(multi) == \
        "mesh {'pod': 2, 'data': 16, 'model': 16} (512 devices)"


def test_chip_smoke_phase_21_rehearses_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 21 on a one-rank gloo group with the reduced
    config and chunked attention (syncs stubbed): the sharded step equals
    the unsharded one, the collectives equal their plain results, and the
    dry run counts the step's FLOPs and collective bytes; then 21(d) in
    two processes on a (1, 2) gloo mesh: the tensor- and sequence-
    parallel step and prefill against the unsharded ones, its op counts
    the dry run's (the phase checks them), its stream reduce-scattered;
    then 21(e) in two processes on a (2, 1) gloo mesh: the FSDP step at
    accum 2 against the unsharded one, its layers gathered one at a
    time, its op counts the dry run's; then 21(f) in two processes on the
    (1, 2) mesh: the expert-parallel prefill, four ticks and a train step
    of the cut deepseek_moe_16b against the unsharded ones, each rank's
    grouped matmuls on half the experts; then 21(g) in two processes on
    the (1, 2) mesh: the MLA cuts of deepseek_v2_236b and minicpm3_4b
    served and trained on half the heads (and half the experts) against
    the unsharded runs; then 21(h) in two processes on the (1, 2) mesh:
    the hybrid served and trained on half the Mamba2 and attention heads
    against the unsharded runs.  Every train step compared runs at the
    base lr, moves every leaf, and is held in fp32 and in float64 (the
    phase checks each leaf; here the largest gaps)."""
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    out = chip_smoke.phase_mesh(0, "CPU rehearsal", card_dev="cpu",
                                smoke=True)

    def held(rec):
        """A step that moved every leaf at the base lr, its float64 first
        moments within 1e-12 of each leaf's max of the unsharded step's."""
        assert rec["lr"] > 0 and rec["moved_least"] > 0
        assert rec["fp64"]["m"][0] <= 1e-12
        assert abs(rec["loss"] - rec["loss_unsharded"]) \
            <= 1e-6 * abs(rec["loss_unsharded"])
    held(out)
    assert out["dryrun_flops"] == out["flops"]
    assert max(out["collectives"].values()) <= 2e-5
    tp = out["tp"]
    held(tp)
    assert tp["logits_err"] <= 1e-4
    assert tp["counts"]["collective_counts"]["reduce-scatter"] > 0
    printed = capsys.readouterr().out
    assert "= the card step's count" in printed
    assert "21(d)" in printed and "op counts = the dry run's" in printed
    fsdp = out["fsdp"]
    held(fsdp)
    assert fsdp["counts"]["collective_counts"]["reduce-scatter"] > 0
    assert "21(e)" in printed
    ep = out["ep"]
    held(ep)
    assert ep["logits_err"] <= 1e-5 * ep["logits_max"]
    # 3 grouped matmuls a prefill and a tick, each on 4 of the 8 experts
    assert ep["gmm_experts"] == [4] * 15
    assert ep["tick_counts"]["collective_counts"]["all-reduce"] > 0
    assert "21(f)" in printed
    mla = out["mla"]["cuts"]
    for arch in ("deepseek_v2_236b", "minicpm3_4b"):
        served, trained = mla[f"{arch}/serve"], mla[f"{arch}/train"]
        assert served["logits_err"] <= 1e-5 * served["logits_max"]
        assert served["tokens"] == served["tokens_unsharded"]
        # the latent decode on 2 of the 4 heads a rank, a layer a tick
        assert served["shapes"]["flash_decode"] == [[2, 48, 32]] * 8
        # a step that moves every leaf: its gradients (the first
        # moments) held against the unsharded step's in float64 and, within
        # their rounding, in fp32 (the phase checks the parameters too)
        assert trained["lr"] == trained["lr_unsharded"] > 0
        assert trained["moved_least"] > 0
        for d, top in trained["fp64"]["m"].values():
            assert d <= 1e-12 * top
        for leaf, (d, top) in trained["fp32"]["m"].items():
            assert d <= max(1e-6 * top, 4 * trained["own"]["m"][leaf][0])
        assert trained["train_counts"]["collective_counts"][
            "all-reduce"] > 0
    # 3 grouped matmuls a prefill and a tick, each on 4 of the 8 experts
    assert mla["deepseek_v2_236b/serve"]["shapes"]["moe_gmm"] == [4] * 15
    assert "21(g)" in printed
    hybrid = out["hybrid"]
    held(hybrid)
    assert hybrid["logits_err"] <= 1e-5 * hybrid["logits_max"]
    # 8 of the 16 Mamba2 heads a rank in each of the 7 layers' scans, and
    # the split norm's 128 of 256 channels a layer, a prefill and 4 ticks
    assert hybrid["shapes"]["mamba_scan"] == [8] * 7
    assert hybrid["shapes"]["rmsnorm_sumsq"] == [128] * 7 * 5
    assert hybrid["counts"]["collective_counts"]["reduce-scatter"] > 0
    assert "21(h)" in printed
