"""The port's op counter, roofline and dry run against the JAX package's
HLO analyzer, roofline and dry run.

* ``model_flops`` and ``active_params`` equal JAX's exactly for every
  arch x shape.
* The counter's FLOPs of the reduced glm4_9b and deepseek_moe_16b train
  steps at 2 x 64 tokens (fp32) against ``analyze_hlo_text`` of JAX's
  compiled single-device step: within 1% (they agree exactly today: the
  same dots, forward, remat recompute and backward), and the scanned
  stacks' trip counts equal.
* test_analysis.py's roofline case on the port's ``RooflineTerms``, at
  the TPU constants and at the H100's.
* A hand-written kernel's call counts by its formula, and the traced
  (fake-tensor) route of flash attention counts the card's backward.
* ``python -m repro_torch.launch.dryrun`` on the smallest real cell, as
  the JAX package's own CLI test asks of its dry run.
* A train step gathers one layer at a time: its collectives are those
  its parameters' layouts imply, and its temp bytes grow by less than
  the added layers' weights when the layers double.
"""
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis.hlo import analyze_hlo_text
from repro.analysis.roofline import active_params as jax_active_params
from repro.analysis.roofline import model_flops as jax_model_flops
from repro.analysis.roofline import roofline_from_report as jax_roofline
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.data import DataConfig, synthetic_batch
from repro.parallel import steps as jst
from repro_torch.analysis import H100, HW, hlo
from repro_torch.analysis.roofline import (active_params, model_flops,
                                           roofline_from_report)
from repro_torch.configs import ARCH_IDS, SHAPES, InputShape
from repro_torch.configs import get_config as torch_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.parallel import steps as tst
from repro_torch.parallel.comm import AbstractMesh

ROOT = Path(__file__).resolve().parents[1]
FLOPS_RTOL = 1e-2
torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_active_params_equal_jax(arch):
    jc, tc = jax_config(arch), torch_config(arch)
    assert active_params(tc) == jax_active_params(jc)
    for name in SHAPES:
        assert model_flops(tc, SHAPES[name]) == \
            jax_model_flops(jc, JSHAPES[name])


@pytest.mark.parametrize("arch", ["glm4_9b", "deepseek_moe_16b"])
def test_counter_flops_match_the_hlo_analyzer(arch):
    jc = jax_config(arch).reduced().replace(dtype="float32")
    tc = torch_config(arch).reduced().replace(dtype="float32")
    b = synthetic_batch(DataConfig(seq_len=64, global_batch=2,
                                   vocab=jc.vocab), 0)
    js = jst.init_train_state(jc, jax.random.PRNGKey(0))
    comp = jax.jit(jst.make_train_step(jc)).lower(
        js, {k: jnp.asarray(v) for k, v in b.items()}).compile()
    want = analyze_hlo_text(comp.as_text(),
                            score_chunks=(jc.attn_chunk, jc.ssm_chunk))
    ts = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                "cpu")
    _, got = hlo.count(tst.make_train_step(tc), ts,
                       {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(got.flops / want.flops - 1) <= FLOPS_RTOL, \
        (got.flops, want.flops)
    assert hlo.scanned_stacks(tc, "train") == want.trip_counts
    # the dry run's trace of the same cell counts the same step
    cell = dryrun.trace_cell(tc, InputShape("t", 64, 2, "train"),
                             AbstractMesh((1, 1), ("data", "model")))
    assert cell["hlo_analysis"]["flops"] == got.flops
    assert cell["hlo_analysis"]["trip_counts"] == want.trip_counts


def test_roofline_terms_match_jax():
    from repro.analysis.hlo import HLOCostReport as JReport
    fields = dict(flops=3.2e12, hbm_bytes=7.5e10,
                  collective_bytes={"all-gather": 2e9, "all-reduce": 1e9},
                  score_buffer_bytes=1e10, recurrent_buffer_bytes=5e9)
    jrep = JReport(**fields)
    trep = hlo.HLOCostReport(**fields)
    want = jax_roofline(jrep, chips=256, model_flops=1e15)
    got = roofline_from_report(trep, chips=256, model_flops=1e15)
    for k in ("t_compute", "t_memory", "t_collective", "bound", "t_bound",
              "roofline_fraction", "useful_flops_ratio",
              "t_memory_xla_path", "hbm_bytes_per_device"):
        assert got.as_dict()[k] == want.as_dict()[k], k
    assert got.t_compute == pytest.approx(trep.flops / HW.peak_flops_bf16)
    h = roofline_from_report(trep, chips=256, model_flops=1e15, hw=H100)
    assert h.t_compute == pytest.approx(3.2e12 / 989e12)
    assert h.t_memory == pytest.approx(6e10 / 3.35e12)
    assert h.t_collective == pytest.approx(3e9 / 450e9)
    assert h.bound == "memory"
    f = roofline_from_report(trep, chips=256, hw=H100, dtype="float32")
    assert f.t_compute == pytest.approx(3.2e12 / 67e12)


def test_kernel_calls_count_by_their_formula():
    """On fake tensors (the dry run's route) a flash attention forward is
    its formula and nothing else; with grad, the backward adds the
    oracle's recompute and gradient, as on the card."""
    b, s, h, d = 1, 32, 4, 16
    with FakeTensorMode():
        q, k, v = (torch.empty(b, s, h, d) for _ in range(3))
        _, rep = hlo.count(ops.flash_attention, q, k, v)
    assert rep.kernel_calls == {"flash_attention": 1}
    assert rep.flops == 2 * (d + d) * b * h * s * (s + 1) // 2
    # the card's backward: recompute the oracle and differentiate it
    qr, kr, vr = (torch.randn(b, h, s, d, requires_grad=True)
                  for _ in range(3))
    with FlopCounterMode(display=False) as fc:
        out = ref.attention_ref(qr, kr, vr, causal=True)
        torch.autograd.grad(out, (qr, kr, vr), torch.ones_like(out))
    with FakeTensorMode():
        q, k, v = (torch.empty(b, s, h, d, requires_grad=True)
                   for _ in range(3))

        def fwd_bwd():
            out = ops.flash_attention(q, k, v)
            torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
        _, rep = hlo.count(fwd_bwd)
    assert rep.flops == 2 * (d + d) * b * h * s * (s + 1) // 2 \
        + fc.get_total_flops()
    # the norm kernel
    with FakeTensorMode():
        x, sc = torch.empty(4, 64), torch.empty(64)
        _, rep = hlo.count(ops.fused_rmsnorm, x, sc)
    assert rep.kernel_calls == {"rmsnorm": 1}
    assert (rep.flops, rep.hbm_bytes) == (4 * 4 * 64, 2 * 4 * 64 * 4 + 4 * 64)


def test_counter_records_traffic_scores_and_recurrences():
    """Operand plus output bytes of each op that is no view; fp32 tensors
    of rank >= 3 whose last dimension is a chunk are score buffers."""
    x, w = torch.randn(2, 8, 16), torch.randn(16, 16)

    def f():
        y = (x @ w).transpose(1, 2)          # the transpose is a view
        return torch.tanh(y)
    _, rep = hlo.count(f, score_chunks=(16,))
    nb = 2 * 8 * 16 * 4
    assert rep.flops == 2 * 2 * 8 * 16 * 16
    assert rep.hbm_bytes >= nb * 2
    assert rep.score_buffer_bytes > 0
    with hlo.recurrence(600):                # no counter: nothing happens
        pass

    def loop():
        with hlo.recurrence(512):
            return torch.tanh(torch.randn(4, 4)) + 1
    _, rep = hlo.count(loop)
    assert rep.recurrent_buffer_bytes == rep.hbm_bytes > 0


def test_dry_run_records_the_blocks_and_the_fit():
    tc = torch_config("deepseek_7b").reduced().replace(dtype="float32")
    mesh = AbstractMesh((4, 2), ("data", "model"))
    cell = dryrun.trace_cell(tc, InputShape("t", 16, 4, "train"), mesh)
    from repro_torch.parallel import sharding as shd
    state = tst.abstract_state(tc, mesh, shd.default_rules())
    batch = tst.abstract_batch(tc, InputShape("t", 16, 4, "train"), mesh,
                               shd.default_rules())
    from repro_torch.tree import leaves
    want = sum(t.numel() * t.element_size() for t in leaves((state, batch)))
    m = cell["memory"]
    assert cell["status"] == "ok" and cell["chips"] == 8
    assert m["argument_bytes"] == want and m["fits_h100"]
    assert m["alias_bytes"] > 0 and m["temp_bytes"] > 0
    hl = cell["hlo_analysis"]
    assert set(hl["collective_bytes"]) == {"all-gather", "reduce-scatter",
                                           "all-reduce"}
    assert cell["roofline_h100"]["hardware"] == "h100-sxm"


def test_dryrun_cli_end_to_end(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = f"{ROOT}/src"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm_125m", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path / "dr.json")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    res = json.loads((tmp_path / "dr.json").read_text())
    cell = res["xlstm_125m|decode_32k|16x16"]
    assert cell["status"] == "ok"
    assert cell["chips"] == 256
    assert cell["roofline"]["t_bound"] > 0
    assert cell["roofline_h100"]["t_bound"] > 0
    assert cell["hlo_analysis"]["kernel_calls"] == {"rmsnorm": 25,
                                                    "slstm_seq": 3}
    skip = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "glm4_9b", "--shape", "long_500k", "--out",
         str(tmp_path / "dr.json")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert skip.returncode == 0, skip.stdout + skip.stderr
    res = json.loads((tmp_path / "dr.json").read_text())
    assert res["glm4_9b|long_500k|16x16"]["status"] == "skip"
    assert "xlstm_125m|decode_32k|16x16" in res          # resumable cache


def test_codesign_prices_a_dry_run_row():
    """``core.codesign.cost_per_step`` takes the dry run's roofline rows,
    and prices them as the JAX package's does."""
    from repro.core.codesign import cost_per_step as jax_cost
    from repro_torch.core.codesign import cost_per_step
    tc = torch_config("xlstm_125m").reduced()
    cell = dryrun.trace_cell(tc, InputShape("t", 32, 2, "train"),
                             AbstractMesh((2, 1), ("data", "model")))
    for row in (cell["roofline"], cell["roofline_h100"]):
        got = cost_per_step(row, 30_000.0, cell["chips"])
        assert got == jax_cost(row, 30_000.0, cell["chips"])
        assert got["t_step_bound_s"] == row["t_bound"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_family_traces_each_kind_of_cell(arch, kind):
    """Each reduced config's train, prefill and decode step traces on a
    (4, 2) abstract mesh: a device's arguments are its blocks and rows,
    and the step issues the plan's collectives: reduce-scatters in a
    train step (the gradients) and in a tensor-parallel prefill (its 32
    positions split over "model": the layers' sums), none in a decode."""
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor
    tc = torch_config(arch).reduced()
    mesh = AbstractMesh((4, 2), ("data", "model"))
    cell = dryrun.trace_cell(tc, InputShape("t", 32, 8, kind), mesh)
    assert cell["status"] == "ok" and cell["memory"]["argument_bytes"] > 0
    hl = cell["hlo_analysis"]
    assert hl["flops"] > 0 and hl["collective_counts"]["all-gather"] > 0
    split = kind == "prefill" and tensor.applies(
        tc, mesh, shd.default_rules(act_shard=tc.act_shard), 8)
    assert ("reduce-scatter" in hl["collective_bytes"]) == \
        (kind == "train" or split)


def test_the_peak_trace_ends_at_the_dry_runs_temp_bytes():
    """``launch/dryrun_peak.py`` traces a cell as the dry run does, and its
    last high of the live bytes is the cell's temp bytes."""
    from repro_torch.launch import dryrun_peak
    tc = torch_config("glm4_9b").reduced()
    cell, highs = dryrun_peak.trace_highs(
        tc, InputShape("t", 32, 8, "train"),
        AbstractMesh((4, 2), ("data", "model")), 0.0)
    assert len(highs) > 1 and highs[-1][2] == cell["memory"]["temp_bytes"]
    assert all(a[2] < b[2] for a, b in zip(highs, highs[1:]))


def _stacked(lay) -> int:
    """The leading "layers" dimensions of a leaf's layout."""
    return len(lay.axes) - len(tuple(
        itertools.dropwhile(lambda a: a == "layers", lay.axes)))


def _implied_collectives(tc, mesh, accum: int) -> dict:
    """The all-gathers, reduce-scatters and all-reduces a train step that
    is not tensor parallel implies from its parameters' layouts
    (``state_layouts``): in each microbatch, each layer of a stacked leaf
    gathered once a pass (the forward and, under remat, its recompute)
    and every other leaf once, one all-gather a mesh axis that splits
    the leaf; each layer's (each leaf's) gradient reduced once, one
    reduce-scatter a splitting axis and one all-reduce a replicating
    axis; then the label count, the loss and the clipping norm, one
    all-reduce a mesh axis each."""
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import leaves
    rules = shd.default_rules(act_shard=tc.act_shard)
    axes = mesh.mesh_dim_names
    passes = 1 if tc.remat == "none" else 2
    got = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 3 * len(axes)}
    for lay in leaves(tst.state_layouts(tc, mesh, rules).params):
        split = [a for e in lay.spec for a in shd._entries(e)]
        n = _stacked(lay)
        layers = int(np.prod(lay.shape[:n]))
        got["all-gather"] += accum * len(split) * layers * (
            passes if n else 1)
        got["reduce-scatter"] += accum * len(split) * layers
        got["all-reduce"] += accum * (len(axes) - len(split)) * layers
    return got


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_the_train_step_gathers_one_layer_at_a_time(remat):
    """Reduced deepseek_7b's train cell (2 microbatches of 8 rows, fp32,
    ``act_shard="batch2d"``: no tensor parallelism) on an abstract (4, 2)
    mesh at 2 and at 4 layers.  Its collectives are those the layouts
    imply: each layer gathered in each pass and reduced once, a
    microbatch at a time.  Under remat the step holds one layer's
    gathered weights at a time, so doubling the layers raises the temp
    bytes by less than the added layers' whole weights (a step that
    gathers the whole tree at its top holds all of them at once); without
    remat the backward keeps each layer's gathered weights, as it keeps
    the rest of the layer's activations."""
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import leaves
    mesh = AbstractMesh((4, 2), ("data", "model"))
    temp = {}
    for n in (2, 4):
        tc = torch_config("deepseek_7b").reduced().replace(
            n_layers=n, dtype="float32", act_shard="batch2d", accum=2,
            remat=remat)
        cell = dryrun.trace_cell(tc, InputShape("t", 16, 16, "train"), mesh)
        counts = cell["hlo_analysis"]["collective_counts"]
        assert counts == _implied_collectives(tc, mesh, 2), n
        temp[n] = cell["memory"]["temp_bytes"]
    lays = leaves(tst.state_layouts(
        tc, mesh, shd.default_rules(act_shard="batch2d")).params)
    layer = sum(int(np.prod(lay.shape[_stacked(lay):])) * 4
                for lay in lays if _stacked(lay))
    if remat != "none":
        assert 0 < temp[4] - temp[2] < 2 * layer, (temp, layer)
