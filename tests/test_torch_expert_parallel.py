"""Expert parallelism over "model" in the MoE mesh steps of the port
(``models.moe.moe_apply`` under ``parallel.tensor``), on gloo ranks on
the CPU against the JAX package, as ``tests/test_torch_parallel.py``
runs its mesh steps (``tests/torch_mesh_programs.py``), on reduced
deepseek_moe_16b (8 experts, top-2, one shared expert; fp32) at the
capacity factor of 1.25, where JAX's dispatch drops slots:

* two train steps on (4, 2), (2, 4) and (1, 8) ("data", "model") at
  ``act_shard="seq"``: each device holds E/m experts (one on (1, 8), where
  4 heads do not divide 8 and the attention stays whole) and S/m rows of
  the stream; against JAX's single-device step, the port's unsharded step
  at 1e-6 of each leaf in fp32 and 1e-12 in float64, the first gradients
  too; and the batch2d step, whose batch is cut over "model", gathering
  the experts whole; each step's op counts the dry run's;
* the mesh prefill on (4, 2) and (2, 4), and on (2, 4) four greedy serve
  ticks after it: logits within 1e-4 of JAX's, the same tokens, the op
  counts the dry run's;
* in one process: ``TensorParallel.of`` tells leaves of the same logical
  axes apart by shape, and raises where their blocks coincide; a train
  step on a (1, 1) mesh (one gloo rank) issues no collective and is
  bit-equal to the unsharded step.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import DataConfig, synthetic_batch
from repro.models import api as japi
from repro.parallel import steps as jst
from repro_torch.configs import InputShape
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import dryrun
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import steps as tst
from repro_torch.parallel import tensor
from repro_torch.parallel.comm import AbstractMesh
from test_torch_parallel import (_check_moe_blocks, _jax_drops, _write_state,
                                 check_sharded_train, run_ranks)
from torch_parity import close

ARCH = "deepseek_moe_16b"
torch.set_num_threads(1)


# Under expert parallelism the layer's output is the sum over the axis of
# each device's experts and its block of the shared expert, which rounds
# otherwise than the unsharded sum; Adam's normalisation carries that into
# the state (tests/torch_mesh_rounding.py deepseek_moe_16b 4x2): the
# mesh's fp32 routed experts land 1.45e-6 of the leaf's largest value from
# the unsharded fp32 step's (1.29e-6 on 2x4), while that step lands 1.06e-6
# and the mesh's 1.26e-6 from the float64 step's.  So on (4, 2) and (2, 4)
# the state is held in float64 (1e-12), the first gradients in both; on
# (1, 8) (9.7e-7) the parameters and first moments in fp32 too.
EP = dict(arch=ARCH, fp32_state=False)


@pytest.mark.parametrize("mesh,act_shard,case", [
    # the MoE dispatch takes the global batch's capacity and positions;
    # under expert parallelism each device routes every token of its rows
    # and computes its block of the experts
    pytest.param((4, 2), "seq", EP, id="moe-mesh0"),
    pytest.param((2, 4), "seq", EP, id="moe-mesh2"),
    # 4 rows over batch2d's 8 devices: the rules cut them over "model"
    # only, so 2 row groups, each held by the 4 data shards; the experts
    # are gathered whole
    pytest.param((4, 2), "batch2d", dict(arch=ARCH), id="moe-batch2d"),
    # one expert a device; 4 heads do not divide 8, so the attention stays
    # whole while the experts, the MLPs and the vocab split
    pytest.param((1, 8), "seq", dict(arch=ARCH), id="moe-experts-1x8"),
])
def test_sharded_train_step_matches_single_device(tmp_path, monkeypatch,
                                                  mesh, act_shard, case):
    check_sharded_train(tmp_path, monkeypatch, mesh, act_shard, case)


def _prefill_case(tmp_path, mesh, ticks: int):
    """JAX's single-device prefill of 4 x 16 tokens (its logits, and the
    greedy tokens of ``ticks`` serve steps after it) beside the mesh
    prefill's and serve steps' output from ``mesh``'s ranks."""
    act_shard, seq = "seq", 16
    jc = jax_config(ARCH).reduced().replace(dtype="float32",
                                            act_shard=act_shard)
    tokens = synthetic_batch(DataConfig(seq_len=seq, global_batch=4,
                                        vocab=jc.vocab), 0)["tokens"]
    js = jst.init_train_state(jc, jax.random.PRNGKey(0))
    prefill = japi.prefill_fn(jc, seq + ticks)
    batch = {"tokens": jnp.asarray(tokens)}
    logits, cache = jax.jit(prefill)(js.params, batch)
    want = [np.asarray(jnp.argmax(logits, -1))]
    step = {"token": jnp.argmax(logits, -1).astype(jnp.int32)[:, None],
            "kv_len": jnp.full((4,), seq, jnp.int32)}
    serve = jax.jit(jst.make_serve_step(jc))
    for _ in range(ticks):
        step, cache = serve(js.params, step, cache)
        want.append(np.asarray(step["token"][:, 0]))
    _write_state(tmp_path, js)
    np.save(tmp_path / "tokens.npy", tokens)
    (tmp_path / "info.json").write_text(json.dumps(dict(
        arch=ARCH, act_shard=act_shard, mesh=list(mesh), ticks=ticks)))
    got, info = run_ranks("sharded_prefill", int(np.prod(mesh)), tmp_path)
    return jc, js, batch, np.asarray(logits), np.stack(want, 1), got, info


def _counts_match(info_counts, tc, shape, mesh):
    pred = dryrun.trace_cell(tc, shape, AbstractMesh(mesh, (
        "data", "model")))["hlo_analysis"]
    for key in ("collective_bytes", "collective_counts", "flops"):
        assert info_counts[key] == pred[key], (shape.kind, key)


@pytest.mark.parametrize("mesh,ticks", [((4, 2), 0), ((2, 4), 4)],
                         ids=["mesh0", "mesh1"])
def test_sharded_moe_prefill_matches_single_device(tmp_path, monkeypatch,
                                                   mesh, ticks):
    """The mesh prefill of reduced deepseek_moe_16b (4 x 16 tokens, at
    the capacity factor of 1.25, where JAX's dispatch drops slots) against
    JAX's single-device prefill logits (within 1e-4); its op counts are
    the dry run's.  Each device computes its E/m experts on S/m rows of
    the stream.  On (2, 4), two experts a device, four greedy serve ticks
    follow from the prefill's cache (one token a row: the stream whole,
    the tokens entering the experts through ``into_split`` and leaving
    through one all-reduce), their tokens equal to JAX's greedy decode and
    the first tick's op counts the dry run's."""
    jc, js, batch, want, tokens, got, info = _prefill_case(tmp_path, mesh,
                                                           ticks)
    assert jc.capacity_factor == 1.25
    assert _jax_drops(monkeypatch, jc, japi.prefill_fn(jc, 16), js.params,
                      batch) > 0
    close(want, got["logits"], rtol=1e-4, atol=1e-4,
          what="mesh prefill logits against JAX")
    tc = torch_config(ARCH).reduced().replace(dtype="float32")
    _check_moe_blocks(tc, info["moe"], mesh[1], 16 // mesh[1])
    _counts_match(info["counts"], tc, InputShape("t", 16, 4, "prefill"),
                  mesh)
    if not ticks:
        return
    assert np.array_equal(got["tokens"], tokens)
    _check_moe_blocks(tc, info["tick_moe"], mesh[1], 1)
    _counts_match(info["tick_counts"], tc,
                  InputShape("t", 16 + ticks, 4, "decode"), mesh)
    assert "reduce-scatter" not in info["tick_counts"]["collective_counts"]


def _layouts(shapes, axes=("embed", "mlp")):
    """A ``Layout`` a leaf of each whole shape, all with logical ``axes``,
    on an abstract (2, 4) mesh under the default rules."""
    mesh = AbstractMesh((2, 4), ("data", "model"))
    rules = shd.default_rules()
    return {f"w{i}": shd.Layout(mesh, rules, axes, s)
            for i, s in enumerate(shapes)}


def test_the_context_tells_leaves_of_the_same_axes_apart():
    """deepseek_moe_16b's dense first layer and shared experts are both
    ("embed", "mlp") SwiGLUs, of widths 10944 and 2816 (256 and 64
    reduced): the context holds both and names each by its block; a
    shape that is neither block raises, and so do two leaves whose blocks
    coincide (a split (8, 12) and a whole (8, 3): 3 does not divide 4)."""
    for cfg in (torch_config(ARCH), torch_config(ARCH).reduced()):
        mesh = AbstractMesh((2, 4), ("data", "model"))
        tp = tensor.TensorParallel.of(mesh, tst.state_layouts(
            cfg, mesh, shd.default_rules()).params)
        widths = {s for a, s, _ in tp.leaves if a == ("embed", "mlp")}
        assert widths == {(cfg.d_model, cfg.d_ff),
                          (cfg.d_model, cfg.d_ff_expert * cfg.n_shared)}
        for f in (cfg.d_ff, cfg.d_ff_expert * cfg.n_shared):
            assert tp.split_dim(torch.empty(cfg.d_model, f // 4),
                                ("embed", "mlp")) == 1
            assert tp.split_dim(torch.empty(f // 4, cfg.d_model),
                                ("mlp", "embed")) == 0
        assert tp.dim_of(("embed", "mlp")) == 1
        with pytest.raises(ValueError, match="its block is"):
            tp.split_dim(torch.empty(cfg.d_model, cfg.d_ff),
                         ("embed", "mlp"))
        assert tp.split_dim(torch.empty(cfg.n_experts // 4, cfg.d_model,
                                        cfg.d_ff_expert),
                            ("experts", "embed", "mlp")) == 0
        assert tp.split_dim(torch.empty(cfg.d_model, cfg.n_experts),
                            ("embed", None)) is None
    mesh = AbstractMesh((2, 4), ("data", "model"))
    tp = tensor.TensorParallel.of(mesh, _layouts([(8, 12), (8, 16)]))
    assert {s for _, s, _ in tp.leaves} == {(8, 12), (8, 16)}
    with pytest.raises(ValueError, match="the same block"):
        tensor.TensorParallel.of(mesh, _layouts([(8, 12), (8, 3)]))


@pytest.mark.parametrize("arch", ["glm4_9b", ARCH])
def test_one_device_mesh_issues_no_collective(tmp_path, arch):
    """A train step on a (1, 1) mesh (one gloo rank) issues no collective,
    as GSPMD emits none over axes of one device: its op counter, and the
    dry run's on an abstract (1, 1) mesh, record none, and its state after
    two steps is bit-equal to the unsharded step's."""
    import datetime
    import torch.distributed as dist
    from repro_torch.analysis import hlo
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tree import leaves, tree_map
    tc = torch_config(arch).reduced().replace(dtype="float32")
    batches = [{k: torch.from_numpy(v) for k, v in synthetic_batch(
        DataConfig(seq_len=16, global_batch=2, vocab=tc.vocab),
        s).items()} for s in range(2)]
    state = tst.init_train_state(tc, torch.Generator().manual_seed(0), "cpu")
    want = tree_map(lambda t: t.clone(), state)
    kw = dict(total_steps=5, warmup=2)
    plain = tst.make_train_step(tc, **kw)
    for b in batches:
        want, _ = plain(want, b)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        rules = shd.default_rules()
        lay = tst.state_layouts(tc, mesh, rules)
        step = tst.make_train_step(tc, mesh=mesh, rules=rules,
                                   global_batch=2, **kw)
        got = tst.shard_state(state, lay)
        (got, _), rep = hlo.count(step, got, batches[0])
        got, _ = step(got, batches[1])
    finally:
        dist.destroy_process_group()
    assert rep.collective_counts == {} and rep.collective_bytes == {}
    assert rep.flops > 0
    cell = dryrun.trace_cell(tc, InputShape("t", 16, 2, "train"),
                             AbstractMesh((1, 1), ("data", "model")))
    assert cell["hlo_analysis"]["collective_counts"] == {}
    assert cell["hlo_analysis"]["flops"] == rep.flops
    for a, b in zip(leaves(got), leaves(want), strict=True):
        assert torch.equal(a, b)
