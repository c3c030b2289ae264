"""The port's mesh steps gather one layer at a time (FSDP as GSPMD runs
JAX's scanned layers), for the families whose mesh steps gather every
weight over every axis, on 8 gloo ranks against the JAX package.

Each test runs ``tests/torch_mesh_programs.py`` on a (4, 2) ("data",
"model") mesh, as ``tests/test_torch_parallel.py`` does:

* Two train steps of reduced zamba2_7b (at ``act_shard="batch2d"``:
  Mamba2 layers and two shared attention blocks, each gathered at each
  of its applications),
  xlstm_125m (mLSTM blocks on two leading "layers" dimensions),
  minicpm3_4b (MLA, at ``act_shard="batch2d"``, whose batch takes "model")
  and whisper_medium (encoder and decoder stacks), and
  of reduced deepseek_7b under ``remat="dots"`` at ``accum=2``, against
  JAX's single-device jitted step and the port's unsharded step at the
  bounds of ``test_sharded_train_step_matches_single_device`` for a step
  that is not tensor parallel: losses at 1e-5 of JAX's and 1e-6 of the
  unsharded step's, the state against JAX's at its tolerances, every
  leaf within 1e-6 and the first gradients within 1e-5 of the unsharded
  step's largest value (xlstm_125m: its state against JAX's only, its
  gradients also in float64 at 1e-12, see its case); each rank's
  collective bytes, counts and FLOPs those of the dry run's trace of the
  same cell on an abstract mesh.
* The prefill and four greedy serve ticks of reduced deepseek_moe_16b:
  the last logits against JAX's prefill, the tokens equal to JAX's
  greedy decode, each step's op counts the dry run's.
* In one process on an abstract mesh: what the model gets for a stacked
  leaf, what gathering a layer and its backward issue, and the check
  that no stacked leaf reaches a layer of a mesh step whole.
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
from repro_torch.parallel import steps as tst
from repro_torch.parallel.comm import AbstractMesh
from repro_torch.tree import leaves
from test_torch_parallel import (LOSS_RTOL, _first_grads, _torch_state,
                                 _write_state, run_ranks)
from torch_mesh_programs import Float64, double
from torch_parity import close

MESH = (4, 2)
SEQ = 16
torch.set_num_threads(1)


def _batches(jc, accum: int, steps: int):
    """``steps`` batches of 4 x ``accum`` rows (a leading microbatch axis
    under ``accum``): tokens and labels, or Whisper's frames, decoder
    tokens and labels."""
    rows = 4 * accum
    out = []
    for s in range(steps):
        if jc.family == "encdec":
            rng = np.random.default_rng(10 + s)
            b = {"frames": rng.standard_normal(
                     (rows, SEQ, jc.d_model)).astype(np.float32),
                 "dec_tokens": rng.integers(0, jc.vocab, (rows, jc.dec_len),
                                            dtype=np.int32),
                 "labels": rng.integers(0, jc.vocab, (rows, jc.dec_len),
                                        dtype=np.int32)}
        else:
            b = synthetic_batch(DataConfig(seq_len=SEQ, global_batch=rows,
                                           vocab=jc.vocab), s)
        if accum > 1:
            b = {k: v.reshape((accum, 4) + v.shape[1:]) for k, v in b.items()}
        out.append(b)
    return out


@pytest.mark.parametrize("arch,case", [
    # batch2d: the rules cut the 4 rows over "model", so the hybrid's
    # layers are gathered whole (its tensor-parallel steps are
    # tests/test_torch_hybrid_parallel.py's).  On this layout A_log's
    # nearly cancelling gradient rounds its fp32 state to 1.61e-6 of the
    # leaf's largest value from the unsharded step's, which is itself
    # 6.8e-5 from the float64 step's (mesh and unsharded agree to 1.4e-15
    # in float64; tests/torch_mesh_rounding.py zamba2_7b 4x2 --act-shard
    # batch2d): its state is held against JAX's step, its first gradients
    # against the unsharded step's in fp32 and in float64, as xlstm's
    pytest.param("zamba2_7b", dict(act_shard="batch2d", fp32_state=False),
                 id="hybrid"),
    # the sLSTM gates' bias has a gradient that nearly cancels over the
    # rows, and AdamW's normalised update turns the order of the
    # data-parallel sums into 2.0e-3 of the leaf's largest value in fp32
    # (2.8e-12 in float64; the embedding's master 2.1e-6), the same gaps
    # as the whole gather's (PERF.md): its state is held against JAX's
    # step, its first gradients against the unsharded step's in fp32 and
    # in float64
    pytest.param("xlstm_125m", dict(fp32_state=False), id="xlstm"),
    # batch2d: the rules cut the 4 rows over "model", so the MLA layers
    # are gathered whole (their tensor-parallel steps are
    # tests/test_torch_mla_parallel.py's)
    pytest.param("minicpm3_4b", dict(act_shard="batch2d"), id="mla"),
    pytest.param("whisper_medium", {}, id="encdec"),
    # remat "dots" keeps the layers' matmul outputs and recomputes the
    # rest, the gather among them; accum 2 adds each microbatch's
    # reduced blocks into the fp32 accumulator
    pytest.param("deepseek_7b", dict(remat="dots", accum=2,
                                     act_shard="batch2d"), id="dots-accum2"),
])
def test_layer_gather_train_step_matches_single_device(tmp_path, arch, case):
    accum, steps = case.get("accum", 1), 2
    act_shard = case.get("act_shard", "seq")
    remat = case.get("remat", "full")
    over = dict(dtype="float32", act_shard=act_shard, remat=remat)
    kw = dict(total_steps=5, warmup=2)
    jc = jax_config(arch).reduced().replace(**over)
    tc = torch_config(arch).reduced().replace(accum=accum, **over)
    batches = _batches(jc, accum, steps)
    js = jst.init_train_state(jc, jax.random.PRNGKey(0))
    _write_state(tmp_path, js)
    np.savez(tmp_path / "batches.npz", **{
        f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
    fp32_state = case.get("fp32_state", True)
    (tmp_path / "info.json").write_text(json.dumps(dict(
        arch=arch, act_shard=act_shard, mesh=list(MESH), steps=steps,
        accum=accum, float64=not fp32_state, remat=remat, **kw)))
    js0 = js
    first = leaves(_first_grads(tc, _torch_state(js, tc), batches[0], accum))
    ts = _torch_state(js, tc)
    jstep = jax.jit(jst.make_train_step(jc, accum=accum, **kw))
    tstep = tst.make_train_step(tc, accum=accum, **kw)
    jl, tl, lrs = [], [], []
    for b in batches:
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        lrs.append(float(jm["lr"]))
    got, info = run_ranks("sharded_train", int(np.prod(MESH)), tmp_path)
    assert float(got["block_diff"]) == 0.0
    assert info["split_leaves"] == 0          # not tensor parallel
    pred = dryrun.trace_cell(tc, InputShape("t", SEQ, 4 * accum, "train"),
                             AbstractMesh(MESH, ("data", "model")))
    for key in ("collective_bytes", "collective_counts", "flops"):
        assert info["counts"][key] == pred["hlo_analysis"][key], key
    close(jl, info["losses"], rtol=LOSS_RTOL, what="losses against JAX")
    close(tl, info["losses"], rtol=1e-6, what="losses against unsharded")
    sharded = [got[f"a{i}"] for i in range(len(leaves(ts)))]
    for j, t, s in zip(jax.tree_util.tree_leaves(js), leaves(ts), sharded,
                       strict=True):
        close(j, s, rtol=1e-5, atol=1e-2 * sum(lrs), what="state vs JAX")
    _within(first, [got[f"g{i}"] for i in range(len(first))], 1e-5,
            "first gradient")
    if fp32_state:
        _within(leaves(ts), sharded, 1e-6, "state leaf")
        return
    # in float64: the first gradients within 1e-12 of the unsharded step's
    with Float64():
        first = leaves(_first_grads(tc, double(_torch_state(js0, tc)),
                                    double(batches[0]), accum))
    assert all(got[f"h{i}"].dtype == np.float64 for i in range(len(first)))
    _within(first, [got[f"h{i}"] for i in range(len(first))], 1e-12,
            "float64 first gradient")


def _within(want, got, rtol: float, what: str) -> None:
    """Each array of ``got`` within ``rtol`` of the largest value of the
    tensor of ``want`` beside it (integer leaves equal)."""
    for i, (t, s) in enumerate(zip(want, got, strict=True)):
        t = t.numpy()
        scale = max(float(np.abs(t).max()), 1e-30)
        assert np.abs(s - t).max() <= rtol * scale, \
            f"{what} {i} {t.shape} vs the unsharded step"


def test_layer_gather_moe_prefill_and_serve_match_single_device(tmp_path):
    """Reduced deepseek_moe_16b (4 x 16 tokens, fp32) prefilled on (4, 2),
    each layer gathered in its turn, then four greedy serve ticks from the
    prefill's cache: the last logits against JAX's single-device prefill
    at the MoE prefill's bounds, the tokens equal to JAX's greedy decode,
    and each step's op counts the dry run's."""
    arch, act_shard, ticks = "deepseek_moe_16b", "seq", 4
    jc = jax_config(arch).reduced().replace(dtype="float32",
                                            act_shard=act_shard)
    tc = torch_config(arch).reduced().replace(dtype="float32",
                                              act_shard=act_shard)
    tokens = synthetic_batch(DataConfig(seq_len=SEQ, global_batch=4,
                                        vocab=jc.vocab), 0)["tokens"]
    js = jst.init_train_state(jc, jax.random.PRNGKey(0))
    logits, cache = jax.jit(japi.prefill_fn(jc, SEQ + ticks))(
        js.params, {"tokens": jnp.asarray(tokens)})
    want = [np.asarray(jnp.argmax(logits, -1))]
    batch = {"token": jnp.argmax(logits, -1).astype(jnp.int32)[:, None],
             "kv_len": jnp.full((4,), SEQ, jnp.int32)}
    serve = jax.jit(jst.make_serve_step(jc))
    for _ in range(ticks):
        batch, cache = serve(js.params, batch, cache)
        want.append(np.asarray(batch["token"][:, 0]))
    _write_state(tmp_path, js)
    np.save(tmp_path / "tokens.npy", tokens)
    (tmp_path / "info.json").write_text(json.dumps(dict(
        arch=arch, act_shard=act_shard, mesh=list(MESH), ticks=ticks)))
    got, info = run_ranks("sharded_prefill", int(np.prod(MESH)), tmp_path)
    close(np.asarray(logits), got["logits"], rtol=1e-4, atol=1e-4,
          what="mesh prefill logits against JAX")
    assert np.array_equal(got["tokens"], np.stack(want, 1))
    am = AbstractMesh(MESH, ("data", "model"))
    for counts, shape in (
            (info["counts"], InputShape("t", SEQ, 4, "prefill")),
            (info["tick_counts"], InputShape("t", SEQ + ticks, 4,
                                             "decode"))):
        pred = dryrun.trace_cell(tc, shape, am)["hlo_analysis"]
        for key in ("collective_bytes", "collective_counts", "flops"):
            assert counts[key] == pred[key], (shape.kind, key)


def test_stacked_leaves_reach_the_layers_one_layer_at_a_time():
    """On an abstract (4, 2) mesh, reduced xlstm_125m's blocks: a stacked
    leaf reaches the model as a ``sharding.Stacked`` (its shape the
    whole leaf's, its layers this device's blocks, each its own autograd
    input), indexed down to one layer's ``LayerBlock``; ``layer`` gathers
    that layer whole (one all-gather a splitting axis) and its backward
    reduces the gradient into the layer's block (one reduce-scatter a
    splitting axis, one all-reduce a replicating axis).  In a mesh step a
    plain tensor reaching ``layer`` raises; off one it passes as it is."""
    from repro_torch.analysis import hlo
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import tree_map
    cfg = torch_config("xlstm_125m").reduced()
    mesh = AbstractMesh(MESH, ("data", "model"))
    rules = shd.default_rules()
    lays = tst.state_layouts(cfg, mesh, rules).params
    blocks = tree_map(lambda x: torch.randn(x.shape),
                      tst.abstract_state(cfg, mesh, rules, "cpu").params)
    live = []
    tree = shd.for_layers(blocks, lays, (), live)
    lay = lays["groups"]["mlstm"]["mixer"]["wq"]
    wq = tree["groups"]["mlstm"]["mixer"]["wq"]
    assert isinstance(wq, shd.Stacked) and wq.lead == lay.shape[:2] == (1, 3)
    assert tuple(wq.shape) == lay.shape
    assert all(t.requires_grad and tuple(t.shape) == lay.local_shape[2:]
               for t in wq.parts)
    assert isinstance(tree["embed"]["embedding"], torch.Tensor)
    one = wq[0][2]
    assert isinstance(one, shd.LayerBlock) and one.block is wq.parts[2]
    split = sum(len(shd._entries(e)) for e in one.layout.spec)
    assert split == 2           # "embed" on data, "heads" on model

    def gather_and_back():
        w = shd.layer({"w": one})["w"]
        assert tuple(w.shape) == lay.shape[2:]
        (g,) = torch.autograd.grad(w.sum(), [one.block])
        assert tuple(g.shape) == lay.local_shape[2:]
    _, rep = hlo.count(gather_and_back)
    assert rep.collective_counts == {"all-gather": split,
                                     "reduce-scatter": split}
    # a norm scale: "embed" on "data", copies along "model"
    norm = tree["groups"]["mlstm"]["ln"]["scale"][0][0]
    assert norm.layout.spec == shd.P("data")
    _, rep = hlo.count(lambda: torch.autograd.grad(
        shd.layer(norm).sum(), [norm.block]))
    assert rep.collective_counts == {"all-gather": 1, "reduce-scatter": 1,
                                     "all-reduce": 1}
    with pytest.raises(IndexError):
        wq[1]
    t = torch.zeros(3)
    assert shd.layer({"w": t})["w"] is t
    with shd.use_blocks(), pytest.raises(ValueError, match="without its"):
        shd.layer({"w": t})
