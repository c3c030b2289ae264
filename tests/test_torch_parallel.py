"""The port's mesh layer on gloo ranks on the CPU, against the JAX package.

Each test runs one subprocess (``tests/torch_mesh_programs.py``) that
spawns its ranks; they meet through a file store under the test's
``tmp_path`` (so parallel test workers share no port) with a 60 s
timeout, and the subprocess has a time limit, so a hang fails one test.

* ``flash_decode_shardmap``, ``compressed_psum`` (k = 1.0) and
  ``pipeline_forward`` on md_programs.py's inputs and meshes (8, 8 and 4
  ranks) against the JAX package's programs on 8 fake devices
  (``tests/jax_mesh_reference.py``) and against their references
  (``ref.decode_ref``, the plain sum, the stages in order), at
  md_programs.py's tolerances.
* The sharded train step of reduced deepseek_7b (fp32, 4 x 16 tokens, two
  steps) on a (4, 2) mesh in both ``act_shard`` modes and on (2, 4):
  against JAX's single-device jitted step at test_torch_train_steps.py's
  tolerances, against the port's unsharded step at 1e-6, every block the
  layout's slice of the whole state; the first step's collective bytes,
  collective counts and FLOPs, as each rank's op counter records them,
  equal the dry run's trace of the same cell on an abstract mesh.  Where
  the step is tensor parallel its residual stream is split by sequence
  (S/m rows a device) and its first gradients equal the unsharded
  step's.
* The sequence collectives of ``parallel.tensor`` on 2 ranks against
  their definitions.
* Elastic restore: a state sharded on (4, 2) and saved whole restores onto
  (2, 4) exactly; that checkpoint restores in JAX, and JAX's restores in
  the port's (2, 4) layout, exactly; each block is also what DTensor's
  ``distribute_tensor`` gives for the layout's placements.
* ``launch.train.main`` on 2 ranks, checkpointed and resumed, against 1
  rank at 1e-5.
"""
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

from repro.checkpoint import store as jstore
from repro.configs import get_config as jax_config
from repro.data import DataConfig, synthetic_batch
from repro.models import api as japi
from repro.parallel import steps as jst
from repro_torch.configs import InputShape
from repro_torch.configs import get_config as torch_config
from repro_torch.kernels import ref as tref
from repro_torch.launch import dryrun
from repro_torch.parallel import steps as tst
from repro_torch.parallel.comm import AbstractMesh
from repro_torch.tree import leaves, unflatten
from torch_mesh_programs import Float64, double
from torch_parity import close

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5          # test_torch_train_steps.py's
torch.set_num_threads(1)


def _env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = f"{ROOT}/src:{ROOT}/tests"
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def run_ranks(prog: str, world: int, d: Path, timeout: int = 240):
    """``prog`` on ``world`` gloo ranks; (out.npz, out.json) of rank 0."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_programs.py"),
         prog, str(world), str(d)], capture_output=True, text=True,
        timeout=timeout, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, f"{prog}:\n{proc.stdout}\n{proc.stderr}"
    arrays = np.load(d / "out.npz") if (d / "out.npz").exists() else None
    info = json.loads((d / "out.json").read_text()) \
        if (d / "out.json").exists() else None
    return arrays, info


@pytest.fixture(scope="module")
def jax_programs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "ref.npz"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "jax_mesh_reference.py"),
         str(out)], capture_output=True, text=True, timeout=300,
        env={**_env(), "JAX_PLATFORMS": "cpu"}, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return np.load(out)


def test_flash_decode_shardmap_on_8_ranks(tmp_path, jax_programs):
    got, _ = run_ranks("flash_decode", 8, tmp_path)
    assert float(got["spread"]) == 0.0      # every rank holds the result
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.standard_normal((2, 4, 16)), dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((2, 64, 4, 16)),
                        dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((2, 64, 4, 16)),
                        dtype=torch.float32)
    want = tref.decode_ref(q, k.transpose(1, 2), v.transpose(1, 2))
    # md_programs.flash_decode_sm's bound
    assert np.abs(got["out"] - want.numpy()).max() < 1e-4
    assert np.abs(got["out"] - jax_programs["flash_decode"]).max() < 1e-5


def test_compressed_psum_on_2_pods_of_4(tmp_path, jax_programs):
    got, _ = run_ranks("compressed_psum", 8, tmp_path)
    rng = np.random.default_rng(2)
    g = rng.standard_normal((2, 4, 64)).astype(np.float32)
    want = g.sum(axis=(0, 1))
    # md_programs.compressed_psum's int8 tolerance
    tol = float(np.abs(want).max()) / 127 * 2 + 1e-5
    assert np.abs(got["out"] - want).max() < tol
    # the same quantization as JAX's, up to one step of the int8 grid
    assert np.abs(got["out"] - jax_programs["psum"][0, 0]).max() < tol
    assert np.abs(got["err"] - jax_programs["psum_err"][0, 0]).max() < tol


def test_pipeline_forward_on_4_stages(tmp_path, jax_programs):
    got, _ = run_ranks("pipeline", 4, tmp_path)
    assert float(got["spread"]) == 0.0
    rng = np.random.default_rng(0)
    s, m, mb, d = 4, 6, 8, 16
    w1 = rng.standard_normal((s, d, d)) * 0.3
    w2 = rng.standard_normal((s, d, d)) * 0.3
    xs = rng.standard_normal((m, mb, d))
    want = torch.as_tensor(xs, dtype=torch.float32)
    for i in range(s):
        want = torch.tanh(want @ torch.as_tensor(w1[i], dtype=torch.float32)
                          ) @ torch.as_tensor(w2[i], dtype=torch.float32)
    assert np.abs(got["out"] - want.numpy()).max() < 1e-5
    assert np.abs(got["out"] - jax_programs["pipeline"]).max() < 1e-5


def _write_state(d: Path, jstate) -> None:
    np.savez(d / "state.npz", **{
        f"a{i}": np.asarray(x)
        for i, x in enumerate(jax.tree_util.tree_leaves(jstate))})


def _torch_state(jstate, cfg):
    return unflatten(tst.abstract_state(cfg), [
        torch.from_numpy(np.array(x))
        for x in jax.tree_util.tree_leaves(jstate)])


# labels masked (-1) at the start of each row of a microbatch: the data
# shards of a (4, 2) mesh hold one row each, so they hold 4, 16, 11 and 0
# valid labels, then 16, 7, 0 and 13
MASKED = ((12, 0, 5, 16), (0, 9, 16, 3))


def _masked(batch, accum):
    """``batch`` with a leading microbatch axis under ``accum`` and
    MASKED's labels set to -1."""
    b = {k: v.reshape(accum, -1, v.shape[-1]).copy()
         for k, v in batch.items()}
    for i in range(accum):
        for r, m in enumerate(MASKED[i]):
            b["labels"][i, r, :m] = -1
    return {k: v if accum > 1 else v[0] for k, v in b.items()}


def _jax_drops(monkeypatch, jc, fn, *args) -> int:
    """The slots JAX's MoE dispatch drops over every MoE layer of
    ``fn(*args)`` (jitted): each layer's routing over the whole batch,
    counted per expert against that batch's capacity at ``jc``'s
    capacity factor."""
    from repro.models import moe as jmoe
    seen, route = [], jmoe.route

    def spy(params, x, top_k):
        out = route(params, x, top_k)
        jax.debug.callback(lambda ids: seen.append(np.asarray(ids)), out[1])
        return out
    with monkeypatch.context() as m:
        m.setattr(jmoe, "route", spy)
        jax.block_until_ready(jax.jit(fn)(*args))
    dropped = 0
    for ids in seen:
        n, k = ids.shape
        e = jc.n_experts
        cap = int(max(1, (n * k / e) * jc.capacity_factor))
        dropped += int(np.maximum(np.bincount(ids.ravel(), minlength=e)
                                  - cap, 0).sum())
    assert seen, "no MoE layer routed"
    return dropped


def _perturbed_norms(js, seed: int = 7):
    """JAX's state ``js`` with every norm scale (ln1, ln2, final_norm)
    drawn as 1 + N(0, 0.5^2), in the parameters and their fp32 master
    copies alike."""
    rng = np.random.default_rng(seed)

    def scale(path, x):
        if getattr(path[-1], "key", None) != "scale":
            return x
        return jnp.asarray(1 + 0.5 * rng.standard_normal(x.shape), x.dtype)
    params = jax.tree_util.tree_map_with_path(scale, js.params)
    master = jax.tree_util.tree_map(lambda x: jnp.array(x, jnp.float32),
                                    params)
    return js._replace(params=params, opt=js.opt._replace(master=master))


def _first_grads(tc, state, batch, accum):
    """The port's unsharded gradients of ``batch`` at ``state``'s
    parameters, as its train step computes them before AdamW."""
    from repro_torch.models import api as tapi
    return tst._accumulated(tapi.loss_fn(tc), state.params, {
        k: torch.as_tensor(v) for k, v in batch.items()}, accum)[1]


def _tensor_parallel(tc, mesh, act_shard, rows) -> bool:
    """Whether a mesh step of ``tc`` is tensor parallel
    (``parallel.tensor.applies``)."""
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor
    return tensor.applies(tc, AbstractMesh(mesh, ("data", "model")),
                          shd.default_rules(act_shard=act_shard), rows)


def _split_leaves(tc, mesh, act_shard, rows) -> int:
    """The parameter leaves a mesh step of ``tc`` hands the layer code as
    their "model" blocks: those whose spec splits them over "model" where
    the step is tensor parallel (``parallel.tensor.applies``), but those
    it gathers whole over "model" too (``tensor.keeps``), else 0."""
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor
    am = AbstractMesh(mesh, ("data", "model"))
    rules = shd.default_rules(act_shard=act_shard)
    if not tensor.applies(tc, am, rules, rows):
        return 0
    lays = tst.state_layouts(tc, am, rules).params
    return sum("model" in lay.spec and "model" in keep
               for lay, keep in zip(leaves(lays), tensor.keeps(lays),
                                    strict=True))


def _check_moe_blocks(tc, got, m: int, rows: int) -> None:
    """What a MoE layer of a mesh step got (``_BlockSpy.moe``): the routed
    experts as this device's block of E/m, the router whole, and ``rows``
    rows of the residual stream (B/dp rows, S/m positions)."""
    e, d, f = tc.n_experts, tc.d_model, tc.d_ff_expert
    assert got["router"] == [d, e]
    assert got["w_gate"] == got["w_up"] == [e // m, d, f]
    assert got["w_down"] == [e // m, f, d]
    assert got["x"][1:] == [rows, d]


@pytest.mark.parametrize("mesh,act_shard,case", [
    pytest.param((4, 2), "seq", {}, id="mesh0-seq"),
    pytest.param((4, 2), "batch2d", {}, id="mesh1-batch2d"),
    pytest.param((2, 4), "seq", {}, id="mesh2-seq"),
    # the loss is one global mean, however the masked labels fall
    pytest.param((4, 2), "seq", dict(masked=True), id="masked-accum1"),
    pytest.param((4, 2), "seq", dict(masked=True, accum=2),
                 id="masked-accum2"),
    # tensor parallel: the VLM, its 8 image patches entering whole; in
    # fp32 its first moments land up to 1.08e-6 of a leaf's largest value
    # from the unsharded step's, which are themselves up to 1.46e-6 from
    # the float64 step's, so they are held in float64 only
    pytest.param((2, 4), "seq", dict(arch="llava_next_mistral_7b",
                                     fp32_moments=False), id="vlm-mesh2"),
    # 4 heads do not divide 8: the attention stays whole, the MLP and
    # the vocab are split
    pytest.param((1, 8), "seq", {}, id="heads-whole-1x8"),
    # norm scales away from 1: the sequence-split step must sum their
    # gradients over "model" (each device computes its rows' share); the
    # scales amplify fp32 rounding (the unsharded fp32 step's parameters
    # land 2.0e-6 of a leaf from the float64 step's, the mesh's 1.5e-6),
    # so its state is held in float64 only, its gradients in both
    pytest.param((2, 4), "seq", dict(norms=True, fp32_state=False),
                 id="norms-mesh2"),
    # nothing divides 3 but 12 rows: every leaf whole, the stream split
    pytest.param((1, 3), "seq", dict(seq=12), id="whole-1x3"),
])
def test_sharded_train_step_matches_single_device(tmp_path, monkeypatch,
                                                  mesh, act_shard, case):
    check_sharded_train(tmp_path, monkeypatch, mesh, act_shard, case)


def check_sharded_train(tmp_path, monkeypatch, mesh, act_shard, case):
    """Two steps of the mesh train step against JAX's single-device step
    and the port's unsharded one (rank 0's record returned), the state at
    1e-6 of each leaf's
    largest value.  Where the step is tensor parallel (dense, VLM and MoE
    families, "model" not a batch axis) its split sums round otherwise:
    the parameters (and, but for the VLM, the first moments) are held at
    1e-6 in fp32, and every leaf in float64 (``Float64``: the mesh step
    and the unsharded step both run again in float64), where the two
    agree to 1e-12, rounding's scale there.  In fp32 the second moments
    land up to 1.24e-6 from the unsharded step's, which is itself up to
    1.4e-6 from the float64 step's (PERF.md).  There the step also splits
    its residual stream by sequence (S/m rows a device), and its first
    gradients (every leaf, the norm scales among them) equal the
    unsharded step's: at 1e-5 of a leaf's largest value in fp32 and
    1e-12 in float64.  A MoE layer gets its block of the experts and the
    router whole (``_check_moe_blocks``)."""
    arch = case.get("arch", "deepseek_7b")
    accum, steps, kw = case.get("accum", 1), 2, dict(total_steps=5,
                                                     warmup=2)
    seq = case.get("seq", 16)
    over = case.get("replace", {})
    jc = jax_config(arch).reduced().replace(dtype="float32",
                                            act_shard=act_shard, **over)
    tc = torch_config(arch).reduced().replace(dtype="float32",
                                              act_shard=act_shard,
                                              accum=accum, **over)
    # a VLM cell of 16 positions is 8 image patches and 8 tokens
    text = seq // 2 if jc.family == "vlm" else seq
    dc = DataConfig(seq_len=text, global_batch=4 * accum, vocab=jc.vocab)
    batches = [synthetic_batch(dc, s) for s in range(steps)]
    if jc.family == "vlm":
        rng = np.random.default_rng(5)
        for b in batches:
            b["img_embeds"] = rng.standard_normal(
                (4 * accum, seq - text, jc.d_model)).astype(np.float32)
    if case.get("masked"):
        batches = [_masked(b, accum) for b in batches]
    js = jst.init_train_state(jc, jax.random.PRNGKey(0))
    if case.get("norms"):
        js = _perturbed_norms(js)
    if jc.family == "moe":              # the case reaches the capacity
        assert jc.capacity_factor == 1.25
        assert _jax_drops(monkeypatch, jc, japi.loss_fn(jc), js.params, {
            k: jnp.asarray(v) for k, v in batches[0].items()}) > 0
    _write_state(tmp_path, js)
    np.savez(tmp_path / "batches.npz", **{
        f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
    # the leaves the layer code gets as their "model" blocks (0: no
    # tensor parallelism, or none divides the axis)
    split = _split_leaves(tc, mesh, act_shard, 4)
    tp = _tensor_parallel(tc, mesh, act_shard, 4)
    (tmp_path / "info.json").write_text(json.dumps(dict(
        arch=arch, act_shard=act_shard, mesh=list(mesh), steps=steps,
        accum=accum, float64=tp, replace=over, **kw)))
    js0, ts = js, _torch_state(js, tc)
    # JAX's single-device jitted step and the port's unsharded one
    jstep = jax.jit(jst.make_train_step(jc, accum=accum, **kw))
    tstep = tst.make_train_step(tc, accum=accum, **kw)
    jl, tl, lrs = [], [], []
    for b in batches:
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        lrs.append(float(jm["lr"]))
    got, info_out = run_ranks("sharded_train", int(np.prod(mesh)),
                              tmp_path)
    assert float(got["block_diff"]) == 0.0
    # the layer code got each model-split leaf as its block, no other
    assert info_out["split_leaves"] == split
    assert tp == (act_shard == "seq")
    assert (split > 0) == tp or mesh == (1, 3)
    # a tensor-parallel device held S/m rows of the residual stream
    assert info_out["stream_rows"] == (seq // mesh[1] if tp else seq)
    if tc.family == "moe":
        _check_moe_blocks(tc, info_out["moe"], mesh[1] if tp else 1,
                          seq // mesh[1] if tp else seq)
    # the dry run of this cell predicts the step's collectives and FLOPs
    pred = dryrun.trace_cell(tc, InputShape("t", seq, 4 * accum, "train"),
                             AbstractMesh(mesh, ("data", "model")))
    counts = info_out["counts"]
    assert counts["collective_bytes"] == \
        pred["hlo_analysis"]["collective_bytes"]
    assert counts["collective_counts"] == \
        pred["hlo_analysis"]["collective_counts"]
    assert counts["flops"] == pred["hlo_analysis"]["flops"]
    close(jl, info_out["losses"], rtol=LOSS_RTOL, what="losses against JAX")
    close(tl, info_out["losses"], rtol=1e-6,
          what="losses against unsharded")
    sharded = [got[f"a{i}"] for i in range(len(leaves(ts)))]
    for j, t, s in zip(jax.tree_util.tree_leaves(js), leaves(ts), sharded,
                       strict=True):
        close(j, s, rtol=1e-5, atol=1e-2 * sum(lrs), what="state vs JAX")
    n = len(leaves(ts.params))
    group = ["params"] * n + ["step"] + ["master"] * n + ["m"] * n + \
        ["v"] * n
    fp32 = {"params", "step", "master", "m", "v"}
    if tp:
        fp32 -= {"v"} if case.get("fp32_moments", True) else {"m", "v"}
        if not case.get("fp32_state", True):
            fp32 = {"step"}
    for g, t, s in zip(group, leaves(ts), sharded, strict=True):
        scale = max(float(np.abs(t.numpy()).max()), 1e-30)
        assert g not in fp32 or np.abs(s - t.numpy()).max() <= 1e-6 * scale, \
            f"{g}: state vs the unsharded step"
    if not tp:
        return info_out
    for i, t in enumerate(leaves(_first_grads(tc, _torch_state(js0, tc),
                                              batches[0], accum))):
        scale = max(float(t.abs().max()), 1e-30)
        assert np.abs(got[f"g{i}"] - t.numpy()).max() <= 1e-5 * scale, \
            f"gradient {i} ({tuple(t.shape)}) vs the unsharded step's"
    with Float64():
        tstep = tst.make_train_step(tc, accum=accum, **kw)
        ts, tl = double(_torch_state(js0, tc)), []
        for i, t in enumerate(leaves(_first_grads(tc, ts, double(
                batches[0]), accum))):
            t = t.numpy()
            scale = max(float(np.abs(t).max()), 1e-30)
            assert got[f"h{i}"].dtype == np.float64
            assert np.abs(got[f"h{i}"] - t).max() <= 1e-12 * scale, \
                f"float64 gradient {i} vs the unsharded step's"
        for b in batches:
            ts, tm = tstep(ts, double(b))
            tl.append(float(tm["loss"]))
    close(tl, info_out["losses64"], rtol=1e-12,
          what="float64 losses against unsharded")
    for i, t in enumerate(leaves(ts)):
        s, t = got[f"d{i}"], t.numpy()
        assert s.dtype == t.dtype and (s.dtype == np.float64
                                       or group[i] == "step")
        scale = max(float(np.abs(t).max()), 1e-30)
        assert np.abs(s - t).max() <= 1e-12 * scale, \
            f"{group[i]}: float64 state vs the unsharded step"
    return info_out


@pytest.mark.parametrize("ticks,seq", [(0, 16), (4, 16), (0, 15)],
                         ids=["prefill", "serve", "prefill-15"])
def test_tensor_parallel_prefill_and_serve_match_single_device(tmp_path,
                                                               ticks, seq):
    """Reduced glm4_9b (4 x ``seq`` tokens, fp32) prefilled on a (2, 4)
    mesh, its heads, MLP and vocab split over "model": the last logits
    against JAX's single-device prefill at the MoE prefill's bounds; then
    ``ticks`` greedy serve steps from the prefill's cache (of the one KV
    head its query head reads), the tokens equal to JAX's greedy decode.
    Each step's op counts are the dry run's.  16 tokens split the
    residual stream by sequence (4 rows a device, reduce-scattered); 15
    do not divide the model axis, so the stream stays whole and no
    reduce-scatter runs."""
    arch, act_shard, mesh = "glm4_9b", "seq", (2, 4)
    jc = jax_config(arch).reduced().replace(dtype="float32",
                                            act_shard=act_shard)
    tc = torch_config(arch).reduced().replace(dtype="float32",
                                              act_shard=act_shard)
    tokens = synthetic_batch(DataConfig(seq_len=seq, global_batch=4,
                                        vocab=jc.vocab), 0)["tokens"]
    js = jst.init_train_state(jc, jax.random.PRNGKey(0))
    logits, cache = jax.jit(japi.prefill_fn(jc, seq + ticks))(
        js.params, {"tokens": jnp.asarray(tokens)})
    want = [np.asarray(jnp.argmax(logits, -1))]
    batch = {"token": jnp.argmax(logits, -1).astype(jnp.int32)[:, None],
             "kv_len": jnp.full((4,), seq, jnp.int32)}
    serve = jax.jit(jst.make_serve_step(jc))
    for _ in range(ticks):
        batch, cache = serve(js.params, batch, cache)
        want.append(np.asarray(batch["token"][:, 0]))
    _write_state(tmp_path, js)
    np.save(tmp_path / "tokens.npy", tokens)
    (tmp_path / "info.json").write_text(json.dumps(dict(
        arch=arch, act_shard=act_shard, mesh=list(mesh), ticks=ticks)))
    got, info = run_ranks("sharded_prefill", 8, tmp_path)
    close(np.asarray(logits), got["logits"], rtol=1e-4, atol=1e-4,
          what="mesh prefill logits against JAX")
    assert info["split_leaves"] == _split_leaves(tc, mesh, act_shard, 4) > 0
    # the prefill's stream: 4 of 16 rows a device, or 15 whole
    assert info["stream_rows"] == (4 if seq == 16 else 15)
    assert ("reduce-scatter" in info["counts"]["collective_counts"]) == \
        (seq == 16)
    am = AbstractMesh(mesh, ("data", "model"))
    pred = dryrun.trace_cell(tc, InputShape("t", seq, 4, "prefill"), am)
    if ticks:
        assert np.array_equal(got["tokens"], np.stack(want, 1))
        # this device's 2 rows of the cache, its query head's one KV head
        kv = [4, 2, seq + ticks, 1, 32]
        assert info["cache_shape"] == {"k": kv, "v": kv}
        pred = dryrun.trace_cell(tc, InputShape("t", seq + ticks, 4,
                                                "decode"), am)
        info["counts"] = info["tick_counts"]
    for key in ("collective_bytes", "collective_counts", "flops"):
        assert info["counts"][key] == pred["hlo_analysis"][key], key


def test_sequence_collectives_on_2_ranks(tmp_path):
    """``gather_seq``, ``scatter_seq``, ``split_seq`` and ``last_row`` on a
    (1, 2) gloo mesh, forward and backward, against their definitions
    from both ranks' draws: the gather joins the rows and reduce-scatters
    its gradient (or, with ``copies``, takes this rank's rows of it), the
    scatter sums and keeps this rank's rows and all-gathers its
    gradient, the split keeps this rank's rows and all-gathers its
    gradient, and the last row is rank 1's, on rank 0."""
    got, _ = run_ranks("seq_collectives", 2, tmp_path)
    x = [got[f"x{r}"] for r in range(2)]
    whole = [got[f"whole{r}"] for r in range(2)]
    g_whole = [got[f"g_whole{r}"] for r in range(2)]
    g_rows = [got[f"g_rows{r}"] for r in range(2)]
    assert np.array_equal(got["gather"], np.concatenate(x, 1))
    assert np.array_equal(got["gather_copies"], np.concatenate(x, 1))
    assert np.allclose(got["gather_grad"], (g_whole[0] + g_whole[1])[:, :3],
                       rtol=0, atol=1e-15)
    assert np.array_equal(got["gather_copies_grad"], g_whole[0][:, :3])
    assert np.allclose(got["scatter"], (whole[0] + whole[1])[:, :3],
                       rtol=0, atol=1e-15)
    assert np.array_equal(got["scatter_grad"], np.concatenate(g_rows, 1))
    assert np.array_equal(got["split"], whole[0][:, :3])
    assert np.array_equal(got["split_grad"], np.concatenate(g_rows, 1))
    assert np.array_equal(got["last_row"], x[1][:, -1:])


@pytest.mark.parametrize("act_shard,rows,axes", [
    ("seq", 4, ("data",)), ("seq", 2, None), ("seq", 1, None),
    ("batch2d", 8, ("data", "model")), ("batch2d", 4, ("model",)),
    ("batch2d", 2, ("model",))])
def test_row_groups_follow_the_batch_cut(act_shard, rows, axes):
    """The row groups a MoE mesh step counts on (4, 2) are the batch axes
    the rules cut its rows over (they drop those that do not divide the
    rows, from the left), and a MoE mesh step needs the global batch to
    know them."""
    from repro_torch.parallel import sharding as shd
    mesh = AbstractMesh((4, 2), ("data", "model"))
    rules = shd.default_rules(act_shard=act_shard)
    groups = shd.RowGroups.of(mesh, rules, rows)
    assert (groups and groups.axes) == axes
    tc = torch_config("deepseek_moe_16b").reduced().replace(
        act_shard=act_shard)
    for make in (lambda: tst.make_train_step(tc, mesh=mesh, rules=rules),
                 lambda: tst.make_prefill_step(tc, 16, mesh, rules),
                 lambda: tst.make_serve_step(tc, mesh, rules)):
        with pytest.raises(ValueError, match="global_batch"):
            make()


def test_elastic_restore_between_meshes_and_packages(tmp_path):
    cfg = jax_config("glm4_9b").reduced().replace(dtype="float32")
    js = jst.init_train_state(cfg, jax.random.PRNGKey(0))
    _write_state(tmp_path, js)
    jstore.save(tmp_path / "jax", 1, js)
    _, info = run_ranks("elastic", 8, tmp_path)
    assert info["worst"] == 0.0
    assert info["moved"] > 0            # some leaves change layout
    # the port's sharded checkpoint restores in JAX, exactly
    back = jstore.restore(tmp_path / "port", 1, js)
    for a, b in zip(jax.tree_util.tree_leaves(js),
                    jax.tree_util.tree_leaves(back), strict=True):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_launcher_on_two_ranks_matches_one(tmp_path):
    """Two ranks to step 2 with a checkpoint, then resumed to step 4 from
    it: the losses of the one-rank run at 1e-5."""
    from repro_torch.launch import train
    argv = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
            "--attn-impl", "chunked"]
    one, two = tmp_path / "one.jsonl", tmp_path / "two.jsonl"
    assert train.main(argv + ["--steps", "4", "--log", str(one)]) == 0
    for steps in ("2", "4"):
        (tmp_path / "argv.json").write_text(json.dumps(argv + [
            "--steps", steps, "--log", str(two), "--ckpt-dir",
            str(tmp_path / "ckpt"), "--ckpt-every", "2"]))
        (tmp_path / "store").unlink(missing_ok=True)
        run_ranks("launcher", 2, tmp_path)
    l1 = [json.loads(x)["loss"] for x in one.read_text().splitlines()]
    l2 = [json.loads(x)["loss"] for x in two.read_text().splitlines()]
    assert len(l1) == len(l2) == 4
    close(l1, l2, rtol=1e-5, what="2-rank losses, resumed at step 2")
