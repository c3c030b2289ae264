"""Tensor and sequence parallelism of the hybrid family over "model" in the
mesh steps of the port (``models.ssm`` and the shared attention blocks
under ``parallel.tensor``), on 8 gloo ranks on the CPU against the JAX
package, as ``tests/test_torch_parallel.py`` runs its mesh steps
(``tests/torch_mesh_programs.py``):

* reduced zamba2_7b (7 Mamba2 layers of 16 heads of 16, state 16, in two
  groups of 3 with a shared attention block after each, and one rest
  layer; 4 attention heads on 4 KV heads), two train steps on (2, 4) and
  (1, 8) at ``act_shard="seq"``: each device holds 16/m Mamba2 heads (the
  gated norm's scale and out_proj as their blocks, in_proj and the conv
  gathered whole and sliced), S/m rows of the stream, and on (2, 4) one
  attention head of 4 (on (1, 8) the heads stay whole, the MLP and the
  vocab split);
* each against JAX's single-device step and the port's unsharded step
  (``test_torch_parallel.check_sharded_train``: every leaf of the state
  at 1e-12 in float64, the first gradients at 1e-5 in fp32 and 1e-12 in
  float64, the op counts the dry run's);
* the mesh prefill on both meshes and four greedy serve ticks from its
  cache: logits within 1e-4 of JAX's, the same tokens, each step's op
  counts the dry run's, the cache a device's (its Mamba2 heads' conv
  channels and states, the KV heads its query heads read).
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
from test_torch_expert_parallel import _counts_match
from test_torch_parallel import (_split_leaves, _write_state,
                                 check_sharded_train, run_ranks)
from torch_parity import close

ARCH = "zamba2_7b"
torch.set_num_threads(1)


def _heads(tc, m: int) -> dict:
    """The heads a device's SSD calls and attention calls take on a model
    axis of ``m``: h/m Mamba2 heads; the attention's query heads and the
    KV heads they read split where they divide, else whole."""
    from repro_torch.parallel import tensor
    h = tc.ssm_expand * tc.d_model // tc.ssm_headdim
    q, kv = tc.n_heads, tc.n_kv_heads
    if q % m == 0:
        tp = tensor.TensorParallel(None, "model", 0, m, ())
        q, kv = q // m, len(tp.kv_heads(q, kv))
    return {"ssd": [h // m], "attn": [[q, kv]]}


# Under the head split a Mamba2 layer's output is a sum over the axis of
# each device's heads, and its gated norm's sum of squares a sum of each
# device's channels, which round otherwise than the unsharded sums; Adam's
# normalisation carries that into the state.  tests/torch_mesh_rounding.py
# gives each case's largest fp32 gap to the unsharded step, a share of
# the leaf's largest value, beside that step's own gap to its float64
# run: (2, 4) params 6.58e-5 (6.8e-5), first moments 3.71e-6 (4.02e-6),
# first gradients 4.79e-6 (4.48e-6); (1, 8) params 8.56e-5 (6.8e-5),
# first moments 6.34e-6 (4.02e-6), first gradients 3.95e-6 (4.48e-6).
# The unsharded fp32 step is as far from float64 as the mesh is from it,
# so the state is held in float64 only, where mesh and unsharded agree to
# 1.95e-13 (params) and 1.69e-14 (moments), and the first gradients in
# both (1e-5 in fp32, 1e-12 in float64).
@pytest.mark.parametrize("mesh,case", [
    pytest.param((2, 4), dict(arch=ARCH, fp32_state=False),
                 id="hybrid-mesh2"),
    pytest.param((1, 8), dict(arch=ARCH, fp32_state=False),
                 id="hybrid-1x8"),
])
def test_hybrid_train_step_matches_single_device(tmp_path, monkeypatch, mesh,
                                                 case):
    """Two train steps against JAX and the unsharded step; each device's
    SSD on its 16/m heads, its attention on its heads (whole where 4 do
    not divide the axis)."""
    info = check_sharded_train(tmp_path, monkeypatch, mesh, "seq", case)
    tc = torch_config(ARCH).reduced()
    assert info["heads"] == _heads(tc, mesh[1])


@pytest.mark.parametrize("mesh", [(2, 4), (1, 8)], ids=["mesh2", "1x8"])
def test_hybrid_prefill_and_serve_match_single_device(tmp_path, mesh):
    """The mesh prefill of 4 x 16 tokens (one SSD chunk), each device
    computing its 16/m Mamba2 heads and its attention heads on the
    gathered sequence and holding 16/m rows of the stream, then four
    greedy serve ticks from its cache: the last logits within 1e-4 of
    JAX's single-device prefill, the tokens JAX's greedy decode, each
    step's op counts the dry run's.  A device's cache holds its rows, the
    conv tails of its heads' x channels and the whole B and C, its heads'
    SSD states, and the KV heads its query heads read."""
    seq, ticks = 16, 4
    jc = jax_config(ARCH).reduced().replace(dtype="float32",
                                            act_shard="seq")
    tc = torch_config(ARCH).reduced().replace(dtype="float32",
                                              act_shard="seq")
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
        arch=ARCH, act_shard="seq", mesh=list(mesh), ticks=ticks)))
    got, info = run_ranks("sharded_prefill", 8, tmp_path)
    close(np.asarray(logits), got["logits"], rtol=1e-4, atol=1e-4,
          what="mesh prefill logits against JAX")
    assert np.array_equal(got["tokens"], np.stack(want, 1))
    assert info["split_leaves"] == _split_leaves(tc, mesh, "seq", 4) > 0
    assert info["stream_rows"] == seq // mesh[1]
    m, rows = mesh[1], 4 // mesh[0]
    heads = _heads(tc, m)
    assert info["heads"] == info["tick_heads"] == heads
    h, p, n = heads["ssd"][0], tc.ssm_headdim, tc.ssm_state
    mamba = {"conv": [rows, 3, h * p + 2 * n], "ssm": [rows, h, n, p]}
    kv = [rows, seq + ticks, heads["attn"][0][1], tc.dh]
    groups = tc.n_layers // tc.attn_every
    assert info["cache_shape"] == {
        "groups": {k: [groups, tc.attn_every] + v for k, v in mamba.items()},
        "attn": {"k": [groups] + kv, "v": [groups] + kv},
        "rest": {k: [tc.n_layers % tc.attn_every] + v
                 for k, v in mamba.items()}}
    _counts_match(info["counts"], tc, InputShape("t", seq, 4, "prefill"),
                  mesh)
    _counts_match(info["tick_counts"], tc,
                  InputShape("t", seq + ticks, 4, "decode"), mesh)
