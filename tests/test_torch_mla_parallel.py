"""Tensor parallelism of MLA over "model" in the mesh steps of the port
(``models.mla`` under ``parallel.tensor``), on 8 gloo ranks on the CPU
against the JAX package, as ``tests/test_torch_parallel.py`` runs its
mesh steps (``tests/torch_mesh_programs.py``):

* reduced deepseek_v2_236b at 8 heads and 3 layers (MLA with q_lora > 0,
  a dense first layer, then MoE layers of 8 experts, top-2, and one shared
  expert, at the capacity factor of 1.25, where JAX's dispatch drops
  slots), two train steps on (4, 2), (2, 4) and (1, 8) at
  ``act_shard="seq"``: each device holds H/m heads of wq_b, wkv_b and wo,
  E/m experts and S/m rows of the stream;
* reduced minicpm3_4b (dense MLA, 4 heads) on (1, 8), where the heads do
  not divide the axis (the attention whole, the MLP and the vocab split),
  and on (2, 4) with q_lora = 0 (wq split by heads);
* each against JAX's single-device step and the port's unsharded step
  (``test_torch_parallel.check_sharded_train``: the state at 1e-6 of
  each leaf in fp32 where that holds, every leaf at 1e-12 in float64, the
  first gradients too, the op counts the dry run's);
* the mesh prefill of both models on (2, 4) and four greedy serve ticks
  from its cache (the latent cache whole over "model"): logits within
  1e-4 of JAX's, the same tokens, each step's op counts the dry run's.
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
from test_torch_parallel import (_check_moe_blocks, _split_leaves,
                                 _write_state, check_sharded_train,
                                 run_ranks)
from torch_parity import close

DS = "deepseek_v2_236b"
CPM = "minicpm3_4b"
# reduced deepseek_v2_236b with heads enough for a block on 8 devices
DS_CUT = {"n_heads": 8, "n_layers": 3}
torch.set_num_threads(1)


# Under the head split and expert parallelism a layer's output is a sum
# over the axis of each device's heads and experts, which rounds
# otherwise than the unsharded sum, and Adam's normalisation carries that
# into the state.  tests/torch_mesh_rounding.py gives each case's largest
# fp32 gap to the unsharded step, a share of the leaf's largest value,
# beside that step's own gap to its float64 run: deepseek_v2_236b (4, 2)
# params 8.82e-7, first moments 1.45e-6 (2.06e-6); (2, 4) 8.41e-7 and
# 1.79e-6; (1, 8) params 1.51e-6 (1.43e-6); minicpm3_4b (1, 8) params
# 3.78e-6 (3.04e-6); q_lora = 0 on (2, 4) params 5.35e-7, first moments
# 1.05e-6 (1.56e-6).  So the parameters (and masters) are held at 1e-6 in
# fp32 where they land within it, and every leaf at 1e-12 in float64,
# where the mesh and the unsharded step agree to 6e-15.
@pytest.mark.parametrize("mesh,case", [
    pytest.param((4, 2), dict(arch=DS, replace=DS_CUT, fp32_moments=False),
                 id="ds-mesh0"),
    pytest.param((2, 4), dict(arch=DS, replace=DS_CUT, fp32_moments=False),
                 id="ds-mesh2"),
    # one head and one expert a device
    pytest.param((1, 8), dict(arch=DS, replace=DS_CUT, fp32_state=False),
                 id="ds-1x8"),
    # 4 heads do not divide 8: the attention whole, the MLP and the vocab
    # split
    pytest.param((1, 8), dict(arch=CPM, fp32_state=False),
                 id="cpm-heads-whole-1x8"),
    # no query compression: wq itself split by heads
    pytest.param((2, 4), dict(arch=CPM, replace={"q_lora": 0},
                              fp32_moments=False), id="cpm-wq-mesh2"),
])
def test_mla_train_step_matches_single_device(tmp_path, monkeypatch, mesh,
                                              case):
    check_sharded_train(tmp_path, monkeypatch, mesh, "seq", case)


@pytest.mark.parametrize("arch,over", [(DS, DS_CUT), (CPM, {})],
                         ids=["ds", "cpm"])
def test_mla_prefill_and_serve_match_single_device(tmp_path, arch, over):
    """The mesh prefill of 4 x 16 tokens on (2, 4), each device computing
    its H/4 heads on the gathered sequence and its 4 of the 16 rows of the
    stream, then four greedy serve ticks from its cache: the last logits
    within 1e-4 of JAX's single-device prefill, the tokens JAX's greedy
    decode, each step's op counts the dry run's.  The latent cache holds
    this device's 2 rows whole in its latent and rope key (it has no
    heads); deepseek_v2's MoE layers get their block of 2 experts."""
    mesh, seq, ticks = (2, 4), 16, 4
    jc = jax_config(arch).reduced().replace(dtype="float32",
                                            act_shard="seq", **over)
    tc = torch_config(arch).reduced().replace(dtype="float32",
                                              act_shard="seq", **over)
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
        arch=arch, act_shard="seq", mesh=list(mesh), ticks=ticks,
        replace=over)))
    got, info = run_ranks("sharded_prefill", 8, tmp_path)
    close(np.asarray(logits), got["logits"], rtol=1e-4, atol=1e-4,
          what="mesh prefill logits against JAX")
    assert np.array_equal(got["tokens"], np.stack(want, 1))
    assert info["split_leaves"] == _split_leaves(tc, mesh, "seq", 4) > 0
    assert info["stream_rows"] == seq // mesh[1]
    n = tc.n_layers - tc.first_dense
    assert info["cache_shape"] == {
        "ckv": [n, 2, seq + ticks, tc.kv_lora],
        "krope": [n, 2, seq + ticks, tc.qk_rope]}
    if tc.family == "moe":
        _check_moe_blocks(tc, info["moe"], mesh[1], seq // mesh[1])
        _check_moe_blocks(tc, info["tick_moe"], mesh[1], 1)
    _counts_match(info["counts"], tc, InputShape("t", seq, 4, "prefill"),
                  mesh)
    _counts_match(info["tick_counts"], tc,
                  InputShape("t", seq + ticks, 4, "decode"), mesh)
