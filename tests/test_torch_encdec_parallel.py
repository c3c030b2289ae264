"""Tensor and sequence parallelism of the encoder-decoder over "model" in
the mesh steps of the port (``models.encdec`` under ``parallel.tensor``),
on 8 gloo ranks on the CPU against the JAX package, as
``tests/test_torch_parallel.py`` runs its mesh steps
(``tests/torch_mesh_programs.py``):

* reduced whisper_medium at 8 heads on 8 KV heads (Whisper's own layout,
  2 encoder and 2 decoder layers, d_model 128, a vocab of 500 padded to
  512), two train steps on (2, 4) and (1, 8) at ``act_shard="seq"``:
  each device holds 8/m heads of the self- and cross-attention, the KV
  heads they read, its block of the MLP and of the vocab, and S/m rows of
  each stream where S divides the axis; with 12 frames on (1, 8) the
  encoder's stream stays whole while the decoder's 16 tokens split;
* each against JAX's single-device step and the port's unsharded step
  (``test_torch_parallel.check_sharded_train``: every leaf of the state
  at 1e-12 in float64, the first gradients at 1e-5 in fp32 and 1e-12 in
  float64, the op counts the dry run's);
* the mesh prefill (the encoder, every decoder layer's cross K/V and the
  first token) on both meshes and four greedy serve ticks from its
  cache: logits within 1e-4 of JAX's, the same tokens, each step's op
  counts the dry run's, the self and cross caches of a device's KV heads;
* chip_smoke.py's phase 21(i) rehearsed in two processes on the CPU.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import api as japi
from repro.parallel import steps as jst
from repro_torch.configs import InputShape
from repro_torch.configs import get_config as torch_config
from test_torch_expert_parallel import _counts_match
from test_torch_parallel import (_split_leaves, _write_state,
                                 check_sharded_train, encdec_batch,
                                 run_ranks)
from torch_parity import close

ARCH = "whisper_medium"
# Whisper's heads all read their own KV head; a vocab that pads
REPLACE = dict(n_heads=8, n_kv_heads=8, vocab=500)
torch.set_num_threads(1)


def _heads(m: int) -> list:
    """The (query, KV) heads of a device's attention calls on a model axis
    of ``m``: 8/m of each."""
    return [[8 // m, 8 // m]]


# Under the head split each attention's, the SwiGLU's and the vocab's
# outputs are sums over the axis of each device's part, which round
# otherwise than the unsharded sums; Adam's normalisation carries that
# into the state.  tests/torch_mesh_rounding.py whisper_medium (--set
# n_heads=8 --set n_kv_heads=8 --set vocab=500) gives each case's largest
# fp32 gap to the unsharded step, a share of the leaf's largest value,
# beside that step's own gap to its float64 run: (2, 4) params 1.24e-6
# (1.22e-6), first moments 1.15e-6 (9.98e-7), first gradients 1.55e-6
# (1.42e-6); (1, 8), 12 frames, params 9.87e-7 (9.14e-7), first moments
# 1.22e-6 (1.42e-6), first gradients 1.42e-6 (1.38e-6).  The unsharded
# fp32 step is as far from float64 as the mesh is from it, so the state
# is held in float64 only, where mesh and unsharded agree to 4.6e-15,
# and the first gradients in both (1e-5 in fp32, 1e-12 in float64).
@pytest.mark.parametrize("mesh,frames", [
    pytest.param((2, 4), 16, id="encdec-mesh2"),
    # 12 frames do not divide 8: the encoder's stream stays whole
    pytest.param((1, 8), 12, id="encdec-frames12-1x8"),
])
def test_encdec_train_step_matches_single_device(tmp_path, monkeypatch,
                                                 mesh, frames):
    """Two train steps against JAX and the unsharded step; each device's
    attention on its 8/m heads, the decoder's stream split to 16/m rows,
    the encoder's to 16/m or whole."""
    info = check_sharded_train(tmp_path, monkeypatch, mesh, "seq", dict(
        arch=ARCH, seq=frames, replace=REPLACE, fp32_state=False))
    m = mesh[1]
    assert info["enc_rows"] == (frames // m if frames % m == 0 else frames)
    assert info["heads"] == {"ssd": [], "attn": _heads(m)}


@pytest.mark.parametrize("mesh,frames", [((2, 4), 16), ((1, 8), 12)],
                         ids=["mesh2", "frames12-1x8"])
def test_encdec_prefill_and_serve_match_single_device(tmp_path, mesh,
                                                      frames):
    """The mesh prefill of 4 rows of ``frames`` frames, each device
    encoding on its heads (its rows of the stream where they divide the
    axis) and projecting its KV heads of every decoder layer's cross
    K/V, then four greedy serve ticks from its cache: the first token's
    logits within 1e-4 of JAX's single-device prefill, the tokens JAX's
    greedy decode, each step's op counts the dry run's; the self and
    cross caches hold the KV heads a device's query heads read."""
    ticks, rows = 4, 4
    over = dict(dtype="float32", act_shard="seq", **REPLACE)
    jc = jax_config(ARCH).reduced().replace(**over)
    tc = torch_config(ARCH).reduced().replace(**over)
    prompt = encdec_batch(jc, rows, frames, 0)["frames"]
    js = jst.init_train_state(jc, jax.random.PRNGKey(0))
    logits, cache = jax.jit(japi.prefill_fn(jc, frames))(
        js.params, {"frames": jnp.asarray(prompt)})
    want = [np.asarray(jnp.argmax(logits, -1))]
    batch = {"token": jnp.argmax(logits, -1).astype(jnp.int32)[:, None],
             "kv_len": jnp.full((rows,), 1, jnp.int32)}
    serve = jax.jit(jst.make_serve_step(jc))
    for _ in range(ticks):
        batch, cache = serve(js.params, batch, cache)
        want.append(np.asarray(batch["token"][:, 0]))
    _write_state(tmp_path, js)
    np.save(tmp_path / "frames.npy", prompt)
    (tmp_path / "info.json").write_text(json.dumps(dict(
        arch=ARCH, act_shard="seq", mesh=list(mesh), ticks=ticks, kv0=1,
        replace=REPLACE)))
    got, info = run_ranks("sharded_prefill", 8, tmp_path)
    close(np.asarray(logits), got["logits"], rtol=1e-4, atol=1e-4,
          what="mesh prefill logits against JAX")
    assert np.array_equal(got["tokens"], np.stack(want, 1))
    assert info["split_leaves"] == _split_leaves(tc, mesh, "seq", rows) > 0
    m, local = mesh[1], rows // mesh[0]
    assert info["enc_rows"] == (frames // m if frames % m == 0 else frames)
    assert info["heads"] == info["tick_heads"] == {"ssd": [],
                                                  "attn": _heads(m)}
    n, kv = tc.n_dec_layers, 8 // m
    cross = [n, local, frames, kv, tc.dh]
    assert info["cache_shape"] == {
        "self": {k: [n, local, tc.dec_len, kv, tc.dh] for k in "kv"},
        "cross_k": cross, "cross_v": cross}
    _counts_match(info["counts"], tc,
                  InputShape("t", frames, rows, "prefill"), mesh)
    _counts_match(info["tick_counts"], tc,
                  InputShape("t", frames, rows, "decode"), mesh)


def test_chip_smoke_phase_21i_rehearses_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's 21(i) in two processes on a (1, 2) gloo mesh with
    the reduced whisper_medium and chunked attention: the prefill and
    four ticks against the unsharded ones (logits within 1e-5 of max
    |logit|, the same tokens), each rank's attention on half the heads
    and its streams split, its op counts the dry run's (the phase checks
    them), and one train step at the base lr that moves every leaf, held
    in fp32 and in float64 (the phase checks each leaf; here the largest
    gaps)."""
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    out = chip_smoke.mesh_encdec(0, "CPU rehearsal", card_dev="cpu",
                                 smoke=True)
    assert out["logits_err"] <= 1e-5 * out["logits_max"]
    assert out["tokens"] == out["tokens_unsharded"]
    assert out["lr"] > 0 and out["moved_least"] > 0
    assert out["fp64"]["m"][0] <= 1e-12
    assert abs(out["loss"] - out["loss_unsharded"]) \
        <= 1e-6 * abs(out["loss_unsharded"])
    # the self and cross decodes of 2 layers a tick on 2 of the 4 heads
    assert out["shapes"]["flash_decode"] == [[2, 32, 32]] * 2 * 2 * (
        1 + chip_smoke.MESH_TICKS)
    counts = out["counts"]["collective_counts"]
    assert counts["reduce-scatter"] > 0 and counts["all-gather"] > 0
    assert "21(i)" in capsys.readouterr().out
