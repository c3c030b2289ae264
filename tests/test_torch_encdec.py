"""The port's encoder-decoder (repro_torch.models.encdec, whisper_medium)
against the JAX package's, and the ragged lengths of Whisper's attention
(1500 encoder frames, a 448-row decoder cache) on the kernels' plain
versions against JAX's padded ``attend_chunked`` / ``attend_decode``.

Weights come from the JAX package's ``init_params`` and are converted key
for key; frames and tokens are drawn from a seed with numpy.  JAX runs
``attend_chunked`` in the encoder-decoder whatever ``attn_impl`` says; the
port's ``"kernel"`` (on the CPU the plain versions) and ``"chunked"`` are
both held against it at atol = rtol = 1e-4, the model and training tests'
tolerance.  The kernels' oracles against JAX: 2e-5 in fp32, the kernel
tests' tolerance (tests/test_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import InputShape as JShape
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import encdec as jed
from repro.parallel import steps as jst
from repro_torch.configs import get_config as torch_config
from repro_torch.configs.base import InputShape
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models import common as tcommon
from repro_torch.models import encdec as ted
from repro_torch.parallel import steps as tst
from repro_torch.tree import leaves
from torch_parity import KERNEL_F32_TOL, close, equal

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
IMPLS = ["kernel", "chunked"]
ARCH = "whisper_medium"


def _models(torch_impl, **overrides):
    jc = jax_config(ARCH).reduced().replace(dtype="float32", **overrides)
    tc = torch_config(ARCH).reduced().replace(dtype="float32",
                                              attn_impl=torch_impl,
                                              **overrides)
    jp = jcommon.init_params(japi.param_spec(jc), jax.random.PRNGKey(0))
    return jc, jp, tc, params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jp), "cpu")


def _frames(cfg, b, s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("torch_impl", IMPLS)
@pytest.mark.parametrize("s_enc", [16, 75])
def test_encode_and_decode_train_match_jax(torch_impl, s_enc):
    """The bidirectional encoder over 16 and 75 frames (75: a ragged chunk
    of the reduced attn_chunk 64, as Whisper's 1500 is of 1024) and the
    teacher-forced decoder with cross-attention."""
    jc, jp, tc, tp = _models(torch_impl)
    frames = _frames(jc, 2, s_enc)
    toks = np.random.default_rng(1).integers(0, jc.vocab, (2, jc.dec_len))
    jenc = jed.encode(jc, jp, jnp.asarray(frames))
    tenc = ted.encode(tc, tp, torch.from_numpy(frames))
    close(jenc, tenc, **TOL, what="encode")
    close(jed.decode_train(jc, jp, jenc, jnp.asarray(toks, jnp.int32)),
          ted.decode_train(tc, tp, tenc, torch.from_numpy(toks)), **TOL,
          what="decode_train")


@pytest.mark.parametrize("torch_impl", IMPLS)
def test_prefill_and_decode_match_jax(torch_impl):
    """``encdec_prefill`` (cross K/V of every decoder layer, an empty self
    cache) and 6 decode steps at ragged fills, logits and every cache leaf
    against JAX's; then one step of the port from JAX's cache converted."""
    jc, jp, tc, tp = _models(torch_impl)
    frames = _frames(jc, 2, 24, seed=2)
    jcache = jed.encdec_prefill(jc, jp, jnp.asarray(frames))
    tcache = ted.encdec_prefill(tc, tp, torch.from_numpy(frames))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jcache):
        close(leaf, dict(jax.tree_util.tree_leaves_with_path(tcache))[path],
              **TOL, what=f"prefill {path}")
    rng = np.random.default_rng(3)
    kv_len = np.array([0, 3], np.int32)
    for i in range(6):
        tok = rng.integers(0, jc.vocab, (2, 1))
        jl, jcache = jed.encdec_decode(jc, jp, jnp.asarray(tok, jnp.int32),
                                       jcache, jnp.asarray(kv_len))
        tl, tcache = ted.encdec_decode(tc, tp, torch.from_numpy(tok), tcache,
                                       torch.from_numpy(kv_len))
        close(jl, tl, **TOL, what=f"decode step {i}")
        kv_len += 1
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tcache))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jcache):
        close(leaf, flat_t[path], **TOL, what=f"decode cache {path}")
    tok = np.ones((2, 1), np.int64)
    want, _ = jed.encdec_decode(jc, jp, jnp.asarray(tok, jnp.int32), jcache,
                                jnp.asarray(kv_len))
    got, _ = ted.encdec_decode(
        tc, tp, torch.from_numpy(tok),
        cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache), "cpu"),
        torch.from_numpy(kv_len))
    close(want, got, **TOL, what="decode from JAX's cache")


def test_decode_equals_the_teacher_forced_forward():
    """tests/test_arch_smoke.py's check in the port: 4 decode steps from
    the prefill's cache give ``decode_train``'s logits at each position,
    at that test's 2e-3."""
    _, _, tc, tp = _models("kernel")
    b = 2
    frames = torch.from_numpy(_frames(tc, b, 16, seed=1))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tc.vocab, (b, 4)))
    full = ted.decode_train(tc, tp, ted.encode(tc, tp, frames), toks)
    cache = ted.encdec_prefill(tc, tp, frames)
    kv = torch.zeros(b, dtype=torch.int32)
    for t in range(4):
        got, cache = ted.encdec_decode(tc, tp, toks[:, t:t + 1], cache, kv)
        kv += 1
        close(full[:, t], got, atol=2e-3, rtol=2e-3, what=f"position {t}")


def test_api_prefill_decode_and_cache_spec_match_jax():
    """``api.prefill_fn`` (encode, cross K/V, a BOS decode), two
    ``api.decode_fn`` steps and ``api.cache_spec`` against the JAX API."""
    jc, jp, tc, tp = _models("kernel")
    frames = _frames(jc, 2, 20, seed=4)
    jl, jcache = japi.prefill_fn(jc, 64)(jp, {"frames": jnp.asarray(frames)})
    tl, tcache = tapi.prefill_fn(tc, 64)(tp, {"frames": torch.from_numpy(
        frames)})
    close(jl, tl, **TOL, what="prefill logits")
    kv_len = np.ones(2, np.int32)
    for _ in range(2):
        tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
        jl, jcache = japi.decode_fn(jc)(jp, jnp.asarray(tok, jnp.int32),
                                        jcache, jnp.asarray(kv_len))
        tl, tcache = tapi.decode_fn(tc)(tp, torch.from_numpy(tok), tcache,
                                        torch.from_numpy(kv_len))
        close(jl, tl, **TOL, what="decode logits")
        kv_len += 1
    for cfg_j, cfg_t, shape in ((jc, tc, (20, 2)),
                                (jax_config(ARCH), torch_config(ARCH),
                                 (1500, 4))):
        js = japi.cache_spec(cfg_j, JShape("e", shape[0], shape[1], "decode"))
        ts = tapi.cache_spec(cfg_t, InputShape("e", shape[0], shape[1],
                                               "decode"))
        flat_j = jax.tree_util.tree_leaves_with_path(
            js, is_leaf=jcommon.is_spec)
        flat_t = dict(jax.tree_util.tree_leaves_with_path(
            ts, is_leaf=lambda s: isinstance(s, tcommon.ParamSpec)))
        assert len(flat_j) == len(flat_t) == 4
        for path, s in flat_j:
            assert (flat_t[path].shape, flat_t[path].axes) == \
                (s.shape, s.axes)
    full = tapi.cache_spec(torch_config(ARCH),
                           InputShape("e", 1500, 4, "decode"))
    assert full["self"]["k"].shape == (24, 4, 448, 16, 64)
    assert full["cross_v"].shape == (24, 4, 1500, 16, 64)


@pytest.mark.parametrize("torch_impl", IMPLS)
def test_encdec_loss_and_gradients_match_jax(torch_impl):
    """``api.loss_fn`` on input_spec's train batch (32 frames, dec_len 16
    tokens and labels) and its gradients against ``jax.value_and_grad``,
    the batch from both packages' ``materialize_batch``."""
    jc, jp, tc, tp = _models(torch_impl)
    jbatch = jst.materialize_batch(jc, JShape("x", 32, 2, "train"), seed=5)
    tbatch = tst.materialize_batch(tc, InputShape("x", 32, 2, "train"),
                                   seed=5, device="cpu")
    assert list(jbatch) == list(tbatch) == ["frames", "dec_tokens",
                                            "labels"]
    for k in jbatch:
        equal(np.asarray(jbatch[k]), tbatch[k], what=k)
    jloss, jgrads = jax.value_and_grad(
        lambda p: japi.loss_fn(jc)(p, jbatch))(jp)
    tloss, tgrads = tst.loss_and_grads(tapi.loss_fn(tc), tp, tbatch)
    close(jloss, tloss, **TOL, what="loss")
    jflat = jax.tree_util.tree_leaves(jgrads)
    tflat = leaves(tgrads)
    assert len(jflat) == len(tflat)
    for j, t in zip(jflat, tflat):
        close(j, t, **TOL, what="gradient")


def test_encdec_training_route_reaches_attention_only(monkeypatch):
    """Under grad the loss reaches ``ops.flash_attention`` (under
    "kernel") and no other wrapper: per layer the encoder's self-attention,
    the decoder's self- and cross-attention, each again in its remat
    recompute; the norms are plain."""
    _, _, tc, tp = _models("kernel")
    calls = {}
    for name in ("fused_rmsnorm", "flash_decode", "flash_attention"):
        real = getattr(ops, name)

        def count(*args, _real=real, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(ops, name, count)
    batch = tst.materialize_batch(tc, InputShape("x", 32, 2, "train"),
                                  seed=5, device="cpu")
    tst.loss_and_grads(tapi.loss_fn(tc), tp, batch)
    assert calls == {"flash_attention":
                     2 * (tc.n_layers + 2 * tc.n_dec_layers)}


def test_engine_and_serve_launcher_refuse_the_encoder_decoder():
    """As in the JAX package: the engine drives decoder-only LMs, and
    Whisper goes through the API."""
    from repro_torch.launch import serve
    from repro_torch.serving import ServeConfig, ServingEngine
    _, _, tc, tp = _models("kernel")
    with pytest.raises(NotImplementedError, match="api.prefill_fn"):
        ServingEngine(tc, tp, ServeConfig(n_slots=2, cache_len=16))
    with pytest.raises(SystemExit, match="decoder-only"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


# ---------------------------------------------------------------------------
# Whisper's ragged lengths on the kernels' plain versions
# ---------------------------------------------------------------------------


def _qkv(b, s, t, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("s,t,causal", [
    (1500, 1500, False),    # the encoder's self-attention, 30 s of audio
    (448, 448, True),       # the training decoder's self-attention
    (448, 1500, False),     # its cross-attention
])
def test_ragged_flash_attention_matches_jax_padded_chunks(s, t, causal):
    """``ops.flash_attention`` takes S, T off the TPU kernel's 128-row
    block, as the CUDA kernel does; on the CPU its plain version agrees
    with JAX's ``attend_chunked``, which pads T to its 1024-key chunk."""
    q, k, v = _qkv(1, s, t, 4, 2, 16, seed=s + t)
    want = jattn.attend_chunked(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, chunk=1024)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    close(want, got, rtol=KERNEL_F32_TOL, atol=KERNEL_F32_TOL,
          what=f"S={s} T={t}")


@pytest.mark.parametrize("t,lens", [
    (448, (448, 300, 1)),           # the decoder's self cache
    (1500, (1500, 1500, 1500)),     # the cross cache: every frame
])
def test_ragged_flash_decode_matches_jax_decode(t, lens):
    """``ops.flash_decode`` takes a cache length off the TPU kernel's
    256-key block; on the CPU its plain version agrees with JAX's
    ``attend_decode`` (the masked softmax decode)."""
    q, k, v = _qkv(3, 1, t, 16, 16, 64, seed=t)
    kv_len = np.array(lens, np.int32)
    want = jattn.attend_decode(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(kv_len))
    got = ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(kv_len))
    close(want, got, rtol=KERNEL_F32_TOL, atol=KERNEL_F32_TOL,
          what=f"T={t}")
