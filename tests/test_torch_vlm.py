"""The port's VLM (llava_next_mistral_7b: the dense GQA decoder with image
patch embeddings before the text) against the JAX package's.

Weights come from the JAX package's ``init_params`` and are converted key
for key; tokens and patch embeddings are drawn from a seed with numpy.
The JAX ``attn_impl="pallas"`` path (Pallas in interpret mode) is held
against the port's ``"kernel"``, and ``"chunked"`` against ``"chunked"``,
at atol = rtol = 1e-4, as the model and training tests are
(tests/test_torch_model.py, tests/test_torch_train.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import InputShape as JShape
from repro.models import api as japi
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.parallel import steps as jst
from repro_torch.configs import get_config as torch_config
from repro_torch.configs.base import InputShape
from repro_torch.convert import params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttf
from repro_torch.parallel import steps as tst
from repro_torch.tree import leaves
from torch_parity import close, equal

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
IMPLS = [("pallas", "kernel"), ("chunked", "chunked")]
ARCH = "llava_next_mistral_7b"


def _models(jax_impl, torch_impl, **overrides):
    jc = jax_config(ARCH).reduced().replace(dtype="float32",
                                            attn_impl=jax_impl, **overrides)
    tc = torch_config(ARCH).reduced().replace(dtype="float32",
                                              attn_impl=torch_impl,
                                              **overrides)
    jp = jcommon.init_params(japi.param_spec(jc), jax.random.PRNGKey(0))
    return jc, jp, tc, params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jp), "cpu")


def _inputs(cfg, b, s, seed=0):
    """Text tokens (B,s) and the config's image patches (B,P,D)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s))
    img = rng.standard_normal((b, cfg.n_img_patches, cfg.d_model)).astype(
        np.float32)
    return tokens, img


@pytest.mark.parametrize("jax_impl,torch_impl", IMPLS)
def test_vlm_prefill_and_decode_match_jax(jax_impl, torch_impl):
    """8 patches and a 24-token prompt of 2 rows prefilled into a 64-row
    cache (the text after the patches), then 4 greedy decode steps:
    logits and caches against JAX's ``lm_prefill`` / ``lm_decode``."""
    jc, jp, tc, tp = _models(jax_impl, torch_impl)
    tokens, img = _inputs(jc, 2, 24)
    jl, jcache = jtf.lm_prefill(jc, jp, jnp.asarray(tokens, jnp.int32), 64,
                                img_embeds=jnp.asarray(img))
    tl, tcache = ttf.lm_prefill(tc, tp, torch.from_numpy(tokens), 64,
                                img_embeds=torch.from_numpy(img))
    close(jl, tl, **TOL, what="prefill logits")
    for name in ("k", "v"):
        close(jcache["layers"][name], tcache["layers"][name], **TOL,
              what=f"prefill cache {name}")
    kv_len = np.full(2, 24 + jc.n_img_patches, np.int32)
    for _ in range(4):
        tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
        jl, jcache = jtf.lm_decode(jc, jp, jnp.asarray(tok, jnp.int32),
                                   jcache, jnp.asarray(kv_len))
        tl, tcache = ttf.lm_decode(tc, tp, torch.from_numpy(tok), tcache,
                                   torch.from_numpy(kv_len))
        close(jl, tl, **TOL, what="decode logits")
        kv_len += 1
    for name in ("k", "v"):
        close(jcache["layers"][name], tcache["layers"][name], **TOL,
              what=f"decode cache {name}")


def test_vlm_decode_consistent_with_jax_forward():
    """tests/test_arch_smoke.py's check across the packages: the port's
    prefill of the patches and 16 tokens, then one decode step, give JAX's
    ``lm_forward`` logits at the last two positions (the patches shift the
    text by n_img_patches)."""
    jc, jp, tc, tp = _models("chunked", "kernel")
    tokens, img = _inputs(jc, 2, 17, seed=1)
    full = jtf.lm_forward(jc, jp, jnp.asarray(tokens, jnp.int32),
                          jnp.asarray(img))
    n = jc.n_img_patches
    pre, cache = ttf.lm_prefill(tc, tp, torch.from_numpy(tokens[:, :16]),
                                32, img_embeds=torch.from_numpy(img))
    close(full[:, n + 15], pre, **TOL, what="prefill")
    got, _ = ttf.lm_decode(tc, tp, torch.from_numpy(tokens[:, 16:]), cache,
                           torch.full((2,), n + 16, dtype=torch.int32))
    close(full[:, n + 16], got, **TOL, what="decode")


@pytest.mark.parametrize("jax_impl,torch_impl", IMPLS)
def test_vlm_forward_matches_jax(jax_impl, torch_impl):
    jc, jp, tc, tp = _models(jax_impl, torch_impl)
    tokens, img = _inputs(jc, 2, 24, seed=2)
    want = jtf.lm_forward(jc, jp, jnp.asarray(tokens, jnp.int32),
                          jnp.asarray(img))
    got = ttf.lm_forward(tc, tp, torch.from_numpy(tokens),
                         torch.from_numpy(img))
    assert tuple(got.shape) == (2, jc.n_img_patches + 24, jc.padded_vocab)
    close(want, got, **TOL, what="lm_forward with img_embeds")
    close(jtf.lm_forward(jc, jp, jnp.asarray(tokens, jnp.int32)),
          ttf.lm_forward(tc, tp, torch.from_numpy(tokens)), **TOL,
          what="lm_forward, text only")


@pytest.mark.parametrize("jax_impl,torch_impl", IMPLS)
def test_vlm_loss_and_gradients_match_jax(jax_impl, torch_impl):
    """``api.loss_fn`` on input_spec's train batch (p = min(8, 32 // 2)
    patches before 24 tokens, the image positions labelled -1) and its
    gradients against ``jax.value_and_grad``, the batch from both
    packages' ``materialize_batch`` (the same numbers)."""
    jc, jp, tc, tp = _models(jax_impl, torch_impl)
    jbatch = jst.materialize_batch(jc, JShape("x", 32, 2, "train"), seed=3)
    tbatch = tst.materialize_batch(tc, InputShape("x", 32, 2, "train"),
                                   seed=3, device="cpu")
    assert list(jbatch) == list(tbatch) == ["tokens", "img_embeds",
                                            "labels"]
    for k in jbatch:
        close(jbatch[k], tbatch[k], rtol=0, what=k)
    jloss, jgrads = jax.value_and_grad(
        lambda p: japi.loss_fn(jc)(p, jbatch))(jp)
    tloss, tgrads = tst.loss_and_grads(tapi.loss_fn(tc), tp, tbatch)
    close(jloss, tloss, **TOL, what="loss")
    jflat = jax.tree_util.tree_leaves(jgrads)
    tflat = leaves(tgrads)
    assert len(jflat) == len(tflat)
    for j, t in zip(jflat, tflat):
        close(j, t, **TOL, what="gradient")


def test_vlm_loss_ignores_the_image_positions():
    """The loss over patches and text equals the cross-entropy of the text
    positions alone: the patches' labels are -1."""
    _, _, tc, tp = _models("chunked", "chunked")
    tokens, img = _inputs(tc, 2, 12, seed=4)
    labels = np.random.default_rng(5).integers(0, tc.vocab, (2, 12))
    batch = {"tokens": torch.from_numpy(tokens),
             "img_embeds": torch.from_numpy(img),
             "labels": torch.from_numpy(labels)}
    logits = ttf.lm_forward(tc, tp, batch["tokens"], batch["img_embeds"])
    want = torch.nn.functional.cross_entropy(
        logits[:, tc.n_img_patches:].reshape(-1, logits.shape[-1]),
        batch["labels"].reshape(-1))
    close(want.detach(), ttf.lm_loss(tc, tp, batch).detach(), rtol=1e-6,
          what="loss")


@pytest.mark.parametrize("seq", [32, 12])
def test_vlm_input_and_cache_specs_match_jax(seq):
    """input_spec (p = min(n_img_patches, seq // 2): 8 at 32, 6 at 12) and
    the decode cache spec, key for key, against the JAX package's."""
    jc, tc = jax_config(ARCH).reduced(), torch_config(ARCH).reduced()
    for kind in ("train", "prefill", "decode"):
        jspec = japi.input_spec(jc, JShape("x", seq, 4, kind))
        tspec = tapi.input_spec(tc, InputShape("x", seq, 4, kind))
        assert list(jspec) == list(tspec)
        for k in jspec:
            assert (jspec[k].shape, jspec[k].axes) == \
                (tspec[k].shape, tspec[k].axes)
            assert jnp.dtype(jspec[k].dtype).name == \
                str(tspec[k].dtype).removeprefix("torch.")
        batch = tst.materialize_batch(tc, InputShape("x", seq, 4, kind),
                                      seed=1, device="cpu")
        jbatch = jst.materialize_batch(jc, JShape("x", seq, 4, kind), seed=1)
        assert list(jbatch) == list(batch)
        for k in jbatch:
            equal(np.asarray(jbatch[k]), batch[k], what=f"{kind} {k}")
    js = japi.cache_spec(jc, JShape("e", 64, 2, "decode"))
    ts = tapi.cache_spec(tc, InputShape("e", 64, 2, "decode"))
    assert {k: (s.shape, s.axes) for k, s in ts["layers"].items()} == \
        {k: (s.shape, s.axes) for k, s in js["layers"].items()}
