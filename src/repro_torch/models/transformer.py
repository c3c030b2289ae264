"""Decoder-only LM for the dense, VLM, MoE, hybrid and xLSTM families,
with GQA or MLA attention, after ``repro/models/transformer.py``.

  lm_spec(cfg)                                -> ParamSpec tree
  lm_forward(cfg, params, tokens[, img_embeds]) -> logits
  lm_loss(cfg, params, batch)                 -> scalar loss (training)
  lm_prefill(cfg, params, tokens, cache_len[, img_embeds])
                                              -> (last_logits, cache)
  lm_decode(cfg, params, token, cache, kv_len) -> (logits, cache)

Layers are stacked on a leading "layers" axis as in the JAX package; the
JAX ``lax.scan`` over layers is a Python loop over views of the stacked
tensors here.  Sharding constraints (no-ops without a mesh) are dropped.
The MoE family (DeepSeekMoE) runs its ``first_dense`` dense layers
("dense_blocks", cache "dense_layers") and then its MoE layers ("blocks",
cache "layers"), whose FFN is ``moe.moe_apply`` with its expert products
through ``ops.moe_gmm``: at ``cfg.capacity_factor`` in prefill and 4.0 in
decode, as in the JAX package.  The hybrid family (Zamba2) runs groups of
Mamba2 layers, each group followed by one of ``n_shared_attn`` shared
attention blocks, then the rest layers; its SSD goes through
``ops.mamba_scan``.  The xLSTM family ("ssm") runs groups of
``slstm_every - 1`` mLSTM blocks and one sLSTM block; its cache is
recurrent state only, and its sLSTM recurrence goes through
``ops.slstm_seq``.  MLA attention (``cfg.attn == "mla"``: minicpm3_4b,
and deepseek_v2_236b's MoE) runs ``mla.mla_layer`` in prefill and the
latent decode ``mla.mla_decode_layer``, its cache {"ckv", "krope"} two
views of one buffer (``init_cache``).  The VLM (llava_next_mistral_7b) is
the dense decoder with precomputed image-patch embeddings before the
text (``img_embeds``); its image positions take no loss.  The
encoder-decoder family is ``encdec.py``.

Inside a tensor-parallel mesh step (``parallel.tensor``; the dense, VLM,
MoE and hybrid families, GQA or MLA, and the encoder-decoder, whose
``encdec.py`` uses the same pieces) the embedding, the attention, the
SwiGLU and the experts take their "model" blocks of the weights and sum
over the axis, the logits stay cut by vocab through the loss
(``cross_entropy(split=...)``), and the prefill's and the decode's
logits are gathered whole.  The step passes the cache's KV-head count
(``kv_heads=``: those this device's query heads read; MLA's latent
cache stays whole); the models do not take shapes from the context.
Where the step splits the residual stream by rows (``tensor.seq_split``)
the embedding leaves this device's rows of the whole sequence (image
patches first), the trunk runs on them with the positions of the whole
sequence, each layer gathers the rows for its projections and
reduce-scatters its output, the prefill writes the whole prompt's K/V
and takes its last row from the axis's last device, and remat keeps only
the rows as each layer's carry.

In a mesh step (``parallel.steps``) every stacked leaf comes as this
device's blocks of its layers (``sharding.Stacked``), and each layer's
body gathers its own weights first (``sharding.layer``): under remat
inside what ``_remat`` checkpoints, so a layer's gathered weights are
freed after its forward and gathered again in its recompute; a shared
attention block is gathered at each of its applications.  ``_layers``
gathers nothing; off a mesh ``layer`` returns the views as they are.

Training (``lm_loss``, or ``lm_forward(..., plain=True)``) takes the
plain route of ``models.common``: norms, MoE experts, SSD and sLSTM in
plain PyTorch, as JAX trains, and attention through ``cfg.attn_impl``
(the flash-attention kernel on the card under "kernel", whose backward
differentiates the oracle).  Each layer runs under ``cfg.remat`` as JAX's
``_remat`` sets it: the dense and MoE blocks, the Mamba2 layers and the
mLSTM blocks are recomputed in the backward under "full".
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..parallel import tensor
from ..parallel.sharding import layer
from .attention import gqa_decode_layer, gqa_layer, gqa_spec
from .common import (ParamSpec, cross_entropy, embed, embed_spec,
                     init_params, mask_padded_vocab, rmsnorm, rmsnorm_spec,
                     spec_map, swiglu, swiglu_spec, unembed, vocab_split,
                     vocab_start, whole_vocab)
from .mla import latent_cache, mla_decode_layer, mla_layer, mla_spec
from .moe import moe_apply, moe_spec
from .ssm import mamba_decode_layer, mamba_layer, mamba_mixer, mamba_spec
from .xlstm import (mlstm_chunked, mlstm_decode, mlstm_spec, slstm_decode,
                    slstm_mixer, slstm_spec)


def stack_specs(tree, n: int):
    """Prepend a ('layers',) axis of size n to every leaf spec."""
    return spec_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                            dtype=s.dtype, init=s.init, scale=s.scale), tree)


# the outputs of matmuls with no batch dimensions, which the "dots" policy
# saves as JAX's checkpoint_dots_with_no_batch_dims does; batched ones
# (bmm, baddbmm) are recomputed, as there
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg):
    """``run(fn, *args)`` calling ``fn(*args)`` under ``cfg.remat``, as
    JAX's ``_remat`` wraps a layer: "full" recomputes the layer in the
    backward (``torch.utils.checkpoint``), "dots" recomputes all but the
    matmul outputs, "none" keeps every activation."""
    if cfg.remat == "none":
        return lambda fn, *args: fn(*args)
    if cfg.remat == "full":
        return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        def contexts():
            return create_selective_checkpoint_contexts(_save_dots)
        return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False,
                                            context_fn=contexts)
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def _layers(tree, n: int):
    """Layer i of a stacked tree, for i in range(n): views of its tensors,
    or in a mesh step each leaf's ``sharding.LayerBlock``, which the
    layer's body gathers (``sharding.layer``); nothing is gathered here."""
    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} \
            if isinstance(t, dict) else t[i]
    return [take(tree, i) for i in range(n)]


def _attn_spec(cfg):
    if cfg.attn == "mla":
        return mla_spec(cfg.d_model, cfg.n_heads, q_lora=cfg.q_lora,
                        kv_lora=cfg.kv_lora, qk_nope=cfg.qk_nope,
                        qk_rope=cfg.qk_rope, v_head=cfg.v_head)
    return gqa_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh)


def block_spec(cfg, moe_layer: bool = False) -> Dict:
    ffn = moe_spec(cfg.d_model, cfg.n_experts, cfg.d_ff_expert,
                   cfg.n_shared) if moe_layer \
        else swiglu_spec(cfg.d_model, cfg.d_ff)
    return {"ln1": rmsnorm_spec(cfg.d_model), "ln2": rmsnorm_spec(cfg.d_model),
            "attn": _attn_spec(cfg), "ffn": ffn}


def _ffn(cfg, p, h, capacity_factor: float, plain: bool = False):
    """The block's FFN: the MoE where its params have a router, as in the
    JAX package, else the dense SwiGLU."""
    if "router" in p:
        return moe_apply(p, h, cfg.top_k, capacity_factor, plain=plain)
    return swiglu(p, h)


def block_apply(cfg, p, x, positions, plain: bool = False):
    """One pre-norm block over a sequence; returns ``(x, k, v)`` with the
    layer's cache rows for the prefill: the rotated K/V, or under MLA the
    latent c_kv and the rope key."""
    p = layer(p)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps, plain=plain)
    if cfg.attn == "mla":
        a, k, v = mla_layer(p["attn"], h, positions,
                            rope_theta=cfg.rope_theta, impl=cfg.attn_impl,
                            chunk=cfg.attn_chunk, plain=plain)
    else:
        a, k, v = gqa_layer(p["attn"], h, positions, impl=cfg.attn_impl,
                            rope_theta=cfg.rope_theta, chunk=cfg.attn_chunk)
    x = x + a
    x = x + _ffn(cfg, p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps,
                                        plain=plain),
                 cfg.capacity_factor, plain)
    return x, k, v


def _block(cfg, p, x, positions, plain):
    return block_apply(cfg, p, x, positions, plain)[0]


def block_decode(cfg, p, x, cache, position, kv_len):
    """One block for one token; updates ``cache`` ({"k","v"}, or MLA's
    {"ckv","krope"}) in place.  The MoE FFN runs at capacity factor 4.0,
    as JAX's decode does."""
    p = layer(p)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.attn == "mla":
        a, _, _ = mla_decode_layer(p["attn"], h, cache["ckv"],
                                   cache["krope"], position, kv_len,
                                   cfg.rope_theta)
    else:
        a, _, _ = gqa_decode_layer(p["attn"], h, cache["k"], cache["v"],
                                   position, kv_len, cfg.rope_theta)
    x = x + a
    return x + _ffn(cfg, p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), 4.0)


def _attn_cache_spec(cfg, batch: int, cache_len: int,
                     kv_heads: Optional[int] = None) -> Dict:
    """One attention layer's decode cache: K/V (of ``kv_heads`` heads,
    every KV head where not given), or MLA's latent and rope key."""
    dt = cfg.torch_dtype
    if cfg.attn == "mla":
        return {
            "ckv": ParamSpec((batch, cache_len, cfg.kv_lora),
                             ("batch", "kv_seq", None), dt, init="zeros"),
            "krope": ParamSpec((batch, cache_len, cfg.qk_rope),
                               ("batch", "kv_seq", None), dt, init="zeros"),
        }
    n = cfg.n_kv_heads if kv_heads is None else kv_heads
    kv = ParamSpec((batch, cache_len, n, cfg.dh),
                   ("batch", "kv_seq", "kv", None), dt, init="zeros")
    return {"k": kv, "v": kv}


def init_cache(spec, device):
    """A zero cache from its spec tree, each MLA {"ckv", "krope"} pair as
    two views of one buffer (``mla.latent_cache``), so the latent decode
    reads its key without a copy."""
    if isinstance(spec, ParamSpec):
        return init_params(spec, None, device)
    if spec.keys() == {"ckv", "krope"}:
        return latent_cache(spec["ckv"], spec["krope"], device)
    return {k: init_cache(v, device) for k, v in spec.items()}


def _stacks(cfg):
    """The stacks of attention blocks in order, as (params key, cache key,
    depth): the MoE family's ``first_dense`` dense layers, then the rest."""
    if cfg.family == "moe" and cfg.first_dense:
        return [("dense_blocks", "dense_layers", cfg.first_dense),
                ("blocks", "layers", cfg.n_layers - cfg.first_dense)]
    return [("blocks", "layers", cfg.n_layers)]


# ---------------------------------------------------------------------------
# Hybrid (Zamba2-style) structure
# ---------------------------------------------------------------------------


def _hybrid_layout(cfg) -> Tuple[int, int, int]:
    """(n_groups, layers per group, rest layers) of the Mamba2 stack."""
    group = cfg.attn_every
    n_groups = cfg.n_layers // group
    return n_groups, group, cfg.n_layers - n_groups * group


def _mamba_block_spec(cfg) -> Dict:
    return {"ln": rmsnorm_spec(cfg.d_model),
            "mixer": mamba_spec(cfg.d_model, expand=cfg.ssm_expand,
                                headdim=cfg.ssm_headdim, state=cfg.ssm_state)}


def _mamba_cache_spec(cfg, batch: int, heads: Optional[int] = None
                      ) -> Dict:
    """One Mamba2 layer's decode cache: the conv tail in the activation
    dtype and the SSD state in fp32, of ``heads`` heads (every one where
    not given): a tensor-parallel device's conv tail holds its heads' x
    channels and the whole B and C (``ssm.mamba_decode_layer``)."""
    h = heads or cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    d_inner = h * cfg.ssm_headdim
    return {
        "conv": ParamSpec((batch, 3, d_inner + 2 * cfg.ssm_state),
                          ("batch", None, "mlp"), cfg.torch_dtype,
                          init="zeros"),
        "ssm": ParamSpec((batch, h, cfg.ssm_state, cfg.ssm_headdim),
                         ("batch", "heads", None, None), torch.float32,
                         init="zeros"),
    }


def _hybrid_walk(cfg, params, cache=None):
    """The hybrid schedule in order: ``("mamba", layer params, layer
    cache)`` for every Mamba2 layer, and ``("attn", shared block params,
    the group's K/V cache)`` after each group, whose weight set is
    ``gi % n_shared_attn``.  Cache entries are views (None without a
    cache), so writing them writes the cache."""
    n_groups, group, rest = _hybrid_layout(cfg)
    shared = _layers(params["shared_attn"], cfg.n_shared_attn)

    def views(tree, n):
        return [None] * n if tree is None else _layers(tree, n)

    def sub(key):
        return None if cache is None else cache[key]

    groups = zip(_layers(params["groups"], n_groups),
                 views(sub("groups"), n_groups), views(sub("attn"), n_groups))
    for gi, (gp, gc, kv) in enumerate(groups):
        for p, c in zip(_layers(gp, group), views(gc, group)):
            yield "mamba", p, c
        yield "attn", shared[gi % cfg.n_shared_attn], kv
    if rest:
        for p, c in zip(_layers(params["rest"], rest),
                        views(sub("rest"), rest)):
            yield "mamba", p, c


# ---------------------------------------------------------------------------
# xLSTM structure
# ---------------------------------------------------------------------------


def _xlstm_layout(cfg) -> Tuple[int, int]:
    """(n_groups, blocks per group): each group is ``group - 1`` mLSTM
    blocks and one sLSTM block."""
    group = cfg.slstm_every
    return cfg.n_layers // group, group


def _xlstm_block_spec(cfg, mixer) -> Dict:
    return {"ln": rmsnorm_spec(cfg.d_model),
            "mixer": mixer(cfg.d_model, cfg.n_heads)}


def _xlstm_walk(cfg, params, cache=None):
    """The xLSTM blocks in order as ``(kind, block params, block cache)``,
    kind "mlstm" or "slstm"; cache entries are views (None without a
    cache), so writing them writes the cache."""
    n_groups, group = _xlstm_layout(cfg)

    def views(tree, n):
        return [None] * n if tree is None else _layers(tree, n)

    gp, gc = params["groups"], cache or {}
    groups = zip(_layers(gp["mlstm"], n_groups),
                 views(gc.get("mlstm"), n_groups),
                 _layers(gp["slstm"], n_groups),
                 views(gc.get("slstm"), n_groups))
    for mp, mc, sp, sc in groups:
        for p, c in zip(_layers(mp, group - 1), views(mc, group - 1)):
            yield "mlstm", p, c
        yield "slstm", sp, sc


def _mlstm_block(cfg, p, x, plain):
    p = layer(p)
    h = rmsnorm(p["ln"], x, cfg.norm_eps, plain=plain)
    return x + mlstm_chunked(p["mixer"], h, chunk=cfg.attn_chunk,
                             plain=plain)[0]


def _xlstm_trunk(cfg, params, x, cache, plain, run):
    """The xLSTM blocks over a sequence, chunked at ``cfg.attn_chunk`` as in
    the JAX package.  With a cache (the prefill), each mLSTM block's carry
    and each sLSTM block's final state go into it.  ``run`` calls each
    mLSTM block without a cache (``_remat``'s runner)."""
    for kind, p, c in _xlstm_walk(cfg, params, cache):
        if kind == "mlstm" and c is None:
            x = run(_mlstm_block, cfg, p, x, plain)
            continue
        p = layer(p)
        h = rmsnorm(p["ln"], x, cfg.norm_eps, plain=plain)
        if kind == "mlstm":
            y, state = mlstm_chunked(p["mixer"], h, chunk=cfg.attn_chunk)
        else:
            y, state = slstm_mixer(p["mixer"], h, plain=plain)
        if c is not None:
            for k in c:
                c[k].copy_(state[k])
        x = x + y
    return x


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def lm_spec(cfg) -> Dict:
    if cfg.family not in ("dense", "vlm", "moe", "hybrid", "ssm"):
        raise ValueError(f"lm_spec does not handle family {cfg.family!r}")
    sp = {"embed": embed_spec(cfg.padded_vocab, cfg.d_model),
          "final_norm": rmsnorm_spec(cfg.d_model)}
    if cfg.family in ("dense", "vlm", "moe"):
        for key, _, n in _stacks(cfg):
            sp[key] = stack_specs(block_spec(
                cfg, cfg.family == "moe" and key == "blocks"), n)
        return sp
    if cfg.family == "ssm":
        n_groups, group = _xlstm_layout(cfg)
        sp["groups"] = {
            "mlstm": stack_specs(stack_specs(
                _xlstm_block_spec(cfg, mlstm_spec), group - 1), n_groups),
            "slstm": stack_specs(_xlstm_block_spec(cfg, slstm_spec),
                                 n_groups),
        }
        return sp
    n_groups, group, rest = _hybrid_layout(cfg)
    sp["groups"] = stack_specs(stack_specs(_mamba_block_spec(cfg), group),
                               n_groups)
    if rest:
        sp["rest"] = stack_specs(_mamba_block_spec(cfg), rest)
    # the shared attention block is the dense block (JAX _shared_attn_spec)
    sp["shared_attn"] = stack_specs(block_spec(cfg), cfg.n_shared_attn)
    return sp


def decode_cache_spec(cfg, batch: int, cache_len: int,
                      kv_heads: Optional[int] = None,
                      ssm_heads: Optional[int] = None) -> Dict:
    """The decode cache of ``batch`` rows; its attention layers' K/V hold
    ``kv_heads`` heads and a hybrid's Mamba2 layers ``ssm_heads`` (a
    tensor-parallel device's, ``parallel.steps``), every head where not
    given."""
    if cfg.family in ("dense", "vlm", "moe"):
        return {ckey: stack_specs(_attn_cache_spec(cfg, batch, cache_len,
                                                   kv_heads), n)
                for _, ckey, n in _stacks(cfg)}
    if cfg.family == "ssm":
        # recurrent state only, in fp32; the mLSTM "m" starts at 0 here,
        # unlike mlstm_init_cache's -1e30, as in the JAX package
        n_groups, group = _xlstm_layout(cfg)
        dh = cfg.d_model // cfg.n_heads

        def state(*shape):
            return ParamSpec((batch, cfg.n_heads) + shape,
                             ("batch", "heads") + (None,) * len(shape),
                             torch.float32, init="zeros")
        mlstm = {"C": state(dh, dh), "n": state(dh), "m": state()}
        slstm = {k: state(dh) for k in ("c", "n", "h", "m")}
        return {"mlstm": stack_specs(stack_specs(mlstm, group - 1),
                                     n_groups),
                "slstm": stack_specs(slstm, n_groups)}
    if cfg.family != "hybrid":
        raise ValueError(cfg.family)
    n_groups, group, rest = _hybrid_layout(cfg)
    mamba = _mamba_cache_spec(cfg, batch, ssm_heads)
    cache = {"groups": stack_specs(stack_specs(mamba, group), n_groups),
             "attn": stack_specs(_attn_cache_spec(cfg, batch, cache_len,
                                                  kv_heads), n_groups)}
    if rest:
        cache["rest"] = stack_specs(mamba, rest)
    return cache


def _mamba_block(cfg, p, x, plain):
    p = layer(p)
    h = rmsnorm(p["ln"], x, cfg.norm_eps, plain=plain)
    return x + mamba_layer(p["mixer"], h, chunk=cfg.ssm_chunk,
                           impl="plain" if plain else "kernel")


def _hybrid_trunk(cfg, params, x, positions, cache, plain, run):
    """The Mamba2 groups, their shared attention blocks and the rest layers.
    With a cache (the prefill), each Mamba2 layer's conv tail and SSD state
    and each shared block's K/V go into it; the prompt length must then be
    a multiple of min(ssm_chunk, S), as in the JAX prefill.  ``run`` calls
    each Mamba2 layer without a cache (``_remat``'s runner); the shared
    attention blocks run as they are, as in JAX's ``group_body``."""
    for kind, p, c in _hybrid_walk(cfg, params, cache):
        if kind == "attn":
            x, k, v = block_apply(cfg, p, x, positions, plain)
            if c is not None:       # the whole sequence's rows
                c["k"][:, :k.shape[1]] = k
                c["v"][:, :v.shape[1]] = v
            continue
        if c is None:
            x = run(_mamba_block, cfg, p, x, plain)
        else:
            p = layer(p)
            h = rmsnorm(p["ln"], x, cfg.norm_eps)
            y, state = mamba_mixer(p["mixer"], h, chunk=cfg.ssm_chunk,
                                   impl="kernel")
            c["conv"].copy_(state["conv"])
            c["ssm"].copy_(state["ssm"])
            x = x + y
    return x


def _embed_inputs(cfg, params, tokens, img_embeds=None):
    """Token embeddings, after the image-patch embeddings (B,P,D) where a
    VLM is given them, as in the JAX package; this device's rows of them
    on a split stream (``common.embed``)."""
    img = None if img_embeds is None else img_embeds.to(cfg.torch_dtype)
    return embed(params["embed"], tokens, img).to(cfg.torch_dtype)


def _trunk(cfg, params, x, cache=None, plain=False):
    """The blocks over the embedded sequence ``x``; writes each layer's
    K/V (MLA's latent, and in the hybrid each Mamba2 layer's states) into
    ``cache`` when one is given.  On the plain route the layers run under
    ``cfg.remat``.  ``x`` may be this device's rows of a split stream
    (``tensor.seq_split``): the positions are the whole sequence's, which
    attention sees gathered."""
    b, s = x.shape[0], x.shape[1]
    sp = tensor.seq_split()
    if sp is not None:
        s *= sp.size
    positions = torch.arange(s, device=x.device).expand(b, s)
    run = _remat(cfg) if plain else (lambda fn, *args: fn(*args))
    if cfg.family == "hybrid":
        return _hybrid_trunk(cfg, params, x, positions, cache, plain, run)
    if cfg.family == "ssm":
        return _xlstm_trunk(cfg, params, x, cache, plain, run)
    names = ("ckv", "krope") if cfg.attn == "mla" else ("k", "v")
    for key, ckey, n in _stacks(cfg):
        for i, p in enumerate(_layers(params[key], n)):
            if cache is None:
                x = run(_block, cfg, p, x, positions, plain)
                continue
            x, *rows = block_apply(cfg, p, x, positions)
            for name, r in zip(names, rows):
                cache[ckey][name][i, :, :r.shape[1]] = r
    return x


def lm_forward(cfg, params, tokens, img_embeds=None, *,
               plain: bool = False):
    """Full-sequence logits. tokens:(B,S_text) [+ img (B,P,D)] ->
    (B,P+S_text,V).  ``plain=True`` is the training forward (module
    docstring)."""
    x = _trunk(cfg, params, _embed_inputs(cfg, params, tokens, img_embeds),
               plain=plain)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, plain=plain)
    return mask_padded_vocab(unembed(params["embed"], x), cfg.vocab,
                             vocab_start(params["embed"]))


def lm_loss(cfg, params, batch):
    """batch: {'tokens', 'labels'[, 'img_embeds']} -> mean next-token
    cross-entropy over the labels >= 0, through the training forward; the
    image positions get the label -1."""
    img = batch.get("img_embeds")
    logits = lm_forward(cfg, params, batch["tokens"], img, plain=True)
    labels = batch["labels"]
    if img is not None:
        labels = torch.cat([labels.new_full(img.shape[:2], -1), labels],
                           dim=1)
    return cross_entropy(logits, labels, split=vocab_split(params["embed"]))


def lm_prefill(cfg, params, tokens, cache_len: int, img_embeds=None,
               kv_heads: Optional[int] = None,
               ssm_heads: Optional[int] = None):
    """Process the prompt (after the image patches, for a VLM given them);
    return (last-token logits (B,V), cache), the cache's K/V of
    ``kv_heads`` heads and its Mamba2 states of ``ssm_heads``
    (``decode_cache_spec``).

    Each layer's K/V (MLA's latent) is computed once, in the attention,
    and written into a zero cache of ``cache_len`` rows; in the hybrid,
    each Mamba2 layer's final states come from the same SSD launch as its
    output, and in the xLSTM each sLSTM layer's from the same
    ``slstm_seq`` launch.  On a split stream the last row is the axis's
    last device's, broadcast to every device of the axis.
    """
    b, s = tokens.shape[0], tokens.shape[1]
    if img_embeds is not None:
        s += img_embeds.shape[1]
    if s > cache_len:
        raise ValueError(f"prompt of {s} tokens over cache_len {cache_len}")
    x = _embed_inputs(cfg, params, tokens, img_embeds)
    cache = init_cache(decode_cache_spec(cfg, b, cache_len, kv_heads,
                                         ssm_heads), x.device)
    x = _trunk(cfg, params, x, cache)
    sp = tensor.seq_split()
    x = x[:, -1:] if sp is None else tensor.last_row(x, sp)
    with tensor.whole_stream():
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = unembed(params["embed"], x)[:, 0]
    return _whole_logits(cfg, params, logits), cache


def lm_decode(cfg, params, token, cache, kv_len):
    """One decode step. token:(B,1) int; kv_len:(B,) int32 cache fill.

    Returns (logits (B,V), cache); the cache is updated in place.
    """
    x = embed(params["embed"], token).to(cfg.torch_dtype)
    if cfg.family == "hybrid":
        for kind, p, c in _hybrid_walk(cfg, params, cache):
            if kind == "attn":
                x = block_decode(cfg, p, x, c, kv_len, kv_len)
                continue
            p = layer(p)
            y, state = mamba_decode_layer(
                p["mixer"], rmsnorm(p["ln"], x, cfg.norm_eps), c)
            c["conv"].copy_(state["conv"])
            c["ssm"].copy_(state["ssm"])
            x = x + y
    elif cfg.family == "ssm":
        for kind, p, c in _xlstm_walk(cfg, params, cache):
            step = mlstm_decode if kind == "mlstm" else slstm_decode
            p = layer(p)
            y, state = step(p["mixer"], rmsnorm(p["ln"], x, cfg.norm_eps), c)
            for k in c:
                c[k].copy_(state[k])
            x = x + y
    else:
        for key, ckey, n in _stacks(cfg):
            for p, c in zip(_layers(params[key], n),
                            _layers(cache[ckey], n)):
                x = block_decode(cfg, p, x, c, kv_len, kv_len)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _whole_logits(cfg, params, unembed(params["embed"], x[:, 0])), \
        cache


def _whole_logits(cfg, params, logits):
    """``unembed``'s (B, V) logits with the padded vocab masked, over the
    whole vocab (a vocab block's gathered)."""
    logits = mask_padded_vocab(logits, cfg.vocab,
                               vocab_start(params["embed"]))
    return whole_vocab(params["embed"], logits)
