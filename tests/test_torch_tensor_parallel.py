"""The tensor-parallel context of the port's mesh steps
(``repro_torch.parallel.tensor``), in one process: where it applies, the
leaves it splits (and the hybrid's it gathers whole and slices: a
device's columns against JAX's layout, the split gated norm against the
whole one, a device's cache), the KV heads a device's query heads read,
the shapes a step gathers and the dry run's cache, the decode's check of
its cache, and the vocab-split cross-entropy on a model axis of one
device against ``common.cross_entropy``; where a step splits its
residual stream by sequence, and the shapes and recorded bytes of the
sequence collectives on an abstract mesh.  The steps themselves, and the
collectives' values, run on gloo ranks in ``tests/test_torch_parallel.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import hlo
from repro_torch.configs import SHAPES, InputShape, get_config
from repro_torch.models.attention import gqa_decode_layer
from repro_torch.models.common import cross_entropy
from repro_torch.models.transformer import decode_cache_spec
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import steps as tst
from repro_torch.parallel import tensor
from repro_torch.parallel.comm import AbstractMesh


def _tp(cfg, mesh, act_shard="seq"):
    rules = shd.default_rules(act_shard=act_shard)
    lays = tst.state_layouts(cfg, mesh, rules).params
    return tensor.TensorParallel.of(mesh, lays, tensor.keeps(lays))


@pytest.mark.parametrize("arch,shape,act_shard,rows,want", [
    ("glm4_9b", (4, 2), "seq", 4, True),
    ("llava_next_mistral_7b", (16, 16), "seq", 256, True),
    ("deepseek_7b", (1, 8), "seq", 4, True),
    # the rules cut the rows over "model": its devices hold other rows
    ("glm4_9b", (4, 2), "batch2d", 8, False),
    ("glm4_9b", (4, 2), "batch2d", None, False),
    # one row: batch2d drops both axes, so "model" holds copies again
    ("glm4_9b", (4, 2), "batch2d", 1, True),
    ("glm4_9b", (8, 1), "seq", 8, False),          # a model axis of one
    # expert parallelism: 64 experts, 4 a device on 16
    ("deepseek_moe_16b", (4, 2), "seq", 4, True),
    ("deepseek_moe_16b", (16, 16), "seq", 256, True),
    # MLA: its heads split (deepseek_v2_236b's MoE layers expert
    # parallel), or on 16 minicpm3_4b's 40 heads stay whole while its
    # MLP and vocab split
    ("deepseek_v2_236b", (4, 2), "seq", 4, True),
    ("minicpm3_4b", (16, 16), "seq", 256, True),
    # the hybrid: 112 Mamba2 heads of 64 and 32 attention heads split;
    # on 32 the Mamba2 heads do not divide, and every layer is whole
    ("zamba2_7b", (4, 2), "seq", 4, True),
    ("zamba2_7b", (16, 16), "seq", 256, True),
    ("zamba2_7b", (8, 32), "seq", 8, False),
    ("xlstm_125m", (4, 2), "seq", 4, False),
    ("minicpm3_4b", (4, 2), "seq", 4, True),
    # the encoder-decoder: 16 heads split on 2 and 16, not on 32
    ("whisper_medium", (4, 2), "seq", 4, True),
    ("whisper_medium", (16, 16), "seq", 256, True),
    ("whisper_medium", (8, 32), "seq", 8, False),
])
def test_tensor_parallel_applies_where_the_rules_leave_model_free(
        arch, shape, act_shard, rows, want):
    cfg = get_config(arch)
    mesh = AbstractMesh(shape, ("data", "model"))
    rules = shd.default_rules(act_shard=act_shard)
    assert tensor.applies(cfg, mesh, rules, rows) == want
    assert not tensor.applies(cfg, None, rules, rows)


def test_the_split_leaves_are_those_the_rules_put_on_model():
    """Reduced glm4_9b on (2, 4): the query heads, the MLP and the vocab
    are split; wk and wv ("embed" takes "data", so "kv" is whole) and the
    norms stay whole.  Reduced deepseek_7b on (1, 8): 4 heads do not
    divide 8, so the attention stays whole while the MLP and vocab are
    split.  A split leaf handed over whole raises."""
    cfg = get_config("glm4_9b").reduced()
    tp = _tp(cfg, AbstractMesh((2, 4), ("data", "model")))
    assert (tp.size, tp.index) == (4, 0)
    got = {axes: dim for axes, _, dim in tp.leaves}
    assert got == {("embed", "heads", None): 1, ("embed", "kv", None): None,
                   ("heads", None, "embed"): 0, ("embed",): None,
                   ("embed", "mlp"): 1, ("mlp", "embed"): 0,
                   ("vocab", "embed"): 0}
    assert tp.split_dim(torch.empty(128, 1, 32), ("embed", "heads", None)) \
        == 1
    assert tp.split_dim(torch.empty(128, 2, 32), ("embed", "kv", None)) \
        is None
    with pytest.raises(ValueError, match="its block is"):
        tp.split_dim(torch.empty(128, 4, 32), ("embed", "heads", None))
    ds = _tp(get_config("deepseek_7b").reduced(),
             AbstractMesh((1, 8), ("data", "model")))
    assert ds.dim_of(("embed", "heads", None)) is None
    assert ds.dim_of(("embed", "mlp")) == 1
    assert ds.dim_of(("vocab", "embed")) == 0


@pytest.mark.parametrize("n_heads,n_kv,size,per_device", [
    (32, 2, 16, 1),        # glm4_9b on 16: 2 query heads, one KV head
    (32, 2, 4, 1),         # glm4_9b on 4: 8 query heads of one group
    (32, 8, 16, 1),        # llava on 16
    (96, 8, 16, 1),        # mistral_large_123b on 16: 6 of a group of 12
    (32, 32, 16, 2),       # deepseek_7b on 16 (MHA)
    (96, 8, 4, 2),         # whole groups of 12
    (4, 2, 2, 1), (4, 2, 4, 1),
])
def test_kv_heads_are_those_the_local_query_heads_read(n_heads, n_kv, size,
                                                       per_device):
    """On every device, local query head j reads local KV head
    j // (local heads // local KV heads), and that is the KV head its
    global query head reads in the whole layer."""
    hl, g = n_heads // size, n_heads // n_kv
    for index in range(size):
        tp = tensor.TensorParallel(None, "model", index, size, ())
        heads = tp.kv_heads(n_heads, n_kv)
        assert len(heads) == per_device and hl % len(heads) == 0
        for j in range(hl):
            assert heads[j // (hl // len(heads))] == (index * hl + j) // g


def test_kv_heads_raise_where_neither_the_block_nor_a_group_divides():
    """12 query heads in groups of 6 over 3 devices: 4 a device, so a
    device's block straddles two groups unevenly."""
    tp = tensor.TensorParallel(None, "model", 1, 3, ())
    with pytest.raises(NotImplementedError, match="neither divides"):
        tp.kv_heads(12, 2)


def test_the_cache_spec_takes_its_kv_heads_from_the_caller():
    """The models build a cache of every KV head unless the step passes
    its count, whatever context is active."""
    cfg = get_config("glm4_9b").reduced()
    tp = _tp(cfg, AbstractMesh((2, 4), ("data", "model")))
    with tensor.use(tp):
        whole = decode_cache_spec(cfg, 2, 8)
        one = decode_cache_spec(cfg, 2, 8, kv_heads=1)
    assert whole["layers"]["k"].shape == (4, 2, 8, 2, 32)
    assert one["layers"]["v"].shape == (4, 2, 8, 1, 32)


def test_a_decode_layer_refuses_a_cache_of_other_kv_heads():
    """Under a head split on (2, 4) a layer computes the one KV head its
    query head reads: a cache of every KV head (as one built outside the
    step holds) raises, a cache of that one head is taken.  Off a step
    a cache of fewer heads than the layer's raises."""
    cfg = get_config("glm4_9b").reduced()
    tp = _tp(cfg, AbstractMesh((2, 4), ("data", "model")))
    rng = np.random.default_rng(0)
    d, dh = cfg.d_model, cfg.dh

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    block = {"wq": t(d, 1, dh), "wk": t(d, 2, dh), "wv": t(d, 2, dh),
             "wo": t(1, dh, d)}
    x, pos = t(2, 1, d), torch.tensor([3, 5], dtype=torch.int32)
    with tensor.use(tp):
        with pytest.raises(ValueError, match="cache of 2 KV heads"):
            gqa_decode_layer(block, x, torch.zeros(2, 8, 2, dh),
                             torch.zeros(2, 8, 2, dh), pos, pos)
        out, k, _ = gqa_decode_layer(block, x, torch.zeros(2, 8, 1, dh),
                                     torch.zeros(2, 8, 1, dh), pos, pos)
    assert out.shape == (2, 1, d) and k[0, 3].abs().max() > 0
    whole = {"wq": t(d, 4, dh), "wk": t(d, 2, dh), "wv": t(d, 2, dh),
             "wo": t(4, dh, d)}
    with pytest.raises(ValueError, match="cache of 1 KV heads"):
        gqa_decode_layer(whole, x, torch.zeros(2, 8, 1, dh),
                         torch.zeros(2, 8, 1, dh), pos, pos)


def test_a_step_gathers_the_model_block_and_the_dry_run_cache_matches():
    """On (2, 4) a step gathers wq over "data" only, (L, D, H/4, dh);
    the gradient reduction keeps that block; the dry run's decode cache
    holds this device's rows and the one KV head its query head reads."""
    cfg = get_config("glm4_9b").reduced()
    mesh = AbstractMesh((2, 4), ("data", "model"))
    rules = shd.default_rules()
    lays = tst.state_layouts(cfg, mesh, rules).params
    wq = lays["blocks"]["attn"]["wq"]
    local = torch.empty(wq.local_shape)
    assert wq.local_shape == (4, 64, 1, 32)
    assert tuple(wq.gather(local).shape) == (4, 128, 4, 32)
    block = wq.gather(local, ("model",))
    assert tuple(block.shape) == (4, 128, 1, 32)
    assert tuple(wq.reduce(block, ("model",)).shape) == wq.local_shape
    cache = tst.abstract_cache(cfg, InputShape("t", 20, 4, "decode"), mesh,
                               rules, device="cpu")
    assert tuple(cache["layers"]["k"].shape) == (4, 2, 20, 1, 32)
    full = get_config("glm4_9b")
    big = tst.abstract_cache(full, SHAPES["decode_32k"],
                             AbstractMesh((16, 16), ("data", "model")),
                             rules)
    assert tuple(big["layers"]["v"].shape) == (40, 8, 32768, 1, 128)
    # batch2d keeps the whole gather: every KV head in the cache
    b2d = shd.default_rules(act_shard="batch2d")
    cache = tst.abstract_cache(cfg, InputShape("t", 20, 8, "decode"), mesh,
                               b2d, device="cpu")
    assert tuple(cache["layers"]["k"].shape) == (4, 1, 20, 2, 32)


@pytest.mark.parametrize("masked", [False, True])
def test_vocab_cross_entropy_on_one_block_is_the_cross_entropy(masked):
    """On a model axis of one device (no collective) the vocab-split loss
    and its gradient equal ``common.cross_entropy``'s at fp32 rounding,
    labels < 0 ignored."""
    rng = np.random.default_rng(0)
    logits = torch.tensor(rng.standard_normal((3, 7, 40)) * 3,
                          dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, 40, (3, 7)))
    if masked:
        labels[0, :5] = -1
        labels[2] = -1
    tp = tensor.TensorParallel(AbstractMesh((1,), ("model",)), "model", 0,
                               1, ())
    a = logits.clone().requires_grad_()
    b = logits.clone().requires_grad_()
    la = cross_entropy(a, labels, split=tp)
    lb = cross_entropy(b, labels)
    la.backward()
    lb.backward()
    torch.testing.assert_close(la, lb, rtol=1e-6, atol=0)
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-8)
    if masked:
        assert a.grad[2].abs().max() == 0


def test_off_a_mesh_step_no_context_is_active():
    """Outside a mesh step the layers see no context; ``use`` restores
    the one before it."""
    assert tensor.active() is None
    tp = tensor.TensorParallel(None, "model", 0, 2, ())
    with tensor.use(tp):
        assert tensor.active() is tp
        with tensor.use(None):
            assert tensor.active() is None
        assert tensor.active() is tp
    assert tensor.active() is None


@pytest.mark.parametrize("arch,shape,act_shard,stream,want", [
    ("glm4_9b", (2, 4), "seq", (4, 16, 128), True),
    ("glm4_9b", (4, 2), "seq", (1, 16, 128), True),
    ("deepseek_7b", (1, 8), "seq", (4, 16, 128), True),
    ("llava_next_mistral_7b", (2, 4), "seq", (2, 8 + 8, 128), True),
    ("glm4_9b", (1, 3), "seq", (4, 12, 128), True),
    # the rows do not divide the axis: the spec drops "model"
    ("glm4_9b", (2, 4), "seq", (4, 15, 128), False),
    ("glm4_9b", (2, 4), "seq", (4, 1, 128), False),     # a decode
    # batch2d maps "seq" to nothing (one row: the step is TP all the same)
    ("glm4_9b", (4, 2), "batch2d", (1, 16, 128), False),
])
def test_the_stream_is_split_where_the_rules_put_model_on_seq(
        arch, shape, act_shard, stream, want):
    """``TensorParallel.for_stream`` reads the rules' spec of the stream
    (B, S, D) as JAX's constraint does: S over "model" where it divides,
    under ``act_shard="seq"`` only; ``seq_split`` answers for the active
    context."""
    cfg = get_config(arch).reduced()
    mesh = AbstractMesh(shape, ("data", "model"))
    rules = shd.default_rules(act_shard=act_shard)
    assert tensor.applies(cfg, mesh, rules, stream[0])
    tp = _tp(cfg, mesh, act_shard).for_stream(stream)
    assert tp.seq == want
    with tensor.use(tp):
        assert (tensor.seq_split() is tp) == want
        with tensor.whole_stream():
            assert tensor.seq_split() is None
            assert tensor.active().size == shape[1]
        assert (tensor.seq_split() is not None) == want
    assert tensor.seq_split() is None


def test_sequence_collectives_shapes_and_bytes_on_an_abstract_mesh():
    """On an abstract (2, 4) mesh: ``gather_seq`` gives the whole sequence
    (an all-gather of its output's bytes) and its backward a device's
    rows (a reduce-scatter of the whole gradient's bytes, or none with
    ``copies``); ``scatter_seq`` the rows (a reduce-scatter of its
    operand) and its backward the whole (an all-gather); ``split_seq``
    the rows (no collective) and its backward the whole (an all-gather);
    ``last_row`` one row (a broadcast).  Rows that do not divide the
    axis raise."""
    cfg = get_config("glm4_9b").reduced()
    tp = _tp(cfg, AbstractMesh((2, 4), ("data", "model"))).for_stream(
        (2, 16, 8))
    assert tp.seq and tp.size == 4
    whole, rows = torch.zeros(2, 16, 8), torch.zeros(2, 4, 8)
    nbytes = whole.numel() * 4

    def run(fn, x):
        x = x.clone().requires_grad_()
        y = fn(x)
        y.backward(torch.ones_like(y))
        return tuple(y.shape), tuple(x.grad.shape)

    for fn, x, shapes, counts in (
            (lambda x: tensor.gather_seq(x, tp), rows,
             ((2, 16, 8), (2, 4, 8)),
             {"all-gather": 1, "reduce-scatter": 1}),
            (lambda x: tensor.gather_seq(x, tp, copies=True), rows,
             ((2, 16, 8), (2, 4, 8)), {"all-gather": 1}),
            (lambda x: tensor.scatter_seq(x, tp), whole,
             ((2, 4, 8), (2, 16, 8)),
             {"reduce-scatter": 1, "all-gather": 1}),
            (lambda x: tensor.split_seq(x, tp), whole,
             ((2, 4, 8), (2, 16, 8)), {"all-gather": 1})):
        got, rep = hlo.count(run, fn, x)
        assert got == shapes
        assert rep.collective_counts == counts
        assert rep.collective_bytes == {k: nbytes for k in counts}
    row, rep = hlo.count(tensor.last_row, rows, tp)
    assert tuple(row.shape) == (2, 1, 8)
    assert rep.collective_counts == {"broadcast": 1}
    with pytest.raises(ValueError, match="15 rows over 4"):
        tensor.scatter_seq(torch.zeros(2, 15, 8), tp)
    with pytest.raises(ValueError, match="15 rows over 4"):
        tp.own_rows(torch.zeros(2, 15, 8))


@pytest.mark.parametrize("arch,heads", [("deepseek_v2_236b", 8),
                                        ("minicpm3_4b", None)])
def test_mla_heads_split_where_they_divide_and_the_latent_cache_is_whole(
        arch, heads):
    """On the production mesh (16, 16): deepseek_v2_236b's wq_b (1536,
    128, 192) and wkv_b (512, 128, 256) share their logical axes and are
    told apart by their blocks, 8 heads each, as is wo; minicpm3_4b's 40
    heads do not divide 16, so its wq_b, wkv_b and wo stay whole and a
    block shape raises.  wq_a and wkv_a stay whole either way, and the
    decode cache of either holds a device's rows of the whole latent and
    rope key (it has no heads)."""
    from repro_torch.models import mla
    cfg = get_config(arch)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    tp = _tp(cfg, mesh)
    h = cfg.n_heads
    wq_b = torch.empty(cfg.q_lora, heads or h, cfg.qk_nope + cfg.qk_rope)
    wkv_b = torch.empty(cfg.kv_lora, heads or h, cfg.qk_nope + cfg.v_head)
    wo = torch.empty(heads or h, cfg.v_head, cfg.d_model)
    params = {"wq_b": wq_b, "wkv_b": wkv_b, "wo": wo}
    with tensor.use(tp):
        assert (mla.head_split(params) is tp) == (heads is not None)
    want = None if heads is None else 1
    assert tp.split_dim(wq_b, mla.WQB_AXES) == want
    assert tp.split_dim(wkv_b, mla.WQB_AXES) == want
    assert tp.split_dim(torch.empty(cfg.d_model, cfg.q_lora),
                        ("embed", None)) is None
    if heads is None:
        with pytest.raises(ValueError, match="its block is"):
            tp.split_dim(torch.empty(cfg.q_lora, 2, 96), mla.WQB_AXES)
    cache = tst.abstract_cache(cfg, SHAPES["decode_32k"], mesh,
                               shd.default_rules())
    n = cfg.n_layers - cfg.first_dense
    assert tuple(cache["layers"]["ckv"].shape) == (n, 8, 32768,
                                                   cfg.kv_lora)
    assert tuple(cache["layers"]["krope"].shape) == (n, 8, 32768,
                                                     cfg.qk_rope)


def test_hybrid_leaves_split_or_gathered_whole_over_model():
    """Reduced zamba2_7b on (2, 4): the Mamba2 gated norm's scale and
    out_proj are split by rows (the channels of 4 of 16 heads), in_proj,
    conv_w and conv_b are gathered whole over "model" too (their keep is
    empty: their "mlp" blocks of 140 and 72 columns would straddle the
    heads and the z | x | B | C | dt parts), A_log, D, dt_bias and the
    norms stay whole; the shared attention blocks split as the dense
    block does.  At full width on (16, 16) the context tells in_proj
    (3584, 14576), taken whole, from the shared blocks' w_gate (3584,
    14336), taken as its (3584, 896) block, which share their axes."""
    from repro_torch.models import ssm
    cfg = get_config("zamba2_7b").reduced()
    mesh = AbstractMesh((2, 4), ("data", "model"))
    rules = shd.default_rules()
    lays = tst.state_layouts(cfg, mesh, rules).params
    mixer = lays["groups"]["mixer"]
    keep = dict(zip(sorted(mixer), tensor.keeps(mixer)))
    assert keep == {"A_log": ("model",), "D": ("model",),
                    "conv_b": (), "conv_w": (), "dt_bias": ("model",),
                    "in_proj": (), "norm": ("model",),
                    "out_proj": ("model",)}
    for name in ("in_proj", "conv_w", "conv_b", "norm", "out_proj"):
        assert "model" in mixer[name].spec, name
    tp = _tp(cfg, mesh)
    got = {(axes, shape): dim for axes, shape, dim in tp.leaves}
    assert got[ssm.IN_AXES, (128, 560)] is None
    assert got[ssm.IN_AXES, (128, 256)] == 1            # w_gate, w_up
    assert got[ssm.CONV_W_AXES, (4, 288)] is None
    assert got[ssm.CHANNEL_AXES, (288,)] is None         # conv_b
    assert got[ssm.CHANNEL_AXES, (256,)] == 0            # norm
    assert got[ssm.OUT_AXES, (256, 128)] == 0    # out_proj and w_down
    assert got[(None,), (16,)] is None                   # A_log, D, dt_bias
    assert got[("embed", "heads", None), (128, 4, 32)] == 1
    assert got[("embed", "kv", None), (128, 4, 32)] is None
    params = {"in_proj": torch.empty(128, 560), "conv_w": torch.empty(4, 288),
              "conv_b": torch.empty(288), "norm": torch.empty(64),
              "out_proj": torch.empty(64, 128)}
    with tensor.use(tp):
        assert ssm.head_split(params) is tp
        with pytest.raises(ValueError, match="its block is"):
            ssm.head_split({**params, "in_proj": torch.empty(128, 140)})
    assert ssm.head_split(params) is None
    full = get_config("zamba2_7b")
    tp = _tp(full, AbstractMesh((16, 16), ("data", "model")))
    assert tp.split_dim(torch.empty(3584, 14576), ssm.IN_AXES) is None
    assert tp.split_dim(torch.empty(3584, 896), ssm.IN_AXES) == 1
    assert tp.split_dim(torch.empty(448, 3584), ssm.OUT_AXES) == 0
    with pytest.raises(ValueError, match="its block is"):
        tp.split_dim(torch.empty(3584, 911), ssm.IN_AXES)


@pytest.mark.parametrize("m", [2, 4, 8])
def test_a_devices_columns_are_its_heads_in_the_jax_layout(m):
    """Reduced zamba2_7b's Mamba2 layer (16 heads of 16, state 16): on
    each device of an axis of ``m`` the port's projection and conv from
    the columns it slices (``ssm._heads``) equal the columns of its heads
    of JAX's whole projection and conv: z, x and dt of heads [i 16/m,
    (i + 1) 16/m), and the whole B and C."""
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    from repro_torch.models import ssm
    cfg = get_config("zamba2_7b").reduced()
    spec = ssm.mamba_spec(cfg.d_model, expand=cfg.ssm_expand,
                          headdim=cfg.ssm_headdim, state=cfg.ssm_state)
    rng = np.random.default_rng(0)
    whole = {k: rng.standard_normal(s.shape).astype(np.float32)
             for k, s in spec.items()}
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    jz, jxbc, jdt, (di, h, p, n) = jssm._project(
        {k: jnp.asarray(v) for k, v in whole.items()}, jnp.asarray(x))
    jconv, _ = jssm.causal_conv(jxbc, jnp.asarray(whole["conv_w"]),
                                jnp.asarray(whole["conv_b"]))
    hl = h // m
    for i in range(m):
        tp = tensor.TensorParallel(None, "model", i, m, ())
        local = ssm._heads({k: torch.from_numpy(v)
                            for k, v in whole.items()}, tp)
        z, xbc, dt, dims = ssm._project(local, torch.from_numpy(x))
        assert dims == (hl * p, hl, p, n)
        ch = slice(i * hl * p, (i + 1) * hl * p)
        xs = np.r_[i * hl * p:(i + 1) * hl * p, di:di + 2 * n]
        close = dict(rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(z.numpy(), np.asarray(jz)[..., ch],
                                   **close)
        np.testing.assert_allclose(xbc.numpy(), np.asarray(jxbc)[..., xs],
                                   **close)
        np.testing.assert_allclose(
            dt.numpy(), np.asarray(jdt)[..., i * hl:(i + 1) * hl], **close)
        conv, _ = ssm.causal_conv(xbc, local["conv_w"], local["conv_b"])
        np.testing.assert_allclose(conv.numpy(), np.asarray(jconv)[..., xs],
                                   **close)
        for name in ("A_log", "D", "dt_bias"):
            np.testing.assert_array_equal(
                local[name].numpy(), whole[name][i * hl:(i + 1) * hl])


def _device_sum(monkeypatch):
    """Collectives over a leading "device" dimension in one process:
    ``tensor``'s all-reduce sums over dimension 0 and gives every device
    the sum, as over a real axis."""
    monkeypatch.setattr(tensor, "_all_reduce", lambda x, tp, op="sum":
                        x.sum(0, keepdim=True).expand_as(x).clone())


@pytest.mark.parametrize("alone", [False, True],
                         ids=["all-reduced", "out_of_split-alone"])
def test_the_split_gated_norm_is_the_whole_norm(monkeypatch, alone):
    """The gated RMSNorm over 4 devices' channels (``ssm._split_norm``: the
    sums of squares all-reduced forward and backward), its forward and
    its gradients in x and the scale, equal the whole norm's over all the
    channels (the plain route, as training runs it, and the ops entries
    forward).  With the sums passed on by ``out_of_split`` alone the
    forward is the same, but each device then differentiates only its
    channels' share of the sum, and the gradient of x is wrong."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import ssm
    _device_sum(monkeypatch)
    m, w = 4, 64
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((3, 5, w)), dtype=torch.float32)
    scale = torch.tensor(1 + 0.5 * rng.standard_normal(w),
                         dtype=torch.float32)
    seed = torch.tensor(rng.standard_normal((3, 5, w)), dtype=torch.float32)
    tp = tensor.TensorParallel(None, "model", 0, m, ())

    def parts(t):           # (..., w) -> (m, ..., w / m): a device a row
        return torch.stack(t.chunk(m, dim=-1))
    xw, sw = x.clone().requires_grad_(), scale.clone().requires_grad_()
    want = ref.rmsnorm_ref(xw, sw)
    (want * seed).sum().backward()
    xs = parts(x).requires_grad_()
    ss = parts(scale)[:, None, None].requires_grad_()
    if alone:
        total = tensor.out_of_split(ref.rmsnorm_sumsq_ref(xs), tp)
        got = ref.rmsnorm_scaled_ref(xs, total, ss, w)
    else:
        got = ssm._split_norm(xs, ss, w, tp, plain=True)
    (got * parts(seed)).sum().backward()
    torch.testing.assert_close(got.detach(), parts(want.detach()),
                               rtol=1e-6, atol=1e-6)
    dx = torch.cat(list(xs.grad), dim=-1)
    if alone:
        assert (dx - xw.grad).abs().max() > 1e-2
        return
    torch.testing.assert_close(dx, xw.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.cat(list(ss.grad[:, 0, 0])), sw.grad,
                               rtol=1e-5, atol=1e-6)
    # the ops entries (the serving route), a device at a time
    total = sum(ops.rmsnorm_sumsq(xd) for xd in parts(x))
    fwd = torch.stack([ops.rmsnorm_scaled(xd, total, sd, w)
                       for xd, sd in zip(parts(x), parts(scale))])
    torch.testing.assert_close(fwd, parts(want.detach()), rtol=1e-6,
                               atol=1e-6)


def test_the_hybrid_cache_a_device_holds():
    """A device's decode cache on (2, 4) and on the production mesh: each
    Mamba2 layer's conv tail of its heads' x channels and the whole B and
    C (3 rows of 4 x 16 + 2 x 16, of 7 x 64 + 2 x 64), its heads' SSD
    states, and each shared block's K/V of the KV heads its query heads
    read; under the head split a decode layer refuses a cache of every
    head."""
    from repro_torch.models import ssm
    cfg = get_config("zamba2_7b").reduced()
    mesh = AbstractMesh((2, 4), ("data", "model"))
    rules = shd.default_rules()
    cache = tst.abstract_cache(cfg, InputShape("t", 20, 4, "decode"), mesh,
                               rules, device="cpu")
    assert tuple(cache["groups"]["conv"].shape) == (2, 3, 2, 3, 96)
    assert tuple(cache["groups"]["ssm"].shape) == (2, 3, 2, 4, 16, 16)
    assert tuple(cache["rest"]["ssm"].shape) == (1, 2, 4, 16, 16)
    assert tuple(cache["attn"]["k"].shape) == (2, 2, 20, 1, 32)
    full = get_config("zamba2_7b")
    big = tst.abstract_cache(full, SHAPES["long_500k"],
                             AbstractMesh((16, 16), ("data", "model")), rules)
    assert tuple(big["groups"]["conv"].shape) == (13, 6, 1, 3, 448 + 128)
    assert tuple(big["groups"]["ssm"].shape) == (13, 6, 1, 7, 64, 64)
    assert tuple(big["rest"]["conv"].shape) == (3, 1, 3, 576)
    assert tuple(big["attn"]["v"].shape) == (13, 1, 524288, 2, 112)
    tp = _tp(cfg, mesh)
    spec = ssm.mamba_spec(cfg.d_model, expand=2, headdim=16, state=16)
    params = {k: torch.zeros(s.shape) for k, s in spec.items()}
    params["norm"], params["out_proj"] = torch.ones(64), torch.zeros(64, 128)
    x = torch.zeros(2, 1, cfg.d_model)
    with tensor.use(tp):
        out, state = ssm.mamba_decode_layer(params, x, {
            "conv": torch.zeros(2, 3, 96), "ssm": torch.zeros(2, 4, 16, 16)})
        assert tuple(state["conv"].shape) == (2, 3, 96)
        with pytest.raises(ValueError, match="computes 4 heads"):
            ssm.mamba_decode_layer(params, x, {
                "conv": torch.zeros(2, 3, 288),
                "ssm": torch.zeros(2, 16, 16, 16)})
