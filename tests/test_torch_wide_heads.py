"""deepseek_v2_236b's head widths in the port, on the CPU.

Its MLA prefill attends with a q/k head of qk_nope + qk_rope = 128 + 64 =
192 and a v head of 128; its latent decode with a key of kv_lora + qk_rope
= 512 + 64 = 576 and a value of 512, the first columns of the key's rows,
128 query heads on one KV head.  The reduced configs
(``configs.base.reduced``) cut these to 16 + 16 and 32, so here they are
held at their real widths:

* the attention oracle and the CUDA kernel's rounding plans at D 192 / Dv
  128, and the decode oracle and the decode kernel's split plan (16 heads
  a block) at 576 / 512, against the JAX package's Pallas kernels in
  interpret mode, at ``torch_parity``'s kernel tolerances;
* the MLA layer and its absorbed decode at those widths (4 heads, d_model
  256) against ``repro/models/mla.py`` at 1e-5, and the serving engine on
  a narrow deepseek_v2_236b against JAX's engine: the same greedy tokens;
* the kernels' host plans (``flash_attention.plan``, ``flash_decode.plan``)
  at every full-width model: a 1 x 128 prefill and a decode step traced on
  fake tensors, as the dry run traces them, and every attention and decode
  call must pass its plan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_config
from repro.kernels.flash_attention import flash_attention_fwd as jax_attention
from repro.kernels.flash_decode import flash_decode as jax_decode
from repro.models import api as japi
from repro.models import common as jcommon
from repro.models import mla as jmla
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import ARCH_IDS, InputShape
from repro_torch.configs import get_config as torch_config
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models import mla as tmla
from repro_torch.parallel import steps as st
from repro_torch.serving import Request, ServeConfig, ServingEngine
from torch_parity import KERNEL_BF16_TOL, KERNEL_F32_TOL, close

torch.set_num_threads(1)
DTYPES = {"float32": (jnp.float32, torch.float32, KERNEL_F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, KERNEL_BF16_TOL)}
# deepseek_v2_236b's MLA widths (d_model, heads, q_lora, kv_lora, qk_nope,
# qk_rope, v_head), narrowed in d_model, heads and q_lora only
WIDTH = (256, 4, 64, 512, 128, 64, 128)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_at_d192_matches_pallas(dtype, causal):
    """(a) B 1, H 2, S = T = 256, D 192, Dv 128: the oracle and the kernel's
    rounding plan (3xTF32 in fp32, P rounded to bf16 in bf16) against the
    Pallas kernel in interpret mode; the widths pass the kernel's plan."""
    _, tdt, tol = DTYPES[dtype]
    qj, qt = _both(_randn((1, 2, 256, 192), 0), dtype)
    kj, kt = _both(_randn((1, 2, 256, 192), 1), dtype)
    vj, vt = _both(_randn((1, 2, 256, 128), 2), dtype)
    want = jax_attention(qj, kj, vj, causal=causal, interpret=True)
    plan = ref.attention_3xtf32 if dtype == "float32" else \
        ref.attention_bf16p
    for got in (ref.attention_ref(qt, kt, vt, causal=causal),
                plan(qt, kt, vt, causal=causal)):
        assert got.shape == (1, 2, 256, 128)
        close(want, got, atol=tol, rtol=tol, what=f"{dtype} D 192")
    assert fa.plan(tdt, 192, 128) == fa.smem_bytes(tdt, 192, 128)


@pytest.mark.parametrize("split", [1, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_latent_decode_at_576_512_matches_pallas(dtype, split):
    """(b) T 512, 8 heads on one KV head, key 576, the value the first 512
    columns of the key's rows (a view), kv_len on both sides of a chunk
    boundary: the oracle and the split plan (a bf16 block of 8 heads rounds
    P, as the kernel's tensor-core path does) against Pallas."""
    _, tdt, tol = DTYPES[dtype]
    b, h, t = 4, 8, 512
    qj, qt = _both(_randn((b, h, 576), 3), dtype)
    rj, rt = _both(_randn((b, 1, t, 576), 4), dtype)
    kv_len = np.array([1, 127, 129, 512], np.int32)
    want = jax_decode(qj, rj, rj[..., :512], jnp.asarray(kv_len),
                      scale=192 ** -0.5, interpret=True)
    vt = rt[..., :512]
    assert fd.value_in_key(rt, vt)
    p = fd.plan(tdt, 576, 512, h, True)
    assert p.heads == 16 and p.chunks == 4
    lens = torch.from_numpy(kv_len)
    close(want, ref.decode_ref(qt, rt, vt, lens, scale=192 ** -0.5),
          atol=tol, rtol=tol, what="decode_ref")
    got = ref.decode_split_ref(qt, rt, vt, lens, split, scale=192 ** -0.5,
                               round_p=fd.rounds_p(tdt, h, 576, 512))
    assert got.dtype == tdt and got.shape == (b, h, 512)
    close(want, got, atol=tol, rtol=tol, what=f"split plan of {split}")


@pytest.mark.parametrize("dtype,d,dv,group,shared,want", [
    # deepseek_v2_236b's latent decode: 16 heads a block, one read
    (torch.float32, 576, 512, 128, True, (4, 16, 2, 223232)),
    (torch.bfloat16, 576, 512, 128, True, (4, 16, 3, 205312)),
    # minicpm3_4b's: K and V staged apart before the single read, once now
    (torch.float32, 288, 256, 40, False, (2, 32, 2, 220672)),
    (torch.float32, 288, 256, 40, True, (2, 32, 2, 154112)),
    (torch.bfloat16, 288, 256, 40, True, (2, 32, 4, 155136)),
    (torch.float32, 128, 128, 16, False, (1, 32, 3, 122880)),
])
def test_decode_plan_at_the_served_widths(dtype, d, dv, group, shared,
                                          want):
    """The plan's chunks a lane, heads a block, stages and shared memory
    (the kernel's header works them out), within the 232,448 bytes a block
    may have."""
    p = fd.plan(dtype, d, dv, group, shared)
    assert (p.chunks, p.heads, p.stages, p.smem) == want
    assert p.smem <= fd.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_plan_refuses_what_does_not_fit(dtype):
    """A value of 512 staged apart from its key, and rows over 576 / 512,
    are refused before any launch."""
    with pytest.raises(ValueError, match="view of the key rows"):
        fd.plan(dtype, 576, 512, 128, False)
    for d, dv in ((592, 512), (576, 528)):
        with pytest.raises(ValueError, match="576/512"):
            fd.plan(dtype, d, dv, 128, True)


def _layer_params(seed=0):
    d, h, q_lora, kv_lora, nope, rope, v = WIDTH
    spec = jmla.mla_spec(d, h, q_lora=q_lora, kv_lora=kv_lora, qk_nope=nope,
                         qk_rope=rope, v_head=v)
    jp = jcommon.init_params(spec, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(_np(jp), "cpu")


def _positions(b, s):
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    return jnp.asarray(pos), torch.from_numpy(pos)


def test_mla_layer_at_deepseek_v2_widths_matches_jax():
    """(c) The prefill layer (attention at D 192 / Dv 128 through the
    port's kernel route, on the CPU its plain version) and the latent and
    rope key it caches, against JAX's ``mla_layer`` at 1e-5."""
    jp, tp = _layer_params()
    b, s = 2, 24
    x = _randn((b, s, WIDTH[0]), 5)
    jpos, tpos = _positions(b, s)
    want = jmla.mla_layer(jp, jnp.asarray(x), jpos, impl="chunked",
                          chunk=16)
    jckv, jkrope = jmla.mla_compress_kv(jp, jnp.asarray(x), jpos, 10000.0,
                                        WIDTH[3])
    got, ckv, krope = tmla.mla_layer(tp, torch.from_numpy(x), tpos,
                                     impl="kernel")
    close(want, got, **LAYER_TOL, what="mla_layer")
    close(jckv, ckv, **LAYER_TOL, what="c_kv")
    close(jkrope, krope, **LAYER_TOL, what="k_rope")


def test_mla_decode_at_deepseek_v2_widths_matches_jax():
    """(c) Three absorbed-weight decode steps against a latent cache of
    576-wide rows filled to 12 and 9: outputs and both cache leaves against
    JAX's ``mla_decode_layer`` at 1e-5; the port's decode hands the kernel
    route the rows as the key and their first 512 columns as the value."""
    jp, tp = _layer_params(seed=2)
    d, kv_lora, rope = WIDTH[0], WIDTH[3], WIDTH[5]
    b, s, t = 2, 12, 16
    x = _randn((b, s + 3, d), 6)
    jpos, _ = _positions(b, s)
    ckv, krope = jmla.mla_compress_kv(jp, jnp.asarray(x[:, :s]), jpos,
                                      10000.0, kv_lora)
    fill = np.array([12, 9], np.int32)
    mask = (np.arange(t)[None, :s] < fill[:, None])[..., None]
    jckv = np.zeros((b, t, kv_lora), np.float32)
    jkrope = np.zeros((b, t, rope), np.float32)
    jckv[:, :s] = np.where(mask, np.asarray(ckv), 0.0)
    jkrope[:, :s] = np.where(mask, np.asarray(krope), 0.0)
    cache = cache_from_numpy({"ckv": jckv, "krope": jkrope}, "cpu")
    rows = tmla.latent_rows(cache["ckv"], cache["krope"])
    assert rows.shape == (b, t, 576)
    assert fd.value_in_key(rows[:, :, None].transpose(1, 2),
                           cache["ckv"][:, :, None].transpose(1, 2))
    jckv, jkrope = jnp.asarray(jckv), jnp.asarray(jkrope)
    for i in range(3):
        xt = x[:, s + i:s + i + 1]
        want, jckv, jkrope = jmla.mla_decode_layer(
            jp, jnp.asarray(xt), jckv, jkrope, jnp.asarray(fill),
            jnp.asarray(fill))
        got, _, _ = tmla.mla_decode_layer(
            tp, torch.from_numpy(xt), cache["ckv"], cache["krope"],
            torch.from_numpy(fill), torch.from_numpy(fill))
        close(want, got, **LAYER_TOL, what=f"decode step {i}")
        close(jckv, cache["ckv"], **LAYER_TOL, what=f"ckv after step {i}")
        close(jkrope, cache["krope"], **LAYER_TOL,
              what=f"krope after step {i}")
        fill = fill + 1


def _narrow(get_config):
    """The reduced deepseek_v2_236b at its real MLA widths."""
    d, h, q_lora, kv_lora, nope, rope, v = WIDTH
    return get_config("deepseek_v2_236b").reduced().replace(
        dtype="float32", d_model=d, n_heads=h, n_kv_heads=h, q_lora=q_lora,
        kv_lora=kv_lora, qk_nope=nope, qk_rope=rope, v_head=v)


def test_engine_on_narrow_deepseek_v2_matches_jax_engine():
    """(d) The serving engine on the narrow deepseek_v2_236b (a dense layer
    and an MoE layer, MLA at 192 / 128 and 576 / 512): 4 requests of
    ragged prompts through 2 slots give JAX's engine's greedy tokens."""
    jc = _narrow(jax_config).replace(attn_impl="pallas")
    tc = _narrow(torch_config).replace(attn_impl="kernel")
    jp = jcommon.init_params(japi.param_spec(jc), jax.random.PRNGKey(0))
    tp = params_from_numpy(_np(jp), "cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, jc.vocab, n).astype(np.int32)
               for n in (5, 16, 9, 12)]
    jeng = JServingEngine(jc, jp, JServeConfig(n_slots=2, cache_len=48))
    teng = ServingEngine(tc, tp, ServeConfig(n_slots=2, cache_len=48))
    for i, (p, m) in enumerate(zip(prompts, (4, 6, 3, 5))):
        jeng.submit(JRequest(uid=i, prompt=p, max_new_tokens=m))
        teng.submit(Request(uid=i, prompt=p, max_new_tokens=m))
    jdone = sorted(jeng.run_until_drained(), key=lambda r: r.uid)
    tdone = sorted(teng.run_until_drained(), key=lambda r: r.uid)
    assert [r.uid for r in tdone] == [r.uid for r in jdone] == [0, 1, 2, 3]
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert [len(r.output) for r in tdone] == [4, 6, 3, 5]


def _cut(cfg):
    """A full-width config cut in depth to the layers that hold each kind
    of its blocks: both of the hybrid's shared attention sets, an sLSTM
    block, the MoE model's dense first layers and one MoE layer, an
    encoder and a decoder layer."""
    if cfg.family == "hybrid":
        return cfg.replace(n_layers=cfg.attn_every * cfg.n_shared_attn)
    if cfg.family == "ssm":
        return cfg.replace(n_layers=cfg.slstm_every)
    if cfg.family == "encdec":
        return cfg.replace(n_layers=1, n_dec_layers=1)
    if cfg.family == "moe":
        return cfg.replace(n_layers=cfg.first_dense + 1)
    return cfg.replace(n_layers=1)


class _Calls:
    """Records the (dtype, widths) of every ``ops.flash_attention`` and
    ``ops.flash_decode`` call while entered, and passes each on."""

    def __init__(self, monkeypatch):
        self.attention, self.decode = [], []
        attend, decode = ops.flash_attention, ops.flash_decode

        def attention_spy(q, k, v, **kw):
            self.attention.append((q.dtype, q.shape[-1], v.shape[-1]))
            return attend(q, k, v, **kw)

        def decode_spy(q, k, v, kv_len, **kw):
            self.decode.append((q.dtype, q.shape[-1], v.shape[-1],
                                q.shape[2] // k.shape[2],
                                fd.value_in_key(k.transpose(1, 2),
                                                v.transpose(1, 2))))
            return decode(q, k, v, kv_len, **kw)
        monkeypatch.setattr(ops, "flash_attention", attention_spy)
        monkeypatch.setattr(ops, "flash_decode", decode_spy)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_full_width_model_passes_the_kernel_plans(arch, dtype,
                                                        monkeypatch):
    """A 1 x 128 prefill and a decode step of every model at full width
    (cut in depth), traced on fake tensors through the kernels' route:
    each flash attention passes ``flash_attention.plan`` and each flash
    decode ``flash_decode.plan`` (the widths and shared memory the card
    takes).  deepseek_v2_236b's 192 / 128 and 576 / 512 are among them."""
    cfg = _cut(torch_config(arch)).replace(dtype=dtype, attn_impl="kernel")
    calls = _Calls(monkeypatch)
    prefill = InputShape("contract", 128, 1, "prefill")
    decode = InputShape("contract", 256, 1, "decode")
    with FakeTensorMode(allow_non_fake_inputs=False):
        params = st.abstract_state(cfg, device="cpu").params
        logits, _ = st.make_prefill_step(cfg, 256)(
            params, st.abstract_batch(cfg, prefill, device="cpu"))
        assert logits.shape[0] == 1
        st.make_serve_step(cfg)(
            params, st.abstract_batch(cfg, decode, device="cpu"),
            st.abstract_cache(cfg, decode, device="cpu"))
    has_attention = cfg.family != "ssm"
    assert bool(calls.attention) == has_attention
    assert bool(calls.decode) == has_attention
    for tdt, d, dv in calls.attention:
        assert fa.plan(tdt, d, dv) <= fa.SMEM_LIMIT
    for tdt, d, dv, group, shared in calls.decode:
        assert fd.plan(tdt, d, dv, group, shared).smem <= fd.SMEM_LIMIT
    if arch == "deepseek_v2_236b":
        assert {(d, dv) for _, d, dv in calls.attention} == {(192, 128)}
        assert {c[1:] for c in calls.decode} == {(576, 512, 128, True)}
