"""The port's Mamba2 pieces (repro_torch.models.ssm, ops.mamba_scan)
against the JAX package's.

Inputs come from numpy with a seed and go to both packages.  On the CPU
``ops.mamba_scan`` runs its plain version, the sequential ``ssd_ref``; it
is held against JAX's Pallas kernel in interpret mode (y) and JAX's
``ssd_ref`` (final state) at atol = rtol = 2e-4, the reference's own SSD
tolerance (tests/test_kernels.py): chunked and sequential sums differ in
order.  The port's chunked path is held against JAX's at 2e-5, the same
algorithm in another framework.  ``ref.ssd_plan``, the CUDA kernel's own
order of work and rounding (3xTF32 in fp32; G and B ⊙ w rounded in bf16),
is held against the same JAX references at 2e-4 in fp32 and 3e-2 in bf16,
also where the decays underflow (dt x 10) and at S = 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)
SSD_TOL = dict(atol=2e-4, rtol=2e-4)
TOL = dict(atol=2e-5, rtol=2e-5)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def _inputs(b, s, h, p, n, seed=0, dt_scale=0.1):
    """xh, dt, a_log, B, C as numpy, drawn as tests/test_kernels.py does."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, s, h, p)).astype(f),
            (np.abs(rng.standard_normal((b, s, h))) * dt_scale).astype(f),
            (rng.standard_normal(h) * 0.5).astype(f),
            rng.standard_normal((b, s, n)).astype(f),
            rng.standard_normal((b, s, n)).astype(f))


def _jt(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


SCAN_SHAPES = [  # (b, s, h, p, n, chunk): tests/test_kernels.py, then ragged
    (1, 32, 2, 8, 4, 8), (2, 64, 3, 16, 8, 16), (1, 128, 1, 32, 16, 32),
    (2, 64, 2, 16, 8, 64),
    (1, 17, 3, 16, 8, 64),      # one ragged chunk of 17 rows
]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SCAN_SHAPES)
def test_mamba_scan_matches_jax(b, s, h, p, n, chunk):
    j, t = _jt(_inputs(b, s, h, p, n))
    y, state = tops.mamba_scan(*t, chunk=chunk)
    assert y.shape == (b, s, h, p) and state.shape == (b, h, n, p)
    assert state.dtype == torch.float32
    jy, _ = jops.mamba_scan(*j, chunk=chunk, interpret=True)
    _, jstate = jref.ssd_ref(*j)
    _close(y, jy, SSD_TOL)
    _close(state, jstate, SSD_TOL)


PLAN_CASES = [(shape, 0.1) for shape in SCAN_SHAPES] + [
    # decays that underflow: dt x 10 drives exp(cum) to 0 within a chunk
    ((2, 64, 3, 16, 8, 16), 1.0), ((1, 128, 1, 32, 16, 32), 1.0),
    ((1, 1, 3, 16, 8, 64), 0.1), ((2, 1, 2, 8, 4, 64), 1.0),   # S = 1
    ((1, 96, 2, 16, 8, 96), 0.1),   # the kernel's chunks: 64 rows, then 32
]
PLAN_TOL = {"float32": SSD_TOL, "bfloat16": dict(atol=3e-2, rtol=3e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,dt_scale", PLAN_CASES)
def test_ssd_plan_matches_jax(shape, dt_scale, dtype):
    """The kernel's plan against the Pallas kernel in interpret mode (y)
    and JAX's ssd_chunked (the final state), on the same x, B and C in
    ``dtype``; dt and a_log stay fp32, as the wrapper hands them over."""
    b, s, h, p, n, chunk = shape
    xh, dt, a_log, bm, cm = _inputs(b, s, h, p, n, seed=4, dt_scale=dt_scale)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jx, jb, jc = (jnp.asarray(a, jdt) for a in (xh, bm, cm))
    tx, tb, tc = (torch.from_numpy(a).to(tdt) for a in (xh, bm, cm))
    y, state = tref.ssd_plan(tx, torch.from_numpy(dt), torch.from_numpy(a_log),
                             tb, tc)
    assert y.dtype == tdt and state.dtype == torch.float32
    jy, _ = jops.mamba_scan(jx, jnp.asarray(dt), jnp.asarray(a_log), jb, jc,
                            chunk=chunk, interpret=True)
    _, jstate = jssm.ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(a_log), jb,
                                 jc, chunk=chunk)
    assert bool(torch.isfinite(y.float()).all())
    _close(y, jy, PLAN_TOL[dtype])
    _close(state, jstate, PLAN_TOL[dtype])


def test_ssd_plan_is_the_sequential_recurrence_at_one_row_chunks():
    """With chunks of one row the plan's products have a single term: its
    fp32 result is the sequential oracle's up to 3xTF32's rounding."""
    _, t = _jt(_inputs(2, 9, 3, 8, 4, seed=5))
    y, state = tref.ssd_plan(*t, rows=1)
    want_y, want_state = tref.ssd_ref(*t)
    _close(y, want_y.numpy(), TOL)
    _close(state, want_state.numpy(), TOL)


def test_mamba_scan_tiling_fills_the_card():
    """zamba2's prefill on 132 SMs: eight chunks fill it with 64-column
    blocks, one chunk (S <= 64) takes 32-column halves of each head."""
    assert tms.tiling(1, 512, 112, 64, 132) == (64, 896)
    assert tms.tiling(1, 256, 112, 64, 132) == (64, 448)
    assert tms.tiling(1, 64, 112, 64, 132) == (32, 224)
    assert tms.tiling(1, 17, 112, 64, 132) == (32, 224)
    assert tms.tiling(2, 64, 3, 16, 132) == (32, 6)
    assert tms.tiling(1, 256, 4, 128, 132) == (32, 64)
    assert (tms.state_tile(4), tms.state_tile(64), tms.state_tile(65)) == \
        (64, 64, 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_layout_contract(dtype):
    """The model's slices of one conv output pass, and their rows start on
    16 bytes (copied 16 bytes at a time); rows off 16 bytes pass too, to be
    copied element by element.  N over 128, P off a multiple of 4 and a
    non-contiguous last dimension raise ValueError."""
    h, p, n = 3, 16, 8
    xbc = torch.zeros(2, 32, h * p + 2 * n, dtype=dtype)
    xh, bm, cm = torch.split(xbc, [h * p, n, n], -1)
    tms.check_layout(xh.reshape(2, 32, h, p), bm, cm)
    assert tms.rows_aligned(xh, bm, cm)
    wide = torch.zeros(1, 8, 136, dtype=dtype)
    with pytest.raises(ValueError, match="N=136"):
        tms.check_layout(torch.zeros(1, 8, 2, 16, dtype=dtype), wide, wide)
    with pytest.raises(ValueError, match="P=6"):
        tms.check_layout(torch.zeros(1, 8, 2, 6, dtype=dtype), bm, cm)
    with pytest.raises(ValueError, match="contiguous"):
        tms.check_layout(torch.zeros(1, 8, 16, 2, dtype=dtype)
                         .transpose(-1, -2), bm, cm)
    odd = torch.zeros(2, 32, h * p + 2 * n + 1, dtype=dtype)[..., 1:]
    ox, ob, oc = torch.split(odd, [h * p, n, n], -1)
    tms.check_layout(ox.reshape(2, 32, h, p), ob, oc)
    assert not tms.rows_aligned(ox, ob, oc)
    # zamba2's slices: rows of 7,296 elements
    xbc = torch.zeros(1, 4, 112 * 64 + 128, dtype=dtype)
    assert tms.rows_aligned(*torch.split(xbc, [112 * 64, 64, 64], -1))
    # a bf16 C of 4 state columns after 16 + 4 columns: 40 bytes in
    xbc = torch.zeros(1, 4, 24, dtype=dtype)
    assert tms.rows_aligned(*torch.split(xbc, [16, 4, 4], -1)) == \
        (dtype == torch.float32)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SCAN_SHAPES)
def test_ssd_chunked_matches_jax(b, s, h, p, n, chunk):
    j, t = _jt(_inputs(b, s, h, p, n, seed=1))
    init = np.random.default_rng(2).standard_normal(
        (b, h, n, p)).astype(np.float32)
    for kw_j, kw_t in [({}, {}), ({"init_state": jnp.asarray(init)},
                                 {"init_state": torch.from_numpy(init)})]:
        y, state = tssm.ssd_chunked(*t, chunk=chunk, **kw_t)
        jy, jstate = jssm.ssd_chunked(*j, chunk=chunk, **kw_j)
        _close(y, jy, TOL)
        _close(state, jstate, TOL)


def test_ssd_step_matches_jax():
    rng = np.random.default_rng(3)
    b, h, p, n = 3, 4, 16, 8
    xh, dt, a_log, bm, cm = _inputs(b, 1, h, p, n, seed=3)
    state = rng.standard_normal((b, h, n, p)).astype(np.float32)
    args = (state, xh[:, 0], dt[:, 0], a_log, bm[:, 0], cm[:, 0])
    j, t = _jt(args)
    ts, ty = tssm.ssd_step(*t)
    js, jy = jssm.ssd_step(*j)
    _close(ts, js, TOL)
    _close(ty, jy, TOL)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    init = rng.standard_normal((2, 3, 12)).astype(np.float32)
    (jx, jw, jb, ji), (tx, tw, tb, ti) = _jt((x, w, b, init))
    for j_init, t_init in [(None, None), (ji, ti)]:
        ty, ttail = tssm.causal_conv(tx, tw, tb, init_state=t_init)
        jy, jtail = jssm.causal_conv(jx, jw, jb, init_state=j_init)
        _close(ty, jy, TOL)
        _close(ttail, jtail, dict(atol=0, rtol=0))


def _mixer_params(seed=0, d_model=64, headdim=16, state=8):
    """JAX's mamba_spec weights, with A_log, dt_bias and conv_b drawn too
    so that every head decays at its own rate."""
    spec = jssm.mamba_spec(d_model, headdim=headdim, state=state)
    jp = jax.tree_util.tree_map(np.asarray, jcommon.init_params(
        spec, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for k in ("A_log", "dt_bias", "conv_b"):
        jp[k] = (rng.standard_normal(jp[k].shape) * 0.5).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in jp.items()},
            params_from_numpy(jp, "cpu"))


@pytest.mark.parametrize("s,chunk", [(32, 16), (20, 16), (12, 16)])
@pytest.mark.parametrize("jax_impl,torch_impl", [("xla", "chunked"),
                                                 ("pallas", "kernel")])
def test_mamba_layer_matches_jax(s, chunk, jax_impl, torch_impl):
    """The full mixer, including the end padding of a sequence off the
    chunk (s = 20)."""
    jp, tp = _mixer_params()
    x = np.random.default_rng(5).standard_normal((2, s, 64)).astype(
        np.float32)
    tol = TOL if torch_impl == "chunked" else SSD_TOL
    _close(tssm.mamba_layer(tp, torch.from_numpy(x), chunk=chunk,
                            impl=torch_impl),
           jssm.mamba_layer(jp, jnp.asarray(x), chunk=chunk, impl=jax_impl),
           tol)


def test_mamba_decode_layer_matches_jax():
    jp, tp = _mixer_params(seed=1)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    jcache = jssm.mamba_init_cache(jp, 3)
    tcache = tssm.mamba_init_cache(tp, 3)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    jcache = {"conv": jnp.asarray(rng.standard_normal(
        jcache["conv"].shape).astype(np.float32)),
        "ssm": jnp.asarray(rng.standard_normal(
            jcache["ssm"].shape).astype(np.float32))}
    tcache = params_from_numpy(jax.tree_util.tree_map(np.asarray, jcache),
                               "cpu")
    for _ in range(3):
        to, tcache = tssm.mamba_decode_layer(tp, torch.from_numpy(x), tcache)
        jo, jcache = jssm.mamba_decode_layer(jp, jnp.asarray(x), jcache)
        _close(to, jo, TOL)
        for k in ("conv", "ssm"):
            _close(tcache[k], jcache[k], TOL)


def test_prefill_state_continues_into_decode():
    """The mixer's final states, as a prefill keeps them, carry a decode
    step to the output of the mixer over the longer sequence."""
    _, tp = _mixer_params(seed=2)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 17, 64)).astype(np.float32))
    _, cache = tssm.mamba_mixer(tp, x[:, :16], chunk=16, impl="kernel")
    step, _ = tssm.mamba_decode_layer(tp, x[:, 16:], cache)
    full = tssm.mamba_layer(tp, x, chunk=17, impl="kernel")
    _close(step, full[:, 16:].numpy(), SSD_TOL)


@pytest.mark.parametrize("s", [70, 100])
def test_prompt_off_the_chunk_raises_like_jax(s):
    """JAX's ssd_chunked asserts S % min(chunk, S) == 0; the port raises
    ValueError from both its SSD paths."""
    j, t = _jt(_inputs(1, s, 2, 8, 4))
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*j, chunk=64)
    with pytest.raises(ValueError, match="chunk"):
        tops.mamba_scan(*t, chunk=64)
    with pytest.raises(ValueError, match="chunk"):
        tssm.ssd_chunked(*t, chunk=64)
