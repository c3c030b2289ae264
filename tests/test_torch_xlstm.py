"""The port's xLSTM (repro_torch.models.xlstm, the "ssm" family of
repro_torch.models.transformer) and sLSTM recurrence
(repro_torch.kernels.ops.slstm_seq) against the JAX package's.

Inputs come from numpy seeds and weights from the JAX package's
``init_params``, converted with ``params_from_numpy``, so both packages
compute the same function on the same numbers.  On the CPU the port's
``slstm_seq`` runs its sequential plain version, held here against JAX's
Pallas ``slstm_seq`` in interpret mode; the CUDA kernel is tested on the
card by tests/test_torch_cuda.py.  The tolerance is 1e-5, JAX's own for
the sLSTM kernel (tests/test_kernels.py): fp32 sums of at most Dh products
in another order, through a recurrence that the forget gate damps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.models import xlstm as jx
from repro_torch.configs import get_config as torch_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as ttf
from repro_torch.models import xlstm as tx

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


def _state_close(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        _close(port[k], ref[k])


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _slstm_inputs(b, s, h, dh, seed=0):
    """JAX's test_slstm_kernel inputs: xg ~ N(0, 1), r and bias at 0.1."""
    return (_x((b, s, 4, h, dh), seed), _x((4, h, dh, dh), seed + 1, 0.1),
            _x((4, h, dh), seed + 2, 0.1))


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# ---------------------------------------------------------------------------
# The sLSTM recurrence: the plain version against JAX's kernel and oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,h,dh", [
    (2, 32, 3, 8), (1, 64, 2, 16), (2, 48, 1, 8),   # tests/test_kernels.py
])
def test_slstm_seq_ref_matches_jax_pallas(b, s, h, dh):
    xg, r, bias = _slstm_inputs(b, s, h, dh, seed=b * 100 + s)
    got, state = tops.slstm_seq(*_torch(xg, r, bias))
    assert got.shape == (b, s, h, dh) and got.dtype == torch.float32
    want = jops.slstm_seq(jnp.asarray(xg), jnp.asarray(r), jnp.asarray(bias),
                          interpret=True)
    _close(got, want)
    # the final h is the last step's output
    _close(state["h"], np.asarray(want)[:, -1])


def test_slstm_seq_ref_takes_any_length():
    """S = 300 at xlstm_125m's heads (4 of 192): the Pallas wrapper refuses
    it (300 is no multiple of its 256-step block); the JAX oracle and the
    port take it, as the model's recurrence does."""
    xg, r, bias = _slstm_inputs(1, 300, 4, 192, seed=3)
    with pytest.raises(AssertionError):
        jops.slstm_seq(jnp.asarray(xg), jnp.asarray(r), jnp.asarray(bias),
                       interpret=True)
    got, _ = tops.slstm_seq(*_torch(xg, r, bias))
    _close(got, jops.slstm_seq(jnp.asarray(xg), jnp.asarray(r),
                               jnp.asarray(bias), impl="xla"))


def _jax_slstm_params(d=128, h=4, seed=0, rh_scale=5.0):
    """An sLSTM layer of JAX's init, its recurrent weights scaled up from
    their 0.02 so that the recurrence moves the result."""
    jp = jcommon.init_params(jx.slstm_spec(d, h), jax.random.PRNGKey(seed))
    jp = dict(jp, rh=jp["rh"] * rh_scale,
              b=jnp.asarray(_x(jp["b"].shape, seed + 7, 0.1)))
    return jp, params_from_numpy(_np(jp), "cpu")


def test_slstm_final_state_matches_jax_prefill():
    """The state the port's prefill puts into the cache (the recurrence's
    final state) against JAX's ``_slstm_layer_with_state``."""
    jp, tp = _jax_slstm_params()
    x = _x((2, 40, 128), 4)
    jy, jstate = jtf._slstm_layer_with_state(jp, jnp.asarray(x))
    ty, tstate = tx.slstm_mixer(tp, torch.from_numpy(x))
    _close(ty, jy)
    _state_close(tstate, jstate)
    # starting from slstm_init_cache (zeros, m too) is starting from nothing
    zero = tx.slstm_init_cache(tp, 2)
    _state_close(zero, jx.slstm_init_cache(jp, 2))
    ty0, tstate0 = tx.slstm_mixer(tp, torch.from_numpy(x), zero)
    _close(ty0, jy)
    _state_close(tstate0, jstate)


def test_slstm_seq_resumes_from_a_middle_state():
    """25 steps, then 15 from their final state, give the 40-step run's
    outputs and final state; and the 40-step run is JAX's."""
    xg, r, bias = _slstm_inputs(2, 40, 4, 32, seed=5)
    txg, tr, tb = _torch(xg, r, bias)
    whole, whole_state = tops.slstm_seq(txg, tr, tb)
    head, mid = tops.slstm_seq(txg[:, :25], tr, tb)
    tail, end = tops.slstm_seq(txg[:, 25:], tr, tb, mid)
    _close(torch.cat([head, tail], dim=1), whole.numpy())
    _state_close(end, {k: v.numpy() for k, v in whole_state.items()})
    _close(whole, jops.slstm_seq(jnp.asarray(xg), jnp.asarray(r),
                                 jnp.asarray(bias), impl="xla"))


def test_slstm_cell_matches_jax_and_the_sequence_at_one_step():
    jp, tp = _jax_slstm_params(seed=1)
    rng = np.random.default_rng(6)
    state = {"c": rng.standard_normal((3, 4, 32)),
             "n": rng.uniform(0.5, 3.0, (3, 4, 32)),
             "h": np.tanh(rng.standard_normal((3, 4, 32))),
             "m": rng.standard_normal((3, 4, 32))}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    xg = _x((3, 4, 4, 32), 7)
    want = jx._slstm_cell(jp, {k: jnp.asarray(v) for k, v in state.items()},
                          jnp.asarray(xg))
    tstate = params_from_numpy(state, "cpu")
    _state_close(tx._slstm_cell(tp, tstate, torch.from_numpy(xg)), want)
    _, seq_state = tops.slstm_seq(torch.from_numpy(xg)[:, None], tp["rh"],
                                  tp["b"], tstate)
    _state_close(seq_state, want)


def test_slstm_seq_refuses_an_empty_sequence():
    xg, r, bias = _torch(*_slstm_inputs(1, 4, 2, 8))
    with pytest.raises(ValueError, match="S >= 1"):
        tops.slstm_seq(xg[:, :0], r, bias)


# ---------------------------------------------------------------------------
# Mixers
# ---------------------------------------------------------------------------


def _mlstm_params(d=64, h=4, seed=0):
    jp = jcommon.init_params(jx.mlstm_spec(d, h), jax.random.PRNGKey(seed))
    return jp, params_from_numpy(_np(jp), "cpu")


def test_mlstm_parallel_matches_jax():
    jp, tp = _mlstm_params()
    x = _x((2, 48, 64), 10)
    _close(tx.mlstm_parallel(tp, torch.from_numpy(x)),
           jx.mlstm_parallel(jp, jnp.asarray(x)))


@pytest.mark.parametrize("s,chunk", [(64, 16), (48, 64), (64, 64)])
def test_mlstm_chunked_matches_jax(s, chunk):
    """Output and carry, over several chunks and within one."""
    jp, tp = _mlstm_params(seed=1)
    x = _x((2, s, 64), 11)
    jy, jcarry = jx.mlstm_chunked(jp, jnp.asarray(x), chunk=chunk)
    ty, tcarry = tx.mlstm_chunked(tp, torch.from_numpy(x), chunk=chunk)
    _close(ty, jy)
    _state_close(tcarry, jcarry)
    # and the parallel form, as tests/test_kernels.py holds JAX's
    _close(ty, jx.mlstm_parallel(jp, jnp.asarray(x)), atol=1e-4, rtol=1e-4)


def test_mlstm_chunked_off_the_chunk_raises_like_jax():
    jp, tp = _mlstm_params()
    x = _x((1, 20, 64), 12)          # over one chunk of 16, not a multiple
    with pytest.raises(AssertionError):
        jx.mlstm_chunked(jp, jnp.asarray(x), chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        tx.mlstm_chunked(tp, torch.from_numpy(x), chunk=16)


def test_mlstm_decode_matches_jax():
    """Four steps from the chunked prefill's carry."""
    jp, tp = _mlstm_params(seed=2)
    x = _x((2, 16, 64), 13)
    _, jcache = jx.mlstm_chunked(jp, jnp.asarray(x), chunk=16)
    _, tcache = tx.mlstm_chunked(tp, torch.from_numpy(x), chunk=16)
    for i in range(4):
        step = _x((2, 1, 64), 14 + i)
        jy, jcache = jx.mlstm_decode(jp, jnp.asarray(step), jcache)
        ty, tcache = tx.mlstm_decode(tp, torch.from_numpy(step), tcache)
        _close(ty, jy)
        _state_close(tcache, jcache)


def test_slstm_layer_matches_jax():
    jp, tp = _jax_slstm_params(seed=2)
    x = _x((2, 24, 128), 15)
    _close(tx.slstm_layer(tp, torch.from_numpy(x)),
           jx.slstm_layer(jp, jnp.asarray(x)))


def test_slstm_decode_matches_jax():
    """Four steps, each a launch at S = 1 from the state before it."""
    jp, tp = _jax_slstm_params(seed=3)
    x = _x((2, 12, 128), 16)
    _, jcache = jtf._slstm_layer_with_state(jp, jnp.asarray(x))
    _, tcache = tx.slstm_mixer(tp, torch.from_numpy(x))
    for i in range(4):
        step = _x((2, 1, 128), 17 + i)
        jy, jcache = jx.slstm_decode(jp, jnp.asarray(step), jcache)
        ty, tcache = tx.slstm_decode(tp, torch.from_numpy(step), tcache)
        _close(ty, jy)
        _state_close(tcache, jcache)


# ---------------------------------------------------------------------------
# The reduced xlstm_125m: 3 mLSTM blocks and 1 sLSTM block, 4 heads of 32
# ---------------------------------------------------------------------------


def _models():
    jc = jax_config("xlstm_125m").reduced().replace(dtype="float32")
    tc = torch_config("xlstm_125m").reduced().replace(dtype="float32")
    jp = jcommon.init_params(japi.param_spec(jc), jax.random.PRNGKey(0))
    return jc, jp, tc, params_from_numpy(_np(jp), "cpu")


def test_xlstm_forward_matches_jax():
    jc, jp, tc, tp = _models()
    tokens = np.random.default_rng(20).integers(0, jc.vocab, (2, 64))
    _close(ttf.lm_forward(tc, tp, torch.from_numpy(tokens)),
           jtf.lm_forward(jc, jp, jnp.asarray(tokens, jnp.int32)))


def _caches_close(tcache, jcache):
    flat_j = jax.tree_util.tree_leaves_with_path(jcache)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tcache))
    assert len(flat_j) == len(flat_t) == 7
    for path, leaf in flat_j:
        _close(flat_t[path], leaf)


@pytest.mark.parametrize("plen", [24, 128])
def test_xlstm_prefill_and_decode_match_jax(plen):
    """A prefill within one mLSTM chunk (24) and over two (128), then 8
    greedy decode steps: logits and every cache leaf."""
    jc, jp, tc, tp = _models()
    tokens = np.random.default_rng(plen).integers(0, jc.vocab, (2, plen))
    jl, jcache = jtf.lm_prefill(jc, jp, jnp.asarray(tokens, jnp.int32), 256)
    tl, tcache = ttf.lm_prefill(tc, tp, torch.from_numpy(tokens), 256)
    _close(tl, jl)
    _caches_close(tcache, jcache)
    kv_len = np.full(2, plen, np.int32)
    for _ in range(8):
        tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
        jl, jcache = jtf.lm_decode(jc, jp, jnp.asarray(tok, jnp.int32),
                                   jcache, jnp.asarray(kv_len))
        tl, tcache = ttf.lm_decode(tc, tp, torch.from_numpy(tok), tcache,
                                   torch.from_numpy(kv_len))
        _close(tl, jl)
        kv_len += 1
    _caches_close(tcache, jcache)


def test_xlstm_prefill_off_the_chunk_raises_like_jax():
    jc, jp, tc, tp = _models()
    tokens = np.zeros((1, 70), np.int64)       # over one chunk of 64
    with pytest.raises(AssertionError):
        jtf.lm_prefill(jc, jp, jnp.asarray(tokens, jnp.int32), 128)
    with pytest.raises(ValueError, match="chunk"):
        ttf.lm_prefill(tc, tp, torch.from_numpy(tokens), 128)


def test_xlstm_routes_every_slstm_layer_through_slstm_seq():
    """On the CPU the wrapper's plain version runs; the model reaches it
    once per sLSTM block in a prefill and in a decode step."""
    _, _, tc, tp = _models()
    calls = []
    real = tops.slstm_seq

    def counted(*args, **kw):
        calls.append(args[0].shape[1])
        return real(*args, **kw)
    tops.slstm_seq = counted
    try:
        logits, cache = ttf.lm_prefill(tc, tp, torch.zeros((1, 9),
                                                           dtype=torch.long),
                                       32)
        ttf.lm_decode(tc, tp, logits.argmax(-1, keepdim=True), cache,
                      torch.tensor([9], dtype=torch.int32))
    finally:
        tops.slstm_seq = real
    assert calls == [9, 1]
