"""The port's MoE (repro_torch.models.moe) and grouped matmul
(repro_torch.kernels.ops.moe_gmm) against the JAX package's.

Inputs come from numpy seeds and weights from the JAX package's
``init_params``, converted with ``params_from_numpy``, so both packages
compute the same function on the same numbers.  On the CPU the port's
``moe_gmm`` runs its plain version, held here against JAX's Pallas ``gmm``
in interpret mode; the CUDA kernel is tested on the card by
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

# The grouped matmul's tolerances are tests/test_kernels.py's: fp32 sums of
# up to 256 products in another order (2e-5), and one bf16 rounding of the
# output (3e-2).
GMM_DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
              "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
# The MoE in fp32: the same routing and dispatch, and expert products whose
# sums differ from JAX's only in order.
MOE_TOL = dict(atol=2e-5, rtol=2e-5)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("dtype", list(GMM_DTYPES))
@pytest.mark.parametrize("e,c,d,f", [
    (2, 64, 32, 64), (4, 100, 64, 128), (1, 128, 128, 256),
    (8, 7, 32, 64),            # capacity smaller than the block (ragged C)
    (8, 1, 128, 256),          # C = 1, as in decode at four slots
])
def test_moe_gmm_matches_jax_pallas(e, c, d, f, dtype):
    jdt, tdt, tol = GMM_DTYPES[dtype]
    rng = np.random.default_rng(e * 1000 + c)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    out = tops.moe_gmm(torch.from_numpy(x).to(tdt),
                       torch.from_numpy(w).to(tdt))
    assert out.shape == (e, c, f) and out.dtype == tdt
    want = jops.moe_gmm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                        interpret=True)
    _close(out, want, atol=tol, rtol=tol)


def test_moe_gmm_takes_a_strided_x():
    """The model hands over its dispatch buffer without the sink row."""
    rng = np.random.default_rng(3)
    buf = rng.standard_normal((4, 9, 64)).astype(np.float32)
    w = rng.standard_normal((4, 64, 128)).astype(np.float32)
    out = tops.moe_gmm(torch.from_numpy(buf)[:, :8], torch.from_numpy(w))
    _close(out, jops.moe_gmm(jnp.asarray(buf[:, :8]), jnp.asarray(w),
                             interpret=True), atol=2e-5, rtol=2e-5)


# Row counts per expert, as moe_apply passes them: none, all C, a ragged
# count, and one above C, which clamps to C.
ROW_CASES = {"zero": 0, "full": None, "ragged": 3, "above_c": 1000}


@pytest.mark.parametrize("dtype", list(GMM_DTYPES))
@pytest.mark.parametrize("case", list(ROW_CASES))
@pytest.mark.parametrize("e,c,d,f", [(4, 7, 32, 64), (4, 60, 128, 256),
                                     (8, 1, 128, 256)])
def test_moe_gmm_rows_match_jax_pallas(e, c, d, f, case, dtype):
    """ops.moe_gmm(x, w, rows) against the TPU gmm on the same buffer,
    whose rows past each expert's count are zero, as the MoE dispatch
    builds it.  Expert 0 takes the case's count, the others seeded ones
    (0 to C + 2), so one call mixes empty, ragged, full and clamped
    experts."""
    jdt, tdt, tol = GMM_DTYPES[dtype]
    rng = np.random.default_rng(e * 100 + c)
    counts = rng.integers(0, c + 3, e).astype(np.int32)
    counts[0] = c if ROW_CASES[case] is None else ROW_CASES[case]
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    x[np.arange(c)[None, :] >= counts[:, None]] = 0.0
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    rows = torch.from_numpy(counts)
    out = tops.moe_gmm(torch.from_numpy(x).to(tdt),
                       torch.from_numpy(w).to(tdt), rows)
    assert out.shape == (e, c, f) and out.dtype == tdt
    want = jops.moe_gmm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                        interpret=True)
    _close(out, want, atol=tol, rtol=tol)
    past = np.arange(c)[None, :] >= np.minimum(counts, c)[:, None]
    assert (out.float().numpy()[past] == 0.0).all()


def test_moe_gmm_rows_give_exact_zeros_whatever_x_holds():
    """Rows past the count are exactly 0 even where x holds NaN there (a
    stale buffer), and rows within it are untouched by those NaNs."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal((3, 64, 128)).astype(np.float32)
    counts = np.array([2, 0, 5], np.int32)
    want = jops.moe_gmm(jnp.asarray(x), jnp.asarray(w), interpret=True)
    x[0, 2:] = np.nan
    x[1] = np.nan
    out = tops.moe_gmm(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(counts)).numpy()
    assert (out[0, 2:] == 0).all() and (out[1] == 0).all()
    np.testing.assert_allclose(out[0, :2], np.asarray(want)[0, :2],
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out[2], np.asarray(want)[2], atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("rows", [torch.zeros(4, dtype=torch.int64),
                                  torch.zeros(3, dtype=torch.int32),
                                  torch.zeros(4, 1, dtype=torch.int32)])
def test_moe_gmm_refuses_rows_that_are_not_e_int32(rows):
    x, w = torch.zeros(4, 2, 32), torch.zeros(4, 32, 64)
    with pytest.raises(ValueError, match="int32"):
        tops.moe_gmm(x, w, rows)


@pytest.mark.parametrize("d,f", [(200, 128), (128, 136), (384, 130)])
def test_moe_gmm_refuses_off_block_shapes_like_jax(d, f):
    """D and F must be multiples of their 128-wide block (any size under
    128 is its own block); both packages refuse the rest."""
    x, w = np.zeros((2, 4, d), np.float32), np.zeros((2, d, f), np.float32)
    with pytest.raises(AssertionError):
        jops.moe_gmm(jnp.asarray(x), jnp.asarray(w), interpret=True)
    with pytest.raises(ValueError, match="128"):
        tops.moe_gmm(torch.from_numpy(x), torch.from_numpy(w))


def _params(d=32, e=8, dff=16, shared=1, seed=7):
    jp = jcommon.init_params(jmoe.moe_spec(d, e, dff, shared),
                             jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _drops(ids, n_experts, cap):
    """Routed pairs over capacity, counted from the routing."""
    counts = np.bincount(np.asarray(ids).reshape(-1), minlength=n_experts)
    return int(np.maximum(counts - cap, 0).sum())


def test_route_matches_jax():
    jp, tp = _params()
    x = _x((40, 32), 1)
    jw, jids, jprobs = jmoe.route(jp, jnp.asarray(x), 2)
    tw, tids, tprobs = tmoe.route(tp, torch.from_numpy(x), 2)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(tw, jw, atol=1e-6, rtol=1e-6)
    _close(tprobs, jprobs, atol=1e-6, rtol=1e-6)


# (capacity factor, x shape, d, experts, d_ff, shared, top_k)
MOE_CASES = {
    # a prefill: two 16-token prompts at the configs' 1.25
    "prefill_1.25": (1.25, (2, 16, 32), 32, 8, 16, 1, 2),
    # a decode tick of four slots at 4.0 with deepseek_moe_16b's 64 experts
    # and top-6: cap = int(24 / 64 * 4) = 1, so colliding pairs drop
    "decode_4.0": (4.0, (4, 1, 64), 64, 64, 32, 2, 6),
    # a tight capacity: many slots drop, the shared expert stays
    "tight_0.5": (0.5, (2, 64, 32), 32, 8, 16, 1, 2),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_jax(case):
    cf, shape, d, e, dff, shared, k = MOE_CASES[case]
    jp, tp = _params(d, e, dff, shared)
    x = _x(shape, 2)
    want = jmoe.moe_apply(jp, jnp.asarray(x), k, capacity_factor=cf)
    got = tmoe.moe_apply(tp, torch.from_numpy(x), k, capacity_factor=cf)
    assert got.shape == shape
    _close(got, want, **MOE_TOL)
    n = shape[0] * shape[1]
    cap = int(max(1, n * k / e * cf))
    _, ids, _ = tmoe.route(tp, torch.from_numpy(x).reshape(n, d), k)
    if case != "prefill_1.25":      # the drop path is exercised
        assert _drops(ids.numpy(), e, cap) > 0


def test_moe_apply_matches_dense_oracle_when_capacity_ample():
    """As tests/test_moe_mla.py: at capacity factor 8 nothing drops, and the
    dispatch equals the every-expert mixture, the port's and JAX's."""
    jp, tp = _params()
    x = _x((2, 16, 32), 3)
    got = tmoe.moe_apply(tp, torch.from_numpy(x), 2, capacity_factor=8.0)
    _close(got, tmoe.moe_ref(tp, torch.from_numpy(x), 2), atol=1e-5,
           rtol=1e-5)
    _close(tmoe.moe_ref(tp, torch.from_numpy(x), 2),
           jmoe.moe_ref(jp, jnp.asarray(x), 2), **MOE_TOL)
    _close(got, jmoe.moe_apply(jp, jnp.asarray(x), 2, capacity_factor=8.0),
           **MOE_TOL)


def test_aux_load_balance_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((96, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ids = rng.integers(0, 8, (96, 2))
    got = tmoe.aux_load_balance_loss(torch.from_numpy(probs),
                                     torch.from_numpy(ids), 8)
    want = jmoe.aux_load_balance_loss(jnp.asarray(probs), jnp.asarray(ids), 8)
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    # and through moe_apply's return_aux, on its own routing
    jp, tp = _params()
    x = _x((2, 16, 32), 6)
    _, jaux = jmoe.moe_apply(jp, jnp.asarray(x), 2, return_aux=True)
    _, taux = tmoe.moe_apply(tp, torch.from_numpy(x), 2, return_aux=True)
    assert taux.item() == pytest.approx(float(jaux), rel=1e-6)
