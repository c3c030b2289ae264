"""The port's threefry PRNG (repro_torch.random) against jax.random.

The same seeded keys go to both.  ``split``, ``fold_in``, ``random_bits``
(``jax.random.bits``), ``uniform``, ``randint`` and ``bernoulli`` must be
bit-equal, single keys and batches of keys alike (a batch stands for the
reference's ``vmap`` over keys).  ``normal`` needs ``log1p``, whose last
bit differs between XLA and torch, so it is held at ``NORMAL_ULP`` units
in the last place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as tr
from torch_parity import equal

SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 32 - 1]
SHAPES = [(), (1,), (5,), (3, 4), (7, 3), (1001,), (2, 3, 5)]
NORMAL_ULP = 4


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _tkey(seed):
    return tr.PRNGKey(seed, device="cpu")


def _keys(n=5, seed=3):
    """A batch of n keys in both packages."""
    return jax.random.split(_jkey(seed), n), tr.split(_tkey(seed), n)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_and_fold_in_are_bit_equal(seed):
    equal(np.asarray(_jkey(seed)), tr.key_data(_tkey(seed)), what="key")
    for num in (1, 2, 3, 7, (2, 3)):
        equal(np.asarray(jax.random.split(_jkey(seed), num)),
              tr.key_data(tr.split(_tkey(seed), num)), what=f"split {num}")
    for data in (0, 1, 12345, 2 ** 31, 2 ** 32 - 1):
        equal(np.asarray(jax.random.fold_in(_jkey(seed), data)),
              tr.key_data(tr.fold_in(_tkey(seed), data)),
              what=f"fold_in {data}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_uniform_bernoulli_are_bit_equal(seed, shape):
    jk, tk = _jkey(seed), _tkey(seed)
    equal(np.asarray(jax.random.bits(jk, shape)),
          tr.random_bits(tk, shape).numpy().astype(np.uint32), what="bits")
    equal(np.asarray(jax.random.uniform(jk, shape)),
          tr.uniform(tk, shape), what="uniform")
    equal(np.asarray(jax.random.uniform(jk, shape, minval=-3.0, maxval=5.0)),
          tr.uniform(tk, shape, -3.0, 5.0), what="uniform [-3, 5)")
    for p in (0.15, 0.5, 0.8):
        equal(np.asarray(jax.random.bernoulli(jk, p, shape)),
              tr.bernoulli(tk, p, shape), what=f"bernoulli {p}")


@pytest.mark.parametrize("bounds", [(0, 10), (1, 7), (0, 59121), (-5, 3),
                                    (3, 3), (7, 2), (0, 2 ** 31 - 1),
                                    (-2 ** 31, 2 ** 31 - 1)])
@pytest.mark.parametrize("shape", [(), (9,), (4, 5), (1001,)])
def test_randint_is_bit_equal(shape, bounds):
    lo, hi = bounds
    for seed in SEEDS[:3]:
        equal(np.asarray(jax.random.randint(_jkey(seed), shape, lo, hi,
                                            dtype=jnp.int32)),
              tr.randint(_tkey(seed), shape, lo, hi),
              what=f"randint {bounds} seed {seed}")


def test_a_batch_of_keys_is_the_reference_vmap():
    jks, tks = _keys()
    equal(np.asarray(jax.vmap(lambda k: jax.random.split(k, 5))(jks)),
          tr.key_data(tr.split(tks, 5)), what="split")
    equal(np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 9))(jks)),
          tr.key_data(tr.fold_in(tks, 9)), what="fold_in")
    equal(np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (3, 2)))(jks)),
          tr.uniform(tks, (3, 2)), what="uniform")
    equal(np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (4,), 0, 13))(jks)),
        tr.randint(tks, (4,), 0, 13), what="randint")
    equal(np.asarray(jax.vmap(
        lambda k: jax.random.bernoulli(k, 0.3, (6,)))(jks)),
        tr.bernoulli(tks, 0.3, (6,)), what="bernoulli")


def _ulp(ref, got) -> np.ndarray:
    ref = np.asarray(ref, np.float32).view(np.int32).astype(np.int64)
    got = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ref - got)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_normal_is_within_a_few_ulp(seed):
    """200,000 draws a key; the measured maximum is printed for PERF.md."""
    ref = np.asarray(jax.random.normal(_jkey(seed), (200_000,)))
    got = tr.normal(_tkey(seed), (200_000,)).numpy()
    ulp = _ulp(ref, got)
    print(f"normal seed {seed}: max {ulp.max()} ulp, "
          f"{(ulp > 0).mean():.4%} of draws differ")
    assert ulp.max() <= NORMAL_ULP
    jks, tks = _keys(64)
    assert _ulp(jax.vmap(lambda k: jax.random.normal(k, ()))(jks),
                tr.normal(tks, ())).max() <= NORMAL_ULP
    assert _ulp(jax.vmap(lambda k: jax.random.normal(k, (3, 7)))(jks),
                tr.normal(tks, (3, 7))).max() <= NORMAL_ULP


def test_erf_inv_ends_and_torch_erfinv_gap():
    """erf_inv gives +-inf at +-1 as XLA does, and the Giles polynomial is
    far closer to XLA's than torch.erfinv."""
    x = np.asarray(jax.random.uniform(_jkey(5), (50_000,), minval=-1.0,
                                      maxval=1.0))
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    ours = tr.erf_inv(torch.from_numpy(x.copy())).numpy()
    theirs = torch.erfinv(torch.from_numpy(x.copy())).numpy()
    assert _ulp(ref, ours).max() <= NORMAL_ULP < _ulp(ref, theirs).max()
    ends = tr.erf_inv(torch.tensor([-1.0, 1.0])).numpy()
    equal(np.asarray(jax.lax.erf_inv(jnp.asarray([-1.0, 1.0]))), ends,
          what="erf_inv(+-1)")


def test_keys_cross_between_packages():
    """A JAX key array, a numpy uint32 key and a port key name the same
    key; the port's keys go back as the uint32 words JAX keeps."""
    jk = jax.random.fold_in(_jkey(7), 3)
    tk = tr.as_key(np.asarray(jk), "cpu")
    equal(np.asarray(jk), tr.key_data(tk), what="as_key")
    equal(np.asarray(jax.random.uniform(jk, (8,))), tr.uniform(tk, (8,)),
          what="uniform from a crossed key")
    with pytest.raises(ValueError):
        tr.split(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        tr.PRNGKey(2 ** 32)
    with pytest.raises(OverflowError):       # as jax.random.randint
        tr.randint(tk, (2,), 0, 2 ** 40)


def test_prng_key_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    with pytest.raises(RuntimeError, match="GPU"):
        tr.PRNGKey(0)
