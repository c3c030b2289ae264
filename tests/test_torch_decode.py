"""The CUDA flash-decode kernel's plan, on the CPU.

The kernel splits each (b, KV head)'s keys into chunks, one block each,
and merges the chunks' partial (m, l, acc) in the same launch; its bf16
tensor-core path rounds P to bf16 before P·V.  ``ref.decode_split_ref``
is that plan in plain PyTorch; here it is held against the JAX Pallas
``flash_decode`` in interpret mode (2e-5 in f32, 3e-2 in bf16), with fill
levels on both sides of a chunk boundary and chunks wholly past kv_len.
The split count the wrapper picks is tested too: it reads the shapes and
the SM count, never kv_len.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(b, h, hkv, t, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, h, d), np.float32),
            rng.standard_normal((b, t, hkv, d), np.float32),
            rng.standard_normal((b, t, hkv, d), np.float32))


def _plan(q, k, v, kv_len, split, dtype=torch.float32):
    """decode_split_ref on the model's layouts: q (B,1,H,D), k/v
    (B,T,Hkv,D) numpy -> (B,H,Dv) float32 numpy; P rounded to bf16 where
    the kernel's tensor-core path would round it."""
    group, d, dv = q.shape[2] // k.shape[2], q.shape[3], v.shape[3]
    q, k, v = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    out = tref.decode_split_ref(q[:, 0], k.transpose(1, 2),
                                v.transpose(1, 2),
                                torch.as_tensor(kv_len, dtype=torch.int32),
                                split, round_p=fd.rounds_p(dtype, group, d,
                                                           dv))
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [16, 112, 128])
@pytest.mark.parametrize("h,hkv", [(2, 2), (4, 2), (16, 1)])   # G 1, 2, 16
def test_split_plan_matches_pallas(h, hkv, d, dtype):
    """T = 256 in 4 chunks of 64: kv_len at a chunk boundary - 1, at it, +1
    and at T; the first row leaves three chunks wholly past kv_len."""
    jdt, tdt, tol = DTYPES[dtype]
    b, t, split = 4, 256, 4
    q, k, v = _inputs(b, h, hkv, t, d)
    kv_len = np.array([63, 64, 65, 256], np.int32)
    want = jops.flash_decode(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                             jnp.asarray(v, jdt), jnp.asarray(kv_len),
                             interpret=True)
    np.testing.assert_allclose(_plan(q, k, v, kv_len, split, tdt),
                               np.asarray(want, np.float32)[:, 0],
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("split", [1, 2, 8, 16])
def test_split_plan_matches_pallas_at_other_split_counts(split):
    """fp32, glm4_9b's group of 16 at D = 128: kv_len at the boundaries of
    this split count's chunks, and 1."""
    b, h, hkv, t, d = 4, 16, 1, 256, 128
    q, k, v = _inputs(b, h, hkv, t, d, seed=1)
    chunk = t // split
    kv_len = np.array([max(chunk - 1, 1), chunk, min(chunk + 1, t), 1],
                      np.int32)
    want = jops.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(kv_len), interpret=True)
    np.testing.assert_allclose(_plan(q, k, v, kv_len, split),
                               np.asarray(want)[:, 0], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("split", [1, 3, 4, 8])
def test_split_plan_matches_plain_decode(split):
    """Against ``decode_ref`` at a ragged chunk (T = 192 in 3 chunks of 64,
    or 4 and 8 chunks rounded up to the 32-key tile, the last ones empty)."""
    b, h, hkv, t, d = 3, 4, 2, 192, 32
    q, k, v = _inputs(b, h, hkv, t, d, seed=2)
    kv_len = np.array([1, 100, 192], np.int32)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    want = tref.decode_ref(qt[:, 0], kt.transpose(1, 2), vt.transpose(1, 2),
                           torch.from_numpy(kv_len))
    np.testing.assert_allclose(_plan(q, k, v, kv_len, split), want.numpy(),
                               atol=2e-5, rtol=2e-5)


def test_split_plan_gives_zero_for_an_empty_cache():
    """kv_len = 0 gives exactly 0 (every chunk empty, weighed 0), as the
    TPU and CUDA kernels do; the other rows are untouched by it."""
    b, h, hkv, t, d = 2, 4, 2, 128, 16
    q, k, v = _inputs(b, h, hkv, t, d, seed=3)
    out = _plan(q, k, v, np.array([0, 77], np.int32), 4)
    assert np.all(out[0] == 0.0)
    want = jops.flash_decode(jnp.asarray(q[1:]), jnp.asarray(k[1:]),
                             jnp.asarray(v[1:]), jnp.asarray([77]),
                             interpret=True)
    np.testing.assert_allclose(out[1:], np.asarray(want)[:, 0], atol=2e-5,
                               rtol=2e-5)


def test_split_plan_ignores_the_cache_past_kv_len():
    """NaN in the unwritten tail changes nothing: masked keys weigh 0 and
    empty chunks are dropped, not multiplied by 0."""
    b, h, hkv, t, d = 2, 4, 2, 256, 32
    q, k, v = _inputs(b, h, hkv, t, d, seed=4)
    kv_len = np.array([65, 3], np.int32)
    clean = _plan(q, k, v, kv_len, 4)
    for i, n in enumerate(kv_len):
        k[i, n:], v[i, n:] = np.nan, np.nan
    np.testing.assert_array_equal(_plan(q, k, v, kv_len, 4), clean)


def test_split_count_reads_shapes_and_sm_count_only():
    """The grid follows T, the (b, KV head) groups and the SM count; kv_len
    is no argument, so a CUDA graph can replay the launch at any fill."""
    assert list(inspect.signature(fd.split_count).parameters) == \
        ["t", "groups", "sms"]


@pytest.mark.parametrize("b,h,hkv,t,want", [
    (4, 32, 2, 1024, 32),     # glm4_9b: 8 groups, 32 splits of 32 keys
    (4, 32, 32, 1024, 4),     # zamba2_7b's shared attention: 128 groups
    (4, 16, 16, 1024, 8),     # deepseek_moe_16b: 64 groups
    (4, 32, 2, 256, 8),       # 8 splits of 32 keys
    (2, 4, 2, 32, 1),         # one split: fewer than 64 keys
    (64, 64, 64, 1024, 1),    # 4096 groups fill the card alone
    (1, 64, 1, 512, 16),      # a group of 64 heads takes two blocks
])
def test_split_count_at_served_layouts(b, h, hkv, t, want):
    assert fd.split_count(t, fd.groups_of(b, h, hkv, 128, 128),
                          132) == want


def test_split_count_bounds():
    """A power of two up to 32; above 1, every split keeps at least one
    32-key tile; more groups never get more splits."""
    for t in (16, 64, 128, 256, 384, 1024, 4096, 32768):
        last = fd.MAX_SPLIT
        for groups in (1, 2, 8, 64, 128, 512, 4096):
            for sms in (114, 132):
                n = fd.split_count(t, groups, sms)
                assert n in (1, 2, 4, 8, 16, 32)
                assert n == 1 or t // n >= fd.MIN_SPLIT_KEYS
            n = fd.split_count(t, groups, 132)
            assert n <= last
            last = n


def test_groups_count_blocks_of_up_to_32_heads():
    assert fd.groups_of(4, 32, 2, 128, 128) == 8
    assert fd.groups_of(4, 32, 32, 128, 128) == 128
    assert fd.groups_of(2, 64, 1, 128, 128) == 4
    assert fd.groups_of(1, 33, 1, 128, 128) == 2
    # the latent rows of 576 / 512 take 16 heads a block
    assert fd.groups_of(4, 128, 1, 576, 512) == 32


def test_rounds_p_where_the_kernel_uses_tensor_cores():
    """bf16 groups of 8 to 16 heads (glm4_9b's 16) take mma.sync, whose A
    operand P is bf16; fp32, MHA and groups over 16 stay on CUDA cores."""
    assert fd.rounds_p(torch.bfloat16, 16, 128, 128)
    assert fd.rounds_p(torch.bfloat16, 8, 64, 64)
    assert not fd.rounds_p(torch.float32, 16, 128, 128)
    assert not fd.rounds_p(torch.bfloat16, 1, 128, 128)
    assert not fd.rounds_p(torch.bfloat16, 32, 128, 128)
    assert not fd.rounds_p(torch.bfloat16, 16, 20, 20)


def test_rounded_plan_stays_within_the_bf16_gate():
    """The rounding of P moves the bf16 result by less than the 3e-2 gate
    against Pallas, at glm4_9b's group of 16."""
    b, h, hkv, t, d = 4, 16, 1, 256, 128
    q, k, v = _inputs(b, h, hkv, t, d, seed=5)
    kv_len = np.array([256, 100, 33, 1], np.int32)
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    args = (qt[:, 0], kt.transpose(1, 2), vt.transpose(1, 2),
            torch.from_numpy(kv_len), 4)
    rounded = tref.decode_split_ref(*args, round_p=True).float()
    plain = tref.decode_split_ref(*args).float()
    assert 0 < (rounded - plain).abs().max() < 3e-2
