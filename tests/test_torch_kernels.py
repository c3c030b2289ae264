"""The port's kernel wrappers (repro_torch.kernels.ops) against the JAX
package's kernels.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held against the JAX Pallas kernels in interpret mode and against the JAX
oracles (impl="xla"), over the shape sweeps and tolerances of
tests/test_kernels.py (2e-5 in f32, 3e-2 in bf16).  The CUDA kernels
themselves are tested on the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (check_layout,
                                                flash_attention_fwd)
from torch_wrapper_calls import WRAPPERS, wrapper_call

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _both(x, dtype):
    """One numpy array as the same-valued JAX array and torch tensor."""
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(port, jax_out, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


ATTN_SHAPES = [
    (1, 2, 2, 64, 64, 32),      # MHA, square
    (2, 4, 2, 128, 128, 32),    # GQA 2x
    (1, 8, 2, 64, 128, 64),     # GQA 4x, longer KV than Q
    (2, 2, 1, 256, 256, 16),    # MQA
]
ATTN_CASES = [(shape, causal) for shape in ATTN_SHAPES
              for causal in (True, False)
              if not (causal and shape[3] != shape[4])]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,causal", ATTN_CASES)
def test_flash_attention(shape, causal, dtype):
    b, h, hkv, s, t, d = shape
    rng = np.random.default_rng(1)
    qj, qt = _both(rng.standard_normal((b, s, h, d), np.float32), dtype)
    kj, kt = _both(rng.standard_normal((b, t, hkv, d), np.float32), dtype)
    vj, vt = _both(rng.standard_normal((b, t, hkv, d), np.float32), dtype)
    out = tops.flash_attention(qt, kt, vt, causal=causal)
    assert out.shape == (b, s, h, d) and out.dtype == qt.dtype
    _close(out, jops.flash_attention(qj, kj, vj, causal=causal,
                                     interpret=True), dtype)
    _close(out, jops.flash_attention(qj, kj, vj, causal=causal, impl="xla"),
           dtype)


# the CUDA kernel's rounding plans against the Pallas kernel: the shape
# sweep and two served shapes with few heads (glm4_9b's and deepseek's head
# width, zamba2_7b's D = 112)
PLAN_CASES = ATTN_CASES + [((1, 2, 2, 512, 512, 128), True),
                           ((1, 2, 2, 512, 512, 112), True)]


def _attn_inputs(shape, dtype, seed=5):
    b, h, hkv, s, t, d = shape
    rng = np.random.default_rng(seed)
    return [_both(rng.standard_normal(x, np.float32), dtype)
            for x in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d))]


def _pallas(inputs, causal):
    return jops.flash_attention(*(j for j, _ in inputs), causal=causal,
                                interpret=True)


def _plan(fn, inputs, causal, **kw):
    qt, kt, vt = (t.transpose(1, 2) for _, t in inputs)
    return fn(qt, kt, vt, causal=causal, **kw).transpose(1, 2)


@pytest.mark.parametrize("shape,causal", PLAN_CASES)
def test_attention_3xtf32_plan_matches_pallas(shape, causal):
    """fp32: both products as three TF32 products hold the 2e-5 gate."""
    inputs = _attn_inputs(shape, "float32")
    _close(_plan(tref.attention_3xtf32, inputs, causal),
           _pallas(inputs, causal), "float32")


@pytest.mark.parametrize("shape,causal", PLAN_CASES)
def test_attention_bf16p_plan_matches_pallas(shape, causal):
    """bf16: p rounded to bf16 before P·V holds the 3e-2 gate."""
    inputs = _attn_inputs(shape, "bfloat16")
    _close(_plan(tref.attention_bf16p, inputs, causal),
           _pallas(inputs, causal), "bfloat16")


def test_single_tf32_product_misses_the_fp32_gate():
    """Why the fp32 kernel splits: one TF32 product a score and an output
    misses 2e-5 at D = 128, S = 512, where the split passes."""
    inputs = _attn_inputs((1, 2, 2, 512, 512, 128), "float32")
    want = np.asarray(_pallas(inputs, True), np.float32)
    one = _plan(tref.attention_3xtf32, inputs, True, split=False)
    err = np.abs(one.numpy() - want).max()
    assert err > 2e-5, err
    three = _plan(tref.attention_3xtf32, inputs, True)
    assert np.abs(three.numpy() - want).max() < 2e-5


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -12, 1 + 3 * 2 ** -12,
                      -(1 + 2 ** -11), -(1 + 2 ** -12)])
    want = torch.tensor([1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -10,
                         -(1 + 2 ** -10), -1.0])
    assert torch.equal(tref.tf32(x), want)


def _misaligned(dtype, shape):
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(*shape)


@pytest.mark.parametrize("dtype,d,dv,ok", [
    (torch.bfloat16, 16, 16, True), (torch.bfloat16, 112, 112, True),
    (torch.bfloat16, 128, 128, True), (torch.bfloat16, 24, 24, False),
    (torch.bfloat16, 144, 128, True), (torch.bfloat16, 192, 128, True),
    (torch.bfloat16, 208, 128, False), (torch.bfloat16, 192, 144, False),
    (torch.float32, 24, 24, True), (torch.float32, 112, 112, True),
    (torch.float32, 12, 12, False), (torch.float32, 136, 128, True),
    (torch.float32, 192, 128, True), (torch.float32, 200, 64, False),
    (torch.float32, 136, 136, False),
])
def test_flash_attention_head_dim_contract(dtype, d, dv, ok):
    """D (q and k) and Dv: multiples of wgmma's k16 in bf16 and mma.sync's
    k8 in fp32, D at most 192 (deepseek_v2_236b's 128 + 64) and Dv at most
    128, and the plan's shared memory within a block's."""
    q = torch.zeros(1, 64, 2, d, dtype=dtype).transpose(1, 2)
    v = torch.zeros(1, 64, 2, dv, dtype=dtype).transpose(1, 2)
    if ok:
        check_layout(q, q, v)
        assert fa.plan(dtype, d, dv) == fa.smem_bytes(dtype, d, dv) \
            <= fa.SMEM_LIMIT
    else:
        with pytest.raises(ValueError, match="multiple"):
            check_layout(q, q, v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_tma_layout_contract(dtype):
    """TMA's rules: 16-byte aligned bases, outer strides in 16-byte steps,
    the head dimension contiguous; a (B,S,H,D) tensor's transposed view and
    any stride of a size-1 dimension pass."""
    good = torch.zeros(2, 64, 4, 32, dtype=dtype).transpose(1, 2)
    check_layout(good, good, good)
    one = torch.zeros(32, dtype=dtype).as_strided((1, 1, 1, 32), (3, 5, 7, 1))
    check_layout(one, good, good)
    with pytest.raises(ValueError, match="aligned"):
        check_layout(good, _misaligned(dtype, (2, 4, 64, 32)), good)
    odd = torch.zeros(2, 4, 64, 36, dtype=dtype)[..., :32]   # 72 or 144 B
    if odd.stride(2) * odd.element_size() % 16:
        with pytest.raises(ValueError, match="strides"):
            check_layout(good, good, odd)
    with pytest.raises(ValueError, match="contiguous"):
        check_layout(good.transpose(2, 3)[..., :32, :], good, good)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,hkv,t,d", [
    (2, 4, 2, 128, 32), (1, 8, 8, 256, 64), (3, 4, 1, 512, 16),
])
def test_flash_decode(b, h, hkv, t, d, dtype):
    rng = np.random.default_rng(2)
    qj, qt = _both(rng.standard_normal((b, 1, h, d), np.float32), dtype)
    kj, kt = _both(rng.standard_normal((b, t, hkv, d), np.float32), dtype)
    vj, vt = _both(rng.standard_normal((b, t, hkv, d), np.float32), dtype)
    kv_len = rng.integers(1, t, b).astype(np.int32)
    out = tops.flash_decode(qt, kt, vt, torch.from_numpy(kv_len))
    assert out.shape == (b, 1, h, d) and out.dtype == qt.dtype
    lj = jnp.asarray(kv_len)
    _close(out, jops.flash_decode(qj, kj, vj, lj, interpret=True), dtype)
    _close(out, jops.flash_decode(qj, kj, vj, lj, impl="xla"), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,d", [(8, 64), (100, 256), (256, 128), (1, 32)])
def test_rmsnorm(n, d, dtype):
    rng = np.random.default_rng(3)
    xj, xt = _both(rng.standard_normal((n, d), np.float32), dtype)
    s = rng.standard_normal(d).astype(np.float32)
    out = tops.fused_rmsnorm(xt, torch.from_numpy(s))
    assert out.dtype == xt.dtype
    _close(out, jops.fused_rmsnorm(xj, jnp.asarray(s), interpret=True),
           dtype)
    _close(out, jops.fused_rmsnorm(xj, jnp.asarray(s), impl="xla"), dtype)


def test_rmsnorm_keeps_leading_axes():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 3, 64), np.float32))
    s = torch.linspace(0.5, 1.5, 64)
    out = tops.fused_rmsnorm(x, s, eps=1e-6)
    np.testing.assert_allclose(
        out.numpy(), tref.rmsnorm_ref(x.reshape(6, 64), s, 1e-6)
        .reshape(2, 3, 64).numpy(), atol=0, rtol=0)


@pytest.mark.parametrize("s,t", [(192, 192), (64, 320)])
def test_flash_attention_block_contract_matches_reference(s, t):
    """S or T off the TPU kernel's 128-row block: the Pallas kernel refuses
    it (a VMEM blocking detail), the port takes it, as its CUDA kernel does
    (ragged tiles, tests/test_torch_cuda.py), and agrees with the JAX
    reference attention on it."""
    rng = np.random.default_rng(s + t)
    x = rng.standard_normal((1, s, 2, 16)).astype(np.float32)
    y = rng.standard_normal((1, t, 2, 16)).astype(np.float32)
    with pytest.raises(AssertionError):
        jops.flash_attention(jnp.asarray(x), jnp.asarray(y), jnp.asarray(y),
                             causal=False, interpret=True)
    got = tops.flash_attention(torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(y), causal=False)
    _close(got, jops.flash_attention(jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(y), causal=False,
                                     impl="xla"), "float32")


def test_causal_flash_attention_needs_square():
    """The kernel aligns causal masks top-left and the oracle bottom-right;
    the port refuses S != T rather than let the two paths disagree."""
    q, kv = torch.zeros(1, 64, 2, 16), torch.zeros(1, 128, 2, 16)
    with pytest.raises(ValueError, match="S == T"):
        tops.flash_attention(q, kv, kv, causal=True)


def test_flash_decode_block_contract_matches_reference():
    """A cache of 384 rows, off the TPU kernel's 256-key block: the Pallas
    kernel refuses it, the port takes it, as its CUDA kernel does (a
    partial last tile), and agrees with the JAX reference decode."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 1, 2, 16)).astype(np.float32)
    kv = rng.standard_normal((1, 384, 2, 16)).astype(np.float32)
    n = np.array([300], np.int32)
    with pytest.raises(AssertionError):
        jops.flash_decode(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                          jnp.asarray(n), interpret=True)
    got = tops.flash_decode(torch.from_numpy(q), torch.from_numpy(kv),
                            torch.from_numpy(kv), torch.from_numpy(n))
    _close(got, jops.flash_decode(jnp.asarray(q), jnp.asarray(kv),
                                  jnp.asarray(kv), jnp.asarray(n),
                                  impl="xla"), "float32")


def test_ops_refuse_devices_other_than_cpu_and_cuda():
    """No silent fallback: only CPU tensors take the plain versions."""
    x = torch.zeros(4, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tops.fused_rmsnorm(x, torch.ones(64, device="meta"))
    q = torch.zeros(1, 64, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, q, q)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise; they never compute on the CPU."""
    q = torch.zeros(1, 2, 64, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_wrappers_refuse_inputs_that_require_grad(name):
    """The kernels have no backward, so a wrapper raises, naming its kernel,
    when grad mode is on and an input requires grad; the check comes before
    the device check, so it holds here too.  Under torch.no_grad() the call
    gets past it and meets the device check instead."""
    call = wrapper_call(name, "cpu")
    with pytest.raises(RuntimeError, match=f"CUDA kernel {name} has no "
                                           f"backward"):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        call()


def test_ops_on_cpu_stay_differentiable():
    """On the CPU, ops run the plain versions, which autograd records."""
    x = torch.randn(2, 4, 32, requires_grad=True)
    w = torch.randn(2, 32, 64, requires_grad=True)
    rows = torch.tensor([3, 0], dtype=torch.int32)
    y = tops.moe_gmm(x, w, rows)
    y.sum().backward()
    assert x.grad is not None and w.grad is not None
    assert x.grad[1].abs().max().item() == 0.0      # expert 1 holds no row
    s = torch.ones(64, requires_grad=True)
    tops.fused_rmsnorm(torch.randn(4, 64), s).sum().backward()
    assert s.grad is not None
