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
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_fwd

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
    """Both packages refuse S or T off their 128-row block."""
    x = np.zeros((1, s, 2, 16), np.float32)
    y = np.zeros((1, t, 2, 16), np.float32)
    with pytest.raises(AssertionError):
        jops.flash_attention(jnp.asarray(x), jnp.asarray(y), jnp.asarray(y),
                             causal=False, interpret=True)
    with pytest.raises(ValueError):
        tops.flash_attention(torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(y), causal=False)


def test_causal_flash_attention_needs_square():
    """The kernel aligns causal masks top-left and the oracle bottom-right;
    the port refuses S != T rather than let the two paths disagree."""
    q, kv = torch.zeros(1, 64, 2, 16), torch.zeros(1, 128, 2, 16)
    with pytest.raises(ValueError, match="S == T"):
        tops.flash_attention(q, kv, kv, causal=True)


def test_flash_decode_block_contract_matches_reference():
    q = np.zeros((1, 1, 2, 16), np.float32)
    kv = np.zeros((1, 384, 2, 16), np.float32)
    n = np.ones(1, np.int32)
    with pytest.raises(AssertionError):
        jops.flash_decode(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                          jnp.asarray(n), interpret=True)
    with pytest.raises(ValueError):
        tops.flash_decode(torch.from_numpy(q), torch.from_numpy(kv),
                          torch.from_numpy(kv), torch.from_numpy(n))


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
