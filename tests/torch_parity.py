"""Shared comparison of the port (``repro_torch``) with the JAX package.

``close`` takes numpy arrays, tensors, JAX arrays or Python numbers on
either side and compares them elementwise at a tolerance the caller
names.  The constants are the tolerances of the reference's own tests:

* ``ENGINE_RTOL``: the batched engine against the scalar path,
  ``tests/test_engine.py`` (with ``ENGINE_ATOL`` for exact zeros);
* ``KERNEL_F32_TOL`` / ``KERNEL_BF16_TOL``: the kernels in fp32 and bf16,
  ``tests/test_kernels.py``.
"""
import numpy as np
import torch

ENGINE_RTOL = 1e-5
ENGINE_ATOL = 1e-8
KERNEL_F32_TOL = 2e-5
KERNEL_BF16_TOL = 3e-2


def to_numpy(x) -> np.ndarray:
    """A host numpy copy of a tensor, a JAX array or a number."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def close(ref, port, *, rtol: float, atol: float = 0.0, what: str = ""):
    """Assert ``port`` equals ``ref`` within ``atol + rtol * |ref|``."""
    ref_np, port_np = to_numpy(ref), to_numpy(port)
    assert ref_np.shape == port_np.shape, \
        f"{what}: shape {port_np.shape} != reference {ref_np.shape}"
    np.testing.assert_allclose(port_np.astype(np.float64),
                               ref_np.astype(np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def equal(ref, port, *, what: str = ""):
    """Assert ``port`` is bit-equal to ``ref``, dtype and shape included."""
    ref_np, port_np = to_numpy(ref), to_numpy(port)
    assert ref_np.dtype == port_np.dtype, \
        f"{what}: dtype {port_np.dtype} != reference {ref_np.dtype}"
    assert ref_np.shape == port_np.shape, \
        f"{what}: shape {port_np.shape} != reference {ref_np.shape}"
    assert np.array_equal(ref_np, port_np), f"{what}: values differ"
