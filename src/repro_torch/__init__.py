"""PyTorch/CUDA port of the accelerator-workload substrate of ``repro``.

The JAX package ``repro`` is the reference; this package computes the
same functions with PyTorch and hand-written CUDA kernels for Hopper
(``kernels/csrc``).  It imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent,
    so no entry point carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU and torch sees none; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def upload(host, device, dtype=None) -> torch.Tensor:
    """A host array (or list) as a tensor on ``device``.  To a GPU it goes
    through pinned memory without blocking the host, so code that must
    not sync (a sweep's dispatch) can carry small host inputs over."""
    t = torch.as_tensor(host, dtype=dtype)
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)
