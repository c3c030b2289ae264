"""Convert the JAX package's trees (parameters, caches) into the port's.

The port keeps the JAX package's names and layouts, so conversion is a
key-for-key copy of leaves.  Leaves arrive as numpy arrays
(``np.asarray`` of a JAX array); bfloat16 arrives as the ``ml_dtypes``
numpy type, which torch cannot read directly, and goes over as its bits.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)     # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device) -> Any:
    """Nested dict of array leaves -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
