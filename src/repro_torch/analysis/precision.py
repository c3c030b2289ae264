"""Float64 witnesses of the port's fp32 computations.

:class:`Float64` runs the port in float64 throughout, so that two ways
of computing the same step (one device or a mesh, one layer order or
another) can be held to each other free of fp32 rounding; :func:`double`
gives a tree's inputs in float64."""
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..tree import tree_map


class Float64(TorchDispatchMode):
    """Runs the port in float64 throughout: every float32 an operation
    asks for (a dtype argument, ``Tensor.float()``, a factory's default)
    is float64 inside the context, the backward and remat's recompute
    included.  Inputs are given as float64.  A witness, free of fp32
    rounding, that two ways of computing a step agree."""

    def __enter__(self):
        self._prev = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        return super().__enter__()

    def __exit__(self, *exc):
        torch.set_default_dtype(self._prev)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        def wide(a):
            return torch.float64 if a is torch.float32 else a
        return func(*map(wide, args),
                    **{k: wide(v) for k, v in (kwargs or {}).items()})


def double(tree):
    """``tree`` with its floating leaves (tensors or numpy arrays) as
    float64 tensors, its other leaves as they are."""
    def wide(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.double() if x.is_floating_point() else x
    return tree_map(wide, tree)
