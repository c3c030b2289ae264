"""Pipeline parallelism over a mesh axis, after ``repro/parallel/pipeline.py``.

GPipe-style microbatched pipeline: each stage (a device along ``axis``)
holds its slice of the stacked per-stage params; activations flow
stage -> stage + 1 by point-to-point sends (``lax.ppermute``'s ring with
the last -> 0 leg dropped) while every stage computes its current
microbatch: the fill/steady/drain schedule, M + S - 1 ticks.  The last
stage's outputs are broadcast to every stage at the end.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..tree import tree_map
from . import comm


def pipeline_forward(stage_fn: Callable, mesh, axis: str = "stage"):
    """Build fn(local_params, microbatches) -> outputs.

    stage_fn(params_slice, x) -> y      one stage's compute
    local_params: leaves (1, ...)       this stage's slice of the stacked
                                        (S, ...) params
    microbatches: (M, mb, ...)          the same on every stage
    returns       (M, mb, ...)          the last stage's outputs, on all
    """
    n_stages = mesh.size(tuple(mesh.mesh_dim_names).index(axis))

    def run(params, xs):
        m = xs.shape[0]
        lp = tree_map(lambda t: t[0], params)
        stage = comm.coordinate(mesh, axis)
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(m + n_stages - 1):
            # stage 0 injects microbatch t (the last one past the end)
            x_in = xs[min(t, m - 1)] if stage == 0 else buf
            y = stage_fn(lp, x_in)
            buf = comm.shift(y, mesh, axis)
            out_idx = t - (n_stages - 1)
            if stage == n_stages - 1 and out_idx >= 0:
                outs[out_idx] = y
        return comm.broadcast(outs, mesh, axis, n_stages - 1)

    return run


def mlp_stage(params, x):
    """Reference stage for tests: y = tanh(x @ w1) @ w2."""
    return torch.tanh(x @ params["w1"]) @ params["w2"]
