"""Meshes of the port, after ``repro/launch/mesh.py``.

A mesh is a ``DeviceMesh`` over the processes of a ``torch.distributed``
job, one device a process: NCCL on the card, gloo on the CPU.  The
process group is started from the environment (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as torchrun sets them) unless
the caller has started it.  Without the ranks a production mesh needs,
:func:`make_production_mesh` gives an abstract one (sizes and names), on
which the dry run traces a device's program.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.parallel.comm import AbstractMesh, axis_sizes


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over this job's ranks,
    on the card (NCCL) unless ``device="cpu"`` (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 devices a pod; multi_pod=True -> 2 pods = 512.  A real
    mesh when this job has exactly that many ranks, else an abstract one."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if dist.is_initialized() and dist.get_world_size() == n:
        return make_mesh(shape, axes, device)
    return AbstractMesh(shape, axes)


def describe(mesh) -> str:
    sizes = axis_sizes(mesh)
    n = 1
    for s in sizes.values():
        n *= s
    return f"mesh {sizes} ({n} devices)"
