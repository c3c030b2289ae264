"""Fault-tolerant checkpointing of tensor trees: async, atomic, retained.

The counterpart of ``repro.checkpoint.store``, in the same on-disk
format, so a checkpoint written by either package restores in the other:

  <dir>/step_000100.tmp-<nonce>/   (written)
  <dir>/step_000100/               (atomic rename when complete)
      manifest.json                (tree structure, shapes, dtypes, hash)
      arrays.npz                   (flat leaves by index: a0, a1, ...)

A tree is a nest of dicts, lists, tuples and ``NamedTuple``s whose leaves
are tensors or numpy arrays; ``None`` is an empty subtree.  Leaves are
flattened in JAX's order (dict keys sorted, sequences and a
``NamedTuple``'s fields in order), and the manifest's ``treedef`` is the
string JAX's ``tree_structure`` prints for the same nest, e.g.
``PyTreeDef({'a': *, 'b': [*, *]})``, or
``PyTreeDef(CustomNode(namedtuple[OptState], [*, {...}, ...]))`` for a
``NamedTuple``, so a training state saved by either package restores in
the other.

* save() is synchronous; AsyncCheckpointer runs it on a background
  thread (the caller never blocks on I/O) with a bounded queue.
* restore() validates the manifest and the digest, and puts every leaf
  on the device (and in the dtype) of the matching leaf of ``like``; with
  ``shardings`` (a tree of ``parallel.sharding.Layout``) each device
  keeps its block in the layout of a mesh that may differ from the one
  that wrote it (elastic restore).
* save() of a sharded state (``shardings``) gathers every leaf and
  writes whole leaves from the device at the mesh's origin, so the
  checkpoint is the one-device format either package reads.
* retention keeps the newest K checkpoints; incomplete .tmp dirs are
  ignored by latest_step() => crash-safe.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..tree import flatten as _flatten
from ..tree import tree_map
from ..tree import unflatten as _unflatten


def _host(x) -> np.ndarray:
    """A leaf as a host numpy array (one device-to-host copy per tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _snapshot(x) -> np.ndarray:
    """A leaf as a host numpy array that shares no memory with ``x``.

    ``_host`` of a CPU tensor is a view of it, and the training step
    updates its state in place, so a checkpoint written in the background
    must own its copy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def save(directory: Path, step: int, tree: Any,
         extra: Optional[Dict] = None, shardings: Any = None) -> Path:
    """Write ``tree`` as ``step``.  With ``shardings`` (a tree of
    ``Layout`` like ``tree``, whose leaves are a device's blocks) every
    device of the mesh must call: the leaves are gathered, the device at
    the origin writes them, and all wait for it."""
    if shardings is not None:
        import torch.distributed as dist
        whole = tree_map(lambda x, lay: lay.gather(x), tree, shardings)
        mesh = _leaves_of(shardings)[0].mesh
        path = Path(directory) / f"step_{step:08d}"
        if not any(mesh.get_coordinate()):
            save(directory, step, whole, extra)
        dist.barrier()
        return path
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp-{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True)
    leaves, treedef = _flatten(tree)
    arrays = {f"a{i}": _host(x) for i, x in enumerate(leaves)}
    np.savez(tmp / "arrays.npz", **arrays)
    digest = hashlib.sha256()
    for i in range(len(leaves)):
        digest.update(arrays[f"a{i}"].tobytes())
    manifest = {
        "step": step,
        "treedef": treedef,
        "n_leaves": len(leaves),
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": [str(a.dtype) for a in arrays.values()],
        "sha256": digest.hexdigest(),
        "time": time.time(),
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                 # atomic publish
    return final


def latest_step(directory: Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.iterdir():
        if p.is_dir() and p.name.startswith("step_") \
                and ".tmp-" not in p.name \
                and (p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def _like_dtype(ref) -> np.dtype:
    if isinstance(ref, torch.Tensor):
        return torch.empty((), dtype=ref.dtype).numpy().dtype
    return np.asarray(ref).dtype


def _leaves_of(tree) -> List[Any]:
    return _flatten(tree)[0]


def restore(directory: Path, step: int, like: Any, shardings: Any = None,
            validate_hash: bool = True) -> Any:
    """Load ``step`` into the structure of ``like``.

    Each leaf is checked against the shape of ``like``'s leaf, cast to its
    dtype and, for a tensor leaf, put on its device (a numpy leaf stays a
    numpy array).  With ``shardings`` (a tree of ``parallel.sharding.
    Layout`` like ``like``, whose leaves give the whole shapes, e.g. meta
    tensors) each leaf is this device's block of the layout, on the
    mesh's device unless ``like``'s leaf has a real one.
    """
    d = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    data = np.load(d / "arrays.npz")
    leaves, _ = _flatten(like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"leaf count mismatch: ckpt {manifest['n_leaves']}"
                         f" vs target {len(leaves)}")
    if validate_hash:
        digest = hashlib.sha256()
        for i in range(len(leaves)):
            digest.update(np.asarray(data[f"a{i}"]).tobytes())
        if digest.hexdigest() != manifest["sha256"]:
            raise ValueError("checkpoint hash mismatch (corrupt?)")
    lays = _leaves_of(shardings) if shardings is not None \
        else [None] * len(leaves)
    out = []
    for i, (ref, lay) in enumerate(zip(leaves, lays, strict=True)):
        arr = np.asarray(data[f"a{i}"])
        if list(arr.shape) != list(ref.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != {ref.shape}")
        arr = arr.astype(_like_dtype(ref))
        if lay is not None:
            dev = ref.device if isinstance(ref, torch.Tensor) \
                and ref.device.type != "meta" else _mesh_device(lay.mesh)
            out.append(lay.shard(torch.from_numpy(arr)).to(dev))
        elif isinstance(ref, torch.Tensor):
            out.append(torch.from_numpy(arr).to(ref.device))
        else:
            out.append(arr)
    return _unflatten(like, out)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class CheckpointManager:
    """Retention + auto-resume glue.

    :meth:`restore_latest` is corruption-tolerant: a retained step whose
    manifest digest no longer matches its arrays (bit rot, torn copy) is
    skipped — counted in ``corrupt_fallbacks`` — and the previous
    retained step is restored instead of raising through.  Only when
    every retained step is unreadable does the error surface."""

    def __init__(self, directory: Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self.corrupt_fallbacks = 0

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             shardings: Any = None):
        """``save`` and retention; with ``shardings`` every device calls
        and the one at the mesh's origin prunes."""
        path = save(self.directory, step, tree, extra, shardings)
        if shardings is None \
                or not any(_leaves_of(shardings)[0].mesh.get_coordinate()):
            self._gc()
        return path

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.directory.iterdir()
            if p.is_dir() and p.name.startswith("step_")
            and ".tmp-" not in p.name)
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)
        # sweep orphaned tmp dirs (crash mid-write)
        for p in self.directory.iterdir():
            if ".tmp-" in p.name:
                shutil.rmtree(p, ignore_errors=True)

    def latest(self) -> Optional[int]:
        return latest_step(self.directory)

    def steps(self) -> List[int]:
        """Complete (published) steps on disk, oldest first."""
        if not self.directory.exists():
            return []
        return sorted(
            int(p.name.split("_")[1])
            for p in self.directory.iterdir()
            if p.is_dir() and p.name.startswith("step_")
            and ".tmp-" not in p.name
            and (p / "manifest.json").exists())

    def restore_latest(self, like: Any):
        """Restore the newest readable retained step (digest-verified).

        A corrupt step falls back to the previous retained one instead
        of raising; ``(None, None)`` when no step exists, and the last
        step's error re-raises only when *every* retained step is
        unreadable."""
        steps = self.steps()
        if not steps:
            return None, None
        last_err: Optional[Exception] = None
        for s in reversed(steps):
            try:
                return s, restore(self.directory, s, like)
            except Exception as e:  # noqa: BLE001 - any corruption mode
                self.corrupt_fallbacks += 1
                last_err = e
        raise ValueError(
            f"no readable checkpoint among steps {steps} in "
            f"{self.directory}") from last_err


class AsyncCheckpointer:
    """Background-thread checkpoint writer with a bounded queue.

    `submit` copies the tree to host memory synchronously (a copy even of
    a CPU tree, which the caller may go on updating in place) and
    enqueues the serialization; the caller continues while
    the previous checkpoint is still being written.  `wait()` drains.
    """

    def __init__(self, manager: CheckpointManager, max_pending: int = 2):
        self.manager = manager
        self.q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self.errors: List[BaseException] = []
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self.q.get()
            if item is None:
                self.q.task_done()
                return
            step, host_tree, extra = item
            try:
                self.manager.save(step, host_tree, extra)
            except BaseException as e:   # surfaced on wait()
                self.errors.append(e)
            finally:
                self.q.task_done()

    def submit(self, step: int, tree: Any, extra: Optional[Dict] = None):
        self.q.put((step, tree_map(_snapshot, tree), extra))

    def wait(self):
        self.q.join()
        if self.errors:
            raise self.errors[0]

    def close(self):
        self.q.put(None)
        self.q.join()
