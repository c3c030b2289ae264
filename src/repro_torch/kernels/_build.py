"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` goes into one shared library with a plain C
interface, compiled for ``sm_90a`` (Hopper) by one ``nvcc`` a source, all
started together, then linked, and loaded with ``ctypes``.  The library
is named after a hash of the sources and flags, built at first use into
``build/torch_kernels/`` at the root of the checkout, and reused while the
sources are unchanged.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0, so a refused launch is never
mistaken for a result.  ptxas reports each kernel's registers, shared
memory and spills (``-Xptxas -v``); the report is kept beside the library
in a ``.log`` file, :func:`build_log` returns it.

The kernels have no backward yet: a wrapper's output carries no
``grad_fn``.  So every wrapper first calls :func:`refuse_grad`, which
raises where autograd would otherwise record the call and lose the
gradient without a word.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Optional, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
COMPILE_FLAGS = [f for f in NVCC_FLAGS if f != "-shared"] + ["-c"]
# C entry points return these for a TMA tensor map they could not encode
# (csrc/hopper.cuh): no cuTensorMapEncodeTiled, or its CUresult + the base
NO_ENCODER, ENCODE_FAILED = 90000, 90001

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[pathlib.Path] = None
_functions = {}
BUILD_SECONDS = 0.0     # time of the nvcc calls; 0 when the library is reused


def _sources() -> Sequence[pathlib.Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib, _lib_path, BUILD_SECONDS
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in _sources():
            h.update(src.name.encode())
            h.update(src.read_bytes())
        out = BUILD_DIR / f"libreprotorch_{h.hexdigest()[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cu = [s for s in _sources() if s.suffix == ".cu"]
            objs = [BUILD_DIR / f"{s.stem}.{os.getpid()}.o" for s in cu]
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [_nvcc(), *COMPILE_FLAGS, "-o", str(o), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for s, o in zip(cu, objs)]
            logs = [p.communicate()[0] for p in procs]
            failed = [f"{s.name} ({p.returncode}):\n{log}" for s, p, log
                      in zip(cu, procs, logs) if p.returncode != 0]
            if not failed:
                link = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                     *map(str, objs)], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
                logs.append(link.stdout)
                if link.returncode != 0:
                    failed.append(f"link ({link.returncode}):\n"
                                  f"{link.stdout}")
            BUILD_SECONDS = time.perf_counter() - t0
            for o in objs:
                o.unlink(missing_ok=True)
            if failed:
                raise RuntimeError("nvcc failed: " + "\n".join(failed))
            out.with_suffix(".log").write_text("".join(logs))
            os.replace(tmp, out)
        _lib, _lib_path = ctypes.CDLL(str(out)), out
        return _lib


def stamped_library(source: str, define: str) -> ctypes.CDLL:
    """``csrc/<source>`` alone, built with ``-D<define>`` (its phase
    stamps, for the scripts in ``repro_torch/launch``) into
    ``build/<stem>_stamps/`` beside the kernel library."""
    src = CSRC / source
    flags = [*NVCC_FLAGS, f"-D{define}"]
    h = hashlib.sha256(" ".join(flags).encode())
    for f in (src, *CSRC.glob("*.cuh")):
        h.update(f.read_bytes())
    out = BUILD_DIR.parent / f"{src.stem}_stamps" / \
        f"lib{src.stem}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_nvcc(), *flags, "-o", str(out), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def use(lib: ctypes.CDLL) -> None:
    """Point every kernel wrapper at ``lib``: a :func:`stamped_library`,
    or the one :func:`library` returned before."""
    global _lib, _functions
    with _lock:
        _lib, _functions = lib, {}


def library_path() -> pathlib.Path:
    """The built library's file (building it on first use)."""
    library()
    return _lib_path


def build_log() -> str:
    """nvcc's and ptxas's report of the build that made the library."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def function(name: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point of the library with its argument types declared
    (``c_void_p`` for pointers and the stream, so none is cut to 32 bits)."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and a tensor input requires grad: the
    kernel's output would carry no ``grad_fn``.  Every kernel wrapper calls
    this before any other check, so it holds on every device."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"CUDA kernel {name} has no backward, and an "
                           f"input requires grad under grad mode: run it "
                           f"under torch.no_grad() or on detached inputs")


def check(err: int, name: str) -> None:
    if err == NO_ENCODER:
        raise RuntimeError(f"CUDA kernel {name}: the CUDA runtime found no "
                           f"cuTensorMapEncodeTiled")
    if err >= ENCODE_FAILED:
        raise RuntimeError(f"CUDA kernel {name}: cuTensorMapEncodeTiled "
                           f"failed, CUresult {err - ENCODE_FAILED}")
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
