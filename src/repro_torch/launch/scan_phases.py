"""Where the time of a ``mamba_scan`` launch goes, phase by phase, on the card.

  PYTHONPATH=src python -m repro_torch.launch.scan_phases

Builds ``src/repro_torch/kernels/csrc/mamba_scan.cu`` alone with
``-DMAMBA_SCAN_STAMPS``, in which thread 0 of every block writes
``%globaltimer`` (ns) at the end of each phase, and points the kernel
wrapper at that build.  Then, at zamba2_7b's prefill widths (H = 112,
P = N = 64), one-chunk (S = 17) and eight-chunk (S = 512) scans in fp32
and bf16: per phase the mean and the largest time over the blocks, each
block's time from its start, the span of the launch, and when the blocks
started (the waves of a grid larger than the card holds at once).  Thread
0 sees the block's critical path, save where another warp publishes.  The
stamps cost a few global stores a block; the default build has none.
Needs a CUDA device and nvcc; the build goes to ``build/mamba_scan_stamps``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from ..kernels import _build
from ..kernels import mamba_scan as ms

UNITS, STAMPS = 8192, 12        # as in the source
PHASES = {1: "take the unit", 2: "x, B, C loads; cumsum", 3: "B ⊙ w",
          4: "Z out (and flagged)", 5: "C Bᵀ and G", 6: "G X",
          7: "look-back", 8: "the chunk's state out", 9: "C state_prev",
          10: "y out", 11: "publish, count out"}


def inputs(gen, dtype, s, h=112, p=64, n=64):
    """The model's layout: x, B and C strided slices of one tensor."""
    xbc = torch.randn(1, s, h * p + 2 * n, generator=gen,
                      device="cuda").to(dtype)
    xh, bm, cm = torch.split(xbc, [h * p, n, n], -1)
    dt = torch.randn(1, s, h, generator=gen, device="cuda").abs() * 0.1
    return (xh.reshape(1, s, h, p), dt,
            torch.randn(h, generator=gen, device="cuda") * 0.5, bm, cm)


def report(stamps: np.ndarray, units: int) -> None:
    st = stamps[:units].astype(np.int64)
    start = st[:, 0]
    last = np.max(np.where(st > 0, st, 0), axis=1)
    t0 = start.min()
    print(f"    span {(last.max() - t0) / 1e3:.2f} us; a block "
          f"{(last - start).mean() / 1e3:.2f} us on average; blocks started "
          f"at {np.percentile((start - t0) / 1e3, [0, 25, 50, 75, 100]).round(2).tolist()}"
          f" us (percentiles 0/25/50/75/100)")
    prev = start.copy()
    for k, name in PHASES.items():
        col = st[:, k]
        has = col > 0
        if has.any():
            d = (col[has] - prev[has]) / 1e3
            print(f"    {name:24s} mean {d.mean():6.3f} us, max "
                  f"{d.max():6.3f} us ({int(has.sum())} blocks)")
        prev = np.where(has, col, prev)


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_phases: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    lib = _build.stamped_library("mamba_scan.cu", "MAMBA_SCAN_STAMPS")
    read = lib.mamba_scan_read_stamps
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    _build.use(lib)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = np.zeros((UNITS, STAMPS), dtype=np.uint64)
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for s in (17, 512):
                args = inputs(gen, dtype, s)
                for _ in range(3):
                    ms.mamba_scan(*args, chunk=min(64, s))
                torch.cuda.synchronize()
                read(buf.ctypes.data)                       # clears them
                ms.mamba_scan(*args, chunk=min(64, s))
                torch.cuda.synchronize()
                if read(buf.ctypes.data):
                    raise RuntimeError("reading the stamps failed")
                pw, units = ms.tiling(1, s, 112, 64, sms)
                print(f"  {str(dtype)[6:]} S={s}: {units} blocks of {pw} "
                      f"columns of P")
                report(buf, units)
    return 0


if __name__ == "__main__":
    sys.exit(main())
