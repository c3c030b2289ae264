"""Where the time of a ``slstm_seq`` step goes, on the card.

  PYTHONPATH=src python -m repro_torch.launch.slstm_phases

Builds ``src/repro_torch/kernels/csrc/slstm_seq.cu`` alone with
``-DSLSTM_SEQ_STAMPS``, in which thread 0 of every block writes
``%globaltimer`` (ns) when the block starts and at five marks of every
step: the step's start, h_{t-1} in (the cluster barrier's wait returned),
the gates summed (products, the reduction of a column's 8 partial sums,
xg and bias), the update done (the gates' activations, the exp-gated
update, h_t written out), h_t sent (the stores into every block's shared
memory, and the barrier's arrival).  It points the kernel wrapper at
that build and runs xlstm_125m's heads (H = 4, Dh = 192) at B = 1, S = 17
and 512 and a decode tick (B = 4, S = 1, from a state), in fp32, in
clusters of 16 blocks.  For each it prints the prologue (block start to step
0), each phase's mean time a step over blocks and steps, the barrier (h_t
sent to h_t in at the next step, which includes waiting for the cluster's
slowest block), a step, and the launch's span; and the launch's time by
CUDA events, with and without the stamps.  Thread 0 sees its own warp's
path; the stamps cost a few global stores a step.  Last, the time of an
empty kernel launched back to back, the floor of any launch.  Needs a CUDA
device and nvcc; the build goes to ``build/slstm_seq_stamps``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from ..kernels import _build
from ..kernels import ref
from ..kernels import slstm_cell as sl
from .timing import device_ms

BLOCKS, STEPS, STAMPS = 64, 512, 5      # as in the source
H, DH = 4, 192


def report(st: np.ndarray, blocks: int, s: int) -> None:
    st = st[:blocks].astype(np.int64)
    start, steps = st[:, STEPS, 0], st[:, :min(s, STEPS)]
    t0 = start.min()
    print(f"    span {(steps[:, -1, 4].max() - t0) / 1e3:.2f} us; blocks "
          f"started within {(start.max() - t0) / 1e3:.2f} us; prologue "
          f"(start to step 0) mean {(steps[:, 0, 0] - start).mean() / 1e3:.3f}"
          f" us, max {(steps[:, 0, 0] - start).max() / 1e3:.3f} us")
    names = ("wait at the step's start", "gates summed", "update",
             "h_t sent")
    # step 0 waits on nothing and its send includes the start's barrier
    inner = steps[:, 1:] if s > 2 else steps
    for k, name in enumerate(names):
        d = (inner[..., k + 1] - inner[..., k]) / 1e3
        print(f"    {name:26s} mean {d.mean():7.3f} us a step, p90 "
              f"{np.percentile(d, 90):7.3f}")
    if s > 1:
        barrier = (steps[:, 1:, 1] - steps[:, :-1, 4]) / 1e3
        step = (steps[:, 1:, 4] - steps[:, :-1, 4]) / 1e3
        print(f"    {'barrier (sent to in)':26s} mean {barrier.mean():7.3f} "
              f"us a step, p90 {np.percentile(barrier, 90):7.3f}")
        print(f"    {'a step':26s} mean {step.mean():7.3f} us, p90 "
              f"{np.percentile(step, 90):7.3f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("slstm_phases: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    plain_lib = _build.library()
    stamped = _build.stamped_library("slstm_seq.cu", "SLSTM_SEQ_STAMPS")
    read = stamped.slstm_seq_read_stamps
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    buf = np.zeros((BLOCKS, STEPS + 1, STAMPS), dtype=np.uint64)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    r, bias = rnd(4, H, DH, DH) * 0.02, torch.zeros(4, H, DH, device="cuda")
    with torch.no_grad():
        for b, s, prefix in ((1, 17, 0), (1, 512, 0), (4, 1, 9)):
            xg = rnd(b, s, 4, H, DH)
            state = ref.slstm_seq_ref(rnd(b, prefix, 4, H, DH), r, bias)[1] \
                if prefix else None

            def call():
                return sl.slstm_seq(xg, r, bias, state)
            _build.use(plain_lib)
            plain_ms = device_ms(call)
            _build.use(stamped)
            stamped_ms = device_ms(call)
            read(buf.ctypes.data)                       # clears them
            call()
            torch.cuda.synchronize()
            if read(buf.ctypes.data):
                raise RuntimeError("reading the stamps failed")
            plan = sl.cluster_plan(b, H, DH, xg.dtype)
            blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
            print(f"  fp32 B={b} S={s}{' from a state' if prefix else ''}: "
                  f"{blocks} blocks, clusters of {plan.cluster}; launch "
                  f"{plain_ms:.4f} ms ({stamped_ms:.4f} ms with the stamps)")
            report(buf, blocks, s)
    empty = stamped.slstm_seq_empty_launch
    empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    print(f"  an empty kernel launched back to back: "
          f"{device_ms(lambda: empty(stream)):.4f} ms a launch")
    return 0


if __name__ == "__main__":
    sys.exit(main())
