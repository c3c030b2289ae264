"""One ``moe_gmm`` call with row counts, repeated, on the card.

  PYTHONPATH=src python -m repro_torch.launch.gmm_repeats [repeats]

The inputs of the card test
``test_moe_gmm_kernel_with_rows[64-60-1408-2048-dtype0]``
(tests/test_torch_cuda.py): E = 64 experts, C = 60, D = 1408, F = 2048,
fp32, x and w from seed 7, seeded row counts, x NaN past each count and
the output over memory left NaN.  Each repeat runs the kernel and its plain
version ``ref.gmm_ref`` and compares them at the test's 2e-5.  It prints
whether either side ever differs from its own first result, bit for bit,
the largest error of each against a float64 product, and, for every repeat
that fails the test's check, the largest error and where it falls: expert,
row (against the expert's count and the 64-row tile) and column.  Needs a
CUDA device.
"""
from __future__ import annotations

import subprocess
import sys

import torch

from ..kernels import moe_gmm as mg
from ..kernels import ref

E, C, D, F = 64, 60, 1408, 2048
TOL = 2e-5


def inputs():
    """The test's x, w and rows, x NaN past each count."""
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(E, C, D, generator=g, device="cuda")
    w = torch.randn(E, D, F, generator=g, device="cuda") * D ** -0.5
    cg = torch.Generator().manual_seed(E * 1000 + C)
    rows = torch.randint(0, C + 3, (E,), generator=cg, dtype=torch.int32)
    for i, n in enumerate((C // 2 + 1, 0, C, C + 5)):
        rows[i] = n
    rows = rows.to("cuda")
    past = torch.arange(C, device="cuda")[None, :] \
        >= rows.clamp_max(C)[:, None]
    return x.masked_fill(past[..., None], float("nan")), w, rows, past


def kernel(x, w, rows):
    """The kernel's output over memory left NaN, as in the test: a
    NaN-filled tensor of the output's size is freed just before the call,
    so the caching allocator hands its block to the wrapper's output.
    Also whether it did."""
    stale = torch.full((E, C, F), float("nan"), device="cuda")
    ptr = stale.data_ptr()
    del stale
    y = mg.moe_gmm(x, w, rows)
    return y, y.data_ptr() == ptr


def where(err, rows):
    e, r, col = (int(i) for i in torch.nonzero(err == err.max())[0])
    return (f"expert {e} (count {int(rows[e])}), row {r} (tile {r // 64}, "
            f"row {r % 64} of it), column {col}")


def main() -> int:
    if not torch.cuda.is_available():
        print("gmm_repeats: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; path {mg.path(*inputs()[:2])}")
    x, w, rows, past = inputs()
    exact = ref.gmm_ref(x.double(), w.double(), rows)
    first_k = first_r = None
    moved_k = moved_r = fails = fresh = 0
    worst_k = worst_r = 0.0
    with torch.no_grad():
        for i in range(repeats):
            (y, stale), want = kernel(x, w, rows), ref.gmm_ref(x, w, rows)
            fresh += not stale
            torch.cuda.synchronize()
            if first_k is None:
                first_k, first_r = y.clone(), want.clone()
            moved_k += not torch.equal(y, first_k)
            moved_r += not torch.equal(want, first_r)
            worst_k = max(worst_k, (y.double() - exact).abs().nan_to_num(
                float("inf")).max().item())
            worst_r = max(worst_r, (want.double() - exact).abs().nan_to_num(
                float("inf")).max().item())
            zeros = bool((y[past] == 0).all())
            ok = zeros and torch.allclose(y, want, atol=TOL, rtol=TOL)
            if not ok:
                fails += 1
                err = (y - want).abs().nan_to_num(float("inf"))
                print(f"  repeat {i}: fails (rows past the count all 0: "
                      f"{zeros}); max |kernel - plain| {err.max().item():.3e}"
                      f" at {where(err, rows)}")
    print(f"{repeats} repeats: {fails} fail the test's check; the kernel "
          f"differs from its first result in {moved_k}, the plain version "
          f"in {moved_r}; max |kernel - float64| {worst_k:.3e}, max "
          f"|plain - float64| {worst_r:.3e}; {fresh} outputs not over "
          f"the NaN-filled block")
    return 0


if __name__ == "__main__":
    sys.exit(main())
