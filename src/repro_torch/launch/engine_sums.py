"""The cost engine's float32 segment sums on the card, held against the CPU
and against the JAX engine, on ``benchmarks/engine_bench.py``'s systems.

  PYTHONPATH=src python -m repro_torch.launch.engine_sums REF.npz [repeats]

``REF.npz`` comes from ``tests/jax_engine_reference.py`` (run where JAX is
installed): the reference's packed batches, ``share_nre`` False and True,
and its engine's ten outputs.  For each batch the script builds the port's
batch from those leaves (``SystemBatch.from_arrays``) on the card and on
the CPU, runs ``CostEngine().total`` on the card ``repeats`` times (default
20), and prints, for every field, the largest relative difference over the
runs against the JAX engine and against the CPU, and how many runs differ
bit for bit from the first (none should: the engine's sums add in one
order on the card).  It also prints how far each of the four
amortization denominators, summed on the card in float32, lies from the
same sum in float64.  It exits 1 if any field misses the engine's
tolerance, 1e-5 relative and 1e-8 absolute (``tests/test_engine.py``), or
if a run differs from the first.
Needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from .. import core
from ..core.engine import _segment_sum

RTOL, ATOL = 1e-5, 1e-8
FIELDS = ("raw_chips", "chip_defects", "raw_package", "package_defects",
          "wasted_kgd", "nre_modules", "nre_chips", "nre_packages",
          "nre_d2d", "total")


def fields(tc) -> dict:
    out = {k: getattr(tc.re, k) for k in FIELDS[:5]}
    out.update({k: getattr(tc.nre, k[4:]) for k in FIELDS[5:9]})
    out["total"] = tc.total
    return {k: v.detach().cpu().double() for k, v in out.items()}


def worst(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(largest relative difference, whether every element is within
    ``ATOL + RTOL * |want|``)."""
    diff = (got - want).abs()
    rel = (diff / want.abs().clamp_min(1e-30)).max().item()
    return rel, bool((diff <= ATOL + RTOL * want.abs()).all())


def denominators(b, dtype) -> dict:
    """The engine's four sums of volumes over each entity, in ``dtype``."""
    q = b.quantity.to(dtype)
    chip_q = (q[:, None] * b.chip_mask.to(dtype)).reshape(-1)
    return {
        "chips": _segment_sum(chip_q, b.chip_entity_id.reshape(-1),
                              b.chip_entity_area.shape[0]),
        "packages": _segment_sum(q, b.pkg_entity_id,
                                 b.pkg_entity_area.shape[0]),
        "modules": _segment_sum(q[b.mod_sys], b.mod_entity,
                                b.mod_entity_area.shape[0]),
        "d2d": _segment_sum(q[b.d2d_sys], b.d2d_entity,
                            b.d2d_entity_nre.shape[0]),
    }


def run(path: str, repeats: int) -> bool:
    ref = np.load(path)
    ok = True
    for tag in ("private", "shared"):
        leaves = {k.split("/")[-1]: ref[k] for k in ref.files
                  if k.startswith(f"{tag}/leaf/")}
        want = {k: torch.as_tensor(ref[f"{tag}/out/{k}"]).double()
                for k in FIELDS}
        card = core.SystemBatch.from_arrays(device="cuda", **leaves)
        host = core.SystemBatch.from_arrays(device="cpu", **leaves)
        engine = core.CostEngine()
        on_cpu = fields(engine.total(host))
        runs = [fields(engine.total(card)) for _ in range(repeats)]
        print(f"{tag}: {card.n_systems} systems, {repeats} runs on the card")
        for k in FIELDS:
            vs_jax = [worst(r[k], want[k]) for r in runs]
            vs_cpu = [worst(r[k], on_cpu[k]) for r in runs]
            moved = sum(not torch.equal(r[k], runs[0][k]) for r in runs[1:])
            held = all(h for _, h in vs_jax + vs_cpu) and not moved
            ok &= held
            print(f"  {k:16s} against JAX {max(r for r, _ in vs_jax):.3e}, "
                  f"against the CPU {max(r for r, _ in vs_cpu):.3e}, "
                  f"{moved} of {repeats - 1} runs differ from the first; "
                  f"{'held' if held else 'MISSED'} at {RTOL:g}")
        exact = denominators(host, torch.float64)
        for k, v in denominators(card, torch.float32).items():
            e = exact[k]
            rel = ((v.cpu().double() - e).abs()
                   / e.abs().clamp_min(1e-30)).max().item()
            print(f"  denominator {k:9s} ({e.numel()} entities, largest "
                  f"{e.max().item():.4g}): float32 on the card against "
                  f"float64, max rel {rel:.3e}")
    return ok


def main(argv) -> int:
    repeats = int(argv[2]) if len(argv) > 2 else 20
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}")
    ok = run(argv[1], repeats)
    print("every field held" if ok else "a field missed the tolerance")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
