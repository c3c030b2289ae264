"""The JAX engine's outputs on ``benchmarks/engine_bench.py``'s design
points, with the packed batch they came from, for holding the port against
them where JAX is not installed.

  PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/jax_engine_reference.py \\
      OUT.npz [n_systems]

writes, for ``share_nre`` False and True (tags ``private`` and ``shared``),
every ``SystemBatch`` leaf as ``<tag>/leaf/<name>`` and the ten fields of
``CostEngine().total`` as ``<tag>/out/<field>``.
``python -m repro_torch.launch.engine_sums OUT.npz`` reads the file on the
card.
"""
import sys

import jax
import numpy as np

import repro.core as R
from benchmarks.engine_bench import make_specs

FIELDS = ("raw_chips", "chip_defects", "raw_package", "package_defects",
          "wasted_kgd", "nre_modules", "nre_chips", "nre_packages",
          "nre_d2d", "total")
TAGS = {"private": False, "shared": True}


def reference(n_systems: int, share_nre: bool):
    """(leaves, fields): the reference's packing of the first ``n_systems``
    design points as numpy arrays, and its engine's ten (N,) outputs."""
    batch = R.SystemBatch.from_systems(
        [R.spec(d) for d in make_specs(n_systems)], share_nre=share_nre)
    leaves = {f: np.asarray(jax.device_get(getattr(batch, f)))
              for f in R.SystemBatch._LEAVES}
    tc = R.CostEngine().total(batch)
    outs = [getattr(tc.re, k) for k in FIELDS[:5]]
    outs += [getattr(tc.nre, k[4:]) for k in FIELDS[5:9]] + [tc.total]
    return leaves, {k: np.asarray(jax.device_get(v))
                    for k, v in zip(FIELDS, outs)}


def main(argv) -> int:
    out = argv[1]
    n = int(argv[2]) if len(argv) > 2 else 10_000
    arrays = {}
    for tag, shared in TAGS.items():
        leaves, fields = reference(n, shared)
        arrays.update({f"{tag}/leaf/{k}": v for k, v in leaves.items()})
        arrays.update({f"{tag}/out/{k}": v for k, v in fields.items()})
    np.savez_compressed(out, **arrays)
    print(f"wrote {len(arrays)} arrays for {n} systems to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
