"""Where a dry-run cell's memory peak falls: the cell traced as
``launch/dryrun.py`` traces it (one device of the production mesh, fake
tensors, the op counter of ``analysis.hlo``), printing each op at which
the bytes the step's ops hold live (the dry run's ``temp_bytes``) pass
their high mark by more than ``--step`` GB, with the live GB and the
port's frames that ran it (inside the backward only the call that
started it shows).

  PYTHONPATH=src python -m repro_torch.launch.dryrun_peak --arch mistral_large_123b --shape train_4k
"""
from __future__ import annotations

import argparse
import sys
import traceback

from repro_torch.analysis import hlo
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh


def trace_highs(cfg, shape, mesh, step_bytes: float):
    """(the dry run's record of the cell, [(op index, op, live bytes,
    frames)] at each new high of the live bytes)."""
    highs, seen = [], {"n": 0, "mark": 0.0}
    dispatch = hlo.OpCounter.__torch_dispatch__

    def spied(self, func, types, args=(), kwargs=None):
        out = dispatch(self, func, types, args, kwargs)
        seen["n"] += 1
        if self._live > seen["mark"] + step_bytes:
            seen["mark"] = self._live
            frames = [f"{f.name}:{f.lineno}" for f in traceback.extract_stack()
                      if "repro_torch" in f.filename
                      and "dryrun" not in f.filename]
            highs.append((seen["n"], str(func), self._live, frames))
        return out
    hlo.OpCounter.__torch_dispatch__ = spied
    try:
        return dryrun.trace_cell(cfg, shape, mesh), highs
    finally:
        hlo.OpCounter.__torch_dispatch__ = dispatch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--step", type=float, default=1.0,
                    help="GB above the last printed high")
    ap.add_argument("--last", type=int, default=8,
                    help="how many of the last highs to print")
    a = ap.parse_args(argv)
    cell, highs = trace_highs(get_config(a.arch), SHAPES[a.shape],
                              make_production_mesh(multi_pod=a.multi_pod),
                              a.step * 1e9)
    m = cell["memory"]
    print(f"{a.arch} {a.shape} on {cell['mesh']}: peak estimate "
          f"{m['peak_estimate_gb']} GB = arguments "
          f"{m['argument_bytes'] / 1e9:.3f} + temp {m['temp_bytes'] / 1e9:.3f}"
          f" + outputs {m['output_bytes'] / 1e9:.3f} - aliased "
          f"{m['alias_bytes'] / 1e9:.3f}; of {len(highs)} highs the last "
          f"{a.last}:")
    for n, op, live, frames in highs[-a.last:]:
        print(f"  op {n} {op}: {live / 1e9:.3f} GB live; "
              f"{' < '.join(reversed(frames[-4:]))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
