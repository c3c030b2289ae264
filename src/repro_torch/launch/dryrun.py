"""Dry run of the port: trace one device's program of every (arch x shape
x mesh) cell on fake tensors, after ``repro/launch/dryrun.py``.

For each cell it builds the port's own step (train / prefill / serve) on
the production mesh (16x16, or 2x16x16 with pods; an abstract mesh when
the job lacks the ranks), makes that device's arguments as
``FakeTensor``s (no storage), runs the step once under the op counter
(``analysis.hlo``) and records:

  * memory         — argument bytes (the device's blocks and rows,
                     exact), output bytes, the peak of the bytes the
                     step's ops hold live (temp), what outputs alias, and
                     whether the sum fits the H100's HBM,
  * hlo_analysis   — the counter's FLOPs, HBM bytes and collective bytes
                     of the device's step (the collectives are the
                     plan's all-gathers, reduce-scatters and all-reduces,
                     with the bytes of the blocks they move),
  * roofline       — the three terms at the TPU constants (the JAX
                     package's keys) and, under ``roofline_h100``, at the
                     H100's, with ``model_flops``.

The traced program is the card's route: the hand-written kernels' calls
count by their formulas (``kernels/ops.py``).  ``t_lower_s`` is the
seconds to build the arguments, ``t_compile_s`` the seconds of the trace.
Results accumulate in a JSON cache keyed ``arch|shape|mesh[|tag]``
(resumable; cells already ``ok`` or ``skip`` are kept unless --force).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4_9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis import hlo
from repro_torch.analysis.roofline import (H100, model_flops,
                                           roofline_from_report)
from repro_torch.configs.base import (ARCH_IDS, SHAPES, cell_supported,
                                      get_config)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import steps as st
from repro_torch.tree import leaves

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "results" \
    / "dryrun_torch.json"


def build_cell(cfg, shape, mesh, rules):
    """(fn, args) of one device's program of a cell; the arguments are
    made on the CPU, as fake tensors under an active ``FakeTensorMode``."""
    dev = "cpu"
    if shape.kind == "train":
        fn = st.make_train_step(cfg, accum=cfg.accum, mesh=mesh,
                                rules=rules, global_batch=shape.global_batch)
        return fn, (st.abstract_state(cfg, mesh, rules, dev),
                    st.abstract_batch(cfg, shape, mesh, rules,
                                      accum=cfg.accum, device=dev))
    params = st.abstract_state(cfg, mesh, rules, dev).params
    batch = st.abstract_batch(cfg, shape, mesh, rules, device=dev)
    if shape.kind == "prefill":
        return st.make_prefill_step(cfg, shape.seq_len, mesh, rules,
                                    shape.global_batch), \
            (params, batch)
    if shape.kind == "decode":
        return st.make_serve_step(cfg, mesh, rules, shape.global_batch), \
            (params, batch, st.abstract_cache(cfg, shape, mesh, rules, dev))
    raise ValueError(shape.kind)


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def trace_cell(cfg, shape, mesh, rules=None) -> dict:
    """The per-device record of one cell (``cfg`` as given) on ``mesh``."""
    rules = rules or shd.default_rules(
        multi_pod="pod" in mesh.mesh_dim_names, act_shard=cfg.act_shard)
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=False):
        fn, args = build_cell(cfg, shape, mesh, rules)
        t_lower = time.time() - t0
        out, rep = hlo.count(fn, *args,
                             score_chunks=(cfg.attn_chunk, cfg.ssm_chunk))
    t_trace = time.time() - t0 - t_lower
    rep.trip_counts = hlo.scanned_stacks(cfg, shape.kind)
    rep.n_while = len(rep.trip_counts)
    arg_leaves, out_leaves = leaves(args), leaves(out)
    arg_ids = {id(t) for t in arg_leaves}
    alias = _bytes(t for t in out_leaves if id(t) in arg_ids)
    arg_b, out_b = _bytes(arg_leaves), _bytes(out_leaves)
    temp = rep.peak_live_bytes
    peak = arg_b + temp + out_b - alias
    mf = model_flops(cfg, shape)
    chips = mesh.size()
    return {
        "status": "ok",
        "mesh": "x".join(str(n) for n in mesh.shape),
        "chips": int(chips),
        "t_lower_s": round(t_lower, 2), "t_compile_s": round(t_trace, 2),
        "memory": {
            "argument_bytes": arg_b, "output_bytes": out_b,
            "temp_bytes": temp, "alias_bytes": alias,
            "peak_estimate_gb": round(peak / 1e9, 3),
            "fits_h100": peak <= H100.hbm_gb * 1e9,
        },
        "hlo_analysis": rep.as_dict(),
        "roofline": roofline_from_report(rep, chips=chips,
                                         model_flops=mf).as_dict(),
        "roofline_h100": roofline_from_report(
            rep, chips=chips, model_flops=mf, hw=H100,
            dtype=cfg.dtype).as_dict(),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides=None) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"status": "skip", "reason": why}
    eff = cfg.replace(**overrides) if overrides else cfg
    res = trace_cell(eff, shape, make_production_mesh(multi_pod=multi_pod))
    res.update(arch=arch, shape=shape_name)
    return res


def cell_key(arch, shape, mesh_label, tag=""):
    k = f"{arch}|{shape}|{mesh_label}"
    return f"{k}|{tag}" if tag else k


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCH_IDS)
    p.add_argument("--shape", choices=list(SHAPES))
    p.add_argument("--mesh", choices=["single", "multi", "both"],
                   default="single")
    p.add_argument("--all", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--out", type=Path, default=DEFAULT_OUT)
    p.add_argument("--tag", default="", help="variant tag for perf sweeps")
    p.add_argument("--override", action="append", default=[],
                   help="cfg override key=value (e.g. remat=dots)")
    args = p.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    args.out.parent.mkdir(parents=True, exist_ok=True)
    results = json.loads(args.out.read_text()) if args.out.exists() else {}

    failures = 0
    for a, s, mp in cells:
        label = "2x16x16" if mp else "16x16"
        key = cell_key(a, s, label, args.tag)
        if key in results and results[key].get("status") in ("ok", "skip") \
                and not args.force:
            print(f"[cached] {key}: {results[key]['status']}")
            continue
        print(f"[run] {key} ...", flush=True)
        try:
            res = run_cell(a, s, mp, overrides or None)
            if overrides:
                res["overrides"] = overrides
        except Exception as e:
            traceback.print_exc()
            res = {"status": "fail", "error": f"{type(e).__name__}: {e}"}
            failures += 1
        results[key] = res
        args.out.write_text(json.dumps(results, indent=1, sort_keys=True))
        if res["status"] == "ok":
            r, h, m = res["roofline"], res["roofline_h100"], res["memory"]
            print(f"  ok: trace {res['t_compile_s']}s  "
                  f"mem/dev {m['peak_estimate_gb']} GB "
                  f"({'fits' if m['fits_h100'] else 'does NOT fit'} an "
                  f"H100)  bound={r['bound']}  t={r['t_bound']:.4f}s  "
                  f"frac={r['roofline_fraction']:.3f}  H100 "
                  f"bound={h['bound']} t={h['t_bound']:.4f}s")
        else:
            print(f"  {res['status']}: {res.get('reason') or res.get('error')}")
    print(f"done: {len(cells)} cells, {failures} failures -> {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
