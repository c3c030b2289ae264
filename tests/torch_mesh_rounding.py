"""How far a mesh train step's state lands from the unsharded step's, in
fp32 and in float64, for one case of
``test_torch_parallel.py::test_sharded_train_step_matches_single_device``.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_mesh_rounding.py \
      deepseek_7b 4x2 [--accum 2] [--masked] [--act-shard seq] \
      [--norms] [--seq 12] [--set n_heads=8 ...]

Two steps of the case's inputs run on one gloo rank a device of the mesh
(``sharded_train``, fp32 then float64 under
``torch_mesh_programs.Float64``) and in this process unsharded, fp32 and
float64.  For each group of state leaves (params, master, m, v) and for
the first step's gradients ("grads") it prints the largest gap, each
leaf's as a share of that leaf's largest value: mesh against unsharded
in fp32 and in float64, and each fp32 step against the float64
unsharded step.  ``--norms`` draws the norm scales away from 1 as the
``norms-mesh2`` case does; ``--seq`` sets the positions a row (an
encoder-decoder's frames, ``test_torch_parallel.encdec_batch``);
``--set`` a field of both reduced configs, as a case's ``replace``.
"""
import argparse
import contextlib
import json
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import torch

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parent)]

import test_torch_parallel as tp  # noqa: E402
from repro_torch.parallel import steps as tst  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from torch_mesh_programs import Float64, double  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("mesh", help="data x model, e.g. 4x2")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--masked", action="store_true")
    ap.add_argument("--act-shard", default="seq")
    ap.add_argument("--norms", action="store_true")
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=INT", help="a config field of both "
                    "packages' reduced config, e.g. n_heads=8")
    a = ap.parse_args(argv)
    mesh = tuple(int(n) for n in a.mesh.split("x"))
    over = {k: int(v) for k, v in (f.split("=") for f in a.set)}
    jc = tp.jax_config(a.arch).reduced().replace(
        dtype="float32", act_shard=a.act_shard, accum=a.accum, **over)
    tc = tp.torch_config(a.arch).reduced().replace(
        dtype="float32", act_shard=a.act_shard, accum=a.accum, **over)
    # the test's inputs: a VLM cell of 16 positions is 8 patches, 8 tokens
    text = a.seq // 2 if jc.family == "vlm" else a.seq
    dc = tp.DataConfig(seq_len=text, global_batch=4 * a.accum,
                       vocab=jc.vocab)
    batches = [tp.encdec_batch(jc, 4 * a.accum, a.seq, s)
               if jc.family == "encdec" else tp.synthetic_batch(dc, s)
               for s in range(2)]
    if jc.family == "vlm":
        rng = np.random.default_rng(5)
        for b in batches:
            b["img_embeds"] = rng.standard_normal(
                (4 * a.accum, a.seq - text, jc.d_model)).astype(np.float32)
    if a.masked:
        batches = [tp._masked(b, a.accum) for b in batches]
    js = tp.jst.init_train_state(jc, jax.random.PRNGKey(0))
    if a.norms:
        js = tp._perturbed_norms(js)
    kw = dict(total_steps=5, warmup=2)
    unsharded, grads = {}, {}
    for name, mode, cast in (("fp32", contextlib.nullcontext(), lambda t: t),
                             ("fp64", Float64(), double)):
        with mode:
            step = tst.make_train_step(tc, accum=a.accum, **kw)
            ts = cast(tp._torch_state(js, tc))
            grads[name] = [g.numpy() for g in leaves(tp._first_grads(
                tc, ts, cast(batches[0]), a.accum))]
            for b in batches:
                ts, _ = step(ts, cast({k: torch.from_numpy(v)
                                       for k, v in b.items()}))
        unsharded[name] = [t.numpy() for t in leaves(ts)]
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        tp._write_state(d, js)
        np.savez(d / "batches.npz", **{
            f"{i}/{k}": v for i, b in enumerate(batches)
            for k, v in b.items()})
        (d / "info.json").write_text(json.dumps(dict(
            arch=a.arch, act_shard=a.act_shard, mesh=list(mesh), steps=2,
            accum=a.accum, float64=True, replace=over, **kw)))
        got, _ = tp.run_ranks("sharded_train", int(np.prod(mesh)), d,
                              timeout=600)
        got = dict(got)
    n = len(leaves(ts.params))
    group = ["params"] * n + ["step"] + ["master"] * n + ["m"] * n + \
        ["v"] * n
    worst = {}
    for i, g in enumerate(group):
        if g == "step":
            continue
        u32, u64 = unsharded["fp32"][i], unsharded["fp64"][i]
        scale = max(float(np.abs(u32).max()), 1e-30)
        gaps = {"mesh-unsharded fp32": got[f"a{i}"] - u32,
                "mesh-unsharded fp64": got[f"d{i}"] - u64,
                "unsharded fp32-fp64": u32 - u64,
                "mesh fp32-unsharded fp64": got[f"a{i}"] - u64}
        for k, x in gaps.items():
            w = worst.setdefault(g, {})
            w[k] = max(w.get(k, 0.0), float(np.abs(x).max()) / scale)
    for i, (g32, g64) in enumerate(zip(grads["fp32"], grads["fp64"])):
        scale = max(float(np.abs(g32).max()), 1e-30)
        w = worst.setdefault("grads", {})
        for k, x in {"mesh-unsharded fp32": got[f"g{i}"] - g32,
                     "mesh-unsharded fp64": got[f"h{i}"] - g64,
                     "unsharded fp32-fp64": g32 - g64,
                     "mesh fp32-unsharded fp64": got[f"g{i}"] - g64}.items():
            w[k] = max(w.get(k, 0.0), float(np.abs(x).max()) / scale)
    print(f"{a.arch} on {mesh}, act_shard {a.act_shard}, accum {a.accum}"
          f"{', masked' if a.masked else ''}{', norms' if a.norms else ''}"
          f", {a.seq} positions: largest gap, a share of the leaf's "
          f"largest value")
    for g, w in worst.items():
        print(f"  {g:6s} " + "  ".join(f"{k} {v:.3g}" for k, v in w.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
