"""Run the body of ``tests/test_torch_cuda.py``'s
``test_mesh_collectives_on_nccl_match_the_cpu`` over many seeds, on the
card, for one or more checkouts.

  python tools/psum_seeds.py N CHECKOUT [CHECKOUT ...]

For each CHECKOUT (a directory holding ``src``), in a process of its own
on a one-rank NCCL group: for seeds 0..N-1, the test's draws from a
``torch.Generator`` of that seed (the test's own is seed 0):
``compressed_psum`` at k = 1.0 on the card against its reconstruction on
the CPU (rtol 1e-6, atol 1e-7) and its residual (rtol 1e-6, atol four
float32 ulps of max |g|, the test's bound; "err_1e-7" the earlier atol
of 1e-7), and a one-stage ``pipeline_forward`` against ``mlp_stage``
(2e-5); one JSON line a checkout with the seeds that miss each check and
the first miss.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def one(n: int, root: str) -> dict:
    import datetime
    import tempfile
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.collectives import (_topk_int8_wire,
                                                  compressed_psum)
    from repro_torch.parallel.pipeline import mlp_stage, pipeline_forward
    tmp = tempfile.mkdtemp(prefix="psum_seeds_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    miss = {"psum": [], "err": [], "err_1e-7": [], "pipeline": []}
    first = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        for seed in range(n):
            gen = torch.Generator().manual_seed(seed)
            g = torch.randn(64, generator=gen)
            out, err = compressed_psum(mesh, pod_axis="model",
                                       k_fraction=1.0)(
                {"g": g.cuda()}, {"g": torch.zeros(64).cuda()})
            qv, idx, scale = _topk_int8_wire(g, 1.0)
            recon = torch.zeros(64)
            recon[idx] = qv.float() * scale
            ulps = 4 * torch.finfo(torch.float32).eps * g.abs().max().item()
            w = {"w1": torch.randn(1, 16, 16, generator=gen) * 0.3,
                 "w2": torch.randn(1, 16, 16, generator=gen) * .3}
            xs = torch.randn(6, 8, 16, generator=gen)
            got = pipeline_forward(mlp_stage, mesh, "data")(
                {k: t.cuda() for k, t in w.items()}, xs.cuda())
            for name, a, b, rtol, atol in (
                    ("psum", out["g"].cpu(), recon, 1e-6, 1e-7),
                    ("err", err["g"].cpu(), g - recon, 1e-6, ulps),
                    ("err_1e-7", err["g"].cpu(), g - recon, 1e-6, 1e-7),
                    ("pipeline", got.cpu(), mlp_stage(
                        {k: t[0] for k, t in w.items()}, xs), 2e-5, 2e-5)):
                try:
                    torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
                except AssertionError as e:
                    miss[name].append(seed)
                    first.setdefault(name, str(e)[:300])
    finally:
        dist.destroy_process_group()
    return {"checkout": os.path.abspath(root), "seeds": n, "miss": miss,
            "first": first}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        print("psum_seeds " + json.dumps(one(int(argv[1]), argv[2])))
        return 0
    rc = 0
    for root in argv[1:]:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", argv[0], root], capture_output=True,
                           text=True)
        lines = [x for x in p.stdout.splitlines()
                 if x.startswith("psum_seeds ")]
        print("\n".join(lines) or p.stdout[-2000:] + p.stderr[-2000:],
              flush=True)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
