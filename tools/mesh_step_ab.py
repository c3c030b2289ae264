"""Time the one-rank mesh train step of ``chip_smoke.py``'s phase 21(a) for
one or more checkouts, on the card.

  python tools/mesh_step_ab.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a directory holding ``chip_smoke.py`` and ``src``.  For
each, in the order given and each in a process of its own (name two
checkouts in turns, older, newer, newer, older: two calls may land on two
cards), it builds that checkout's kernels, starts a one-rank NCCL group on
a file store under a temporary directory, runs that checkout's
``chip_smoke.mesh_step`` (the (1, 1) mesh step of full-width glm4_9b cut
to 2 layers, 1 x 128 tokens, fp32, against the unsharded step), and
times the step three times (``chip_smoke.median_event_ms``: CUDA events,
median of 5 after one warm-up).  One JSON line a checkout (``mesh_step``:
its ms, its leaves bit-equal to the unsharded step's, its collective
bytes and the device events its step adds), then the card's name and
power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def one(root: str) -> dict:
    """The record of ``root``'s phase 21(a) step, in this process."""
    import datetime
    import tempfile
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as c
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import steps as st
    _build.library()
    tmp = tempfile.mkdtemp(prefix="mesh_step_ab_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        cfg = c._mesh_cfg(False)
        out = c.mesh_step(cfg, 0, "cuda", mesh)
        step, lay, batch = out.pop("step"), out.pop("layouts"), \
            out.pop("batch")
        state = st.shard_state(st.init_train_state(cfg, torch.Generator(
            device="cuda").manual_seed(0), "cuda"), lay)
        ms = [c.median_event_ms(lambda: step(state, batch), iters=5,
                                warmup=1) for _ in range(3)]
    finally:
        dist.destroy_process_group()
    return {"checkout": root, "ms": ms, "equal_leaves": out["equal_leaves"],
            "leaves": out["leaves"], "worst": out["worst"],
            "collective_bytes": out["collective_bytes"],
            "events_added": out["events_added"]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        print("mesh_step " + json.dumps(one(argv[1])), flush=True)
        return 0
    rc = 0
    for root in argv:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root], capture_output=True, text=True)
        lines = [x for x in p.stdout.splitlines()
                 if x.startswith("mesh_step ")]
        print("\n".join(lines) or p.stdout[-2000:] + p.stderr[-2000:],
              flush=True)
        rc = rc or p.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return rc


if __name__ == "__main__":
    sys.exit(main())
