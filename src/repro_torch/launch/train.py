"""Training launcher of the port, after ``repro/launch/train.py``: the same
flags, loop, jsonl log, heartbeat file, async checkpoints and resume from
the newest step, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_125m \
      --steps 300 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt

Runs on the GPU (``--device cuda``, the default) and raises when there is
none; ``--device cpu`` runs the plain PyTorch versions of the kernels.
``--attn-impl`` picks the attention ("kernel": the flash-attention kernel
on the card).  Weights are random, drawn from ``--seed``; the data is
``data.synthetic_batch``.  The JAX launcher's mesh over several devices
waits for ``parallel/`` (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, CheckpointManager
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.parallel import steps as st


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCH_IDS, default="xlstm_125m")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced config (CPU-friendly)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--ckpt-dir", type=Path, default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log", type=Path, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--attn-impl", choices=("kernel", "chunked", "full"),
                   default="kernel")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    cfg = cfg.replace(dtype="float32", attn_impl=args.attn_impl)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = st.init_train_state(cfg, gen, device)
    step_fn = st.make_train_step(
        cfg, base_lr=args.lr, warmup=min(20, args.steps // 10 + 1),
        total_steps=args.steps, accum=args.accum)

    dc = DataConfig(seq_len=args.seq, global_batch=args.batch,
                    vocab=cfg.vocab, seed=args.seed)

    start = 0
    ckpt = None
    writer = None
    if args.ckpt_dir:
        args.ckpt_dir.mkdir(parents=True, exist_ok=True)
        ckpt = CheckpointManager(args.ckpt_dir, keep=3)
        latest = ckpt.latest()
        if latest is not None:
            _, state = ckpt.restore_latest(state)
            start = latest
            print(f"[resume] restored step {start} from {args.ckpt_dir}")
        writer = AsyncCheckpointer(ckpt)

    logf = open(args.log, "a") if args.log else None
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in synthetic_batch(dc, step).items()}
        if args.accum > 1:
            batch = {k: v.reshape((args.accum, v.shape[0] // args.accum)
                                  + v.shape[1:]) for k, v in batch.items()}
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if logf:
            logf.write(json.dumps({"step": step + 1, "loss": loss,
                                   "lr": float(metrics["lr"]),
                                   "t": time.time() - t0}) + "\n")
            logf.flush()
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step+1:5d}  loss {loss:.4f}  "
                  f"({(time.time()-t0)/(step-start+1):.3f}s/step)")
        if writer and (step + 1) % args.ckpt_every == 0:
            writer.submit(step + 1, state)
        if args.ckpt_dir:
            (args.ckpt_dir / "heartbeat").write_text(str(time.time()))
    if writer:
        writer.submit(args.steps, state)
        writer.wait()
        writer.close()
    if logf:
        logf.close()
    first, last = losses[0], float(np.mean(losses[-10:]))
    floor = float(np.log(cfg.vocab))     # random-stream entropy floor
    print(f"done: loss {first:.4f} -> {last:.4f} "
          f"(uniform-token floor ~{floor:.3f})")
    # success = finite and not diverging; synthetic random tokens sit AT
    # the entropy floor, so "improvement" is only meaningful vs blow-up
    ok = np.isfinite(last) and last < max(first * 1.05, floor * 1.1)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
