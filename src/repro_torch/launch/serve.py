"""Serving launcher of the port: the continuous-batching engine over a
synthetic request trace; reports throughput, TTFT and decode-step time.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4_9b \
      --requests 8 --slots 4 --cache-len 1024 --prompt-len 128
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek_moe_16b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm_125m \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3_4b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llava_next_mistral_7b --smoke --device cpu

Runs on the GPU (``--device cuda``, the default) and raises when there is
none; ``--device cpu`` runs the plain PyTorch versions of the kernels.
Weights are random, drawn from ``--seed``; nothing is downloaded.  The
engine serves decoder-only models (a VLM with text prompts); an
encoder-decoder (whisper_medium) is refused, as in the JAX launcher, and
runs through ``api.prefill_fn`` / ``api.decode_fn``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.models import api
from repro_torch.models.common import init_params
from repro_torch.serving import Request, ServeConfig, ServingEngine


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCH_IDS, default="glm4_9b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--cache-len", type=int, default=128)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--max-new", type=int, default=24)
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
    if cfg.family == "encdec":
        raise SystemExit("serve drives decoder-only archs")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(api.param_spec(cfg), gen, device)
    engine = ServingEngine(cfg, params,
                           ServeConfig(n_slots=args.slots,
                                       cache_len=args.cache_len))
    rng = np.random.default_rng(args.seed)
    # The hybrid prefill takes a prompt over one SSD chunk only at a
    # multiple of the chunk (as JAX's ssd_chunked), and the xLSTM prefill
    # one over an mLSTM chunk (attn_chunk) likewise, so draw within a chunk.
    chunk = {"hybrid": cfg.ssm_chunk, "ssm": cfg.attn_chunk}.get(cfg.family)
    max_len = args.prompt_len if chunk is None else min(args.prompt_len,
                                                        chunk)
    t0 = time.time()
    for uid in range(args.requests):
        plen = int(rng.integers(4, max_len + 1))
        prompt = rng.integers(0, cfg.vocab, size=plen).astype(np.int32)
        engine.submit(Request(uid=uid, prompt=prompt,
                              max_new_tokens=args.max_new))
    finished = engine.run_until_drained()
    dt = time.time() - t0
    toks = sum(len(r.output) for r in finished)
    ttft = sorted(r.t_first - r.t_submit for r in finished)
    lat = sorted(r.t_done - r.t_submit for r in finished)
    step = sorted(engine.decode_s)
    print(f"served {len(finished)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, {engine.steps} decode ticks) on {device}")
    if finished:
        print(f"TTFT p50 {ttft[len(ttft)//2]*1e3:.0f}ms  "
              f"p95 {ttft[int(len(ttft)*0.95)-1]*1e3:.0f}ms   "
              f"latency p50 {lat[len(lat)//2]*1e3:.0f}ms  "
              f"p95 {lat[int(len(lat)*0.95)-1]*1e3:.0f}ms   "
              f"decode step p50 {step[len(step)//2]*1e3:.2f}ms")
    return 0 if len(finished) == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
