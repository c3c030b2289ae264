#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases; each raises (exit code 1) on failure, nothing is caught, and each
prints its seconds:

1. print the card (nvidia-smi name, power limit); build the CUDA kernels
   from ``src/repro_torch/kernels/csrc`` with nvcc (one process a source,
   all at once, then a link) and print the seconds;
   print ptxas's registers, shared memory and spills of the ten attention
   kernels, of the grouped matmul's tiled and streaming kernels, of the
   six flash-decode and of the eight SSD-scan instantiations, and count
   the tensor-core instructions (HGMMA, HMMA) of the attention, tiled
   grouped-matmul, flash-decode and SSD-scan kernels in the SASS
   (``cuobjdump -sass``): none in an attention, tiled, bf16 decode or scan
   kernel would mean a CUDA-core path (the fp32 decode kernels must have
   none); ptxas's lines of the twelve sLSTM instantiations and of the
   twenty RMSNorm ones (9 served widths x 2 types, and the general path),
   and the sLSTM kernel's cluster plan at xlstm_125m's heads; and hold
   ``flash_decode.plan``'s shared memory to the C launcher's at every
   served decode shape (``served_decode_shapes``), in both types;
2. hold each kernel against its plain PyTorch version on the card at the
   serving paths' shapes, in fp32 (atol = rtol = 2e-5; 2e-4 for the SSD
   scan, whose chunked and sequential sums differ in order) and bf16
   (3e-2), and time kernel, plain version and the one PyTorch library call
   that computes the same function (none for the SSD scan and the sLSTM;
   ``torch.bmm`` for the grouped matmul, which the port never calls),
   beside the card's bound; the attention rows run first, and each names
   the kernels SDPA ran (one ``torch.profiler`` pass a row); SDPA gets
   GQA's K and V expanded to every head beforehand, so it times one MHA
   call; the decode rows cover glm4_9b's, zamba2_7b's and
   deepseek_moe_16b's head layouts in both types, and a served fill
   (kv_len 544/160/68/9) in fp32, and each fails unless one
   ``ops.flash_decode`` call runs exactly one device kernel; the fp32
   attention kernel computes on tensor cores in 3xTF32, so its bound
   counts 3x the flops at the TF32 peak, as do the grouped matmul's fp32
   tiled path and the fp32 SSD scan; the scan at zamba2_7b's prefill
   lengths 17, 64, 256 and 512; the grouped matmul also with the row counts
   of a seeded top-6 routing (a 4-slot decode tick and a 512-token
   prefill), bounded by the active experts' bytes and rows; the sLSTM at
   xlstm_125m's prefill (S = 512, 300 and 17) and decode tick (4 slots, S
   = 1, from a state), its final state compared too; and this slice's
   shapes: flash attention at minicpm3_4b's MLA prefill (S 512, 40 heads,
   D 96, Dv 64) and whisper_medium's encoder (S = T = 1500, non-causal,
   16 heads of 64), flash decode at minicpm3_4b's latent decode (40 heads
   on one KV head, key 288, value 256 a view of the key's rows, T 1024,
   in both types and at a served fill) and whisper's cross (T 1500) and
   self (T 448) decodes; flash attention (S 512, causal) and flash decode
   (T 1024) at D 128 with the (query, KV) heads one device computes in a
   tensor-parallel mesh step (``TP_HEADS``: 2/1, 8/1, 6/1 and 2/2), in
   both types; deepseek_v2_236b's shapes: flash attention at its MLA
   prefill (S 512, 128 heads, D 192, Dv 128) and flash decode at its
   latent decode (128 heads on one KV head, key 576, value 512 a view of
   the key's rows, T 1024 full, in both types, and at a served fill in
   fp32), and the grouped matmul at its 160 experts (5120 -> 1536 and
   1536 -> 5120, the routed counts of a 4-slot tick and of a 512-token
   prefill); the flash attention (S 512, D 192 / Dv 128; D 96 / Dv 64)
   and the latent flash decode (576 / 512; 288 / 256) at the 64 heads of
   a rank of 21(g)'s deepseek_v2_236b and the 20 of its minicpm3_4b, and the
   grouped matmul on its block of deepseek_v2_236b's experts (80-159 of
   160, the 1 x 128 prefill's and a one-slot tick's counts); the grouped
   matmul on one rank's block of 21(f)'s expert
   parallelism (experts 32-63 of 64, given that block's slice of the
   counts: a one-slot tick and the 1 x 128 prefill); RMSNorm first fails unless one call runs exactly
   one device kernel, the port's, then runs the decode tick's 4 rows at
   every served width (256 to 12288) and a 512-token prefill at 4096 and
   7168, in both types, and glm4_9b's decode chain in fp32 (the residual
   added in place, the norm, the 4096 x 4608 projection), the library row
   with ``F.rms_norm`` in the norm's place;
3. full-width glm4_9b cut to 2 layers, same weights on the card
   (kernels) and on the CPU (plain versions): a 128-token prefill and 8
   greedy decode steps must give logits within 1e-3 of max |logit| and
   the same tokens;
4. serve full glm4_9b (40 layers, fp32, random weights from a seed) with
   the continuous-batching engine: 4 slots, cache 1024, 8 requests of 32
   new tokens; every request must finish and every kernel must have run,
   with the launch counts the model's structure implies (served once, to
   keep the run within its time limit; ``phase_serve``'s ``repeats``
   serves them again, each on a fresh engine); then 16 decode ticks of a full
   pool on the host clock and 8 more under torch.profiler say how busy
   the card is and which kernels take its time, and the norm's device ms
   a tick (likewise in every later serving phase); last, one 512-token
   prefill alone, timed on the host clock and profiled for the flash
   attention kernel's share of the device time;
5. full-width zamba2_7b cut to 13 layers (two groups of 6 Mamba2 layers,
   so both shared attention weight sets, and one rest layer), card
   against CPU as in phase 3: the 128-token prefill is two SSD chunks, so
   the state carries across a chunk boundary;
6. serve full zamba2_7b (81 Mamba2 layers and 13 shared attention blocks,
   fp32, random weights from a seed) as in phase 4, glm4_9b's weights
   freed first; prompts are within one SSD chunk of 64 or a multiple of
   it (256, 512), as the reference's prefill takes them; last, one
   512-token prefill alone, as in phase 4, profiled for the SSD scan's
   and flash attention's shares of the device time;
7. full-width deepseek_moe_16b cut to 3 layers (its dense first layer and
   2 MoE layers), card against CPU as in phase 3, printing how many
   (token, layer) top-6 routes differ between the two;
8. serve full deepseek_moe_16b (28 layers, 64 routed experts of which 6
   a token and 2 shared, fp32, 64.66 GB of random weights from a seed) as
   in phase 4, zamba2's weights freed first; every routed-expert product
   goes through the grouped-matmul kernel, 81 launches a prefill and a
   tick; the profile prints ``moe_gmm``'s ms a tick and, over 8 more
   ticks, the mean number of experts that hold rows a launch; then one
   decode step's MoE FFN runs under
   ``torch.cuda.set_sync_debug_mode("error")``, so a host sync inside the
   dispatch fails the run;
9. the whole 12-layer xlstm_125m, card against CPU as in phase 3, with a
   300-token prefill (no multiple of the TPU sLSTM kernel's 256 steps);
10. serve full xlstm_125m (9 mLSTM and 3 sLSTM blocks, fp32, random
   weights from a seed) as in phase 4, deepseek_moe_16b's weights freed
   first, with prompts of 300 and 512 among the eight; every sLSTM layer
   of a prefill and of a tick is one ``slstm_seq`` launch; last, one
   512-token prefill alone, as in phase 4, profiled for the sLSTM kernel's
   share of the device time;
11. the paper's cost model (``repro_torch.core``, no CUDA source of its
   own): benchmarks/engine_bench.py's 10,000 heterogeneous specs packed
   with ``share_nre`` False and True (host seconds printed), priced by
   ``CostEngine.total`` on the card and on the CPU, the ten fields held
   together at 1e-5 relative and 64 seeded systems held against the scalar
   ``re_cost`` / ``amortized_costs``; one ``total`` under
   ``torch.cuda.set_sync_debug_mode("error")``; a 10^6-system batch (the
   standalone batch tiled 100 times through ``from_arrays``, every tile its
   own product group) whose every tile must equal the 10^4 result, with the
   card's ms per ``total`` (median of 20, CUDA events), the CPU's, systems/s
   and peak device memory; then ``best_partition``, ``sweep_partitions``
   over Fig. 4's grid, ``optimize_chiplet_count`` and
   ``price_accelerators`` on the card against the CPU; ``total`` called
   20 times on each 10^4 batch must give bit-equal fields every time, and
   at 10^6 systems the NRE's deterministic segment sums are timed against
   the float32 ``index_add`` atomics they replaced, in turns;
12. the paper's design-space exploration (``repro_torch.dse``) on
   benchmarks/dse_bench.py's space (19,707 candidates, 59,121 systems),
   each step on the card held against the port on the CPU: every
   candidate in chunks of 512 at 1e-5, the same exhaustive winner, a
   second sweep bit-equal and one sweep dispatched under
   ``torch.cuda.set_sync_debug_mode("error")``; Monte Carlo at 256 draws
   over 2,048 candidates; the legacy evaluator over 512 candidates,
   bit-equal across runs and at 1e-6 of the fused prices; the
   evolutionary search at population 256 for 8 generations, nominal and
   at the q90 objective, with the CPU's winner and history; the uneven
   split; candidates/s and generations/s on the host clock, and each DSE
   graph's card ms (CUDA events) beside its byte floor.  The DSE runs
   none of the six kernels, and the phase fails if one launches;
13. the pricing service (``repro_torch.service``) on dse_bench's space:
   benchmarks/service_bench.py's full diet (8 clients, each 4 sweeps of
   2,048 rows and 4 point queries, plus a search at population 32 for 8
   generations, a Monte Carlo sweep at 64 draws, a what-if grid, a rank
   over 128 candidates and a raw ``spec()`` group; chunk 128, split 32)
   served on the card and on the CPU: every response ok, card against CPU
   at 1e-5 with the same search winner and history, the card's responses
   bit-equal to the port's ``ChunkedEvaluator`` / ``portfolio_search`` on
   the card at chunk 128, one copy a tick and no first call of a lane
   signature in a tick; a 5-client run with every tick under
   ``torch.cuda.set_sync_debug_mode("error")`` (the copy excepted); the
   aggregate candidates/s at >= 0.5x the single-client fused rate at
   chunk 128 (service_bench's bound), p50/p95/p99 latency, ticks by lane,
   padded-slot waste, and the card's busy share of 16 chunk ticks
   (``torch.profiler``); then a seeded chaos schedule (typed envelopes,
   ok rows bit-equal to the fused or legacy oracle) and a crash replayed
   from its journal (answers equal to an uncrashed run's), on the card.
   No kernel of the six launches;
14. training through the port's trainer (``parallel.steps``, the plain
   route of the models with attention through the flash-attention kernel,
   remat "full"), every earlier model's tensors freed: (a) full-width
   glm4_9b cut to 2 layers, the same parameters and 1 x 128 batch on the
   card and on the CPU: loss within 1e-4 relative, each gradient leaf
   within 1e-3 of its max |g|, one AdamW update from the same gradient
   tree within 1e-6 of each leaf's max, and 4 flash-attention launches
   (forward and recompute) and no other; (b) full-width glm4_9b at 8 of
   its 40 layers (2.2524 B parameters, 45 GB of fp32 state and gradient)
   for 6 steps of 4 x 512 tokens at the launcher's lr, warmup and
   schedule: every loss finite, exactly 16 flash-attention launches a step
   and none of the other five kernels, the median step (host clock),
   tokens/s, one more step under torch.profiler for the busy share, the
   top device kernels and flash attention's share, peak memory, and the
   model FLOPs over the step against the fp32 peak; (c)
   ``launch.train.main`` for xlstm_125m (full width and depth) to step 8
   with checkpoints at 4 and 8, then to step 12, resuming from 8, and
   tests/test_substrate.py's resume property on the card (6 steps straight
   against 3 + save + restore + 3 at 1e-6);
15. full-width minicpm3_4b (MLA: q_lora 768, kv_lora 256, qk 64 + 32, v
   64, 40 heads) cut to 2 layers, card against CPU as in phase 3; its
   prefill attention runs the flash-attention kernel at D 96 / Dv 64 and
   its decode the latent flash decode at D 288 / Dv 256;
16. serve all 62 layers of minicpm3_4b (fp32, 16.3 GB of random weights
   from a seed) as in phase 4, every earlier model's tensors freed: each
   layer runs a flash attention a prefill and a latent flash decode a
   tick, and four norms (q_norm and kv_norm too), as the counts assert;
   the tick p50 and the busy share as in phase 4;
17. full-width llava_next_mistral_7b cut to 2 layers, card against CPU as
   in phase 3, with 256 image-patch embeddings (drawn from the seed)
   before a 256-token prompt (input_spec at seq 512);
18. serve all 32 layers of llava_next_mistral_7b (fp32, 28.4 GB of random
   weights), minicpm3_4b's freed first: one ``api.prefill_fn`` request
   with all 2880 anyres patches and a 192-token prompt (S = 3072, cache
   3328) and 32 greedy ``api.decode_fn`` steps, with their launch counts;
   then the engine serves 8 text requests as in phase 4;
19. full-width whisper_medium cut to 2 encoder and 2 decoder layers, card
   against CPU: 1500 frames (30 s of audio, from the seed) through
   ``api.prefill_fn`` (the encoder, cross K/V, a BOS step) and 8 greedy
   decode steps, logits within 1e-3 of max |logit| and the same tokens;
20. whisper_medium at full size (24 + 24 layers, 0.96 B parameters),
   llava's weights freed first: B = 4 x 1500 frames through
   ``api.prefill_fn`` and 64 greedy decode steps (a self flash decode over
   the 448-row cache and a cross flash decode over 1500 frames a layer and
   step), with launch counts, step p50 and the busy share of a step; then
   training: a 2 + 2-layer cut (1 x 1500 frames, 448 decoder tokens) card
   against CPU at phase 14(a)'s tolerances, and 2 AdamW steps of the full
   model through ``parallel.steps`` on one batch of 2 x 1500 frames, the
   loss finite and falling, 144 flash-attention launches a step and no
   other kernel;
21. the mesh layer, every earlier model's tensors freed, on a one-rank
   (1, 1) ("data", "model") mesh over NCCL started on a file store under a
   temporary directory: (a) full-width glm4_9b cut to 2 layers, 1 x 128
   tokens, fp32: one step of ``make_train_step(mesh=...)`` (AdamW on the
   blocks, which on one device are the leaves) against
   phase 14(a)'s unsharded step from the same state and batch: the loss
   and every updated leaf within 1e-6 of the leaf's max (bit-equal but
   for the clipping norm, which sums the leaves' blocks in another
   order), 4 flash-attention launches and no other kernel, and the device
   events the collectives add (a profiled step of each); (b) ``flash_decode_shardmap``, ``compressed_psum`` at
   k = 1.0 and a one-stage ``pipeline_forward`` on the card against their
   plain results on the CPU; (c) the dry run's trace of that cut cell on
   fake tensors: its FLOPs and collective bytes must equal the op
   counter's for the step (a) ran on the card, and the step's time (CUDA
   events, median of 5) is printed beside the H100 roofline's t_bound;
   (d) the first tensor- and sequence-parallel step on the card: two
   processes on the one card, a (1, 2) ("data", "model") mesh over gloo
   with CUDA tensors (NCCL refuses two ranks on one device), the same
   cut glm4_9b, each rank holding half the query heads, the MLP and the
   vocab, and 64 of the 128 rows of the residual stream: the mesh
   prefill and one train step against the unsharded ones on the card
   (loss within 1e-6, parameters within 1e-6 of a leaf's max, logits
   within 1e-4), each rank's launches (the step's 4 flash attentions;
   the prefill's 2 flash attentions and 5 RMSNorms) and its op counts
   equal to the dry run's trace on an abstract (1, 2) mesh; three more
   steps timed on the host clock (a gloo step, its collectives staged
   through the host: not a speed of the design); (e) FSDP on a (2, 1)
   mesh over two such processes, 4 x 128 tokens at accum 2, each layer
   gathered in its turn, against the unsharded step, with each rank's
   peak memory; (f) expert parallelism on the (1, 2) mesh of (d):
   full-width deepseek_moe_16b cut to its dense first layer and one MoE
   layer of 64 experts (top-6, 2048 -> 1408, vocab 102,400, fp32), 32
   experts a rank: the 1 x 128 mesh prefill, 4 greedy serve ticks and
   one train step against the unsharded ones on the card (logits within
   1e-5 of max |logit|, the same tokens, loss and parameters within 1e-6
   of a leaf's max), each rank's ``moe_gmm`` calls on 32 experts, its
   launches, and its op counts of the three equal to the dry run's, each
   rank's peak memory beside the unsharded run's; then one tick of that
   step on an abstract (1, 2) mesh (collectives of shapes only) under
   sync debug mode "error"; (g) tensor parallelism of MLA on the (1, 2)
   mesh over two such processes: full-width deepseek_v2_236b cut to its
   dense first layer and one MoE layer (4.834 B parameters, 64 of 128
   heads and 80 of 160 experts a rank, drawn a leaf at a time so that no
   process holds the whole model) served, 1 x 128 tokens and 4 greedy
   ticks, and cut to its dense first layer (0.862 B) trained one step;
   full-width minicpm3_4b cut to 2 layers (20 of 40 heads a rank) served
   and trained alike: against the unsharded runs on the card (logits
   within 1e-5 of max |logit|, the same tokens; a step at the base lr,
   no warmup, that moves every leaf: its loss within 1e-6, each leaf of
   its first moments within 4 times the unsharded step's own gap to
   float64 or 1e-6 of the leaf's max, and in float64 with plain
   attention its loss, first moments and parameters within 1e-12), each
   rank's flash attentions (64 heads,
   D 192 / Dv 128; 20 heads, 96 / 64) and latent flash decodes (64 heads
   on 576 / 512; 20 on 288 / 256) on its heads and its grouped matmuls
   on 80 experts, its launches and its op counts equal to the dry run's,
   each rank's peak memory beside the unsharded run's.  Axes of one
   device issue no collective, so (a)'s step runs none and (d)-(g) none
   over "data";
22. full-width deepseek_v2_236b (MLA: q_lora 1536, kv_lora 512, qk 128 +
   64, v 128, 128 heads; 160 routed top-6 experts of 1536 and 2 shared)
   cut to 2 layers, the dense first one and one MoE layer (4.834 B
   parameters, 19.34 GB in fp32), card against CPU as in phase 3, printing
   how many top-6 routes differ; its prefill attention runs the flash
   attention kernel at D 192 / Dv 128 and its decode the latent flash
   decode at key 576 / value 512, each row read once;
23. serve deepseek_v2_236b at full width cut to 4 layers, 1 dense and 3
   MoE (12.779 B parameters, 51.11 GB in fp32), as in phase 4, every
   earlier model's tensors freed: each layer runs a flash attention a
   prefill and a latent flash decode a tick, each MoE layer 3 grouped
   matmuls a prefill and a tick, and four norms a layer and the final
   one, as the counts assert; the tick p50, busy ms, kernels a tick, the
   tick's floor and peak memory.

Then a ``{"kernels": [...]}`` line and, last, the device line.  Exits
nonzero without a CUDA device or without the repository around it.
"""
from __future__ import annotations

import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TF32_FLOPS = 495e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# (query, KV) heads of a device in a tensor-parallel mesh step
# (parallel/tensor.py): glm4_9b and llava_next_mistral_7b on a model axis
# of 16, glm4_9b on 4, mistral_large_123b on 16, deepseek_7b on 16
TP_HEADS = ((2, 1), (8, 1), (6, 1), (2, 2))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def host_ms(fn, iters: int = 20) -> float:
    """Mean wall time of one call issued back to back, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def bound(nbytes: float, flops: float, dtype, peak=None) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (PEAK_FLOPS[dtype] if peak is None else peak) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_events(fn) -> list:
    """Names of the device events (kernels, copies, sets) of one (warm)
    call of ``fn``, one entry an event, from a torch.profiler pass."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_kernels(fn) -> list:
    """Names of the device kernels one (warm) call of ``fn`` runs."""
    return sorted(set(device_events(fn)))


def kernel_report() -> None:
    """Phase 1: ptxas's report and the SASS tensor-core instruction counts
    of the attention kernels (one instantiation per storage type and
    padded Dv), of the grouped matmul's tiled path (one per storage type)
    and of the SSD scan (storage type x N tile x P tile); fails if one has
    no HGMMA (bf16 attention and tiled matmul) or HMMA (the rest).
    ptxas's lines of the grouped matmul's streaming instantiations and of
    the decode kernels are printed too."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import slstm_cell as sl

    def ours(name):
        return "flash_attn" in name or "gmm_tiled" in name \
            or "gmm_stream" in name or "flash_decode" in name \
            or "mamba_scan" in name or "slstm_seq" in name \
            or "rmsnorm" in name
    ptxas, fn = {}, None
    for line in _build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1) if ours(m.group(1)) else None
        elif fn and ("spill" in line or "Used" in line):
            ptxas.setdefault(fn, []).append(line.split(":")[-1].strip())
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if ours(m.group(1)) else None
            if fn:
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn:
            for op in ("HGMMA", "HMMA"):
                counts[fn][op] += bool(re.search(rf"\b{op}\.", line))
    attention = sorted(f for f in counts if "flash_attn" in f)
    tiled = sorted(f for f in counts if "gmm_tiled" in f)
    # bf16: D padded to 64, 128 or 192; fp32: 128 or 192 (its stages); each
    # with Dv padded to 64 or 128
    check(len(attention) == 10, f"expected 10 attention kernels in the "
                                f"SASS, found {attention}")
    check(len(tiled) == 2, f"expected 2 tiled moe_gmm kernels in the SASS, "
                           f"found {tiled}")

    def dtype(fn):
        return "bf16" if "bfloat16" in fn else "f32"
    labels = {}
    for fn in attention:
        dp, dvp = re.findall(r"Li(\d+)E", fn)
        labels[fn] = f"flash_attn_kernel<{dtype(fn)}, D {dp}, Dv {dvp}>"
    for fn in tiled:
        labels[fn] = f"gmm_tiled<{dtype(fn)}>"
    for fn in attention + tiled:
        c, bf16 = counts[fn], "bfloat16" in fn
        print(f"  {labels[fn]}: {c['HGMMA']} HGMMA, {c['HMMA']} HMMA in the "
              f"SASS; ptxas: {'; '.join(ptxas.get(fn, ['no report']))}")
        check(c["HGMMA"] > 0 if bf16 else c["HMMA"] > 0,
              f"{labels[fn]} has no tensor-core instruction")
    for fn in sorted(f for f in ptxas if "gmm_stream" in f):
        cs, unroll = re.findall(r"Li(\d+)E", fn)
        print(f"  gmm_stream<{dtype(fn)}, rows {cs}, loads {unroll}>: "
              f"ptxas: {'; '.join(ptxas[fn])}")
    decode = sorted(f for f in ptxas if "flash_decode" in f)
    check(len(decode) == 6, f"expected 6 flash_decode kernels (3 plans x 2 "
                            f"types), found {decode}")
    for fn in decode:
        nc, heads, stages = re.findall(r"Li(\d+)E", fn)
        hmma = counts.get(fn, {}).get("HMMA", 0)
        print(f"  flash_decode_kernel<{dtype(fn)}, Dv chunks {nc}, heads "
              f"{heads}, stages {stages}>: {hmma} HMMA in the SASS; ptxas: "
              f"{'; '.join(ptxas[fn])}")
        # bf16 groups of 8-16 heads run mma.sync; fp32 stays on CUDA cores
        check(hmma > 0 if "bfloat16" in fn else hmma == 0,
              f"flash_decode_kernel<{dtype(fn)}>: {hmma} HMMA")
    scans = sorted(f for f in counts if "mamba_scan" in f)
    check(len(scans) == 8, f"expected 8 mamba_scan kernels, found {scans}")
    for fn in scans:
        nt, pw = re.findall(r"Li(\d+)E", fn)
        hmma = counts[fn]["HMMA"]
        print(f"  mamba_scan_kernel<{dtype(fn)}, N tile {nt}, P tile {pw}>: "
              f"{hmma} HMMA in the SASS; ptxas: "
              f"{'; '.join(ptxas.get(fn, ['no report']))}")
        check(hmma > 0, f"mamba_scan_kernel<{dtype(fn)}, {nt}, {pw}> has no "
                        f"tensor-core instruction")
    slstm = sorted(f for f in ptxas if "slstm_seq" in f)
    check(len(slstm) == 12, f"expected 12 slstm_seq kernels, found {slstm}")
    for fn in slstm:
        j4, nb = re.findall(r"Li(\d+)E", fn)
        print(f"  slstm_seq_kernel<{dtype(fn)}, h span {32 * int(j4)}, row "
              f"slots {nb}>: ptxas: {'; '.join(ptxas[fn])}")
    norms = sorted(f for f in ptxas
                   if "rmsnorm_vec" in f or "rmsnorm_any" in f)
    check(len(norms) == 20, f"expected 20 rmsnorm kernels (9 widths x 2 "
                            f"types and the general path), found {norms}")
    split = sorted(f for f in ptxas if "row_sumsq" in f or "row_scaled" in f)
    check(len(split) == 4, f"expected 4 split-norm kernels (the sums of "
                           f"squares and the scaled rows x 2 types), found "
                           f"{split}")
    for fn in norms + split:
        shape = re.findall(r"Li(\d+)E", fn)
        what = (f"{shape[0]} threads a row, {shape[1]} vectors a thread"
                if "rmsnorm_vec" in fn else "general path"
                if "rmsnorm_any" in fn else "split norm, sums of squares"
                if "row_sumsq" in fn else "split norm, scaled rows")
        print(f"  rmsnorm<{dtype(fn)}, {what}>: ptxas: "
              f"{'; '.join(ptxas[fn])}")
    for b in (1, 4):
        plan = sl.cluster_plan(b, 4, 192, torch.float32)
        print(f"  slstm_seq at xlstm_125m's heads, B = {b}: clusters of "
              f"{plan.cluster} blocks of {max(plan.cols)} columns, grid "
              f"{plan.grid}, {plan.threads} threads and {plan.smem} bytes of "
              f"shared memory a block")
    for dtype in (torch.float32, torch.bfloat16):
        print(f"  dynamic shared memory at D = Dv = 128, {dtype}: "
              f"attention {fa.smem_bytes(dtype, 128, 128)} bytes, at D 192 "
              f"/ Dv 128 {fa.smem_bytes(dtype, 192, 128)}; decode, "
              f"a block of glm4_9b (G = 16) "
              f"{fd.smem_bytes(dtype, 128, 128, 16)}, of G = 1 "
              f"{fd.smem_bytes(dtype, 128, 128, 1)}, of minicpm3_4b's "
              f"latent decode (D 288, Dv 256, G = 40) "
              f"{fd.smem_bytes(dtype, 288, 256, 40, True)} (K and V staged "
              f"apart {fd.smem_bytes(dtype, 288, 256, 40)}), of "
              f"deepseek_v2_236b's (D 576, Dv 512, G = 128) "
              f"{fd.smem_bytes(dtype, 576, 512, 128, True)}; SSD scan at "
              f"N = 64, P tile 64 {ms.smem_bytes(dtype, 64, 64)}, P tile 32 "
              f"{ms.smem_bytes(dtype, 64, 32)}")
    # the Python plan (which the wrapper and the dry run check) against the
    # C launcher's layout, at every served decode shape
    shapes = served_decode_shapes()
    for dtype in (torch.float32, torch.bfloat16):
        for d, dv, group, shared in shapes:
            want = fd.smem_bytes(dtype, d, dv, group, shared)
            got = fd.plan(dtype, d, dv, group, shared).smem
            check(got == want, f"flash_decode.plan {dtype} D={d} Dv={dv} "
                               f"G={group} shared={shared}: {got} bytes, "
                               f"the launcher's {want}")
    print(f"  flash_decode.plan equals the launcher's shared memory at "
          f"{len(shapes)} served decode shapes x 2 types: {shapes}")


def served_decode_shapes() -> list:
    """(D, Dv, group, value read from the key rows) of every decode the
    served models and the tensor-parallel heads run."""
    from repro_torch.configs import ARCH_IDS, get_config
    out = set()
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if cfg.attn == "mla":
            out.add((cfg.kv_lora + cfg.qk_rope, cfg.kv_lora, cfg.n_heads,
                     True))
        elif cfg.family != "ssm":
            out.add((cfg.dh, cfg.dh, cfg.n_heads // cfg.n_kv_heads, False))
    out.update((128, 128, h // hkv, False) for h, hkv in TP_HEADS)
    # MLA's latent decode on a rank of 21(g): half the heads on the one
    # latent head
    out.update((cfg.kv_lora + cfg.qk_rope, cfg.kv_lora, cfg.n_heads // 2,
                True) for cfg in map(get_config, ARCH_IDS)
               if cfg.attn == "mla")
    return sorted(out)


def compare(name, got, want, dtype, tol=None) -> float:
    torch.cuda.synchronize()
    tol = TOL[dtype] if tol is None else tol
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    check(ok, f"{name}: kernel disagrees with its plain version, max abs "
              f"err {err} at tolerance {tol}")
    return err


def phase_kernels(gen):
    """Phase 2: every kernel against its plain version, timed.  Rows are
    keyed (kernel, dtype, shape label)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.timing import device_ms

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def timed(kern, plain, lib, err, nbytes, flops, dtype, peak=None,
              sdpa=False, note=""):
        """``sdpa``: the library call is SDPA, whose kernels get named;
        ``note`` goes into the printed row (the bound's accounting)."""
        return dict(err=err, ms=device_ms(kern), host_ms=host_ms(kern),
                    plain_ms=device_ms(plain),
                    library_ms=None if lib is None else device_ms(lib),
                    library_kernels=device_kernels(lib) if sdpa else None,
                    bound=bound(nbytes, flops, dtype, peak), note=note)

    def attention(s, h, hkv, d, dtype, tag, t=None, dv=None, causal=True):
        """One prompt of ``s`` queries against ``t`` keys (``s`` unless
        given), head widths ``d`` and ``dv`` (``d`` unless given), causal
        (square) or not; the scale is D^-0.5."""
        t, dv = t or s, dv or d
        q = rnd(1, s, h, d, dtype=dtype)
        k, v = rnd(1, t, hkv, d, dtype=dtype), rnd(1, t, hkv, dv, dtype=dtype)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        # SDPA on K and V expanded to every head before the timed call: one
        # MHA call, not its GQA path (the math kernel in fp32)
        ke = kt.repeat_interleave(h // hkv, dim=1)
        ve = vt.repeat_interleave(h // hkv, dim=1)
        kern = lambda: ops.flash_attention(q, k, v, causal=causal)
        plain = lambda: ref.attention_ref(qt, kt, vt, causal=causal)
        lib = lambda: F.scaled_dot_product_attention(qt, ke, ve,
                                                     is_causal=causal)
        err = compare(f"flash_attention S={s} T={t} D={d} Dv={dv} {tag}",
                      kern(), plain().transpose(1, 2), dtype)
        pairs = h * s * (s + 1) // 2 if causal else h * s * t
        nbytes = (q.numel() + h * s * dv + k.numel() + v.numel()) \
            * q.element_size()
        flops = 2 * (d + dv) * pairs
        if dtype == torch.float32:      # 3xTF32 on tensor cores
            return timed(kern, plain, lib, err, nbytes, 3 * flops, dtype,
                         TF32_FLOPS, sdpa=True)
        return timed(kern, plain, lib, err, nbytes, flops, dtype, sdpa=True)

    def decode(h, hkv, d, dtype, tag, lens=(1024, 700, 129, 1), t=1024,
               latent=None):
        """4 slots of a ``t``-row cache, ragged fill; one call must run one
        device kernel (the split keys merge in the same launch).
        ``latent``: (kv_lora, scale) of MLA's decode, one KV head whose key
        is a (B, T, d) row buffer and whose value the view of its first
        kv_lora columns, at the model's scale (minicpm3_4b: 256 of 256 +
        32, 96^-0.5; deepseek_v2_236b: 512 of 512 + 64, 192^-0.5); the rows
        are read once, since the value is a prefix of the key."""
        from repro_torch.kernels import flash_decode as fd
        b = 4
        q = rnd(b, 1, h, d, dtype=dtype)
        if latent:
            k = rnd(b, t, hkv, d, dtype=dtype)
            (dv, scale), v = latent, k[..., :latent[0]]
        else:
            k, v = rnd(b, t, hkv, d, dtype=dtype), rnd(b, t, hkv, d,
                                                       dtype=dtype)
            dv, scale = d, None
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(t, device="cuda")[None, :]
                < kv_len[:, None])[:, None, None, :]
        kern = lambda: ops.flash_decode(q, k, v, kv_len, scale=scale)
        plain = lambda: ref.decode_ref(q[:, 0], kt, vt, kv_len, scale=scale)
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True, scale=scale)
        err = compare(f"flash_decode T={t} D={d} Dv={dv} {tag}",
                      kern()[:, 0], plain(), dtype)
        # a profiler pass now and then records no device event at all (as
        # after the plain SSD loops, above); a pass that records none says
        # nothing, so take up to three
        events = []
        for _ in range(3):
            events = events or device_events(kern)
        check(len(events) == 1 and "flash_decode" in events[0],
              f"one flash_decode call ran {len(events)} device events: "
              f"{events}")
        n_kv = int(kv_len.sum())
        rows = d if latent else d + dv
        nbytes = (q.numel() + b * h * dv + hkv * rows * n_kv) \
            * q.element_size() + 4 * b
        pl = fd.plan(dtype, d, dv, h // hkv, bool(latent))
        split = fd.split_count(t, fd.groups_of(b, h, hkv, d, dv),
                               torch.cuda.get_device_properties(0)
                               .multi_processor_count)
        return timed(kern, plain, lib, err, nbytes, 2 * (d + dv) * h * n_kv,
                     dtype, sdpa=True, note=f"{split} splits, {pl.heads} "
                                            f"heads a block, {pl.smem} B of "
                                            f"shared memory, 1 device kernel")

    def rmsnorm(n, dm, dtype, tag):
        x, s_ = rnd(n, dm, dtype=dtype), rnd(dm, dtype=torch.float32)
        kern = lambda: ops.fused_rmsnorm(x, s_, eps=1e-5)
        plain = lambda: ref.rmsnorm_ref(x, s_, 1e-5)
        lib = lambda: F.rms_norm(x, (dm,), s_.to(dtype), eps=1e-5)
        err = compare(f"rmsnorm N={n} D={dm} {tag}", kern(), plain(), dtype)
        nbytes = 2 * x.numel() * x.element_size() + 4 * dm
        return timed(kern, plain, lib, err, nbytes, 4 * n * dm, dtype)

    def norm_sumsq(n, w, dtype, tag):
        """The split norm's first entry: each row's fp32 sum of squares.
        One PyTorch call computes it in fp32 only (``torch.linalg.vecdot``
        of the rows with themselves; on bf16 it sums in bf16)."""
        x = rnd(n, w, dtype=dtype)
        kern = lambda: ops.rmsnorm_sumsq(x)
        plain = lambda: ref.rmsnorm_sumsq_ref(x)
        lib = (lambda: torch.linalg.vecdot(x, x)) \
            if dtype == torch.float32 else None
        err = compare(f"rmsnorm_sumsq N={n} W={w} {tag}", kern() / w,
                      plain() / w, torch.float32)
        return timed(kern, plain, lib, err, x.numel() * x.element_size()
                     + 4 * n, 2 * n * w, dtype, note="fp32 sums; the error "
                                                     "of the sums / W")

    def norm_scaled(n, w, dtype, tag):
        """The split norm's second entry: the rows normalised by a total
        over 16 blocks of ``w`` channels (zamba2_7b's gated norm on a
        device of 16).  No single PyTorch call takes the total given."""
        x, s_ = rnd(n, w, dtype=dtype), rnd(w, dtype=torch.float32)
        total = ref.rmsnorm_sumsq_ref(rnd(n, 16 * w, dtype=dtype))
        kern = lambda: ops.rmsnorm_scaled(x, total, s_, 16 * w, eps=1e-5)
        plain = lambda: ref.rmsnorm_scaled_ref(x, total, s_, 16 * w, 1e-5)
        err = compare(f"rmsnorm_scaled N={n} W={w} {tag}", kern(), plain(),
                      dtype)
        nbytes = 2 * x.numel() * x.element_size() + 4 * (n + w)
        return timed(kern, plain, None, err, nbytes, 3 * n * w, dtype)

    def norm_chain(dtype, tag):
        """glm4_9b's decode at 4 rows: the residual added in place, the
        norm reading it right after, the q/k/v projection (4096 x 4608);
        plain and library rows swap the norm for ``ref.rmsnorm_ref`` and
        ``F.rms_norm``.  The bound counts the three steps' bytes (each
        read once, the weight's 75.5 MB in fp32 above all) and FLOPs."""
        n, dm, k = 4, 4096, 4608
        h, r = rnd(n, dm, dtype=dtype), rnd(n, dm, dtype=dtype) * 1e-3
        s_ = rnd(dm, dtype=torch.float32)
        w = (rnd(dm, k, dtype=torch.float32) * dm ** -0.5).to(dtype)

        def step(norm):
            h.add_(r)
            return norm(h) @ w
        kern = lambda: step(lambda v: ops.fused_rmsnorm(v, s_, eps=1e-5))
        plain = lambda: step(lambda v: ref.rmsnorm_ref(v, s_, 1e-5))
        lib = lambda: step(lambda v: F.rms_norm(v, (dm,), s_.to(dtype),
                                                eps=1e-5))
        got = kern()
        err = compare(f"rmsnorm chain N={n} D={dm} {tag}", got,
                      ref.rmsnorm_ref(h, s_, 1e-5) @ w, dtype)
        el = h.element_size()
        nbytes = el * (5 * n * dm + dm * k + n * k) + 4 * dm
        flops = 5 * n * dm + 2 * n * dm * k
        return timed(kern, plain, lib, err, nbytes, flops, dtype,
                     note=f"add + norm + {dm}x{k} projection")

    def scan(b, s, h, p, n, chunk, dtype, tag):
        """y and the final state; x, B and C are strided slices of one
        tensor, as the model hands them over.  The fp32 kernel computes its
        products in 3xTF32 on tensor cores, so its bound counts 3x the
        flops at the TF32 peak.  No single PyTorch call computes the
        chunked SSD, so there is no library time."""
        from repro_torch.kernels import mamba_scan as ms
        xbc = rnd(b, s, h * p + 2 * n, dtype=dtype)
        xh, bm, cm = torch.split(xbc, [h * p, n, n], -1)
        xh = xh.reshape(b, s, h, p)
        dt = (rnd(b, s, h, dtype=torch.float32).abs() * 0.1).to(dtype)
        a_log = rnd(h, dtype=torch.float32) * 0.5
        kern = lambda: ops.mamba_scan(xh, dt, a_log, bm, cm, chunk=chunk)
        plain = lambda: ref.ssd_ref(xh, dt, a_log, bm, cm)
        (y, st), (want_y, want_st) = kern(), plain()
        label = f"mamba_scan B={b} S={s} H={h} P={p} N={n} L={chunk} {tag}"
        err = max(compare(label + " y", y, want_y, dtype, SSD_TOL[dtype]),
                  compare(label + " state", st, want_st, dtype,
                          SSD_TOL[dtype]))
        # each input read once, y and the state written once; operations of
        # the causal triangle: C·Bᵀ once for all heads, then per head the
        # intra-chunk product, C @ state and the state update
        el, ell = xh.element_size(), min(chunk, s)
        nc, pairs = s // ell, ell * (ell + 1) // 2
        nbytes = el * (2 * xh.numel() + 2 * b * s * n + dt.numel()) \
            + 4 * h + 4 * b * h * n * p
        flops = b * nc * (2 * n * pairs + h * (2 * p * pairs + 4 * ell * n * p))
        pw, units = ms.tiling(b, s, h, p, torch.cuda.get_device_properties(
            0).multi_processor_count)
        note = f"{units} blocks of {pw} columns of P"
        if dtype == torch.float32:      # 3xTF32 on tensor cores
            return timed(kern, plain, None, err, nbytes, 3 * flops, dtype,
                         TF32_FLOPS, note=note + ", 3xTF32 accounting")
        return timed(kern, plain, None, err, nbytes, flops, dtype, note=note)

    def slstm(b, s, h, dh, r_scale, b_scale, dtype, tag, prefix=0):
        """h and the final state.  r and bias at the model's init (r at
        0.02, bias 0) or larger, so that the recurrence matters; with
        ``prefix``, from the state the plain version reaches after that
        many steps.  The recurrent product is fp32 whatever xg's type, so
        its operations are bounded at the fp32 peak.  No single PyTorch
        call computes the exp-gated sLSTM (``nn.LSTM`` is another
        function), so there is no library time."""
        from repro_torch.kernels import slstm_cell as sl
        xg = rnd(b, s, 4, h, dh, dtype=dtype)
        r = rnd(4, h, dh, dh, dtype=torch.float32) * r_scale
        bias = rnd(4, h, dh, dtype=torch.float32) * b_scale
        state = None if not prefix else ref.slstm_seq_ref(
            rnd(b, prefix, 4, h, dh, dtype=dtype), r, bias)[1]
        kern = lambda: ops.slstm_seq(xg, r, bias, state)
        plain = lambda: ref.slstm_seq_ref(xg, r, bias, state)
        (got_h, got_st), (want_h, want_st) = kern(), plain()
        label = f"slstm_seq B={b} S={s} H={h} Dh={dh} r={r_scale} {tag}"
        err = max([compare(label + " h", got_h, want_h, dtype)]
                  + [compare(f"{label} {k}", got_st[k], want_st[k], dtype)
                     for k in want_st])
        # xg read and h written once, r and bias read once, the four state
        # leaves written (and read, from a state) once
        n_state = 4 * 4 * b * h * dh * (2 if prefix else 1)
        nbytes = xg.element_size() * (xg.numel() + b * s * h * dh) \
            + 4 * (r.numel() + bias.numel()) + n_state
        flops = 2 * b * s * 4 * h * dh * dh
        plan = sl.cluster_plan(b, h, dh, dtype)
        return timed(kern, plain, None, err, nbytes, flops, torch.float32,
                     note=f"{plan.grid[1] * plan.grid[2]} clusters of "
                          f"{plan.cluster} blocks, {max(plan.cols)} columns "
                          f"and {plan.threads} threads a block")

    def gmm(e, c, d, f, dtype, tag, counts=None):
        """x is the model's view of its (E, C + 1, D) dispatch buffer
        without the sink row; w ~ N(0, 1/D), the scale of the model's
        weights, so outputs are O(1) and fp32 sums of D products in two
        orders stay within 2e-5.  ``counts``: the rows each expert holds,
        clamped to C and passed as ``rows``, with x zero past them as the
        dispatch builds it; the bound then counts the active experts'
        weights and their rows' operations only, while ``torch.bmm`` still
        computes the whole buffer.  The tiled fp32 path computes in
        3xTF32 on tensor cores, so its bound counts 3x the flops at the
        TF32 peak; the streaming path's FMAs are fp32 on CUDA cores."""
        from repro_torch.kernels import moe_gmm as mg
        x = rnd(e, c + 1, d, dtype=dtype)[:, :c]
        w = (rnd(e, d, f, dtype=torch.float32) * d ** -0.5).to(dtype)
        rows, n_rows, active = None, e * c, e
        if counts is not None:
            rows = torch.as_tensor(counts, dtype=torch.int32,
                                   device="cuda").clamp_max(c)
            x.masked_fill_(torch.arange(c, device="cuda")[None, :, None]
                           >= rows[:, None, None], 0.0)
            n_rows, active = int(rows.sum()), int((rows > 0).sum())
        kern = lambda: ops.moe_gmm(x, w, rows)
        plain = lambda: ref.gmm_ref(x, w, rows)
        lib = lambda: torch.bmm(x, w)
        err = compare(f"moe_gmm E={e} C={c} D={d} F={f} {tag}", kern(),
                      plain(), dtype)
        path = mg.path(x, w)
        nbytes = (n_rows * d + active * d * f + e * c * f) \
            * x.element_size() + (0 if rows is None else 4 * e)
        flops = 2 * n_rows * d * f
        note = f"{path}, {active} of {e} experts active"
        if dtype == torch.float32 and path == "tiled":
            return timed(kern, plain, lib, err, nbytes, 3 * flops, dtype,
                         TF32_FLOPS, note=note + ", 3xTF32 accounting")
        return timed(kern, plain, lib, err, nbytes, flops, dtype, note=note)

    # One norm call is one device kernel, the port's, in both types:
    # checked first, since later profiler passes of this phase may record
    # no device event at all (one run lost every pass from the attention
    # rows on, SDPA's included).
    for dtype in (torch.float32, torch.bfloat16):
        x, s_ = rnd(4, 4096, dtype=dtype), rnd(4096, dtype=torch.float32)
        kern = functools.partial(ops.fused_rmsnorm, x, s_, eps=1e-5)
        kern()
        events = []
        for _ in range(3):
            events = events or device_events(kern)
        check(len(events) == 1 and "rmsnorm" in events[0],
              f"one rmsnorm call ran {len(events)} device events: {events}")
        print(f"  rmsnorm N=4 D=4096 {dtype}: one device kernel a call, "
              f"{events[0][:72]}")
    # The attention rows come first: profiler passes that followed the
    # plain SSD and sLSTM loops (~10^5 launches each) recorded no device
    # kernel for SDPA.
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        # flash attention: prefill of one prompt, glm4_9b heads; 9, 67 and
        # 110 are served prompt lengths, causal in a ragged 64-row tile
        for s in (9, 64, 67, 110, 512):
            rows[("flash_attention", tag, f"S={s}")] = attention(
                s, 32, 2, 128, dtype, tag)
        rows[("flash_decode", tag, "T=1024")] = decode(32, 2, 128, dtype, tag)
    # zamba2's shared attention: head dim 112, 32 KV heads (group 1)
    for s in (17, 512):
        rows[("flash_attention", "float32", f"S={s} D=112 MHA")] = attention(
            s, 32, 32, 112, torch.float32, "float32")
    # decode rows: each layout in both types at kv_len 1024/700/129/1, and
    # in fp32 at a served fill, 544/160/68/9 (a 512-token prompt and 32 new
    # tokens, down to a short prompt)
    served = (544, 160, 68, 9)
    rows[("flash_decode", "float32", "T=1024 fill 544/160/68/9")] = decode(
        32, 2, 128, torch.float32, "float32", served)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        rows[("flash_decode", tag, "T=1024 D=112 MHA")] = decode(
            32, 32, 112, dtype, tag)
    rows[("flash_decode", "float32", "T=1024 D=112 MHA fill 544/160/68/9")] \
        = decode(32, 32, 112, torch.float32, "float32", served)
    # deepseek_moe_16b's attention: MHA, 16 heads of 128
    for s in (110, 512):
        rows[("flash_attention", "float32", f"S={s} H=16 MHA")] = attention(
            s, 16, 16, 128, torch.float32, "float32")
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        rows[("flash_decode", tag, "T=1024 H=16 MHA")] = decode(
            16, 16, 128, dtype, tag)
    rows[("flash_decode", "float32", "T=1024 H=16 MHA fill 544/160/68/9")] \
        = decode(16, 16, 128, torch.float32, "float32", served)
    # this slice's shapes: minicpm3_4b's MLA prefill (40 heads, q/k 96, v
    # 64) and latent decode (40 heads on one KV head, key 288, value 256);
    # whisper_medium's encoder (1500 frames, non-causal, 16 heads of 64)
    # and its decoder's self (448 rows) and cross (1500 frames) decodes
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        rows[("flash_attention", tag, "S=512 H=40 D=96 Dv=64 MLA")] = \
            attention(512, 40, 40, 96, dtype, tag, dv=64)
        rows[("flash_attention", tag, "S=T=1500 H=16 D=64 encoder")] = \
            attention(1500, 16, 16, 64, dtype, tag, causal=False)
        rows[("flash_decode", tag, "T=1024 H=40 Hkv=1 D=288 Dv=256 latent")] \
            = decode(40, 1, 288, dtype, tag, latent=(256, 96 ** -0.5))
    rows[("flash_decode", "float32",
          "T=1024 H=40 Hkv=1 D=288 Dv=256 latent fill 544/160/68/9")] = \
        decode(40, 1, 288, torch.float32, "float32", served,
               latent=(256, 96 ** -0.5))
    # deepseek_v2_236b: its MLA prefill (128 heads, q/k 128 + 64, v 128)
    # and its latent decode (128 heads on one KV head, key 512 + 64, value
    # the first 512 columns of the key rows), full and at a served fill
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        rows[("flash_attention", tag, "S=512 H=128 D=192 Dv=128 MLA")] = \
            attention(512, 128, 128, 192, dtype, tag, dv=128)
        rows[("flash_decode", tag,
              "T=1024 H=128 Hkv=1 D=576 Dv=512 latent full")] = decode(
            128, 1, 576, dtype, tag, (1024,) * 4, latent=(512, 192 ** -0.5))
    rows[("flash_decode", "float32",
          "T=1024 H=128 Hkv=1 D=576 Dv=512 latent fill 544/160/68/9")] = \
        decode(128, 1, 576, torch.float32, "float32", served,
               latent=(512, 192 ** -0.5))
    # the heads on a rank of 21(g)'s tensor-parallel MLA: deepseek_v2_236b's
    # 64 of 128 and minicpm3_4b's 20 of 40, the prefill attention and the
    # latent decode
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        rows[("flash_attention", tag, "S=512 H=64 D=192 Dv=128 MLA TP")] = \
            attention(512, 64, 64, 192, dtype, tag, dv=128)
        rows[("flash_decode", tag,
              "T=1024 H=64 Hkv=1 D=576 Dv=512 latent TP")] = decode(
            64, 1, 576, dtype, tag, (1024,) * 4, latent=(512, 192 ** -0.5))
        rows[("flash_attention", tag, "S=512 H=20 D=96 Dv=64 MLA TP")] = \
            attention(512, 20, 20, 96, dtype, tag, dv=64)
        rows[("flash_decode", tag,
              "T=1024 H=20 Hkv=1 D=288 Dv=256 latent TP")] = decode(
            20, 1, 288, dtype, tag, (1024,) * 4, latent=(256, 96 ** -0.5))
    # the (query, KV) heads of a tensor-parallel mesh step (TP_HEADS)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for h, hkv in TP_HEADS:
            rows[("flash_attention", tag, f"S=512 H={h} Hkv={hkv} TP")] = \
                attention(512, h, hkv, 128, dtype, tag)
            rows[("flash_decode", tag, f"T=1024 H={h} Hkv={hkv} TP")] = \
                decode(h, hkv, 128, dtype, tag)
    # a rank of 21(h)'s tensor-parallel zamba2_7b: its 16 of the 32
    # attention heads of 112 (16 KV heads) at the 1 x 128 prefill, and its
    # decode
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        rows[("flash_attention", tag, "S=128 H=16 D=112 MHA TP")] = \
            attention(128, 16, 16, 112, dtype, tag)
        rows[("flash_decode", tag, "T=1024 H=16 D=112 MHA TP")] = decode(
            16, 16, 112, dtype, tag)
    rows[("flash_decode", "float32", "T=132 H=16 D=112 MHA TP fill 128")] = \
        decode(16, 16, 112, torch.float32, "float32", (128,) * 4, t=132)
    rows[("flash_decode", "float32", "T=1500 H=16 D=64 cross")] = decode(
        16, 16, 64, torch.float32, "float32", (1500,) * 4, t=1500)
    rows[("flash_decode", "float32", "T=448 H=16 D=64 self fill "
                                     "448/300/65/1")] = decode(
        16, 16, 64, torch.float32, "float32", (448, 300, 65, 1), t=448)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        # RMSNorm: the decode step's 4 rows and a 512-token prefill, at
        # glm4_9b's d_model and zamba2's gated-norm width; the decode step
        # at every served width (MLA's kv_norm 256 and q_norm 768,
        # xlstm_125m 768, whisper_medium 1024, deepseek_moe_16b 2048,
        # minicpm3_4b 2560, zamba2_7b 3584, 12288); deepseek_v2_236b's
        # widths, which no vector instantiation holds and the general path
        # runs (kv_norm 512, q_norm 1536, d_model 5120, the last also at a
        # 512-token prefill); and glm4_9b's decode chain around the norm
        for n in (4, 512):
            for dm in (4096, 7168, 5120):
                rows[("rmsnorm", tag, f"N={n} D={dm}")] = rmsnorm(
                    n, dm, dtype, tag)
        for dm in (256, 768, 1024, 2048, 2560, 3584, 12288, 512, 1536):
            rows[("rmsnorm", tag, f"N=4 D={dm}")] = rmsnorm(4, dm, dtype,
                                                            tag)
        if dtype == torch.float32:
            rows[("rmsnorm", tag, "chain N=4 D=4096")] = norm_chain(dtype,
                                                                   tag)
        # the SSD scan at zamba2's prefill (a ragged chunk, one chunk, the
        # served long prompts of four and eight chunks) and at one shape of
        # tests/test_kernels.py
        for s in (17, 64, 256, 512):
            rows[("mamba_scan", tag, f"S={s}")] = scan(
                1, s, 112, 64, 64, 64, dtype, tag)
        rows[("mamba_scan", tag, "B=2 S=64 H=3 P=16 N=8 L=16")] = scan(
            2, 64, 3, 16, 8, 16, dtype, tag)
        # a rank of 21(h): 56 of the 112 heads, at its 1 x 128 prefill
        rows[("mamba_scan", tag, "S=128 H=56 TP")] = scan(
            1, 128, 56, 64, 64, 64, dtype, tag)
        # the split gated norm's entries: a decode tick's 4 rows and a
        # 512-token prefill, on a device's block of zamba2_7b's 7168
        # channels over 16, 2 and 1 devices
        for n in (4, 512):
            for w in (448, 3584, 7168):
                rows[("rmsnorm_sumsq", tag, f"N={n} W={w}")] = norm_sumsq(
                    n, w, dtype, tag)
                rows[("rmsnorm_scaled", tag, f"N={n} W={w}")] = norm_scaled(
                    n, w, dtype, tag)
        # the grouped matmul at deepseek_moe_16b's expert FFN: decode (C = 1
        # at four slots), prefill at S = 128 and 512 (C = 15 and 60 at
        # capacity factor 1.25), gate/up (D=2048, F=1408) and down (D=1408,
        # F=2048); and a ragged C of tests/test_kernels.py
        for c, d, f in ((1, 2048, 1408), (1, 1408, 2048), (15, 2048, 1408),
                        (60, 2048, 1408), (60, 1408, 2048)):
            rows[("moe_gmm", tag, f"E=64 C={c} D={d} F={f}")] = gmm(
                64, c, d, f, dtype, tag)
        rows[("moe_gmm", tag, "E=8 C=7 D=32 F=64")] = gmm(8, 7, 32, 64,
                                                          dtype, tag)
        # routed rows: the counts of a seeded top-6 routing over 64 experts,
        # of a 4-slot decode tick (C = 1 at capacity factor 4.0) and of a
        # 512-token prefill (C = 60 at 1.25)
        for n_tok, c in ((4, 1), (512, 60)):
            rows[("moe_gmm", tag, f"routed {n_tok} tokens E=64 C={c} "
                                  f"D=2048 F=1408")] = gmm(
                64, c, 2048, 1408, dtype, tag,
                routed_counts(n_tok, 64, 6, seed=n_tok))
        # one rank's block of expert parallelism over two devices (21(f)):
        # experts 32-63 of the 64, the block's slice of the counts as
        # ``rows``, at the 1 x 128 prefill (C = 15 at 1.25: gate/up and
        # down) and a one-slot tick (C = 1 at 4.0)
        for n_tok, c, d, f in ((1, 1, 2048, 1408), (128, 15, 2048, 1408),
                               (128, 15, 1408, 2048)):
            rows[("moe_gmm", tag, f"routed {n_tok} tokens experts 32-63 "
                                  f"E=32 C={c} D={d} F={f}")] = gmm(
                32, c, d, f, dtype, tag,
                routed_counts(n_tok, 64, 6, seed=n_tok)[32:])
        # deepseek_v2_236b's routed experts (160, top-6): gate/up (D=5120,
        # F=1536) and down (1536 -> 5120) of a 4-slot tick (C = 1 at
        # capacity factor 4.0) and a 512-token prefill (C = 24 at 1.25)
        for n_tok, c in ((4, 1), (512, 24)):
            for d, f in ((5120, 1536), (1536, 5120)):
                rows[("moe_gmm", tag, f"routed {n_tok} tokens E=160 C={c} "
                                      f"D={d} F={f}")] = gmm(
                    160, c, d, f, dtype, tag,
                    routed_counts(n_tok, 160, 6, seed=n_tok))
        # one rank's block of 21(g)'s deepseek_v2_236b: experts 80-159 of
        # the 160, the block's slice of the counts of the 1 x 128 prefill
        # (C = 6 at 1.25: gate/up and down) and of a one-slot tick (C = 1
        # at 4.0)
        for n_tok, c, d, f in ((1, 1, 5120, 1536), (128, 6, 5120, 1536),
                               (128, 6, 1536, 5120)):
            rows[("moe_gmm", tag, f"routed {n_tok} tokens experts 80-159 "
                                  f"E=80 C={c} D={d} F={f}")] = gmm(
                80, c, d, f, dtype, tag,
                routed_counts(n_tok, 160, 6, seed=n_tok)[80:])
        # the sLSTM at xlstm_125m's heads (4 of 192): a 512-, a 300- and a
        # 17-token prefill, and a decode tick of 4 slots from a state
        for s_, rs, bs in ((512, 0.02, 0.0), (512, 0.1, 0.1),
                           (300, 0.02, 0.0), (17, 0.02, 0.0)):
            rows[("slstm_seq", tag, f"B=1 S={s_} r={rs}")] = slstm(
                1, s_, 4, 192, rs, bs, dtype, tag)
        for rs, bs in ((0.02, 0.0), (0.1, 0.1)):
            rows[("slstm_seq", tag, f"B=4 S=1 r={rs} from state")] = slstm(
                4, 1, 4, 192, rs, bs, dtype, tag, prefix=9)
    for (name, tag, size), r in rows.items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        print(f"  {name:16s} {tag:9s} {size:36s} max_abs_err "
              f"{r['err']:.3e}  kernel {r['ms']:.4f} ms (host-issued "
              f"{r['host_ms']:.4f} ms)  plain {r['plain_ms']:.4f} ms  "
              f"library {lib}  bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]})" + (f"  [{r['note']}]" if r["note"] else ""))
        if r["library_kernels"] is not None:
            print(f"    SDPA kernels: " + (" | ".join(
                n[:100] for n in r["library_kernels"]) or "none recorded"))
    return rows


def routed_counts(n_tokens: int, n_experts: int, top_k: int, seed: int):
    """Rows per expert of a seeded routing: each token picks ``top_k``
    distinct experts uniformly."""
    rng = np.random.default_rng(seed)
    ids = np.argsort(rng.random((n_tokens, n_experts)), axis=1)[:, :top_k]
    return np.bincount(ids.ravel(), minlength=n_experts)


def run_greedy(cfg, params, prompt, cache_len, steps, img=None):
    """A prefill of ``prompt`` (after the (1, P, D) numpy image patches
    ``img``, for a VLM) and ``steps`` greedy decode steps; the logits of
    each on the host and the tokens."""
    from repro_torch.models import transformer as tf
    dev = params["embed"]["embedding"].device
    tokens = torch.as_tensor(prompt[None, :], dtype=torch.long, device=dev)
    img_t = None if img is None else torch.from_numpy(img).to(dev)
    logits, cache = tf.lm_prefill(cfg, params, tokens, cache_len,
                                  img_embeds=img_t)
    out_logits, out_tokens = [logits.cpu()], []
    n = prompt.shape[0] + (0 if img is None else img.shape[1])
    kv_len = torch.tensor([n], dtype=torch.int32, device=dev)
    for _ in range(steps):
        tok = logits.argmax(dim=-1, keepdim=True)
        out_tokens.append(int(tok))
        logits, cache = tf.lm_decode(cfg, params, tok, cache, kv_len)
        kv_len += 1
        out_logits.append(logits.cpu())
    return out_logits, out_tokens


class RouteLog:
    """Records the top-k expert ids of every ``moe.route`` call, as sorted
    (token, k) arrays on the host, while it is entered."""

    def __enter__(self):
        from repro_torch.models import moe
        self.calls, self._route = [], moe.route

        def logged(params, x_flat, top_k):
            out = self._route(params, x_flat, top_k)
            self.calls.append(out[1].sort(dim=-1).values.cpu())
            return out
        moe.route = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._route


def route_differences(card, cpu):
    """(token, layer) routes whose top-k sets differ, and all of them."""
    check(len(card) == len(cpu) and all(a.shape == b.shape
                                        for a, b in zip(card, cpu)),
          "card and CPU routed different numbers of tokens")
    diff = sum(int((a != b).any(dim=-1).sum()) for a, b in zip(card, cpu))
    return diff, sum(a.shape[0] for a in card)


def phase_cut(arch, n_layers, seed, prompt_len=128, n_img=0):
    """Phases 3, 5, 7, 9, 15 and 17: a full-width model cut to
    ``n_layers``, the same weights on the card and on the CPU, a
    ``prompt_len``-token prefill (after ``n_img`` image patches drawn from
    the seed, for a VLM) and 8 greedy decode steps.  For an MoE model it
    also counts the (token, layer) top-k routes that differ between the
    two; a route that flips on a near-tie is reported, not hidden."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.common import init_params
    cfg = get_config(arch).replace(n_layers=n_layers, dtype="float32",
                                   attn_impl="kernel")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p_gpu = init_params(api.param_spec(cfg), gen, "cuda")

    def to_cpu(t):
        return t.cpu() if isinstance(t, torch.Tensor) else \
            {k: to_cpu(v) for k, v in t.items()}
    p_cpu = to_cpu(p_gpu)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab, prompt_len)
    img = rng.standard_normal((1, n_img, cfg.d_model)).astype(np.float32) \
        if n_img else None
    cache_len = 2 * (prompt_len + n_img)
    t0 = time.perf_counter()
    with RouteLog() as card_routes:
        gl, gt = run_greedy(cfg, p_gpu, prompt, cache_len, 8, img)
    t1 = time.perf_counter()
    with RouteLog() as cpu_routes:
        cl, ct = run_greedy(cfg, p_cpu, prompt, cache_len, 8, img)
    t2 = time.perf_counter()
    if cfg.family == "moe":
        diff, total = route_differences(card_routes.calls, cpu_routes.calls)
        print(f"  top-{cfg.top_k} routes that differ between card and CPU: "
              f"{diff} of {total} (token, layer) routes")
    worst = 0.0
    for i, (g, c) in enumerate(zip(gl, cl)):
        # over the real vocab: the padded entries are masked to -1e30, which
        # would make any difference look small beside max |logit|
        g, c = g[..., :cfg.vocab], c[..., :cfg.vocab]
        check(bool(torch.isfinite(g).all()), f"step {i}: non-finite logits")
        rel = ((g - c).abs().max() / c.abs().max()).item()
        worst = max(worst, rel)
        check(rel <= 1e-3, f"step {i}: card logits off the CPU's by {rel} of "
                           f"max |logit|")
    check(gt == ct, f"greedy tokens differ: card {gt} cpu {ct}")
    print(f"  {n_layers}-layer full-width {arch}: prefill "
          f"{f'{n_img} patches + ' if n_img else ''}{prompt_len} + 8 "
          f"decode steps, worst |card - cpu| / max|logit| = {worst:.3e}, "
          f"tokens equal ({gt}); card {t1 - t0:.2f} s, cpu "
          f"{t2 - t1:.2f} s")
    del p_gpu, p_cpu
    torch.cuda.empty_cache()


def structure_launches(cfg, n_prefill, n_steps):
    """Kernel launches the model's structure implies for ``n_prefill``
    prefills and ``n_steps`` decode ticks.  Two norms a block: a dense, MoE
    or shared attention block, a Mamba2 layer (the block's and the gated
    one) and an xLSTM block (the block's and the heads'), and one final
    norm; an MLA block adds its kv_norm and, with a query compression, its
    q_norm.  One attention a dense, MoE or shared attention block (MLA's
    latent decode too); one SSD scan a Mamba2 layer; three grouped matmuls
    (gate, up, down) an MoE layer; one sLSTM recurrence an sLSTM block.
    The encoder-decoder's prefill (``api.prefill_fn``) is the encoder (an
    attention and two norms a layer, and its final norm) and a BOS decode
    step; a decode step is three norms, a self and a cross flash decode a
    decoder layer and the final norm."""
    calls = n_prefill + n_steps
    # the split norm's entries run only in a tensor-parallel hybrid step
    split = {"rmsnorm_sumsq": 0, "rmsnorm_scaled": 0}
    if cfg.family == "encdec":
        n, nd = cfg.n_layers, cfg.n_dec_layers
        return {"flash_attention": n * n_prefill,
                "flash_decode": 2 * nd * calls, "mamba_scan": 0,
                "moe_gmm": 0, "slstm_seq": 0, **split,
                "rmsnorm": (2 * n + 1) * n_prefill + (3 * nd + 1) * calls}
    attn = mamba = moe = slstm = 0
    if cfg.family == "hybrid":
        mamba, attn = cfg.n_layers, cfg.n_layers // cfg.attn_every
    elif cfg.family == "ssm":
        slstm = cfg.n_layers // cfg.slstm_every
    else:
        attn = cfg.n_layers
    if cfg.family == "moe":
        moe = cfg.n_layers - cfg.first_dense
    blocks = cfg.n_layers + (attn if cfg.family == "hybrid" else 0)
    mla = (1 + (cfg.q_lora > 0)) * cfg.n_layers if cfg.attn == "mla" else 0
    return {"flash_attention": attn * n_prefill,
            "flash_decode": attn * n_steps,
            "mamba_scan": mamba * n_prefill, "moe_gmm": 3 * moe * calls,
            "rmsnorm": (2 * blocks + mla + 1) * calls,
            "slstm_seq": slstm * calls, **split}


def serve_once(cfg, params, prompts, new_tokens):
    """Drive the engine over ``prompts`` from launch counts of 0; check
    that every request finished and every kernel ran as often as the
    model's structure implies."""
    from repro_torch.kernels import ops
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    engine = ServingEngine(cfg, params, ServeConfig(n_slots=4,
                                                    cache_len=1024))
    ops.reset_launch_counts()
    t0 = time.time()
    for uid, prompt in enumerate(prompts):
        engine.submit(Request(uid=uid, prompt=prompt,
                              max_new_tokens=new_tokens))
    finished = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ops.launch_counts()
    check(len(finished) == len(prompts),
          f"{len(finished)} of {len(prompts)} requests finished")
    for r in finished:
        check(len(r.output) == new_tokens
              and all(0 <= t < cfg.vocab for t in r.output),
              f"request {r.uid}: bad output {r.output}")
    want = structure_launches(cfg, len(prompts), engine.steps)
    check(launches == want, f"launch counts {launches}, the model's "
                            f"structure implies {want}")
    return finished, engine, wall, launches


def tick_params(cfg, spec):
    """Parameters one decode tick reads: every weight once, every expert's
    included (the floor of §2 in PERF.md, one definition for every path;
    phase 8 also prints it at the measured share of active experts),
    except the hybrid's shared attention blocks, read once per group of
    Mamba2 layers, alternating between the weight sets."""
    from repro_torch.models.common import count_params
    n = count_params(spec)
    if cfg.family == "hybrid":
        per_set = count_params(spec["shared_attn"]) // cfg.n_shared_attn
        n += per_set * (cfg.n_layers // cfg.attn_every - cfg.n_shared_attn)
    return n


def tick_cache_bytes(cfg, slots, fill):
    """Bytes of cache a tick of ``slots`` rows reads and writes, from the
    cache spec: a K/V leaf is read to ``fill`` positions a row and written
    at one; every other leaf (recurrent state, a conv tail) is read and
    written whole."""
    from repro_torch.configs.base import InputShape
    from repro_torch.models import api
    from repro_torch.models.common import spec_leaves
    spec = api.cache_spec(cfg, InputShape("tick", 1024, slots, "decode"))
    total = 0.0
    for s in spec_leaves(spec):
        size = math.prod(s.shape) * s.dtype.itemsize
        if "kv_seq" in s.axes:
            total += size / s.shape[s.axes.index("kv_seq")] * (fill + 1)
        else:
            total += 2 * size
    return total


def phase_serve(arch, seed, max_prompt, repeats: int = 1, then=None,
                long=(256, 512), before=None, n_layers=None):
    """Phases 4, 6, 8, 10, 16, 18 and 23: a full model (or its full width
    cut to ``n_layers``) through the serving engine, the same 8 requests
    ``repeats`` times, each on a fresh engine.  Six prompts are drawn in
    [4, max_prompt], two have the ``long`` lengths.  ``before(cfg,
    params)`` runs before the engine and ``then(cfg, params)`` last, on the
    same weights; the launches of the engine's first run are returned,
    plus those ``before`` returns."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.common import count_params, init_params
    cfg = get_config(arch).replace(dtype="float32", attn_impl="kernel")
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    spec = api.param_spec(cfg)
    n_params = count_params(spec)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(spec, torch.Generator(device="cuda").manual_seed(
        seed), "cuda")
    torch.cuda.synchronize()
    print(f"  {arch}{'' if n_layers is None else f' cut to {n_layers} layers'}"
          f": {n_params / 1e9:.3f} B params fp32 ({4 * n_params / 1e9:.2f} "
          f"GB), init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(4, max_prompt + 1, 6)] + list(long)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    new_tokens = 32
    n_tick = tick_params(cfg, spec)
    fill = sum(lens) / len(lens) + new_tokens / 2
    n_cache = tick_cache_bytes(cfg, 4, fill)
    step_bound = (4 * n_tick + n_cache) / HBM_BYTES_PER_S * 1e3
    print(f"  prompts {lens}, {new_tokens} new tokens each, 4 slots, cache "
          f"1024; decode-step bound {step_bound:.3f} ms ({n_tick / 1e9:.3f} B "
          f"fp32 weights a tick + {n_cache / 1e6:.1f} MB of cache read and "
          f"written at a mean fill of {fill:.1f} positions, over HBM)")
    print(f"  launches per prefill {structure_launches(cfg, 1, 0)}, per tick "
          f"{structure_launches(cfg, 0, 1)}")
    extra = None if before is None else before(cfg, params)
    first, all_steps, engine = None, [], None
    for run in range(repeats):
        engine = None       # one pool's cache at a time
        finished, engine, wall, launches = serve_once(cfg, params, prompts,
                                                      new_tokens)
        first = first or launches
        toks = sum(len(r.output) for r in finished)
        ttft = sorted(r.t_first - r.t_submit for r in finished)
        step_ms = sorted(1e3 * s for s in engine.decode_s)
        all_steps += step_ms
        print(f"  run {run}: {toks} tokens in {wall:.2f} s = "
              f"{toks / wall:.1f} tok/s, {engine.steps} decode ticks; step "
              f"p50 {step_ms[len(step_ms) // 2]:.2f} ms, min "
              f"{step_ms[0]:.2f} ms, max {step_ms[-1]:.2f} ms; TTFT p50 "
              f"{ttft[len(ttft) // 2] * 1e3:.1f} ms, max "
              f"{ttft[-1] * 1e3:.1f} ms")
        print(f"    TTFT per request (ms, queueing included): "
              f"{[round((r.t_first - r.t_submit) * 1e3, 1) for r in finished]}")
    all_steps.sort()
    print(f"  decode step over all {repeats} runs: p50 "
          f"{all_steps[len(all_steps) // 2]:.2f} ms, min {all_steps[0]:.2f} "
          f"ms, max {all_steps[-1]:.2f} ms of {len(all_steps)} ticks")
    print(f"  launches {first}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del engine
    active = phase_profile(cfg, params, seed)
    if active is not None:
        # the floor at the measured share of experts with rows: only their
        # weights need to be read
        routed = 3 * (cfg.n_layers - cfg.first_dense) * cfg.n_experts \
            * cfg.d_model * cfg.d_ff_expert
        unread = routed * (1 - active / cfg.n_experts)
        print(f"  decode-step bound at {active:.2f} of {cfg.n_experts} "
              f"experts read a launch: "
              f"{(4 * (n_tick - unread) + n_cache) / HBM_BYTES_PER_S * 1e3:.3f}"
              f" ms ({(n_tick - unread) / 1e9:.3f} B fp32 weights a tick)")
    if then is not None:
        then(cfg, params)
    if extra is not None:
        first = {k: first[k] + extra[k] for k in first}
    return first


# the device kernels' names of a kernel family, in a profile
DEVICE_NAMES = {"flash_attention": "flash_attn", "mamba_scan": "mamba_scan",
                "slstm_seq": "slstm_seq_kernel"}


def lone_prefill(kernels, cfg, params, s: int = 512, repeats: int = 3,
                 profiles: int = 3):
    """The last step of phases 4, 6 and 10: one ``s``-token prefill through the
    engine's prefill function, alone on the card: a warm call, ``repeats``
    timed on the host clock (synchronised), then one under torch.profiler
    for the share of the device time of each of ``kernels`` (keys of
    ``DEVICE_NAMES``).  The wrappers' counts of the profiled prefill must be
    what the model's structure implies; the profile must hold one device
    kernel for each of those launches, or it lost records and is taken
    again, up to ``profiles`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.models import api
    prefill = api.prefill_fn(cfg, 1024)
    tokens = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, s)), dtype=torch.long, device="cuda")
    prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    want = {k: structure_launches(cfg, 1, 0)[k] for k in kernels}
    for attempt in range(1, profiles + 1):
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
        launched = ops.launch_counts()
        for k in kernels:
            check(launched[k] == want[k], f"the profiled prefill launched "
                                          f"{launched[k]} {k}, not {want[k]}")
        busy = 0.0
        us = {k: 0.0 for k in kernels}
        runs = {k: 0 for k in kernels}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                busy += e.device_time_total
                for k in kernels:
                    if DEVICE_NAMES[k] in e.name:
                        us[k] += e.device_time_total
                        runs[k] += 1
        if runs == want:
            break
        print(f"  profile {attempt} of the prefill holds {runs} device "
              f"kernels for {want} launches")
        check(attempt < profiles, f"{profiles} profiles of the prefill each "
                                  f"lost device kernels")
    shares = ", ".join(f"{k} {us[k] / 1e3:.3f} ms in {runs[k]} launches = "
                       f"{100 * us[k] / busy:.2f}%" for k in kernels)
    print(f"  one {s}-token prefill alone: {', '.join(f'{t:.2f}' for t in times)}"
          f" ms (host clock, synchronised); profiled: device busy "
          f"{busy / 1e3:.2f} ms; {shares} of it")


def moe_decode_without_sync(cfg, params):
    """Phase 8's last check: the MoE FFN of one decode step (4 slots, the
    first MoE layer, capacity factor 4.0) under sync debug mode "error",
    where any call that waits for the device raises; its output must equal
    that of the same call run beforehand."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import _layers
    p = _layers(params["blocks"], 1)[0]["ffn"]
    x = torch.randn(4, 1, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    want = moe.moe_apply(p, x, cfg.top_k, capacity_factor=4.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe.moe_apply(p, x, cfg.top_k, capacity_factor=4.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(err <= 1e-5 * want.abs().max().item(), f"the MoE FFN under sync "
                                                 f"debug mode differs by {err}")
    print(f"  one decode step's MoE FFN ran under sync debug mode \"error\" "
          f"without a host sync (|diff| to an earlier run {err:.3e})")


class ActiveExperts:
    """Counts, on the device, the experts that hold rows in every
    ``ops.moe_gmm`` call made while it is entered."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self._gmm, self.calls = ops, ops.moe_gmm, 0
        self.total = torch.zeros((), dtype=torch.long, device="cuda")

        def counted(x, w, rows=None):
            self.calls += 1
            self.total += x.shape[0] if rows is None else (rows > 0).sum()
            return self._gmm(x, w, rows)
        ops.moe_gmm = counted
        return self

    def __exit__(self, *exc):
        self.ops.moe_gmm = self._gmm

    def mean(self) -> float:
        return self.total.item() / max(self.calls, 1)


def phase_profile(cfg, params, seed, plain_ticks: int = 16,
                  ticks: int = 8):
    """Where a decode tick's time goes, on a full 4-slot pool after its
    admissions: ``plain_ticks`` ticks timed on the host clock alone, then
    ``ticks`` more under torch.profiler.  The device's busy time comes
    from the profile; its share is taken of the unprofiled tick, since
    the profiler's own host cost lengthens the ticks it traces.  For an
    MoE model, ``moe_gmm``'s time a tick, and then, over ``ticks`` more
    ticks, the mean number of experts with rows a launch, which it
    returns (None for other models)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    engine = ServingEngine(cfg, params, ServeConfig(n_slots=4,
                                                    cache_len=1024))
    rng = np.random.default_rng(seed + 1)
    for uid in range(4):
        engine.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab, 64).astype(np.int32),
            max_new_tokens=plain_ticks + 2 * ticks + 4))
    engine.step()
    torch.cuda.synchronize()
    for _ in range(plain_ticks):
        engine.step()
    plain = sorted(1e3 * s for s in engine.decode_s[1:])
    plain_mean = sum(plain) / len(plain)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(all(r is not None for r in engine.active), "the profiled pool "
                                                     "was not full")
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.device_time_total)
    busy_ms = sum(us for _, us in by_name.values()) / 1e3 / ticks
    n_kernels = sum(n for n, _ in by_name.values())
    print(f"  {plain_ticks} unprofiled ticks of a full pool: mean "
          f"{plain_mean:.2f} ms, p50 {plain[len(plain) // 2]:.2f} ms, min "
          f"{plain[0]:.2f} ms, max {plain[-1]:.2f} ms")
    print(f"  {ticks} profiled ticks: wall {wall / ticks * 1e3:.2f} ms/tick "
          f"(profiler included), device busy {busy_ms:.2f} ms/tick = "
          f"{100 * busy_ms / plain_mean:.1f}% of the unprofiled mean tick, "
          f"{n_kernels / ticks:.0f} device kernels/tick")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"    {us / ticks / 1e3:8.3f} ms/tick  {n // ticks:4d}/tick  "
              f"{name[:90]}")
    norm = [(n, us) for name, (n, us) in by_name.items() if "rmsnorm" in name]
    n_norm = sum(n for n, _ in norm)
    if n_norm:
        us_norm = sum(us for _, us in norm)
        print(f"  rmsnorm: {us_norm / ticks / 1e3:.4f} ms/tick in "
              f"{n_norm // ticks} launches/tick, {us_norm / n_norm:.2f} us a "
              f"launch")
    if cfg.family == "moe":
        gmm = [(n, us) for name, (n, us) in by_name.items()
               if "gmm_stream" in name or "gmm_tiled" in name]
        check(bool(gmm), "the profiled ticks ran no moe_gmm kernel")
        with ActiveExperts() as active:
            for _ in range(ticks):
                engine.step()
        print(f"  moe_gmm: {sum(us for _, us in gmm) / ticks / 1e3:.3f} "
              f"ms/tick in {sum(n for n, _ in gmm) // ticks} launches/tick; "
              f"{active.mean():.2f} of {cfg.n_experts} experts hold rows a "
              f"launch (mean of {active.calls} launches over {ticks} more "
              f"ticks)")
        return active.mean()
    return None


# The cost model's design points: benchmarks/engine_bench.py's heterogeneous
# sweep (5 nodes x 4 integrations, 150-850 mm^2, 2-5 unequal chiplets).  A
# copy, since that module imports the JAX package.
COST_NODES = ("5nm", "7nm", "12nm", "14nm", "28nm")
COST_INTEGRATIONS = ("SoC", "MCM", "InFO", "2.5D")
# Fig. 4's grid (benchmarks/fig4_re_integration.py), with the unsplit n = 1
FIG4_NODES = ("14nm", "7nm", "5nm")
FIG4_INTEGRATIONS = ("MCM", "InFO", "2.5D")
FIG4_AREAS = (300.0, 500.0, 800.0, 900.0)
FIG4_NS = (1, 2, 3, 5)
ENGINE_RTOL, ENGINE_ATOL = 1e-5, 1e-8   # tests/test_engine.py's tolerance


def make_specs(n: int):
    """n deterministic heterogeneous design points (no RNG: index-derived)."""
    specs = []
    for i in range(n):
        integ = COST_INTEGRATIONS[i % len(COST_INTEGRATIONS)]
        area = 150.0 + (i * 7919) % 700          # 150..850 mm^2
        qty = 1e5 * (1 + i % 50)
        if integ == "SoC":
            specs.append({"kind": "soc", "name": f"s{i}", "area": float(area),
                          "process": COST_NODES[i % len(COST_NODES)],
                          "quantity": qty})
        else:
            k = 2 + i % 4                        # 2..5 chiplets
            fracs = [1.0 + ((i + j) % 3) for j in range(k)]  # unequal slices
            procs = [COST_NODES[(i + j) % len(COST_NODES)] for j in range(k)]
            specs.append({"kind": "split", "name": f"s{i}",
                          "area": float(area), "fractions": fracs,
                          "processes": procs, "integration": integ,
                          "quantity": qty})
    return specs


def cost_fields(tc) -> dict:
    """The ten per-system outputs of ``CostEngine.total``: five RE, four
    NRE and the total."""
    return {**{k: getattr(tc.re, k) for k in
               ("raw_chips", "chip_defects", "raw_package",
                "package_defects", "wasted_kgd")},
            **{f"nre_{k}": getattr(tc.nre, k) for k in
               ("modules", "chips", "packages", "d2d")},
            "total": tc.total}


def hold(label, got: dict, want: dict, rtol=ENGINE_RTOL) -> str:
    """Each field of ``got`` within ``atol + rtol * |want|``, on the host;
    returns the largest relative difference and its field, printed."""
    worst, field = 0.0, "none"
    for k, w in want.items():
        w = torch.as_tensor(w, dtype=torch.float64).cpu()
        g = torch.as_tensor(got[k]).cpu().double().reshape(w.shape)
        diff = (g - w).abs()
        check(bool((diff <= ENGINE_ATOL + rtol * w.abs()).all()),
              f"{label}: {k} differs, max abs {diff.max().item():.3e}")
        rel = (diff / w.abs().clamp_min(1e-30)).max().item()
        if rel > worst:
            worst, field = rel, k
    return f"{worst:.3e} ({field})"


def scalar_reference(core, systems, picks, shared: bool) -> dict:
    """The scalar path's ten fields for the systems at ``picks``: each
    system alone, or all of them as one group."""
    group = core.amortized_costs(systems) if shared else None
    rows = []
    for i in picks:
        s = systems[i]
        u = group[s.name] if shared else core.amortized_costs([s])[s.name]
        rows.append([u.re.raw_chips, u.re.chip_defects, u.re.raw_package,
                     u.re.package_defects, u.re.wasted_kgd, u.nre_modules,
                     u.nre_chips, u.nre_packages, u.nre_d2d, u.total])
    cols = list(zip(*rows))
    keys = ("raw_chips", "chip_defects", "raw_package", "package_defects",
            "wasted_kgd", "nre_modules", "nre_chips", "nre_packages",
            "nre_d2d", "total")
    return {k: list(v) for k, v in zip(keys, cols)}


def tile_batch(core, b, k: int):
    """``b`` repeated ``k`` times along every axis through ``from_arrays``,
    each tile's entity ids and owning systems offset so that every tile is
    its own product group; built on b's device."""
    n = b.n_systems
    sizes = {"chip_entity_id": b.chip_entity_area.shape[0],
             "pkg_entity_id": b.pkg_entity_area.shape[0],
             "mod_entity": b.mod_entity_area.shape[0],
             "d2d_entity": b.d2d_entity_nre.shape[0],
             "mod_sys": n, "d2d_sys": n}
    leaves = {}
    for f in core.SystemBatch._LEAVES:
        a = getattr(b, f)
        t = a.repeat(k, *([1] * (a.ndim - 1)))
        if f in sizes:
            tile = torch.arange(k, device=a.device, dtype=torch.int32)
            off = tile.repeat_interleave(a.shape[0]) * sizes[f]
            t = t + (off[:, None] if a.ndim == 2 else off)
        leaves[f] = t
    return core.SystemBatch.from_arrays(device=b.device, **leaves)


def median_event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by a pair of CUDA events around each
    of ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_busy(fn) -> tuple:
    """(device events, device-busy ms, the three names that take the most
    of it with their ms) of one warm call of ``fn``, from a torch.profiler
    pass: kernels, copies and sets, which one stream runs one after
    another."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return len(dev), sum(by_name.values()), top


def cpu_ms(fn) -> float:
    """Host time of one call on the CPU."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def segment_sum_cost(engine, big, smi: str) -> dict:
    """What the deterministic NRE sums cost at 10^6 systems: ``total`` and
    the NRE alone with the engine's sums, and with the float32
    ``index_add`` atomics they replace, in turns (deterministic, atomics,
    atomics, deterministic); card ms by CUDA events (median of 20) and
    the NRE's busy ms (``torch.profiler``)."""
    from repro_torch.core import engine as engine_mod
    ordered = engine_mod._segment_sum

    def atomics(values, ids, num_segments):
        out = torch.zeros((num_segments,), dtype=values.dtype,
                          device=values.device)
        return out.index_add(0, ids, values)

    runs = {"deterministic": [], "atomics": []}
    for label in ("deterministic", "atomics", "atomics", "deterministic"):
        engine_mod._segment_sum = ordered if label == "deterministic" \
            else atomics
        try:
            total_ms = median_event_ms(lambda: engine.total(big).total)
            nre_ms = median_event_ms(lambda: engine.nre(big).total)
            _, nre_busy, top = device_busy(lambda: engine.nre(big).total)
        finally:
            engine_mod._segment_sum = ordered
        runs[label].append({"total_ms": total_ms, "nre_ms": nre_ms,
                            "nre_busy_ms": nre_busy})
        print(f"[11] {big.n_systems} systems, NRE sums by {label}: total "
              f"{total_ms:.4f} ms, NRE {nre_ms:.4f} ms (CUDA events, median "
              f"of 20), NRE busy {nre_busy:.4f} ms; most of it: " + "; ".join(
                  f"{name[:50]} {ms_:.4f}" for name, ms_ in top) + f"; {smi}")
    return runs


def phase_cost_model(seed: int, smi: str) -> dict:
    """Phase 11: the paper's cost model (``repro_torch.core``) on the card
    against the CPU, at engine_bench's 10^4 heterogeneous systems and at a
    10^6-system batch; then the explorer, the gradient partitioner and the
    codesign pricer."""
    from repro_torch import core
    from repro_torch.core.gradient import optimize_chiplet_count

    n_small, reps = 10_000, 100
    torch.cuda.synchronize()        # the CUDA context exists before packing
    t0 = time.perf_counter()
    systems = [core.spec(d) for d in make_specs(n_small)]
    t_spec = time.perf_counter() - t0
    engine = core.CostEngine()
    batches, pack_s = {}, {}
    for shared in (False, True):
        t0 = time.perf_counter()
        batches[shared] = core.SystemBatch.from_systems(
            systems, share_nre=shared, device="cuda")
        torch.cuda.synchronize()
        pack_s[shared] = time.perf_counter() - t0
    print(f"[11] {n_small} specs built in {t_spec:.3f} s; packed on the host "
          f"and copied: share_nre=False {pack_s[False]:.3f} s, True "
          f"{pack_s[True]:.3f} s")

    picks = np.random.default_rng(seed).choice(n_small, 64, replace=False)
    small = {}
    for shared, b in batches.items():
        card = cost_fields(engine.total(b))
        cpu = cost_fields(engine.total(b.to("cpu")))
        err = hold(f"10k share_nre={shared}, card against CPU", card, cpu)
        ref = scalar_reference(core, systems, picks, shared)
        idx = torch.as_tensor(picks, device="cuda")
        err_ref = hold(f"10k share_nre={shared}, card against the scalar "
                       "path", {k: v[idx] for k, v in card.items()}, ref)
        print(f"[11] share_nre={shared}: ten fields, card against CPU, max "
              f"rel {err}; 64 seeded systems against the scalar path, "
              f"max rel {err_ref}")
        small[shared] = card
    b = batches[True]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.total(b).total
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("[11] CostEngine.total ran under sync debug mode 'error'")
    for shared, b in batches.items():
        first = cost_fields(engine.total(b))
        for call in range(1, 20):
            got = cost_fields(engine.total(b))
            for k, v in first.items():
                check(torch.equal(got[k], v), f"share_nre={shared}: call "
                      f"{call}'s {k} differs from the first call's")
    print("[11] CostEngine.total on the 10^4 batches, share_nre False and "
          "True: 20 calls each, every field bit-equal to the first call's")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    big = tile_batch(core, batches[False], reps)
    n_big = big.n_systems
    got = cost_fields(engine.total(big))
    want = {k: v.reshape(1, -1).expand(reps, -1)
            for k, v in small[False].items()}
    err = hold(f"{n_big} systems: every tile against the 10k result",
               {k: v.reshape(reps, -1) for k, v in got.items()}, want)
    print(f"[11] {n_big} systems ({reps} tiles of {n_small}, each its own "
          f"product group): every tile equals the 10k result, max rel "
          f"{err}")

    timing = {}
    for label, bb in (("1e4", batches[False]), ("1e6", big)):
        ms = median_event_ms(lambda: engine.total(bb).total)
        events, busy, top = device_busy(lambda: engine.total(bb).total)
        # the least bytes a call moves: every leaf read once, ten (N,)
        # float32 outputs written once
        nbytes = sum(getattr(bb, f).numel() * getattr(bb, f).element_size()
                     for f in core.SystemBatch._LEAVES) + 10 * 4 * bb.n_systems
        on_cpu = bb.to("cpu")
        engine.total(on_cpu).total                  # first call: allocations
        c_ms = cpu_ms(lambda: engine.total(on_cpu).total)
        timing[label] = {"systems": bb.n_systems, "card_ms": ms,
                         "device_events": events, "busy_ms": busy,
                         "bytes": nbytes,
                         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                         "cpu_ms": c_ms,
                         "card_systems_per_s": bb.n_systems / ms * 1e3,
                         "cpu_systems_per_s": bb.n_systems / c_ms * 1e3}
        print(f"[11] {bb.n_systems} systems, CostEngine.total: card "
              f"{ms:.4f} ms (median of 20, CUDA events), "
              f"{timing[label]['card_systems_per_s']:.4g} systems/s; CPU "
              f"{c_ms:.2f} ms (one call), "
              f"{timing[label]['cpu_systems_per_s']:.4g} systems/s; {smi}")
        print(f"[11] {bb.n_systems} systems: one call runs {events} device "
              f"events, busy {busy:.4f} ms of the {ms:.4f} ms; its "
              f"{nbytes / 1e6:.1f} MB read and written once take "
              f"{timing[label]['bound_ms']:.4f} ms at 3.35 TB/s; {smi}")
        print(f"[11] {bb.n_systems} systems: most busy time in " + "; ".join(
            f"{name[:60]} {ms_:.4f} ms" for name, ms_ in top))
        del on_cpu
    peak = torch.cuda.max_memory_allocated()
    print(f"[11] peak device memory from the 10^6 batch on: {peak / 2**20:.1f}"
          f" MiB; {smi}")
    timing["segment_sums"] = segment_sum_cost(engine, big, smi)
    del big, got, want
    gc.collect()
    torch.cuda.empty_cache()

    card_bp = core.best_partition("5nm", "MCM", 800.0, device="cuda")
    cpu_bp = core.best_partition("5nm", "MCM", 800.0, device="cpu")
    check(card_bp["best_n"] == cpu_bp["best_n"],
          f"best_partition: n {card_bp['best_n']} on the card, "
          f"{cpu_bp['best_n']} on the CPU")
    hold("best_partition", {k: card_bp[k] for k in ("best_cost", "soc_cost")},
         {k: cpu_bp[k] for k in ("best_cost", "soc_cost")})
    for process in FIG4_NODES:
        for integ in FIG4_INTEGRATIONS:
            card = core.sweep_partitions(process, integ, FIG4_AREAS, FIG4_NS,
                                         device="cuda")
            cpu = core.sweep_partitions(process, integ, FIG4_AREAS, FIG4_NS,
                                        device="cpu")
            hold(f"sweep_partitions {process} {integ}",
                 {"total": card["total"]}, {"total": cpu["total"]})
    t0 = time.perf_counter()
    card_opt = optimize_chiplet_count("5nm", "MCM", 800.0,
                                                    device="cuda")
    t_opt = time.perf_counter() - t0
    cpu_opt = optimize_chiplet_count("5nm", "MCM", 800.0,
                                                   device="cpu")
    check(card_opt.n_rounded == cpu_opt.n_rounded,
          f"optimize_chiplet_count: n {card_opt.n_rounded} on the card, "
          f"{cpu_opt.n_rounded} on the CPU")
    hold("optimize_chiplet_count", {"n": card_opt.n_relaxed},
         {"n": cpu_opt.n_relaxed}, rtol=1e-4)
    hold("optimize_chiplet_count costs",
         {k: getattr(card_opt, k) for k in ("cost_relaxed", "cost_rounded",
                                            "cost_soc")},
         {k: getattr(cpu_opt, k) for k in ("cost_relaxed", "cost_rounded",
                                           "cost_soc")})
    acc = core.AcceleratorSpec("acc")
    card_acc = core.price_accelerators(acc, device="cuda")
    cpu_acc = core.price_accelerators(acc, device="cpu")
    for label in cpu_acc:
        hold(f"price_accelerators {label}", card_acc[label], cpu_acc[label])
    print(f"[11] best_partition 5nm MCM 800 mm^2: n = {card_bp['best_n']}, "
          f"saving {card_bp['saving']:.4f}; sweep_partitions over Fig. 4's "
          f"{len(FIG4_NODES) * len(FIG4_INTEGRATIONS)} grids; "
          f"optimize_chiplet_count: n* = {card_opt.n_relaxed:.5f} -> "
          f"{card_opt.n_rounded} (CPU {cpu_opt.n_relaxed:.5f}), 300 steps "
          f"in {t_opt:.2f} s on the host clock; price_accelerators: "
          f"{len(card_acc)} candidates; all equal to the CPU's")
    summary = {"pack_s": {"share_nre_false": pack_s[False],
                          "share_nre_true": pack_s[True]},
               "timing": timing, "peak_mib": peak / 2**20,
               "optimize_s": t_opt, "card": smi}
    print("[11] " + json.dumps({"cost_model": summary}))
    return summary


# benchmarks/dse_bench.py's SPACE (a copy: that module imports the JAX
# package): 3 SKUs, 3 nodes, 2 integrations, chiplet counts 1-6, reuse with
# and without a shared package; 19,707 candidates, 59,121 systems.
DSE_SKUS = (("laptop", 300.0, 2e6), ("desktop", 600.0, 1e6),
            ("server", 900.0, 3e5))


def dse_space():
    from repro_torch import dse
    return dse.DesignSpace(
        skus=tuple(dse.SKU(*s) for s in DSE_SKUS),
        processes=("5nm", "7nm", "12nm"), integrations=("MCM", "2.5D"),
        chiplet_counts=(1, 2, 3, 4, 6), allow_reuse=True,
        reuse_package_options=(False, True))


def eval_fields(arrays) -> dict:
    """An EvalArrays' priced fields (risk stats included) by name."""
    out = {f: getattr(arrays, f) for f in ("sku_unit_total", "sku_unit_re",
                                           "sku_unit_nre", "portfolio_cost")}
    out.update({f"risk_{k}": v for k, v in (arrays.risk or {}).items()})
    return out


def same_arrays(label, a, b) -> None:
    for k, v in eval_fields(a).items():
        check(np.array_equal(v, eval_fields(b)[k]), f"{label}: {k} differs")


def tensor_bytes(*items) -> int:
    """Bytes of tensors, SystemBatches and dicts of tensors."""
    from repro_torch.core import SystemBatch
    n = 0
    for it in items:
        if isinstance(it, SystemBatch):
            it = [getattr(it, f) for f in SystemBatch._LEAVES]
        elif isinstance(it, dict):
            it = list(it.values())
        elif isinstance(it, torch.Tensor):
            it = [it]
        n += sum(t.numel() * t.element_size() for t in it)
    return n


def host_rate(fn, n: int) -> tuple:
    """(items/s, seconds) of one warm call of ``fn`` that ends on the host
    (it reads its results back), on the host clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return n / dt, dt


def phase_dse(seed: int, smi: str, card_dev: str = "cuda") -> dict:
    """Phase 12: the paper's design-space exploration (``repro_torch.dse``)
    on dse_bench's space, each step on the card held against the port on
    the CPU; throughputs and the DSE graphs' card times.  ``card_dev`` is
    the card; naming the CPU rehearses the phase's control flow, with
    both sides on the CPU."""
    from repro_torch import dse
    from repro_torch import random as prng
    from repro_torch.core import optimize_uneven_split
    from repro_torch.dse import evaluate as dse_eval
    from repro_torch.dse import search as dse_search
    from repro_torch.dse import space as dse_sp
    from repro_torch.dse import uncertainty as dse_unc
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    sp = dse_space()
    n = sp.size()
    check(n == 19707, f"dse_bench's space has {n} candidates, not 19707")
    idx = np.arange(n)
    chunk = 512
    card = dse.ChunkedEvaluator(sp, chunk, device=card_dev)
    cpu = dse.ChunkedEvaluator(sp, chunk, device="cpu")
    rates = {}

    # 1. every candidate, card against the CPU, twice on the card
    rates["fused_candidates_per_s"], t_sweep = host_rate(
        lambda: card.evaluate_indices(idx), n)
    got = card.evaluate_indices(idx)
    t0 = time.perf_counter()
    want = cpu.evaluate_indices(idx)
    t_cpu = time.perf_counter() - t0
    err = hold("fused sweep, card against CPU", eval_fields(got),
               eval_fields(want))
    same_arrays("a second fused sweep", card.evaluate_indices(idx), got)
    ex_card = dse.exhaustive_search(sp, evaluator=card)
    ex_cpu = dse.exhaustive_search(sp, evaluator=cpu)
    check(ex_card.best.label == ex_cpu.best.label,
          f"exhaustive winner {ex_card.best.label} on the card, "
          f"{ex_cpu.best.label} on the CPU")
    print(f"[12] {n} candidates ({n * len(sp.skus)} systems) in chunks of "
          f"{chunk}: card against CPU max rel {err}; a second sweep "
          f"bit-equal; exhaustive winner {ex_card.best.label} "
          f"(${ex_card.best.portfolio_cost:,.0f}) on both; one sweep "
          f"{t_sweep * 1e3:.2f} ms on the host clock, "
          f"{rates['fused_candidates_per_s']:.4g} candidates/s (CPU "
          f"{n / t_cpu:.4g}); {smi}")

    wide = 4096
    rates[f"fused_candidates_per_s_chunk_{wide}"], t_wide = host_rate(
        lambda: dse.ChunkedEvaluator(sp, wide, device=card_dev)
        .evaluate_indices(idx), n)
    print(f"[12] the same sweep in chunks of {wide}: {t_wide * 1e3:.2f} ms, "
          f"{rates[f'fused_candidates_per_s_chunk_{wide}']:.4g} candidates/s "
          f"on the host clock (8x fewer launches a candidate); {smi}")

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = card.dispatch_indices(idx)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    same_arrays("a sweep dispatched under sync debug mode",
                dse_eval._to_host(pending), got)
    print(f"[12] one sweep's {-(-n // chunk)} chunks dispatched under sync "
          "debug mode 'error'; its one copy back equals the sweep")

    # 2. Monte Carlo: 256 draws over 2,048 candidates
    mc_idx = np.sort(np.random.default_rng(seed).choice(n, 2048,
                                                        replace=False))
    mc = dict(mc_key=prng.PRNGKey(seed, "cpu"), mc_draws=256)
    rates["mc_candidates_per_s"], t_mc = host_rate(
        lambda: card.evaluate_indices(mc_idx, **mc), mc_idx.size)
    got_mc = card.evaluate_indices(mc_idx, **mc)
    err = hold("Monte Carlo, card against CPU", eval_fields(got_mc),
               eval_fields(cpu.evaluate_indices(mc_idx, **mc)))
    print(f"[12] Monte Carlo, 256 draws over {mc_idx.size} candidates: card "
          f"against CPU max rel {err}; {t_mc * 1e3:.2f} ms, "
          f"{rates['mc_candidates_per_s']:.4g} candidates/s on the host "
          f"clock; {smi}")

    # 3. the legacy host-packing evaluator: deterministic, and the fused
    #    path's prices at 1e-6
    leg_idx = idx[:chunk]
    legacy = dse.ChunkedEvaluator(sp, chunk, fused=False, device=card_dev)
    first = legacy.evaluate_indices_legacy(leg_idx)
    rates["legacy_candidates_per_s"], t_leg = host_rate(
        lambda: legacy.evaluate_indices_legacy(leg_idx), leg_idx.size)
    same_arrays("a second legacy run",
                legacy.evaluate_indices_legacy(leg_idx), first)
    err = hold("legacy against fused", {"pf": first.portfolio_cost},
               {"pf": got.portfolio_cost[:chunk]}, rtol=1e-6)
    print(f"[12] legacy evaluator over {chunk} candidates: three runs "
          f"bit-equal, against the fused prices max rel {err}; "
          f"{t_leg * 1e3:.1f} ms, {rates['legacy_candidates_per_s']:.4g} "
          f"candidates/s on the host clock; {smi}")

    # 4. the evolutionary search, nominal and at the q90 objective
    search_kw = dict(population=256, generations=8, elite=32)
    for label, risk in (("nominal", None),
                        ("q90", dse.RiskConfig(n_draws=256, quantile=0.9))):
        runs, secs = [], []
        for dev in (card_dev, "cpu"):
            ev = dse.ChunkedEvaluator(sp, chunk, device=dev)
            t0 = time.perf_counter()
            runs.append(dse.portfolio_search(
                sp, prng.PRNGKey(seed + 1, dev), risk=risk, evaluator=ev,
                **search_kw))
            secs.append(time.perf_counter() - t0)
        a, b = runs
        check(a.best.label == b.best.label and
              [h["best_label"] for h in a.history] ==
              [h["best_label"] for h in b.history] and
              [h["evaluated"] for h in a.history] ==
              [h["evaluated"] for h in b.history],
              f"{label} search: card and CPU histories differ")
        hold(f"{label} search objectives",
             {"best": [h["best_objective"] for h in a.history]},
             {"best": [h["best_objective"] for h in b.history]})
        rates[f"search_{label}_generations_per_s"] = \
            search_kw["generations"] / secs[0]
        print(f"[12] {label} portfolio_search, population 256, 8 "
              f"generations: winner {a.best.label} and history as on the "
              f"CPU; {a.n_evaluated} candidates priced; "
              f"{rates[f'search_{label}_generations_per_s']:.4g} "
              f"generations/s on the host clock, final sweep included (CPU "
              f"{search_kw['generations'] / secs[1]:.4g}); {smi}")

    # 5. the gradient partitioner
    args = ("5nm", "MCM", [300.0, 200.0, 100.0, 100.0, 100.0], 3)
    t0 = time.perf_counter()
    u_card = optimize_uneven_split(*args, device=card_dev)
    t_uneven = time.perf_counter() - t0
    u_cpu = optimize_uneven_split(*args, device="cpu")
    check(u_card["assignment"] == u_cpu["assignment"],
          f"uneven split: {u_card['assignment']} on the card, "
          f"{u_cpu['assignment']} on the CPU")
    hold("uneven split", {k: u_card[k] for k in ("soft_cost", "hard_cost")},
         {k: u_cpu[k] for k in ("soft_cost", "hard_cost")})
    print(f"[12] optimize_uneven_split: assignment {u_card['assignment']} "
          f"as on the CPU, 500 steps in {t_uneven:.2f} s on the host clock")

    # 6. the DSE graphs one at a time: card ms (CUDA events, median of 20)
    #    beside the bytes each must move once at 3.35 TB/s
    enc = sp.encoder()
    tables = enc.tables_on(card_dev)
    meta = enc.meta
    qty = torch.tensor([s_[2] for s_ in DSE_SKUS], dtype=torch.float32,
                       device=card_dev)
    cidx = torch.as_tensor(idx[:chunk], dtype=torch.int32, device=card_dev)
    key = prng.PRNGKey(seed, card_dev)
    sig = dse.Uncertainty().as_array(card_dev)
    batch = dse_sp.encode_arrays(tables, meta, cidx)
    pop = prng.randint(key, (256,), 0, n)
    graphs = {}

    def graph(name, fn, nbytes):
        ms = median_event_ms(fn)
        events, busy, _ = device_busy(fn)
        graphs[name] = {"ms": ms, "bytes": nbytes,
                        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                        "device_events": events, "busy_ms": busy}
        print(f"[12] {name}: {ms:.4f} ms (CUDA events, median of 20), "
              f"{events} device events busy {busy:.4f} ms "
              f"(torch.profiler); {nbytes / 1e6:.3f} MB once take "
              f"{graphs[name]['bound_ms']:.5f} ms; {smi}")

    tab_bytes = tensor_bytes(tables)
    graph("encode_arrays (512 candidates)",
          lambda: dse_sp.encode_arrays(tables, meta, cidx),
          tab_bytes + tensor_bytes(cidx, batch))
    nre = dse_sp.encoded_nre(tables, meta, cidx)
    graph("encoded_nre (512 candidates)",
          lambda: dse_sp.encoded_nre(tables, meta, cidx),
          tab_bytes + tensor_bytes(cidx) + 4 * tensor_bytes(nre.modules))
    out = dse_eval._chunk_impl(tables, cidx, qty, meta=meta,
                               flow="chip-last")
    graph("_chunk_impl (512 candidates)",
          lambda: dse_eval._chunk_impl(tables, cidx, qty, meta=meta,
                                       flow="chip-last"),
          tab_bytes + tensor_bytes(cidx, *[o for o in out if o is not None]))
    out = dse_eval._chunk_mc_impl(tables, cidx, qty, key, sig, meta=meta,
                                  flow="chip-last", n_draws=256,
                                  quantiles=(0.5, 0.9))
    graph("_chunk_mc_impl (512 candidates, 256 draws)",
          lambda: dse_eval._chunk_mc_impl(
              tables, cidx, qty, key, sig, meta=meta, flow="chip-last",
              n_draws=256, quantiles=(0.5, 0.9)),
          tab_bytes + tensor_bytes(cidx, *out[:4], out[4], out[5]))
    draws = dse_unc.mc_re_totals_impl(batch, key, sig, "chip-last", 256)
    graph("mc_re_totals_impl (1,536 systems, 256 draws)",
          lambda: dse_unc.mc_re_totals_impl(batch, key, sig, "chip-last",
                                            256),
          tensor_bytes(batch, draws))
    sens = dse_unc._sens_impl(batch, "chip-last", dse.SENSITIVITY_PARAMS)
    graph("_sens_impl (1,536 systems)",
          lambda: dse_unc._sens_impl(batch, "chip-last",
                                     dse.SENSITIVITY_PARAMS),
          tensor_bytes(batch, sens))
    for label, n_draws in (("nominal", 0), ("256 draws", 256)):
        step = functools.partial(
            dse_search._gen_step_impl, tables, key, pop, qty, key, sig,
            meta=meta, flow="chip-last", population=256, elite=32,
            jump_prob=0.15, n_draws=n_draws, quantile=0.9)
        res = step()
        graph(f"_gen_step_impl (population 256, {label})", step,
              tab_bytes + tensor_bytes(pop, res[1]) + 8)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    optimize_uneven_split(*args, device=card_dev)
    end.record()
    end.synchronize()
    graphs["gradient.py:125-126 (one descent step)"] = {
        "ms": start.elapsed_time(end) / 500, "bytes": None,
        "bound_ms": None}
    print(f"[12] optimize_uneven_split, one grad-and-step of 500: "
          f"{start.elapsed_time(end) / 500:.4f} ms (CUDA events around the "
          f"500 steps, divided by 500; its bytes are a few hundred); {smi}")
    bits_ms = median_event_ms(lambda: prng.random_bits(key, (10 ** 6,)))
    rates["random_bits_1e6_ms"] = bits_ms
    print(f"[12] random_bits of 10^6 words: {bits_ms:.4f} ms (CUDA events, "
          f"median of 20); its 8 MB of int64 words written once take "
          f"{8e6 / HBM_BYTES_PER_S * 1e3:.5f} ms; {smi}")

    launches = ops.launch_counts()
    check(not any(launches.values()),
          f"the DSE path launched kernels: {launches}")
    print(f"[12] kernel launches on the DSE path: {launches} (its graphs "
          f"are torch graphs; no TPU kernel is on this path)")
    summary = {"rates": rates, "graphs": graphs,
               "winner": ex_card.best.label, "card": smi}
    print("[12] " + json.dumps({"dse": summary}))
    return summary


# benchmarks/service_bench.py's full diet: 8 clients, each 4 sweeps of
# 2,048 rows and 4 point queries, plus a search, a Monte Carlo sweep, a
# what-if grid, a rank and a raw spec() group (clients 0-4), at chunk 128
SERVICE_CLIENTS = 8


def service_config(S, **kw):
    return S.ServiceConfig(
        chunk=128, split=32, warm_mc=((64, (0.5, 0.9)),),
        warm_search=(S.SearchWarmup(population=32, elite=8),),
        max_pending=10_000_000, **kw)


def service_diet(S, i: int, rng, size: int, sweeps: int = 4,
                 sweep_rows: int = 2048) -> list:
    """Client ``i``'s requests, as service_bench's ``_client_requests``
    makes them (deterministic in the seed)."""
    reqs = []
    for _ in range(sweeps):
        reqs.append(S.PriceRequest(
            indices=rng.integers(0, size, sweep_rows).tolist()))
        reqs.append(S.PriceRequest(indices=rng.integers(0, size, 4).tolist()))
    if i == 0:
        reqs.append(S.SearchRequest(seed=1, population=32, generations=8,
                                    elite=8))
    elif i == 1:
        reqs.append(S.MCRiskRequest(
            indices=rng.integers(0, size, 64).tolist(),
            mc=S.McSpec(draws=64, quantiles=(0.5, 0.9), seed=0)))
    elif i == 2:
        reqs.append(S.WhatIfRequest(base=int(rng.integers(0, size))))
    elif i == 3:
        reqs.append(S.RankRequest(indices=rng.integers(0, size, 128).tolist(),
                                  top_k=5))
    elif i == 4:
        reqs.append(S.PriceSystemsRequest(specs=(
            {"kind": "soc", "name": "soc_a", "area": 250.0,
             "process": "7nm", "quantity": 1e6},
            {"kind": "split", "name": "mcm_b", "area": 500.0,
             "process": "7nm", "n_chiplets": 2, "integration": "MCM",
             "quantity": 5e5},)))
    return reqs


def serve_diet(S, sp, cfg, dev, clients: int = SERVICE_CLIENTS,
               on_service=None):
    """Serve the diet of ``clients`` concurrent clients; returns (the
    requests, the responses in the same order, the wall from the first
    submission to the last answer, the stopped service)."""
    import asyncio

    size = sp.size()
    diets = [service_diet(S, i, np.random.default_rng(100 + i), size)
             for i in range(clients)]

    async def main():
        svc = S.PricingService(sp, cfg, device=dev)
        if on_service is not None:
            on_service(svc)
        await svc.start()                               # the warmup

        async def client(reqs):
            return [await svc.submit(r) for r in reqs]

        t0 = time.perf_counter()
        per_client = await asyncio.gather(*(client(r) for r in diets))
        wall = time.perf_counter() - t0
        await svc.stop()
        return per_client, wall, svc

    per_client, wall, svc = asyncio.run(main())
    return ([r for d in diets for r in d],
            [r for rs in per_client for r in rs], wall, svc)


def hold_response(label, got, want, rtol=ENGINE_RTOL) -> None:
    """One service response against another (card against CPU): prices,
    risk stats and what-if grids within ``rtol``, rank orders, search
    winners and histories equal."""
    check(got.ok and want.ok and got.kind == want.kind,
          f"{label}: {got.error} / {want.error}")
    a, b = got.result, want.result
    if got.kind in ("price", "mc_risk"):
        check(np.array_equal(a.idx, b.idx), f"{label}: indices differ")
        hold(label, eval_fields(a), eval_fields(b), rtol)
    elif got.kind == "rank":
        hold(label, {"values": a.values}, {"values": b.values}, rtol)
        if not np.array_equal(a.order, b.order):
            print(f"[13] {label}: rank orders differ; objectives "
                  f"{a.values.tolist()} / {b.values.tolist()}")
        check(np.array_equal(a.order, b.order), f"{label}: rank order")
    elif got.kind == "what_if":
        check([r["candidate"] for r in a.rows] ==
              [r["candidate"] for r in b.rows], f"{label}: what-if grid")
        hold(label, {"base": [a.base_cost],
                     "grid": [r["portfolio_cost"] for r in a.rows]},
             {"base": [b.base_cost],
              "grid": [r["portfolio_cost"] for r in b.rows]}, rtol)
    elif got.kind == "search":
        if a.best.label != b.best.label:
            print(f"[13] {label}: winners {a.best.label} "
                  f"({a.best.portfolio_cost}) / {b.best.label} "
                  f"({b.best.portfolio_cost})")
        check(a.best.label == b.best.label and
              [h["best_label"] for h in a.history] ==
              [h["best_label"] for h in b.history] and
              [h["evaluated"] for h in a.history] ==
              [h["evaluated"] for h in b.history] and
              [r.label for r in a.ranked] == [r.label for r in b.ranked],
              f"{label}: search winner or history differs")
        hold(label, {"history": [h["best_objective"] for h in a.history],
                     "ranked": [r.portfolio_cost for r in a.ranked]},
             {"history": [h["best_objective"] for h in b.history],
              "ranked": [r.portfolio_cost for r in b.ranked]}, rtol)
    else:
        hold(label, {k: [r[k] for r in a.rows]
                     for k in ("re_total", "nre_total", "total")},
             {k: [r[k] for r in b.rows]
              for k in ("re_total", "nre_total", "total")}, rtol)


def hold_direct(label, svc, req, resp, ev, search_kw) -> None:
    """A card response bit-equal to the port's direct API on the card:
    ``ChunkedEvaluator`` at the service's chunk shape and
    ``portfolio_search`` with that evaluator."""
    from repro_torch import dse
    from repro_torch import random as prng
    a = resp.result
    if resp.kind in ("price", "mc_risk"):
        kw = {}
        if req.mc is not None:
            kw = dict(mc_key=prng.PRNGKey(req.mc.seed, ev.device),
                      mc_draws=req.mc.draws,
                      mc_quantiles=req.mc.quantiles)
        same_arrays(label, a, ev.evaluate_indices(np.asarray(req.indices),
                                                  **kw))
    elif resp.kind == "rank":
        d = ev.evaluate_indices(np.asarray(req.indices))
        order = np.lexsort((d.idx, d.portfolio_cost))
        check(np.array_equal(a.order, d.idx[order]) and
              np.array_equal(a.values, d.portfolio_cost[order]),
              f"{label}: rank differs from the direct sweep")
    elif resp.kind == "what_if":
        idx = svc._what_if_grid(req)[0]
        d = ev.evaluate_indices(idx).portfolio_cost
        check(a.base_cost == float(d[0]) and
              [r["portfolio_cost"] for r in a.rows] ==
              [float(x) for x in d[1:]],
              f"{label}: what-if differs from the direct sweep")
    elif resp.kind == "search":
        ds = dse.portfolio_search(
            svc.space, prng.PRNGKey(req.seed, ev.device),
            population=req.population, generations=req.generations,
            elite=req.elite, evaluator=ev, **search_kw)
        check(a.history == ds.history and
              [r.label for r in a.ranked] == [r.label for r in ds.ranked]
              and [r.portfolio_cost for r in a.ranked] ==
              [r.portfolio_cost for r in ds.ranked],
              f"{label}: search differs from portfolio_search")


def phase_service(seed: int, smi: str, card_dev: str = "cuda") -> dict:
    """Phase 13: the pricing service (``repro_torch.service``) on
    dse_bench's space, service_bench's full diet served on the card and on
    the CPU.  ``card_dev`` is the card; naming the CPU rehearses the
    phase's control flow, with both sides on the CPU."""
    import asyncio
    import shutil

    from repro_torch import dse
    from repro_torch import service as S
    from repro_torch.kernels import ops
    from repro_torch.obs import torchhooks
    from repro_torch.resilience import FaultInjector

    ops.reset_launch_counts()
    sp = dse_space()
    size = sp.size()
    cfg = service_config(S)
    chunk = cfg.chunk

    # the single-client fused rate at chunk 128 (service_bench's yardstick)
    ev = dse.ChunkedEvaluator(sp, chunk, device=card_dev)
    idx = np.random.default_rng(seed).integers(0, size, 4 * 2048)
    single, _ = host_rate(lambda: ev.evaluate_indices(idx), idx.size)

    # 1. the diet on the card (each tick's dispatch under sync debug mode
    #    "error", the one copy excepted) and on the CPU
    real_to_host = torchhooks.to_host

    def copy_outside_debug(tree):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real_to_host(tree)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    def under_debug(svc):
        tick = svc._tick

        def checked():
            torch.cuda.set_sync_debug_mode("error")
            torchhooks.to_host = copy_outside_debug
            try:
                return tick()
            finally:
                torchhooks.to_host = real_to_host
                torch.cuda.set_sync_debug_mode(0)

        svc._tick = checked

    reqs, card, wall, svc = serve_diet(S, sp, cfg, card_dev)
    _, debug, _, dsvc = serve_diet(S, sp, cfg, card_dev, clients=5,
                                   on_service=under_debug)
    check(all(r.ok for r in debug), "a tick under sync debug mode failed")
    t0 = time.perf_counter()
    _, cpu, cpu_wall, cpu_svc = serve_diet(S, sp, cfg, "cpu")
    t_cpu = time.perf_counter() - t0
    bad = [r for r in card + cpu if not r.ok]
    check(not bad, f"{len(bad)} requests failed: {bad[:1]}")
    for j, (a, b) in enumerate(zip(card, cpu)):
        hold_response(f"request {j} ({a.kind}), card against CPU", a, b)
    for j, (req, r) in enumerate(zip(reqs, card)):
        if r.kind != "price_systems":
            hold_direct(f"request {j} ({r.kind}) against the direct API",
                        svc, req, r, ev, {})
    snap, dsnap = svc.snapshot(), dsvc.snapshot()
    for label, sn in (("card", snap), ("sync-debug", dsnap),
                      ("CPU", cpu_svc.snapshot())):
        check(sn["device_gets"] == sn["ticks"],
              f"{label}: {sn['device_gets']} copies in {sn['ticks']} ticks")
        check(sn["recompiles_after_warmup"] == 0,
              f"{label}: {sn['recompiles_after_warmup']} first calls in "
              "ticks")
    check(snap["ticks_by_lane"] == cpu_svc.snapshot()["ticks_by_lane"],
          "card and CPU ticked different lanes")
    led = snap["ledger"]
    check(led["open"] == 0 and led["tick_residual_rel_max"] <= 0.05 and
          led["unattributed_ms"] == 0.0, f"ledger: {led}")
    check(all(r.trace_id and r.bill and r.bill["status"] == "ok"
              for r in card), "a response lacks a trace id or closed bill")
    agg = snap["rows_priced"] / wall
    ratio = agg / single
    lat = snap["latency_s"]
    cpu_rate = cpu_svc.snapshot()["rows_priced"] / cpu_wall
    winner = next(r for r in card if r.kind == "search").result.best.label
    print(f"[13] service_bench's diet, {SERVICE_CLIENTS} clients, "
          f"{len(card)} requests, {snap['rows_priced']} rows in "
          f"{snap['ticks']} ticks {snap['ticks_by_lane']}: every response "
          f"ok, card against CPU at 1e-5 (same search winner {winner} and "
          f"history), bit-equal to the direct APIs on the card; "
          f"{snap['device_gets']} copies, 0 first calls in ticks; "
          f"{dsnap['ticks']} ticks of 5 clients under sync debug mode "
          f"'error'")
    print(f"[13] card: {agg:.6g} candidates/s aggregate over {wall:.4f} s "
          f"(host clock), {ratio:.4f}x the single-client fused rate "
          f"{single:.6g} at chunk {chunk}; latency p50 "
          f"{lat['p50'] * 1e3:.3f} ms, p95 {lat['p95'] * 1e3:.3f} ms, p99 "
          f"{lat['p99'] * 1e3:.3f} ms; padded-slot waste "
          f"{snap['padded_waste_frac']:.4f}; busy in ticks "
          f"{snap['busy_s']:.4f} s; CPU {cpu_rate:.6g} candidates/s "
          f"({t_cpu:.1f} s); {smi}")
    check(ratio >= 0.5, f"coalesced rate {agg:.0f} is {ratio:.3f}x the "
          f"single-client rate {single:.0f} (service_bench needs >= 0.5x)")

    # 2. the card's busy share of chunk ticks: 16 one-chunk price requests
    #    in a row, device time (torch.profiler) over the ticks' wall
    bsvc = S.PricingService(sp, service_config(S, result_cache_entries=0),
                            device=card_dev)
    bsvc.warmup()
    rng = np.random.default_rng(seed + 1)

    def sixteen_ticks():
        async def main():
            await bsvc.start()
            for _ in range(16):
                r = await bsvc.submit(S.PriceRequest(
                    indices=rng.integers(0, size, chunk).tolist()))
                check(r.ok, f"busy run: {r.error}")
            await bsvc.stop()
        asyncio.run(main())

    sixteen_ticks()                                     # warm
    busy0 = bsvc.metrics.per_lane["chunk"].busy_s
    sixteen_ticks()                                     # unprofiled
    tick_ms = (bsvc.metrics.per_lane["chunk"].busy_s - busy0) / 16 * 1e3
    events, busy_ms, top = device_busy(sixteen_ticks)
    busy_ms /= 16
    share = busy_ms / tick_ms if tick_ms else 0.0
    top = [(name[:48], round(ms / 16, 4)) for name, ms in top]
    print(f"[13] 16 chunk ticks: {tick_ms:.4f} ms a tick on the host clock "
          f"(unprofiled), the card busy {busy_ms:.4f} ms a tick "
          f"({events // 16} device events; torch.profiler, 16 more ticks), "
          f"a busy share of {share:.4f}; most busy ms a tick in {top}; "
          f"{smi}")

    # 3. a seeded chaos schedule on the card: typed envelopes, ok rows
    #    bit-equal to the oracle their provenance names
    chaos = ("seed=13;dispatch_error:p=0.4;poison:p=0.35,n=2;"
             "flood:p=0.25,n=2;recompile:p=0.5,n=1")
    ccfg = service_config(S, breaker_cooldown_s=0.05,
                          result_cache_entries=0)
    crng = np.random.default_rng(7)
    batches = [crng.integers(0, size, 8).tolist() for _ in range(12)]

    async def chaos_run():
        s_ = S.PricingService(sp, ccfg, device=card_dev)
        s_.faults = FaultInjector(chaos)
        await s_.start()
        out = await asyncio.gather(
            *(s_.submit(S.PriceRequest(indices=b)) for b in batches))
        await s_.stop()
        return out, s_

    resps, csvc = asyncio.run(chaos_run())
    legacy = dse.ChunkedEvaluator(sp, chunk, fused=False, device=card_dev)
    codes, n_ok = [], 0
    for b, r in zip(batches, resps):
        codes.append("ok" if r.ok else r.error.code)
        if not r.ok:
            check(r.error.code in (S.QUEUE_FULL, S.NUMERICAL_ERROR),
                  f"chaos: untyped failure {r.error}")
            continue
        n_ok += 1
        mask = r.degraded_rows if r.degraded else np.zeros(len(b), bool)
        fused = ev.evaluate_indices(np.asarray(b))
        old = legacy.evaluate_indices_legacy(np.asarray(b)) \
            if mask.any() else None
        for j in range(len(b)):
            src = old if mask[j] else fused
            check(np.array_equal(r.result.sku_unit_total[j],
                                 src.sku_unit_total[j]),
                  f"chaos: row {j} differs from its oracle")
    cres = csvc.snapshot()["resilience"]
    check(n_ok >= 1 and cres["loop_errors"] == 0 and
          csvc.sched.pending_rows == 0, f"chaos: {cres}")
    print(f"[13] chaos schedule '{chaos}': outcomes {codes}; faults fired "
          f"{cres['faults']['fired']}; ok rows bit-equal to the fused or "
          f"legacy oracle their provenance names")

    # the poison fault writes NaN into a row of the tick's host copy: its
    # owner alone fails, the coalesced sibling stays bit-equal
    pair = [list(range(40)), list(range(1000, 1040))]

    async def poison_run():
        s_ = S.PricingService(sp, ccfg, device=card_dev)
        s_.faults = FaultInjector("seed=3;poison:p=1.0,n=1")
        await s_.start()
        out = await asyncio.gather(
            *(s_.submit(S.PriceRequest(indices=b)) for b in pair))
        await s_.stop()
        return out

    poisoned = asyncio.run(poison_run())
    check(sorted((r.ok, r.error.code if r.error else "") for r in poisoned)
          == [(False, S.NUMERICAL_ERROR), (True, "")],
          f"poison: {[r.error for r in poisoned]}")
    for b, r in zip(pair, poisoned):
        if r.ok:
            same_arrays("poison's sibling", r.result,
                        ev.evaluate_indices(np.asarray(b)))
    print("[13] poison fault: its owner failed with numerical_error, the "
          "coalesced sibling bit-equal to the direct sweep")

    # 4. a crash and its journal replay, on the card
    jdir = os.path.join(ROOT, "build", "service_journal")
    shutil.rmtree(jdir, ignore_errors=True)
    dcfg = service_config(S, durability=S.DurabilityConfig(
        directory=jdir, checkpoint_every=2))
    crash_reqs = [S.PriceRequest(indices=list(range(300))),
                  S.MCRiskRequest(indices=[5, 50, 500], mc=S.McSpec(
                      draws=64, quantiles=(0.5, 0.9), seed=3)),
                  S.SearchRequest(seed=2, population=32, generations=8,
                                  elite=8),
                  S.RankRequest(indices=list(range(0, 2000, 7)), top_k=3)]
    clean, _ = S.serve(sp, crash_reqs, service_config(S), device=card_dev)

    async def crash_and_replay():
        s_ = S.PricingService(sp, dcfg, device=card_dev)
        await s_.start()
        s_.faults = FaultInjector("seed=1;crash:p=0.3,n=1")
        crashed = await asyncio.gather(*(s_.submit(r) for r in crash_reqs))
        await s_.stop()
        s_.faults = FaultInjector("")
        await s_.start()
        replayed = await s_.drain_replayed()
        await s_.stop()
        return crashed, replayed, s_

    crashed, replayed, rsvc = asyncio.run(crash_and_replay())
    dur = rsvc.snapshot()["durability"]
    by_trace = {r.trace_id: r for r in replayed}
    for c, want, req in zip(crashed, clean, crash_reqs):
        got = c if c.ok else by_trace.get(c.trace_id)
        check(got is not None and got.ok, f"crash: {req.kind} lost")
        hold_response(f"crash replay ({req.kind})", got, want, rtol=0.0)
    shutil.rmtree(jdir, ignore_errors=True)
    print(f"[13] crash fault ({dur['crashes']} crash): "
          f"{sum(not c.ok for c in crashed)} requests cut, "
          f"{dur['journal_replayed']} replayed from the journal "
          f"({dur['checkpoints_restored']} search restored from its "
          f"checkpoint), every answer equal to an uncrashed run's")

    launches = ops.launch_counts()
    check(not any(launches.values()),
          f"the service path launched kernels: {launches}")
    print(f"[13] kernel launches on the service path: {launches}")
    summary = {"agg_candidates_per_s": agg, "single_client_per_s": single,
               "vs_single_client": ratio, "latency_s": lat,
               "ticks_by_lane": snap["ticks_by_lane"],
               "padded_waste_frac": snap["padded_waste_frac"],
               "tick_ms": tick_ms, "tick_busy_ms": busy_ms,
               "busy_share": share, "wall_s": wall,
               "cpu_candidates_per_s": cpu_rate,
               "chaos": codes, "card": smi}
    print("[13] " + json.dumps({"service": summary}))
    return summary


# Phase 14, training: full-width glm4_9b at 8 of its 40 layers, 2.2524 B
# parameters.  The fp32 param, master, m, v and gradient (20 bytes a
# parameter, 45 GB) fit the 80 GB card beside the logits of a 4 x 512 batch
# (1.24 GB each for the logits, their softmax and their gradient).
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 4, 512, 6


def train_launches(cfg, steps: int) -> dict:
    """Kernel launches ``steps`` train steps of a dense model imply: one
    flash attention a block in the forward and one in its remat recompute
    (``cfg.remat`` "full"); the encoder-decoder's are its encoder layers'
    self-attention and its decoder layers' self- and cross-attention.  The
    norms, and every other kernel, are plain on the training route."""
    from repro_torch.kernels import ops
    want = {k: 0 for k in ops.launch_counts()}
    attn = cfg.n_layers + 2 * cfg.n_dec_layers if cfg.family == "encdec" \
        else cfg.n_layers
    want["flash_attention"] = 2 * attn * steps
    return want


def to_dev(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def train_cut(cfg, seed, card_dev, batch=None) -> dict:
    """14(a), and 20's 2 + 2-layer whisper_medium: the same parameters and
    batch (1 x 128 tokens unless ``batch``, a dict of numpy arrays, is
    given) on the card and on the CPU: loss within 1e-4 relative, each
    gradient leaf within 1e-3 of its max |g|, and one AdamW update from the
    same gradient tree within 1e-6 of each leaf's max."""
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.common import count_params, init_params
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.parallel.steps import loss_and_grads
    from repro_torch.tree import leaves, tree_map
    loss_fn = api.loss_fn(cfg)
    p_card = init_params(api.param_spec(cfg), torch.Generator(
        device=card_dev).manual_seed(seed), card_dev)
    p_cpu = tree_map(lambda t: t.to("cpu", copy=True), p_card)
    if batch is None:
        batch = synthetic_batch(DataConfig(seq_len=128, global_batch=1,
                                           vocab=cfg.vocab, seed=seed), 0)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    l_card, g_card = loss_and_grads(loss_fn, p_card, to_dev(batch, card_dev))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launched = ops.launch_counts()
    l_cpu, g_cpu = loss_and_grads(loss_fn, p_cpu, to_dev(batch, "cpu"))
    t2 = time.perf_counter()
    if card_dev == "cuda":
        check(launched == train_launches(cfg, 1), f"a loss and its "
              f"gradients launched {launched}, not {train_launches(cfg, 1)}")
    rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    check(math.isfinite(float(l_card)) and rel <= 1e-4,
          f"card loss {float(l_card)} against the CPU's {float(l_cpu)}")
    g_worst = 0.0
    for a, b in zip(leaves(g_card), leaves(g_cpu), strict=True):
        err = ((a.cpu() - b).abs().max() / b.abs().max()).item()
        g_worst = max(g_worst, err)
        check(err <= 1e-3, f"a gradient leaf {tuple(b.shape)} is off the "
                           f"CPU's by {err} of its max |g|")
    # one AdamW update from the CPU's gradient tree, on both
    outs = []
    for dev, params in ((card_dev, p_card), ("cpu", p_cpu)):
        grads = tree_map(lambda t: t.to(dev), g_cpu)
        outs.append(adamw_update(grads, adamw_init(params), 3e-4,
                                 param_dtype=torch.float32))
    (np_card, st_card), (np_cpu, st_cpu) = outs
    u_worst = 0.0
    for a, b in zip(leaves((np_card, st_card.m, st_card.v)),
                    leaves((np_cpu, st_cpu.m, st_cpu.v)), strict=True):
        err = ((a.cpu() - b).abs().max() / b.abs().max()).item()
        u_worst = max(u_worst, err)
        check(err <= 1e-6, f"the AdamW update of a leaf {tuple(b.shape)} "
                           f"is off the CPU's by {err} of its max")
    print(f"  {cfg.n_layers}-layer {cfg.name} (d_model {cfg.d_model}, "
          f"{count_params(api.param_spec(cfg)) / 1e9:.4f} B params), "
          f"batch {({k: v.shape for k, v in batch.items()})}: loss card {float(l_card):.6f} cpu "
          f"{float(l_cpu):.6f} (rel {rel:.2e}); worst gradient leaf "
          f"{g_worst:.2e} of its max |g|; one AdamW update, worst leaf "
          f"{u_worst:.2e} of its max; launches {launched}; card "
          f"{t1 - t0:.2f} s, cpu {t2 - t1:.2f} s")
    return {"loss_rel": rel, "grad_worst": g_worst, "update_worst": u_worst}


def train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one train step (forward and backward, the remat
    recompute not counted): 6 a token for each weight that multiplies (all
    but the norm scales; the tied table once, as the output layer) and, a
    layer, 3 x 2 causal-halved attention products of 2 B S^2 H D each."""
    n_mult = n_params - (2 * cfg.n_layers + 1) * cfg.d_model
    attn = 3 * cfg.n_layers * 2 * 2 * batch * seq * seq * cfg.n_heads \
        * cfg.dh / 2
    return 6 * n_mult * batch * seq + attn


def train_full(cfg, seed, card_dev, batch, seq, steps) -> dict:
    """14(b): ``steps`` train steps through ``parallel.steps`` at the
    launcher's lr, warmup and schedule, each from launch counts of 0, on
    the host clock (synchronised); then one more step under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.common import count_params
    from repro_torch.parallel import steps as st
    n_params = count_params(api.param_spec(cfg))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = st.init_train_state(cfg, torch.Generator(
        device=card_dev).manual_seed(seed), card_dev)
    torch.cuda.synchronize()
    print(f"  {cfg.name} (d_model {cfg.d_model}), {cfg.n_layers} layers: "
          f"{n_params / 1e9:.4f} B params, {20 * n_params / 1e9:.1f} GB of "
          f"fp32 param, master, m, v and gradient; state made in "
          f"{time.perf_counter() - t0:.1f} s; batch {batch} x {seq}")
    step_fn = st.make_train_step(cfg, base_lr=3e-4,
                                 warmup=min(20, steps // 10 + 1),
                                 total_steps=steps)
    dc = DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab,
                    seed=seed)
    want = train_launches(cfg, 1)
    times, losses, total = [], [], {k: 0 for k in want}
    for i in range(steps):
        b = to_dev(synthetic_batch(dc, i), card_dev)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launched = ops.launch_counts()
        total = {k: total[k] + launched[k] for k in total}
        losses.append(loss)
        print(f"  step {i + 1}: loss {loss:.6f}, lr "
              f"{float(metrics['lr']):.3e}, {times[-1]:.1f} ms, launches "
              f"{launched}")
        check(math.isfinite(loss), f"step {i + 1}: loss {loss}")
        if card_dev == "cuda":
            check(launched == want, f"step {i + 1} launched {launched}, "
                                    f"not {want}")
    med = float(np.median(times))
    tokens = batch * seq
    b = to_dev(synthetic_batch(dc, steps), card_dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = step_fn(state, b)
        check(math.isfinite(float(metrics["loss"])), "the profiled step's "
                                                     "loss is not finite")
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.device_time_total)
    busy = sum(us for _, us in by_name.values()) / 1e3
    fa = [(n, us) for name, (n, us) in by_name.items()
          if DEVICE_NAMES["flash_attention"] in name]
    fa_n, fa_ms = sum(n for n, _ in fa), sum(us for _, us in fa) / 1e3
    flops = train_flops(cfg, n_params, batch, seq)
    peak = torch.cuda.max_memory_allocated() / 1e9
    share = 100 * busy / med if med else 0.0
    print(f"  median step {med:.1f} ms of {steps} (host clock, "
          f"synchronised; min {min(times):.1f}, max {max(times):.1f}), "
          f"{tokens / med * 1e3:.1f} tokens/s")
    print(f"  one more step under torch.profiler: device busy {busy:.1f} ms "
          f"= {share:.1f}% of the median step, "
          f"{sum(n for n, _ in by_name.values())} device events; "
          f"flash_attention {fa_n} kernels, {fa_ms:.2f} ms = "
          f"{100 * fa_ms / busy if busy else 0.0:.2f}% of the busy time")
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:10]:
        print(f"    {us / 1e3:9.2f} ms  {n:6d}  {name[:90]}")
    print(f"  peak memory {peak:.2f} GB (torch.cuda.max_memory_allocated); "
          f"model FLOPs {flops / 1e12:.2f} T a step (6 a token a "
          f"multiplying weight + causal attention, no recompute) over the "
          f"median step = {flops / med / 1e9:.1f} TFLOP/s, "
          f"{100 * flops / med / 1e9 / (PEAK_FLOPS[torch.float32] / 1e12):.1f}"
          f"% of the card's fp32 (non-tensor-core) peak of 67 TFLOP/s "
          f"(H100 SXM data sheet; TF32 is off)")
    return {"losses": losses, "step_ms": times, "median_ms": med,
            "tokens_per_s": tokens / med * 1e3, "busy_ms": busy,
            "busy_share": share, "flash_attention_ms": fa_ms,
            "flash_attention_kernels": fa_n, "peak_gb": peak,
            "model_tflops": flops / 1e12, "launches": total}


def train_launcher(seed, card_dev, smoke: bool) -> dict:
    """14(c): ``launch.train.main`` for xlstm_125m with a checkpoint
    directory: a first call to step 8 (checkpoints at 4 and 8), a second
    to step 12, which must resume from step 8; both return 0."""
    import contextlib
    import io
    import shutil
    from repro_torch.launch import train
    ckpt = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    args = ["--arch", "xlstm_125m", "--ckpt-dir", ckpt, "--ckpt-every",
            "4", "--device", card_dev, "--seed", str(seed)] + \
        (["--smoke", "--batch", "2", "--seq", "32"] if smoke else [])
    outs, rcs = [], []
    for steps in (8, 12):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rcs.append(train.main(args + ["--steps", str(steps)]))
        outs.append(buf.getvalue())
        print("\n".join("    " + line for line in outs[-1].splitlines()))
        print(f"  the call to step {steps} returned {rcs[-1]} in "
              f"{time.perf_counter() - t0:.1f} s")
        if steps == 8:
            saved = sorted(p for p in os.listdir(ckpt)
                           if p.startswith("step_"))
            check(saved == ["step_00000004", "step_00000008"],
                  f"checkpoints after the first call: {saved}")
    shutil.rmtree(ckpt, ignore_errors=True)
    check(rcs == [0, 0], f"the launcher returned {rcs}")
    check(f"[resume] restored step 8 from {ckpt}" in outs[1],
          "the second call did not resume from step 8")
    return {"returns": rcs}


def train_resume(cfg, seed, card_dev) -> float:
    """14(c): tests/test_substrate.py's resume property on the card: 6 steps
    straight equal 3, save, restore, 3, at 1e-6."""
    import shutil
    from repro_torch.checkpoint import restore, save
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.parallel import steps as st
    from repro_torch.tree import leaves
    step = st.make_train_step(cfg, total_steps=6)
    dc = DataConfig(seq_len=64, global_batch=2, vocab=cfg.vocab, seed=seed)

    def fresh():
        return st.init_train_state(cfg, torch.Generator(
            device=card_dev).manual_seed(seed), card_dev)

    def run(state, lo, hi):
        for s in range(lo, hi):
            state, _ = step(state, to_dev(synthetic_batch(dc, s), card_dev))
        return state
    straight = run(fresh(), 0, 6)
    half = run(fresh(), 0, 3)
    ckpt = os.path.join(ROOT, "build", "train_resume")
    save(ckpt, 3, half)
    resumed = run(restore(ckpt, 3, fresh()), 3, 6)
    shutil.rmtree(ckpt, ignore_errors=True)
    worst = 0.0
    for a, b in zip(leaves(straight.params), leaves(resumed.params),
                    strict=True):
        worst = max(worst, (a - b).abs().max().item())
        check(torch.allclose(a, b, atol=1e-6, rtol=1e-6),
              f"a resumed leaf {tuple(a.shape)} is off the straight run by "
              f"{(a - b).abs().max().item()}")
    print(f"  resume property ({cfg.name}, 2 x 64 tokens): 6 steps straight "
          f"against 3 + save + restore + 3, worst |diff| {worst:.3e} "
          f"(atol = rtol = 1e-6)")
    return worst


def phase_train(seed: int, smi: str, card_dev: str = "cuda",
                smoke: bool = False) -> dict:
    """Phase 14: training through the port's trainer (``parallel.steps``,
    ``launch.train``) on the card: (a) a full-width 2-layer glm4_9b against
    the CPU, (b) full-width glm4_9b at 8 layers for 6 steps, (c) the
    launcher's run and resume of xlstm_125m and the resume property.
    ``card_dev`` is the card; naming the CPU with ``smoke`` rehearses the
    phase's control flow on the reduced configs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    glm = get_config("glm4_9b")
    xl = get_config("xlstm_125m")
    if smoke:
        glm, xl = glm.reduced(), xl.reduced()
    glm = glm.replace(dtype="float32", attn_impl="kernel")
    xl = xl.replace(dtype="float32", attn_impl="kernel")
    layers, batch, seq = (TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ) if not smoke \
        else (glm.n_layers, 2, 64)
    out = {"card": smi}
    out["cut"] = train_cut(glm.replace(n_layers=2), seed, card_dev)
    gc.collect()
    torch.cuda.empty_cache()
    out["full"] = train_full(glm.replace(n_layers=layers), seed, card_dev,
                             batch, seq, TRAIN_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    out["launcher"] = train_launcher(seed, card_dev, smoke)
    out["resume_worst"] = train_resume(xl, seed, card_dev)
    launched = ops.launch_counts()
    check(not any(launched.values()), f"the xlstm_125m runs launched "
                                      f"{launched}")
    summary = {k: v for k, v in out["full"].items() if k != "step_ms"}
    print("[14] " + json.dumps({"train": {"cut": out["cut"],
                                          "full": summary,
                                          "resume_worst": out["resume_worst"],
                                          "card": smi}}))
    return out


# this slice's served paths: the MLA dense model, the VLM, the
# encoder-decoder
VLM_TEXT, VLM_STEPS = 192, 32
WHISPER_BATCH, WHISPER_STEPS = 4, 64


def vlm_image_request(cfg, params, text=VLM_TEXT) -> dict:
    """Phase 18's first part: one ``api.prefill_fn`` request with all
    ``n_img_patches`` patch embeddings (drawn from a seed) and a
    ``text``-token prompt, then ``VLM_STEPS`` greedy ``api.decode_fn``
    steps, from launch counts of 0, on the device of ``params``; every
    logit finite and the launches what the structure implies (on the
    card).  Returns the launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import api
    dev = params["embed"]["embedding"].device
    rng = np.random.default_rng(11)
    img = torch.from_numpy(rng.standard_normal(
        (1, cfg.n_img_patches, cfg.d_model)).astype(np.float32)).to(dev)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (1, text)),
                             device=dev)
    s = cfg.n_img_patches + text
    prefill = api.prefill_fn(cfg, s + 256)
    decode = api.decode_fn(cfg)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens, "img_embeds": img})
    torch.cuda.synchronize()
    t_prefill = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(logits[:, :cfg.vocab]).all()),
          "the image prefill's logits are not finite")
    kv = torch.tensor([s], dtype=torch.int32, device=dev)
    times, out = [], []
    for _ in range(VLM_STEPS):
        tok = logits.argmax(dim=-1, keepdim=True)
        out.append(int(tok))
        t0 = time.perf_counter()
        logits, cache = decode(params, tok, cache, kv)
        kv += 1
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(logits[:, :cfg.vocab]).all()),
              "a decode step's logits are not finite")
    launched = ops.launch_counts()
    want = structure_launches(cfg, 1, VLM_STEPS)
    check(dev.type != "cuda" or launched == want,
          f"the image request launched {launched}, the structure implies "
          f"{want}")
    check(all(0 <= t < cfg.vocab for t in out), f"bad tokens {out}")
    print(f"  one request of {cfg.n_img_patches} image patches + "
          f"{text} tokens (S = {s}, cache {s + 256}): prefill "
          f"{t_prefill:.1f} ms (host clock, synchronised), {VLM_STEPS} "
          f"decode steps p50 {sorted(times)[len(times) // 2]:.2f} ms; "
          f"tokens {out[:8]}...; launches {launched}")
    return launched


def greedy_api(cfg, params, batch, steps, kv0):
    """``api.prefill_fn`` of ``batch`` and ``steps`` greedy
    ``api.decode_fn`` steps from a fill of ``kv0``: the logits of each on
    the host, the tokens, and each step's host ms (synchronised)."""
    from repro_torch.models import api
    dev = params["embed"]["embedding"].device
    logits, cache = api.prefill_fn(cfg, cfg.dec_len)(params, batch)
    b = logits.shape[0]
    kv = torch.full((b,), kv0, dtype=torch.int32, device=dev)
    decode = api.decode_fn(cfg)
    out_logits, out_tokens, times = [logits.cpu()], [], []
    for _ in range(steps):
        tok = logits.argmax(dim=-1, keepdim=True)
        out_tokens.append(tok[:, 0].tolist())
        t0 = time.perf_counter()
        logits, cache = decode(params, tok, cache, kv)
        kv += 1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        out_logits.append(logits.cpu())
    return out_logits, out_tokens, times, cache


def whisper_cfg(smoke=False, **kw):
    """whisper_medium in fp32 through the kernels (``smoke``: the reduced
    config, for a rehearsal on the CPU); its frames: 1500, 30 s of audio
    (32 for the reduced config)."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper_medium")
    cfg = cfg.reduced() if smoke else cfg
    return cfg.replace(dtype="float32", attn_impl="kernel", **kw), \
        32 if smoke else 1500


def phase_whisper_cut(seed, card_dev="cuda", smoke=False):
    """Phase 19: whisper_medium at full width cut to 2 + 2 layers, the
    same weights and 1500 frames on the card and on the CPU: a BOS
    prefill and 8 greedy decode steps through the API.  ``card_dev``
    "cpu" with ``smoke`` rehearses it on the reduced config."""
    from repro_torch.models import api
    from repro_torch.models.common import init_params
    from repro_torch.tree import tree_map
    cfg, n_frames = whisper_cfg(smoke, n_layers=2, n_dec_layers=2)
    p_gpu = init_params(api.param_spec(cfg), torch.Generator(
        device=card_dev).manual_seed(seed), card_dev)
    p_cpu = tree_map(lambda t: t.to("cpu", copy=True), p_gpu)
    frames = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, n_frames, cfg.d_model)).astype(np.float32))
    t0 = time.perf_counter()
    gl, gt, _, _ = greedy_api(cfg, p_gpu, {"frames": frames.to(card_dev)},
                              8, 1)
    t1 = time.perf_counter()
    cl, ct, _, _ = greedy_api(cfg, p_cpu, {"frames": frames}, 8, 1)
    t2 = time.perf_counter()
    worst = 0.0
    for i, (g, c) in enumerate(zip(gl, cl)):
        g, c = g[..., :cfg.vocab], c[..., :cfg.vocab]
        check(bool(torch.isfinite(g).all()), f"step {i}: non-finite logits")
        rel = ((g - c).abs().max() / c.abs().max()).item()
        worst = max(worst, rel)
        check(rel <= 1e-3, f"step {i}: card logits off the CPU's by {rel} of "
                           f"max |logit|")
    check(gt == ct, f"greedy tokens differ: card {gt} cpu {ct}")
    print(f"  2 + 2-layer full-width whisper_medium: {n_frames} frames, BOS "
          f"prefill + 8 decode steps, worst |card - cpu| / max|logit| = "
          f"{worst:.3e}, tokens equal ({[t[0] for t in gt]}); card "
          f"{t1 - t0:.2f} s, cpu {t2 - t1:.2f} s")
    del p_gpu, p_cpu
    torch.cuda.empty_cache()


def phase_whisper(seed, smi, card_dev="cuda", smoke=False) -> dict:
    """Phase 20: whisper_medium served at full size through the API, then
    trained (the 2 + 2-layer cut against the CPU, 2 AdamW steps of the
    full model).  ``card_dev`` "cpu" with ``smoke`` rehearses it on the
    reduced config (launch counts are checked on the card only)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.common import count_params, init_params
    from repro_torch.parallel import steps as st
    cfg, n_frames = whisper_cfg(smoke)
    n_steps = min(WHISPER_STEPS, cfg.dec_len - 2)
    on_card = card_dev == "cuda"
    spec = api.param_spec(cfg)
    n_params = count_params(spec)
    params = init_params(spec, torch.Generator(device=card_dev).manual_seed(
        seed), card_dev)
    frames = torch.randn(WHISPER_BATCH, n_frames, cfg.d_model,
                         device=card_dev, generator=torch.Generator(
                             device=card_dev).manual_seed(seed + 1))
    print(f"  {cfg.name}: {n_params / 1e9:.4f} B params fp32; "
          f"B = {WHISPER_BATCH} x {n_frames} frames, {n_steps} decode steps")
    greedy_api(cfg, params, {"frames": frames[:1]}, 2, 1)      # warm
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, tokens, times, cache = greedy_api(
        cfg, params, {"frames": frames}, n_steps, 1)
    wall = time.perf_counter() - t0
    served = ops.launch_counts()
    want = structure_launches(cfg, 1, n_steps)
    check(not on_card or served == want, f"whisper launched {served}, the "
                                         f"structure implies {want}")
    for i, g in enumerate(logits):
        check(bool(torch.isfinite(g[..., :cfg.vocab]).all()),
              f"step {i}: non-finite logits")
    check(all(0 <= t < cfg.vocab for row in tokens for t in row),
          "tokens out of the vocab")
    kv = torch.full((WHISPER_BATCH,), 1 + n_steps, dtype=torch.int32,
                    device=card_dev)
    tok = torch.zeros(WHISPER_BATCH, 1, dtype=torch.long, device=card_dev)
    events, busy, top = device_busy(
        lambda: api.decode_fn(cfg)(params, tok, cache, kv))
    p50 = sorted(times)[len(times) // 2]
    print(f"  {n_steps} decode steps of {WHISPER_BATCH} rows in "
          f"{wall:.2f} s with the prefill; step p50 {p50:.2f} ms (min "
          f"{min(times):.2f}, max {max(times):.2f}); one more step profiled: "
          f"device busy {busy:.2f} ms = {100 * busy / p50:.1f}% of the p50 "
          f"step, {events} device events, top "
          f"{[(n[:50], round(ms, 3)) for n, ms in top]}; launches {served}")
    del params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    out = {"served": served, "step_p50_ms": p50, "busy_ms": busy}
    # training: the 2 + 2-layer cut against the CPU, then the full model
    cut, _ = whisper_cfg(smoke, n_layers=2, n_dec_layers=2)
    batch = st.materialize_batch(cut, InputShape("t", n_frames, 1, "train"),
                                 seed=seed, device="cpu")
    out["cut"] = train_cut(cut, seed, card_dev,
                           {k: v.numpy() for k, v in batch.items()})
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = st.init_train_state(cfg, torch.Generator(
        device=card_dev).manual_seed(seed), card_dev)
    step = st.make_train_step(cfg, base_lr=3e-4, warmup=0, total_steps=2)
    batch = st.materialize_batch(cfg, InputShape("t", n_frames, 2, "train"),
                                 seed=seed, device=card_dev)
    losses, step_ms, total = [], [], {}
    for i in range(2):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launched = ops.launch_counts()
        total = {k: total.get(k, 0) + v for k, v in launched.items()}
        check(not on_card or launched == train_launches(cfg, 1),
              f"train step {i + 1} launched {launched}, not "
              f"{train_launches(cfg, 1)}")
    check(all(math.isfinite(x) for x in losses) and losses[1] < losses[0],
          f"whisper's losses on one batch {losses} are not finite and "
          f"falling")
    print(f"  2 AdamW steps of the full {cfg.name}, 2 x {n_frames} frames and "
          f"2 x {cfg.dec_len} tokens, one batch: losses {losses}, "
          f"{step_ms[0]:.1f} / {step_ms[1]:.1f} ms (host clock, "
          f"synchronised; the first includes first calls), peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches a "
          f"step {launched}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    out.update(losses=losses, train_step_ms=step_ms, train_launches=total)
    print("[20] " + json.dumps({"whisper": {**out, "card": smi}}))
    return out


# phase 21: the mesh layer on a one-rank (1, 1) mesh, full-width glm4_9b
# cut to 2 layers, 1 x 128 tokens, fp32
MESH_LAYERS, MESH_SEQ = 2, 128


def _host_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


# Part A of the mesh phases (21(a), 21(d)-(h)): a train step compared with
# the unsharded one runs at the base lr (warmup 0: under warmup the first
# step's lr is 0 and moves nothing), in fp32 and again in float64 with
# plain attention, and is held by ``_hold_trained``


def _fresh(cuda: bool) -> None:
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _release_host_memory()


def _release_host_memory() -> None:
    """Hand freed host memory back to the machine (96 GiB for the card and
    every process of a phase): the page-locked buffers PyTorch keeps for
    reuse (gloo stages each collective of a card's tensors through them),
    where this build of PyTorch offers a call for it, and the C heap's
    free pages."""
    import ctypes
    for name in ("_host_emptyCache", "_accelerator_emptyHostCache"):
        fn = getattr(torch._C, name, None)
        if fn is not None and torch.cuda.is_available():
            fn()
            break
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:
        pass


def _rss_gb() -> float:
    """This process's resident host memory, GB (0 where /proc has none)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return 0.0


def _leaf_paths(tree, at: str = "") -> list:
    """The "/"-joined key path of each leaf of a tree of dicts, in
    ``tree.leaves`` order."""
    if not isinstance(tree, dict):
        return [at]
    return [p for k in sorted(tree)
            for p in _leaf_paths(tree[k], f"{at}/{k}" if at else k)]


def _trained(state, lay, keep: bool = True) -> tuple:
    """The parameters and the first moments of a sharded train state,
    gathered whole a leaf at a time in host memory (two ranks' float64
    states and their gathered copies do not fit the one card): each block
    copied to the host and the host copies gathered (gloo's collectives of
    host tensors stage nothing through the card), or, where not ``keep``,
    gathered (every rank joins the collectives) and dropped;
    after one step the first moments hold the clipped gradient times 1 -
    b1."""
    from repro_torch.tree import leaves

    def whole(tree, lays):
        out = []
        for x, lw in zip(leaves(tree), leaves(lays), strict=True):
            w = lw.gather(x.to("cpu", copy=True))
            out.append(w if keep else None)
        return out
    return whole(state.params, lay.params), whole(state.opt.m, lay.opt.m)


def _state_blocks(cfg, lay, gen, dev):
    """This device's blocks of ``steps.init_train_state(cfg, gen, dev)``,
    its parameters drawn a leaf at a time (``_blocks_from_seed``), so that
    the whole state is never on the card."""
    from repro_torch.models import api
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import steps as st
    from repro_torch.tree import tree_map
    p32 = _blocks_from_seed(api.param_spec(cfg), lay.params, gen, dev)
    return st.TrainState(params=tree_map(lambda x: x.to(cfg.torch_dtype),
                                         p32), opt=adamw_init(p32))


def _train_sharded(cfg, mesh, rules, lay, batch, gen, dev, sync,
                   keep: bool = True, **step_kw) -> tuple:
    """Part A's sharded half, in a rank: one mesh train step of ``cfg`` at
    the base lr from the state ``gen`` draws, on this rank's blocks (its
    launches, op counts, loss, lr, host seconds, this rank's memory before
    it and its peak across it, the blocks held), then the same step in
    float64 with plain attention (the kernels take no float64).  Returns
    (that record, the parameters and first moments of each step gathered
    whole into host memory, fp32 then float64; dropped where not
    ``keep``)."""
    from repro_torch.analysis import hlo
    from repro_torch.analysis.precision import Float64, double
    from repro_torch.kernels import ops
    from repro_torch.parallel import steps as st
    cuda = dev == "cuda"
    state = _state_blocks(cfg, lay, gen(), dev)
    _fresh(cuda)        # the peak of the step, from the blocks on
    before = torch.cuda.memory_allocated() if cuda else 0
    step = st.make_train_step(cfg, total_steps=10, warmup=0, mesh=mesh,
                              rules=rules, **step_kw)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    (state, m), rep = hlo.count(step, state, batch)
    sync()
    got = {"train_launches": ops.launch_counts(),
           "train_counts": _op_counts(rep), "loss": float(m["loss"]),
           "lr": float(m["lr"]), "seconds": time.perf_counter() - t0,
           "before": before,
           "peak": torch.cuda.max_memory_allocated() if cuda else 0}
    t1 = time.perf_counter()
    trained = [_trained(state, lay, keep)]
    del state, step
    _fresh(cuda)
    t2 = time.perf_counter()
    wide = cfg.replace(attn_impl="chunked")
    state = double(_state_blocks(wide, lay, gen(), dev))
    with Float64():
        state, m = st.make_train_step(wide, total_steps=10, warmup=0,
                                      mesh=mesh, rules=rules,
                                      **step_kw)(state, batch)
        sync()
        t3 = time.perf_counter()
        trained.append(_trained(state, lay, keep))
    got["loss64"] = float(m["loss"])
    del state
    _fresh(cuda)
    got["rss_gb"] = round(_rss_gb(), 2)
    # host seconds of the parts: the fp32 gather, the float64 step and
    # its gather
    got["part_seconds"] = [round(t, 2) for t in (
        t2 - t1, t3 - t2, time.perf_counter() - t3)]
    return got, trained


def _train_unsharded(cfg, gen, dev, batch, trained, sync,
                     accum: int = 1) -> dict:
    """Part A's unsharded half, after every sharded tensor is freed: the
    same step unsharded from the same state, in fp32 and in float64; each
    leaf's gaps of the sharded ``trained`` to it (``fp32``, ``fp64``), the
    unsharded fp32 step's own gap to its float64 run (``own``, the
    rounding the sharded one is held against), how far the step moved
    each leaf (a share of its largest value), its losses, lr, peak memory
    and host seconds (``unsharded_seconds``).  The gaps are taken on the
    device of the unsharded state, a leaf at a time."""
    from repro_torch.analysis.precision import Float64, double
    from repro_torch.parallel import steps as st
    from repro_torch.tree import leaves
    cuda = dev == "cuda"
    t0 = time.perf_counter()
    (p32, m32), (p64, m64) = trained
    _fresh(cuda)
    state = st.init_train_state(cfg, gen(), dev)
    before = [p.clone() for p in leaves(state.params)]
    top = [p.abs().max().item() for p in before]
    _fresh(cuda)        # the peak of the step, from the state on
    state, pm = st.make_train_step(cfg, total_steps=10, warmup=0,
                                   accum=accum)(state, batch)
    sync()
    out = {"peak_unsharded": torch.cuda.max_memory_allocated() if cuda
           else 0}
    names = _leaf_paths(state.params)

    def gaps(mine, theirs):
        """Each leaf's largest absolute gap and the largest |value| of
        ``theirs``, by the leaf's path."""
        return {k: ((a.to(b.device) - b).abs().max().item(),
                    b.abs().max().item())
                for k, a, b in zip(names, mine, theirs, strict=True)}
    u32 = leaves(state.params), leaves(state.opt.m)
    # each leaf's move, a share of its largest |value| before or after
    # the step (zero-initialised leaves start at 0)
    moved = [d / max(a, b) for a, (d, b) in zip(
        top, gaps(before, u32[0]).values())]
    fp32 = {"params": gaps(p32, u32[0]), "m": gaps(m32, u32[1])}
    del state, before       # the unsharded fp32 results stay (u32)
    _fresh(cuda)
    wide = cfg.replace(attn_impl="chunked")
    state = double(st.init_train_state(wide, gen(), dev))
    with Float64():
        state, pm64 = st.make_train_step(wide, total_steps=10, warmup=0,
                                         accum=accum)(state, double(batch))
    u64 = leaves(state.params), leaves(state.opt.m)
    out.update(loss_unsharded=float(pm["loss"]),
               loss64_unsharded=float(pm64["loss"]),
               lr_unsharded=float(pm["lr"]), moved_least=min(moved),
               moved_most=max(moved), fp32=fp32,
               fp64={"params": gaps(p64, u64[0]), "m": gaps(m64, u64[1])},
               own={"params": gaps(u32[0], u64[0]),
                    "m": gaps(u32[1], u64[1])})
    del state, u64
    _fresh(cuda)
    out["unsharded_seconds"] = time.perf_counter() - t0
    return out


def _worst(gaps: dict) -> dict:
    """Of {"params": {leaf: (gap, max)}, "m": {...}}, each group's largest
    gap as a share of its leaf's max, and that leaf."""
    return {g: max((d / max(top, 1e-30), k) for k, (d, top)
                   in by_leaf.items()) for g, by_leaf in gaps.items()}


def _adam_first_step_slack(r0: dict, prec: str, tol: float) -> dict:
    """Each leaf's bound on its parameters' gap after one AdamW step, from
    its first moments' gap.  At the first step the update is lr g / (|g| +
    eps) + lr wd p, and g -> g / (|g| + eps) has slope at most 1 / eps
    (at g = 0): a gradient gap dg moves a parameter by up to lr dg / eps,
    and m = (1 - b1) g.  So the parameters, from the same p, may differ
    by lr / eps x max |dm| / (1 - b1), plus ``tol`` of the leaf's max for
    the rounding of the update itself."""
    import inspect
    from repro_torch.optim.adamw import adamw_update
    arg = inspect.signature(adamw_update).parameters
    eps, b1 = arg["eps"].default, arg["b1"].default
    return {k: r0["lr"] / eps * r0[prec]["m"][k][0] / (1 - b1) + tol * top
            for k, (_, top) in r0[prec]["params"].items()}


def _hold_trained(label: str, r0: dict) -> str:
    """Part A's check of a sharded step's record joined with its unsharded
    one (``_train_sharded``, ``_train_unsharded``): the step ran at the
    base lr and moved every leaf; the fp32 loss within 1e-6 and the
    float64 one within 1e-12 of the unsharded step's; the first moments
    (the clipped gradient times 1 - b1) within 1e-12 of each leaf's max in
    float64 and, in fp32, within 4 times the unsharded step's own gap to
    float64, or 1e-6 of the max; the parameters within what Adam's first
    step makes of the first moments' gap (``_adam_first_step_slack``),
    plus 1e-12 (float64) or 1e-6 (fp32) of the max.  Returns what it
    held, for the phase's line."""
    l1, l2 = r0["loss_unsharded"], r0["loss"]
    check(math.isfinite(l2) and abs(l1 - l2) <= 1e-6 * abs(l1),
          f"{label}: loss {l2} against the unsharded {l1}")
    check(abs(r0["loss64"] - r0["loss64_unsharded"])
          <= 1e-12 * abs(r0["loss64_unsharded"]),
          f"{label}: float64 loss {r0['loss64']!r} against the unsharded "
          f"{r0['loss64_unsharded']!r}")
    check(r0["lr"] == r0["lr_unsharded"] > 0.0 and r0["moved_least"] > 0.0,
          f"{label}: the step compared ran at lr {r0['lr']} (unsharded "
          f"{r0['lr_unsharded']}) and moved a leaf by as little as "
          f"{r0['moved_least']} of its max")
    worst = {k: _worst(r0[k]) for k in ("fp32", "fp64", "own")}
    v, leaf = worst["fp64"]["m"]
    check(v <= 1e-12, f"{label}: float64 first moments off the unsharded "
                      f"step's by {v} of a leaf's max at {leaf}")
    for leaf, (d, top) in r0["fp32"]["m"].items():
        own, _ = r0["own"]["m"][leaf]
        check(d <= max(1e-6 * top, 4 * own), f"{label}: first moments at "
              f"{leaf} off the unsharded step's by {d} (max {top}), over 4 "
              f"x its own gap to float64 ({own}) and 1e-6 of the max")
    slack = {}
    for prec, tol in (("fp64", 1e-12), ("fp32", 1e-6)):
        lim = _adam_first_step_slack(r0, prec, tol)
        for leaf, (d, top) in r0[prec]["params"].items():
            check(d <= lim[leaf], f"{label}: {prec} parameters at {leaf} off "
                  f"the unsharded step's by {d} (max {top}), over "
                  f"{lim[leaf]}, lr / eps x its first moments' gap / "
                  f"(1 - b1) + {tol} of the max")
        slack[prec] = max(d / lim[k] for k, (d, _)
                          in r0[prec]["params"].items())

    def held(k, g):
        v, leaf = worst[k][g]
        return f"{v:.3e} ({leaf})"
    return (f"one step at lr {r0['lr']:.3e}, which moved each leaf by "
            f"{r0['moved_least']:.3e} to {r0['moved_most']:.3e} of its max: "
            f"fp32 loss {l2!r} (unsharded {l1!r}); the largest gap to the "
            f"unsharded step, a share of the leaf's max, in fp32 first "
            f"moments {held('fp32', 'm')}, parameters "
            f"{held('fp32', 'params')}, the unsharded fp32 step's own gap "
            f"to float64 {held('own', 'm')} and {held('own', 'params')}; in "
            f"float64 (attention plain) first moments {held('fp64', 'm')}, "
            f"parameters {held('fp64', 'params')} (of their bound from the "
            f"moments' gap at most {slack['fp32']:.3f} in fp32, "
            f"{slack['fp64']:.3f} in float64); rank 0's seconds: the fp32 "
            f"step {r0['seconds']:.1f}, its gather, the float64 step and "
            f"its gather {r0['part_seconds']}, the unsharded steps "
            f"{r0['unsharded_seconds']:.1f}; its host memory after the "
            f"sharded steps {r0['rss_gb']} GB")


def _trained_record(r0: dict) -> dict:
    """Of a record ``_hold_trained`` held, what a phase returns: the
    losses, the lr, how far the step moved the leaves and each group's
    largest gap (``_worst``) in fp32, in float64 and the unsharded fp32
    step's own."""
    out = {k: r0[k] for k in ("loss", "loss_unsharded", "loss64",
                              "loss64_unsharded", "lr", "moved_least",
                              "moved_most")}
    out.update({k: _worst(r0[k]) for k in ("fp32", "fp64", "own")})
    return out


def mesh_step(cfg, seed, card_dev, mesh) -> dict:
    """21(a): one step of ``make_train_step(mesh=...)`` at the base lr
    against phase 14(a)'s unsharded step, from the same state (drawn from
    ``seed``) and batch, in fp32 and in float64 (part A:
    ``_train_sharded``, ``_train_unsharded``, ``_hold_trained``; on one
    rank the gap is the clipping norm's order of summation alone); then
    one profiled step of each from a fresh state, whose device events
    differ by what the collectives add."""
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import steps as st
    batch = to_dev(synthetic_batch(DataConfig(
        seq_len=MESH_SEQ, global_batch=1, vocab=cfg.vocab, seed=seed), 0),
        card_dev)
    gen = lambda: torch.Generator(device=card_dev).manual_seed(seed)
    sync = torch.cuda.synchronize if card_dev == "cuda" else (lambda: None)
    profiled = (lambda fn: device_events(fn)) if card_dev == "cuda" \
        else (lambda fn: [fn()][:0])
    rules = shd.default_rules()
    lay = st.state_layouts(cfg, mesh, rules)
    got, trained = _train_sharded(cfg, mesh, rules, lay, batch, gen,
                                  card_dev, sync)
    got.update(_train_unsharded(cfg, gen, card_dev, batch, trained, sync))
    del trained
    launched = got["train_launches"]
    if card_dev == "cuda":
        check(launched == train_launches(cfg, 1), f"the sharded step "
              f"launched {launched}, not {train_launches(cfg, 1)}")
    held = _hold_trained("21(a)", got)
    plain = st.make_train_step(cfg, total_steps=10, warmup=0)
    state = st.init_train_state(cfg, gen(), card_dev)
    ev_plain = profiled(lambda: plain(state, batch))
    del state
    _fresh(card_dev == "cuda")
    sharded = st.make_train_step(cfg, total_steps=10, warmup=0, mesh=mesh,
                                 rules=rules)
    state = _state_blocks(cfg, lay, gen(), card_dev)
    ev_sharded = profiled(lambda: sharded(state, batch))
    del state
    _fresh(card_dev == "cuda")
    added = {}
    for name in ev_sharded:
        added[name] = added.get(name, 0) + 1
    for name in ev_plain:
        added[name] = added.get(name, 0) - 1
    # the collectives' own events, and the count of all others that moved
    # (the clipping norm's sums are other kernels in the sharded step)
    added = {k: v for k, v in added.items() if v}
    comm_events = {k: v for k, v in added.items()
                   if "nccl" in k.lower() or "memcpy" in k.lower()}
    added = {**comm_events, "other kernels": sum(
        v for k, v in added.items() if k not in comm_events)}
    counts = got["train_counts"]
    print(f"  21(a) {cfg.name} {cfg.n_layers} layers, 1 x {MESH_SEQ} tokens, "
          f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}: {held}; "
          f"launches {launched}; collectives {counts['collective_counts']} "
          f"moving {counts['collective_bytes']} bytes; device events of a "
          f"sharded step less an unsharded one's: {added}")
    return {**_trained_record(got), "launches": launched,
            "flops": counts["flops"],
            "collective_bytes": counts["collective_bytes"],
            "events_added": added, "step": sharded, "layouts": lay,
            "batch": batch}


def mesh_collectives(card_dev, mesh) -> dict:
    """21(b): ``flash_decode_shardmap``, ``compressed_psum`` (k = 1.0) and
    a one-stage ``pipeline_forward`` on the mesh against their plain
    results on the CPU, with md_programs.py's inputs."""
    from repro_torch.kernels import ref
    from repro_torch.parallel.collectives import (_topk_int8_wire,
                                                  compressed_psum,
                                                  flash_decode_shardmap)
    from repro_torch.parallel.pipeline import mlp_stage, pipeline_forward
    f32 = dict(dtype=torch.float32)
    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), **f32) for s in
               ((2, 4, 16), (2, 64, 4, 16), (2, 64, 4, 16)))
    got = flash_decode_shardmap(mesh, "model")(
        q.to(card_dev), k.to(card_dev), v.to(card_dev)).cpu()
    want = ref.decode_ref(q, k.transpose(1, 2), v.transpose(1, 2))
    e_fd = (got - want).abs().max().item()
    check(e_fd <= 2e-5, f"flash_decode_shardmap is off by {e_fd}")
    g = torch.as_tensor(np.random.default_rng(2).standard_normal(64), **f32)
    out, err = compressed_psum(mesh, pod_axis="model", inner_axes=("data",),
                               k_fraction=1.0)(
        {"g": g.to(card_dev)}, {"g": torch.zeros(64, device=card_dev)})
    qv, idx, scale = _topk_int8_wire(g, 1.0)
    recon = torch.zeros(64)
    recon[idx] = qv.float() * scale
    e_ps = max((out["g"].cpu() - recon).abs().max().item(),
               (err["g"].cpu() - (g - recon)).abs().max().item())
    check(e_ps <= 1e-6, f"compressed_psum is off by {e_ps}")
    rng = np.random.default_rng(0)
    w1, w2 = (torch.as_tensor(rng.standard_normal((1, 16, 16)) * 0.3, **f32)
              for _ in range(2))
    xs = torch.as_tensor(rng.standard_normal((6, 8, 16)), **f32)
    got = pipeline_forward(mlp_stage, mesh, "data")(
        {"w1": w1.to(card_dev), "w2": w2.to(card_dev)}, xs.to(card_dev))
    want = mlp_stage({"w1": w1[0], "w2": w2[0]}, xs)
    e_pp = (got.cpu() - want).abs().max().item()
    check(e_pp <= 2e-5, f"the one-stage pipeline is off by {e_pp}")
    print(f"  flash_decode_shardmap |diff| {e_fd:.2e}, compressed_psum (k 1.0)"
          f" {e_ps:.2e}, pipeline_forward (1 stage, 6 microbatches) "
          f"{e_pp:.2e}, against the CPU's plain results")
    return {"flash_decode": e_fd, "compressed_psum": e_ps,
            "pipeline": e_pp}


# 21(d): the first tensor- and sequence-parallel step on the card, two
# processes on the one card over gloo (NCCL refuses two ranks on one
# device) on a (1, 2) ("data", "model") mesh
MESH_TP = (1, 2)


def _mesh_cfg(smoke: bool):
    from repro_torch.configs import get_config
    cfg = get_config("glm4_9b")
    if smoke:
        cfg = cfg.reduced()
    return cfg.replace(n_layers=MESH_LAYERS, dtype="float32",
                       attn_impl="chunked" if smoke else "kernel")


def _op_counts(rep) -> dict:
    """An op counter's FLOPs and collectives, as JSON gives them back."""
    return json.loads(json.dumps({
        "flops": rep.flops, "collective_bytes": rep.collective_bytes,
        "collective_counts": rep.collective_counts}))


def _tp_rank(rank: int, tmp: str, seed: int, card_dev: str,
             smoke: bool, run=None) -> None:
    """21(d) or 21(e) in one of the two processes: a gloo group on the
    file store in ``tmp`` (both ranks on the card's device 0), the run of
    ``run`` (:func:`_tp_run` unless given), its record written to
    ``tmp/rank<r>.json``."""
    import datetime
    import torch.distributed as dist
    os.environ["LOCAL_RANK"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = (run or _tp_run)(rank, seed, card_dev, smoke)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _two_ranks(run, seed: int, card_dev: str, smoke: bool) -> tuple:
    """(each rank's record, seconds): :func:`_tp_rank` of ``run`` in two
    processes on the one card."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="mesh_two_")
    t0 = time.perf_counter()
    try:
        mp.spawn(_tp_rank, args=(tmp, seed, card_dev, smoke, run), nprocs=2)
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ranks, time.perf_counter() - t0


def _tp_run(rank: int, seed: int, card_dev: str, smoke: bool) -> dict:
    """One rank of 21(d): the mesh prefill of the cut glm4_9b on this
    rank's blocks (its 16 of 32 query heads, half the MLP and the vocab,
    64 of the 128 rows of the residual stream), its op counts and
    launches; one train step at the base lr in fp32 and float64 (part A,
    ``_train_sharded``); three more steps timed on the host clock; then,
    on rank 0, the unsharded prefill and step on the card from the same
    state and batch (``_train_unsharded``)."""
    from repro_torch.analysis import hlo
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import steps as st
    cuda = card_dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        sync()
        seconds[name] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()
    cfg = _mesh_cfg(smoke)
    mesh = make_mesh(MESH_TP, ("data", "model"), card_dev)
    rules = shd.default_rules()
    lay = st.state_layouts(cfg, mesh, rules)
    batch = to_dev(synthetic_batch(DataConfig(
        seq_len=MESH_SEQ, global_batch=1, vocab=cfg.vocab, seed=seed), 0),
        card_dev)
    gen = lambda: torch.Generator(device=card_dev).manual_seed(seed)
    state = _state_blocks(cfg, lay, gen(), card_dev)
    _fresh(cuda)
    lap("setup")
    prefill = st.make_prefill_step(cfg, MESH_SEQ, mesh, rules, 1)
    ops.reset_launch_counts()
    (logits, _), prep = hlo.count(prefill, state.params,
                                  {"tokens": batch["tokens"]})
    sync()
    out = {"prefill_launches": ops.launch_counts(),
           "prefill_counts": _op_counts(prep), "laps": seconds}
    logits = logits.cpu()
    del state
    lap("prefill")
    got, trained = _train_sharded(cfg, mesh, rules, lay, batch, gen,
                                  card_dev, sync, rank == 0, global_batch=1)
    out.update(got)
    lap("step")
    state = _state_blocks(cfg, lay, gen(), card_dev)
    step = st.make_train_step(cfg, total_steps=10, warmup=0, mesh=mesh,
                              rules=rules, global_batch=1)
    times = []
    for _ in range(3):
        sync()
        t1 = time.perf_counter()
        step(state, batch)
        sync()
        times.append((time.perf_counter() - t1) * 1e3)
    out["step_ms"] = times
    del state, step
    _fresh(cuda)
    lap("timed")
    if rank:
        return out
    plain_state = st.init_train_state(cfg, gen(), card_dev)
    with torch.no_grad():
        want = api.prefill_fn(cfg, MESH_SEQ)(
            plain_state.params, {"tokens": batch["tokens"]})[0].cpu()
    del plain_state
    out["logits_err"] = (logits - want).abs().max().item()
    out["logits_max"] = want.abs().max().item()
    out.update(_train_unsharded(cfg, gen, card_dev, batch, trained, sync))
    lap("unsharded")
    return out


def mesh_tp(seed: int, smi: str, card_dev: str = "cuda",
            smoke: bool = False) -> dict:
    """21(d): :func:`_tp_rank` in two processes on the one card, each
    holding half of every split leaf and 64 of the 128 rows of the
    residual stream; its train step at the base lr held against the
    unsharded one in fp32 and float64 (``_hold_trained``), the
    prefill's logits within 1e-4 (absolute and relative) of the
    unsharded prefill's; each rank's launches those of the step (4 flash
    attentions, no other kernel) and of the prefill (2 flash attentions,
    5 RMSNorms, on 64 rows but the final norm's one); each rank's op
    counts of both steps equal to the dry run's trace of the same cells
    on an abstract (1, 2) mesh."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.parallel.comm import AbstractMesh
    cfg = _mesh_cfg(smoke)
    ranks, t_ranks = _two_ranks(_tp_run, seed, card_dev, smoke)
    t0 = time.perf_counter()
    am = AbstractMesh(MESH_TP, ("data", "model"))
    for kind in ("train", "prefill"):
        cell = dryrun.trace_cell(cfg, InputShape("cut", MESH_SEQ, 1, kind),
                                 am)["hlo_analysis"]
        want = json.loads(json.dumps({k: cell[k] for k in (
            "flops", "collective_bytes", "collective_counts")}))
        for r, got in enumerate(ranks):
            check(got[f"{kind}_counts"] == want, f"rank {r}'s {kind} op "
                  f"counts {got[f'{kind}_counts']} differ from the dry "
                  f"run's {want}")
    if card_dev == "cuda":
        prefill = dict(train_launches(cfg, 0), flash_attention=MESH_LAYERS,
                       rmsnorm=2 * MESH_LAYERS + 1)
        for r, got in enumerate(ranks):
            check(got["train_launches"] == train_launches(cfg, 1),
                  f"rank {r}'s step launched {got['train_launches']}")
            check(got["prefill_launches"] == prefill,
                  f"rank {r}'s prefill launched {got['prefill_launches']}")
    t_trace = time.perf_counter() - t0
    r0 = ranks[0]
    held = _hold_trained("21(d)", r0)
    check(r0["logits_err"] <= 1e-4 * (1 + r0["logits_max"]),
          f"two-rank prefill logits off by {r0['logits_err']}")
    launched = {k: sum(r[f"{p}_launches"][k] for r in ranks
                       for p in ("train", "prefill"))
                for k in r0["train_launches"]}
    ms = [float(np.median(r["step_ms"])) for r in ranks]
    print(f"  21(d) {cfg.name} {cfg.n_layers} layers, 1 x {MESH_SEQ} tokens "
          f"on a {MESH_TP} mesh, two processes on one card over gloo: 64 "
          f"rows of the stream a rank; {held}; prefill logits |diff| "
          f"{r0['logits_err']:.3e} of max {r0['logits_max']:.3f}; launches "
          f"a rank: step {r0['train_launches']}, prefill "
          f"{r0['prefill_launches']}; op counts = the dry run's; step "
          f"{ms} ms a rank (median of 3, host clock: a two-process gloo "
          f"step with host-staged collectives, not a speed of the design); "
          f"collectives of the step {r0['train_counts']['collective_counts']}"
          f"; seconds: the two processes {t_ranks:.1f} (rank 0's parts "
          f"{r0['laps']}), the dry run's traces {t_trace:.1f}; card "
          f"{smi}")
    return {**_trained_record(r0), "logits_err": r0["logits_err"],
            "launches": launched, "step_ms": ms,
            "counts": r0["train_counts"],
            "prefill_counts": r0["prefill_counts"]}


# 21(e): FSDP one layer at a time across two devices, two processes on the
# one card over gloo on a (2, 1) ("data", "model") mesh: 4 x 128 tokens at
# accum 2, one row a rank a microbatch; glm4_9b cut to one layer, since
# two ranks' float64 steps of two (a rank's half of the 0.62 B-weight
# embedding, gathered whole, and its whole gradient, ~40 GB a rank) do
# not fit the one card
MESH_FSDP, FSDP_ROWS, FSDP_ACCUM, FSDP_LAYERS = (2, 1), 4, 2, 1


def _fsdp_cfg(smoke: bool):
    return _mesh_cfg(smoke).replace(accum=FSDP_ACCUM, n_layers=FSDP_LAYERS)


def _fsdp_batch(cfg, seed: int, card_dev: str) -> dict:
    """The whole batch of 21(e): FSDP_ROWS x MESH_SEQ tokens with a leading
    microbatch axis of FSDP_ACCUM."""
    from repro_torch.data import DataConfig, synthetic_batch
    batch = to_dev(synthetic_batch(DataConfig(
        seq_len=MESH_SEQ, global_batch=FSDP_ROWS, vocab=cfg.vocab,
        seed=seed), 0), card_dev)
    return {k: v.reshape(FSDP_ACCUM, -1, v.shape[-1])
            for k, v in batch.items()}


def _fsdp_run(rank: int, seed: int, card_dev: str, smoke: bool) -> dict:
    """One rank of 21(e): one train step at the base lr of the cut
    glm4_9b at accum 2 on this rank's blocks (half of every leaf that
    "data" splits) and its row of each microbatch, each layer gathered in
    its turn and its gradient reduce-scattered as the backward leaves it,
    in fp32 and float64 (part A, ``_train_sharded``): the step's op
    counts, launches, peak memory and host seconds; then, on rank 0, the
    unsharded step on the card from the same state and the whole batch
    (``_train_unsharded``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import steps as st
    cuda = card_dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = _fsdp_cfg(smoke)
    mesh = make_mesh(MESH_FSDP, ("data", "model"), card_dev)
    rules = shd.default_rules()
    lay = st.state_layouts(cfg, mesh, rules)
    whole = _fsdp_batch(cfg, seed, card_dev)
    batch = st.batch_rows(whole, mesh, rules, FSDP_ACCUM)
    gen = lambda: torch.Generator(device=card_dev).manual_seed(seed)
    out, trained = _train_sharded(cfg, mesh, rules, lay, batch, gen,
                                  card_dev, sync, rank == 0,
                                  accum=FSDP_ACCUM, global_batch=FSDP_ROWS)
    out["rows"] = int(batch["tokens"].shape[1])
    if rank:
        return out
    out.update(_train_unsharded(cfg, gen, card_dev, whole, trained, sync,
                                FSDP_ACCUM))
    return out


def mesh_fsdp(seed: int, smi: str, card_dev: str = "cuda",
              smoke: bool = False) -> dict:
    """21(e): :func:`_fsdp_run` in two processes on the one card on a (2, 1)
    mesh, FSDP only: its step at the base lr held against the unsharded
    one in fp32 and float64 (``_hold_trained``); each rank's
    launches those of one train step at accum 2 (two microbatches launch
    what two steps of one do) and its op counts those of the dry run's
    trace of the same cell on an abstract (2, 1) mesh.  Prints each
    rank's peak memory across the step beside the whole parameter tree
    that a step gathering it at its top held on top of the blocks."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models import api
    from repro_torch.models.common import count_params
    from repro_torch.parallel.comm import AbstractMesh
    cfg = _fsdp_cfg(smoke)
    ranks, t_ranks = _two_ranks(_fsdp_run, seed, card_dev, smoke)
    t0 = time.perf_counter()
    cell = dryrun.trace_cell(cfg, InputShape("cut", MESH_SEQ, FSDP_ROWS,
                                             "train"),
                             AbstractMesh(MESH_FSDP, ("data", "model")))
    want = json.loads(json.dumps({k: cell["hlo_analysis"][k] for k in (
        "flops", "collective_bytes", "collective_counts")}))
    t_trace = time.perf_counter() - t0
    for r, got in enumerate(ranks):
        check(got["rows"] == 1, f"rank {r} held {got['rows']} rows")
        check(got["train_counts"] == want, f"rank {r}'s op counts "
              f"{got['train_counts']} differ from the dry run's {want}")
        if card_dev == "cuda":
            check(got["train_launches"] == train_launches(cfg, FSDP_ACCUM),
                  f"rank {r}'s step launched {got['train_launches']}, not "
                  f"{train_launches(cfg, FSDP_ACCUM)}")
    r0 = ranks[0]
    held = _hold_trained("21(e)", r0)
    whole = count_params(api.param_spec(cfg)) * 4
    counts = want["collective_counts"]
    print(f"  21(e) {cfg.name} {cfg.n_layers} layers, {FSDP_ROWS} x "
          f"{MESH_SEQ} tokens at accum {FSDP_ACCUM} on a {MESH_FSDP} mesh, "
          f"two processes on one card over gloo, one row a rank a "
          f"microbatch: {held}; launches a rank "
          f"{r0['train_launches']}; op counts = the dry run's ({counts}); "
          f"peak "
          f"memory across the step a rank "
          f"{[round(r['peak'] / 1e9, 3) for r in ranks]} GB, "
          f"{[round(r['before'] / 1e9, 3) for r in ranks]} GB before it "
          f"(blocks and batch); the whole fp32 parameter tree a step "
          f"gathering it at its top held beside them: {whole / 1e9:.3f} GB;"
          f" the step {[round(r['seconds'], 2) for r in ranks]} s a rank "
          f"(host clock, gloo's collectives staged through the host); "
          f"seconds: the two processes {t_ranks:.1f}, the dry run's trace "
          f"{t_trace:.1f}; card {smi}")
    return {**_trained_record(r0),
            "launches": {k: sum(r["train_launches"][k] for r in ranks)
                         for k in r0["train_launches"]},
            "counts": r0["train_counts"],
            "peak_bytes": [r["peak"] for r in ranks],
            "before_bytes": [r["before"] for r in ranks],
            "whole_tree_bytes": whole,
            "step_s": [r["seconds"] for r in ranks]}


# 21(f): expert parallelism on the card, two processes on the one card over
# gloo on the (1, 2) mesh of 21(d): full-width deepseek_moe_16b cut to its
# dense first layer and one MoE layer of 64 experts, 32 a rank; it and
# 21(g) serve MESH_TICKS greedy ticks after the mesh prefill
MESH_EP_LAYERS, MESH_TICKS = 2, 4


def _ep_cfg(smoke: bool):
    from repro_torch.configs import get_config
    cfg = get_config("deepseek_moe_16b")
    if smoke:
        cfg = cfg.reduced()
    return cfg.replace(n_layers=MESH_EP_LAYERS, dtype="float32",
                       attn_impl="chunked" if smoke else "kernel")


class _OpShapes:
    """Records, of every call made while it is entered, the (heads, key
    width, value width) of ``ops.flash_attention`` and
    ``ops.flash_decode``, the experts of ``ops.moe_gmm``, the heads of
    ``ops.mamba_scan`` and the width of the split norm's entries."""

    SHAPE = {"flash_attention": lambda q, k, v, *a: [
                 int(q.shape[2]), int(q.shape[3]), int(v.shape[3])],
             "flash_decode": lambda q, k, v, *a: [
                 int(q.shape[2]), int(q.shape[3]), int(v.shape[3])],
             "moe_gmm": lambda x, *a: int(x.shape[0]),
             "mamba_scan": lambda xh, *a: int(xh.shape[2]),
             "rmsnorm_sumsq": lambda x, *a: int(x.shape[-1]),
             "rmsnorm_scaled": lambda x, *a: int(x.shape[-1])}
    NAMES = tuple(SHAPE)

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.calls = ops, {n: [] for n in self.NAMES}
        self._fns = {n: getattr(ops, n) for n in self.NAMES}

        def recorder(name):
            fn, seen = self._fns[name], self.calls[name]

            def recorded(*a, **k):
                seen.append(self.SHAPE[name](*a))
                return fn(*a, **k)
            return recorded
        for n in self.NAMES:
            setattr(ops, n, recorder(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self._fns.items():
            setattr(self.ops, n, fn)


def _mesh_serve(params, prefill, tick, prompt, dev, sync) -> dict:
    """The prefill's logits, launches and op counts, then the ticks'
    tokens, launches and the first tick's op counts, with the shapes the
    attention and grouped-matmul wrappers got."""
    from repro_torch.analysis import hlo
    from repro_torch.kernels import ops
    got = {}
    with _OpShapes() as shapes:
        ops.reset_launch_counts()
        (logits, cache), rep = hlo.count(prefill, params, prompt)
        sync()
        got.update(prefill_launches=ops.launch_counts(),
                   prefill_counts=_op_counts(rep), logits=logits.cpu())
        tok = {"token": torch.argmax(logits, -1).to(torch.int32)[:, None],
               "kv_len": torch.full((1,), MESH_SEQ, dtype=torch.int32,
                                    device=dev)}
        tokens = [tok["token"]]
        ops.reset_launch_counts()
        for i in range(MESH_TICKS):
            if i == 0:
                (tok, cache), rep = hlo.count(tick, params, tok, cache)
                got["tick_counts"] = _op_counts(rep)
            else:
                tok, cache = tick(params, tok, cache)
            tokens.append(tok["token"])
        sync()
    got.update(tick_launches=ops.launch_counts(), shapes=shapes.calls,
               tokens=torch.cat(tokens, 1).cpu().tolist())
    return got


def _ep_run(rank: int, seed: int, card_dev: str, smoke: bool) -> dict:
    """One rank of 21(f): the mesh prefill of the cut deepseek_moe_16b (1 x
    128 tokens), four greedy serve ticks from its cache and one train step
    at the base lr in fp32 and float64 (part A, ``_train_sharded``) on
    this rank's blocks (its 32 of 64 routed experts, half the query heads,
    the MLPs and the vocab, 64 of the 128 rows of the stream): op counts,
    launches, the experts of each ``moe_gmm`` call, peak memory, the
    tokens; then, on rank 0, the unsharded prefill, ticks and step on the
    card from the same state and batch (``_train_unsharded``)."""
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import steps as st
    cuda = card_dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = _ep_cfg(smoke)
    mesh = make_mesh(MESH_TP, ("data", "model"), card_dev)
    rules = shd.default_rules()
    lay = st.state_layouts(cfg, mesh, rules)
    batch = to_dev(synthetic_batch(DataConfig(
        seq_len=MESH_SEQ, global_batch=1, vocab=cfg.vocab, seed=seed), 0),
        card_dev)
    prompt = {"tokens": batch["tokens"]}
    gen = lambda: torch.Generator(device=card_dev).manual_seed(seed)
    state = _state_blocks(cfg, lay, gen(), card_dev)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()

    out = _mesh_serve(state.params, st.make_prefill_step(
        cfg, MESH_SEQ + MESH_TICKS, mesh, rules, 1),
        st.make_serve_step(cfg, mesh, rules, 1), prompt, card_dev, sync)
    out["gmm_experts"] = out.pop("shapes")["moe_gmm"]
    out.update(serve_seconds=time.perf_counter() - t0,
               serve_peak=torch.cuda.max_memory_allocated() if cuda else 0)
    del state
    got, trained = _train_sharded(cfg, mesh, rules, lay, batch, gen,
                                  card_dev, sync, rank == 0, global_batch=1)
    out.update(got)
    if rank:
        out.pop("logits")
        return out
    _fresh(cuda)
    plain_state = st.init_train_state(cfg, gen(), card_dev)
    with torch.no_grad():
        want = _mesh_serve(plain_state.params,
                           api.prefill_fn(cfg, MESH_SEQ + MESH_TICKS),
                           st.make_serve_step(cfg), prompt, card_dev, sync)
    out["serve_peak_unsharded"] = torch.cuda.max_memory_allocated() \
        if cuda else 0
    del plain_state
    logits = out.pop("logits")
    out.update(logits_err=(logits - want["logits"]).abs().max().item(),
               logits_max=want["logits"].abs().max().item(),
               tokens_unsharded=want["tokens"])
    out.update(_train_unsharded(cfg, gen, card_dev, batch, trained, sync))
    return out


def _ep_tick_without_sync(cfg, seed: int) -> None:
    """One serve tick of the expert-parallel step of 21(f) under sync debug
    mode "error", on rank 0's blocks in one process: on an abstract (1, 2)
    mesh, whose collectives are shapes only (over gloo every collective
    of a CUDA tensor is staged through the host), so it holds the layer
    code, the routing and the dispatch to no host sync."""
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import api
    from repro_torch.models.common import init_params
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import steps as st
    from repro_torch.parallel.comm import AbstractMesh
    from repro_torch.tree import tree_map
    am = AbstractMesh(MESH_TP, ("data", "model"))
    rules = shd.default_rules()
    lay = st.state_layouts(cfg, am, rules).params
    params = tree_map(lambda x, l: l.shard(x), init_params(
        api.param_spec(cfg), torch.Generator(device="cuda").manual_seed(
            seed), "cuda"), lay)
    gc.collect()
    tokens = torch.from_numpy(synthetic_batch(DataConfig(
        seq_len=MESH_SEQ, global_batch=1, vocab=cfg.vocab, seed=seed),
        0)["tokens"]).cuda()
    logits, cache = st.make_prefill_step(cfg, MESH_SEQ + 1, am, rules, 1)(
        params, {"tokens": tokens})
    tick = st.make_serve_step(cfg, am, rules, 1)
    tok = {"token": torch.argmax(logits, -1).to(torch.int32)[:, None],
           "kv_len": torch.full((1,), MESH_SEQ, dtype=torch.int32,
                                device="cuda")}
    tick(params, tok, cache)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _ = tick(params, tok, cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(0 <= int(got["token"].max()) < cfg.vocab, "the tick's token "
          f"{got['token']} is out of the vocab")


def mesh_ep(seed: int, smi: str, card_dev: str = "cuda",
            smoke: bool = False) -> dict:
    """21(f): :func:`_ep_run` in two processes on the one card on the (1, 2)
    mesh, expert parallel: the prefill's logits within 1e-5 of max |logit|
    of the unsharded prefill's, the four ticks' tokens equal to the
    unsharded ones, the train step at the base lr held against the
    unsharded one in fp32 and float64 (``_hold_trained``); each rank's
    ``moe_gmm`` launches on E/2 experts (32), its launches those of a
    prefill (2 flash attentions, 5 RMSNorms, 3 ``moe_gmm``), of the ticks
    (per tick 2 flash decodes, 5 RMSNorms, 3 ``moe_gmm``) and of a train
    step (4 flash attentions), and its op counts of the three equal to
    the dry run's trace on an abstract (1, 2) mesh; then one tick under
    sync debug mode "error" (:func:`_ep_tick_without_sync`).  Prints each
    rank's peak memory beside the unsharded run's."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.parallel.comm import AbstractMesh
    cfg = _ep_cfg(smoke)
    ranks, t_ranks = _two_ranks(_ep_run, seed, card_dev, smoke)
    t0 = time.perf_counter()
    am = AbstractMesh(MESH_TP, ("data", "model"))
    for kind, seq, key in (("train", MESH_SEQ, "train_counts"),
                           ("prefill", MESH_SEQ, "prefill_counts"),
                           ("decode", MESH_SEQ + MESH_TICKS,
                            "tick_counts")):
        cell = dryrun.trace_cell(cfg, InputShape("cut", seq, 1, kind),
                                 am)["hlo_analysis"]
        want = json.loads(json.dumps({k: cell[k] for k in (
            "flops", "collective_bytes", "collective_counts")}))
        for r, got in enumerate(ranks):
            check(got[key] == want, f"rank {r}'s {kind} op counts "
                  f"{got[key]} differ from the dry run's {want}")
    t_trace = time.perf_counter() - t0
    half = cfg.n_experts // MESH_TP[1]
    for r, got in enumerate(ranks):
        check(got["gmm_experts"] == [half] * 3 * (1 + MESH_TICKS),
              f"rank {r}'s moe_gmm calls took {got['gmm_experts']} experts")
    if card_dev == "cuda":
        n = cfg.n_layers
        prefill = dict(train_launches(cfg, 0), flash_attention=n,
                       rmsnorm=2 * n + 1, moe_gmm=3)
        ticks = dict(train_launches(cfg, 0), flash_decode=n * MESH_TICKS,
                     rmsnorm=(2 * n + 1) * MESH_TICKS,
                     moe_gmm=3 * MESH_TICKS)
        for r, got in enumerate(ranks):
            for part, want in (("prefill", prefill), ("tick", ticks),
                               ("train", train_launches(cfg, 1))):
                check(got[f"{part}_launches"] == want, f"rank {r}'s {part} "
                      f"launched {got[f'{part}_launches']}, not {want}")
    r0 = ranks[0]
    held = _hold_trained("21(f)", r0)
    check(r0["logits_err"] <= 1e-5 * r0["logits_max"],
          f"expert-parallel prefill logits off by {r0['logits_err']} "
          f"(max |logit| {r0['logits_max']})")
    check(r0["tokens"] == r0["tokens_unsharded"] == ranks[1]["tokens"],
          f"expert-parallel tokens {r0['tokens']} against the unsharded "
          f"{r0['tokens_unsharded']}")
    synced = "not run on the CPU"
    if card_dev == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        _ep_tick_without_sync(cfg, seed)
        synced = "none"
    launched = {k: sum(r[f"{p}_launches"][k] for r in ranks
                       for p in ("prefill", "tick", "train"))
                for k in r0["train_launches"]}
    print(f"  21(f) {cfg.name} {cfg.n_layers} layers (the dense first one "
          f"and one of {cfg.n_experts} experts, top-{cfg.top_k}), 1 x "
          f"{MESH_SEQ} tokens on a {MESH_TP} mesh, two processes on one card "
          f"over gloo, {half} experts a rank: prefill logits |diff| "
          f"{r0['logits_err']:.3e} of max {r0['logits_max']:.3f}; "
          f"{MESH_TICKS} ticks' tokens equal {r0['tokens']}; {held}; "
          f"moe_gmm calls a rank {len(r0['gmm_experts'])}, each "
          f"on {half} experts; launches a rank: prefill "
          f"{r0['prefill_launches']}, ticks {r0['tick_launches']}, step "
          f"{r0['train_launches']}; op counts = the dry run's (step "
          f"{r0['train_counts']['collective_counts']}, tick "
          f"{r0['tick_counts']['collective_counts']}); host syncs in a tick "
          f"under sync debug mode \"error\": {synced}; peak memory a rank "
          f"served {[round(r['serve_peak'] / 1e9, 3) for r in ranks]} GB "
          f"(unsharded {r0['serve_peak_unsharded'] / 1e9:.3f}), trained "
          f"{[round(r['peak'] / 1e9, 3) for r in ranks]} GB (unsharded "
          f"{r0['peak_unsharded'] / 1e9:.3f}); seconds: the two processes "
          f"{t_ranks:.1f} (rank 0's sharded serving "
          f"{r0['serve_seconds']:.1f}, step {r0['seconds']:.1f}), the dry "
          f"run's traces {t_trace:.1f}; card {smi}")
    return {**_trained_record(r0),
            "logits_err": r0["logits_err"], "logits_max": r0["logits_max"],
            "tokens": r0["tokens"], "launches": launched,
            "gmm_experts": r0["gmm_experts"], "counts": r0["train_counts"],
            "tick_counts": r0["tick_counts"],
            "peak_bytes": [r["serve_peak"] for r in ranks],
            "peak_unsharded_bytes": r0["serve_peak_unsharded"]}


# 21(g): tensor parallelism of MLA on the card, two processes on the one
# card over gloo on the (1, 2) mesh of 21(d): full-width deepseek_v2_236b
# cut to its dense first layer and one MoE layer (64 of 128 heads, 80 of
# 160 experts a rank) served, and cut to its dense first layer trained;
# full-width minicpm3_4b cut to 2 layers (20 of 40 heads a rank) served
# and trained
MLA_CUTS = (("deepseek_v2_236b", 2, "serve"), ("deepseek_v2_236b", 1,
                                                "train"),
            ("minicpm3_4b", 2, "serve"), ("minicpm3_4b", 2, "train"))


def _mla_cfg(arch: str, n_layers: int, smoke: bool):
    """``arch`` at full width (reduced in the CPU rehearsal) cut to
    ``n_layers``, fp32, one microbatch; a MoE model cut to no more layers
    than its dense first ones is the dense decoder of those layers."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.reduced()
    if cfg.family == "moe" and n_layers <= cfg.first_dense:
        cfg = cfg.replace(family="dense", first_dense=0)
    return cfg.replace(n_layers=n_layers, dtype="float32", accum=1,
                       attn_impl="chunked" if smoke else "kernel")


def _blocks_from_seed(spec, lay, gen, dev):
    """This device's blocks of the parameters ``init_params(spec, gen,
    dev)`` draws, drawn a leaf at a time in its order, so that the whole
    tree is never on the card."""
    from repro_torch.models.common import ParamSpec, init_params
    if isinstance(spec, ParamSpec):
        return lay.shard(init_params(spec, gen, dev))
    return {k: _blocks_from_seed(v, lay[k], gen, dev)
            for k, v in spec.items()}


def _mla_run(rank: int, seed: int, card_dev: str, smoke: bool) -> dict:
    """One rank of 21(g), each cut of ``MLA_CUTS`` in turn on this rank's
    blocks (half the heads of wq_b, wkv_b and wo, half the experts, the
    MLPs and the vocab; 64 of the 128 rows of the stream): a cut served
    runs the 1 x 128 mesh prefill and four greedy ticks (logits, tokens,
    launches, op counts, the wrappers' shapes, this rank's peak memory);
    a cut trained runs one step at the base lr in fp32 and float64 (part
    A, ``_train_sharded``).  Then, on rank 0, each cut unsharded on the
    card from the same seed, every sharded tensor freed first
    (``_train_unsharded`` for a trained one)."""
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.models.common import init_params
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import steps as st
    cuda = card_dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    mesh = make_mesh(MESH_TP, ("data", "model"), card_dev)
    rules = shd.default_rules()
    gen = lambda: torch.Generator(device=card_dev).manual_seed(seed)
    out, wholes = {}, {}
    for arch, n, part in MLA_CUTS:
        cfg = _mla_cfg(arch, n, smoke)
        batch = to_dev(synthetic_batch(DataConfig(
            seq_len=MESH_SEQ, global_batch=1, vocab=cfg.vocab, seed=seed),
            0), card_dev)
        lay = st.state_layouts(cfg, mesh, rules)
        if part == "serve":
            _fresh(cuda)
            t0 = time.perf_counter()
            params = _blocks_from_seed(api.param_spec(cfg), lay.params,
                                       gen(), card_dev)
            got = _mesh_serve(
                params, st.make_prefill_step(
                    cfg, MESH_SEQ + MESH_TICKS, mesh, rules, 1),
                st.make_serve_step(cfg, mesh, rules, 1),
                {"tokens": batch["tokens"]}, card_dev, sync)
            del params
            sync()
            got.update(seconds=time.perf_counter() - t0,
                       peak=torch.cuda.max_memory_allocated() if cuda else 0)
        else:
            got, trained = _train_sharded(cfg, mesh, rules, lay, batch, gen,
                                          card_dev, sync, rank == 0,
                                          global_batch=1)
            if rank == 0:
                wholes[arch] = trained
            del trained
        out[f"{arch}/{part}"] = got
    if rank:
        for got in out.values():
            got.pop("logits", None)
        return out
    for arch, n, part in MLA_CUTS:
        cfg = _mla_cfg(arch, n, smoke)
        batch = to_dev(synthetic_batch(DataConfig(
            seq_len=MESH_SEQ, global_batch=1, vocab=cfg.vocab, seed=seed),
            0), card_dev)
        got = out[f"{arch}/{part}"]
        if part == "train":
            got.update(_train_unsharded(cfg, gen, card_dev, batch,
                                        wholes.pop(arch), sync))
            continue
        _fresh(cuda)
        params = init_params(api.param_spec(cfg), gen(), card_dev)
        with torch.no_grad():
            want = _mesh_serve(
                params, api.prefill_fn(cfg, MESH_SEQ + MESH_TICKS),
                st.make_serve_step(cfg), {"tokens": batch["tokens"]},
                card_dev, sync)
        del params
        # over the real vocab: the padded columns hold -1e30
        logits = got.pop("logits")[..., :cfg.vocab]
        plain = want["logits"][..., :cfg.vocab]
        got.update(
            logits_err=(logits - plain).abs().max().item(),
            logits_max=plain.abs().max().item(),
            tokens_unsharded=want["tokens"],
            peak_unsharded=torch.cuda.max_memory_allocated() if cuda else 0)
    return out


def _mla_want_launches(cfg, part: str) -> dict:
    """The launches a rank's cut of 21(g) makes: a prefill's flash
    attention a layer, the latent flash decode a layer a tick, four norms
    a layer (ln1, ln2, q_norm, kv_norm) and the final one a prefill and a
    tick, three grouped matmuls a MoE layer a prefill and a tick; a train
    step's two flash attentions a layer (``train_launches``)."""
    if part == "train":
        return {"train": train_launches(cfg, 1)}
    n, moe = cfg.n_layers, 3 * (cfg.n_layers - cfg.first_dense) \
        if cfg.family == "moe" else 0
    norms = (4 if cfg.q_lora else 3) * n + 1
    return {"prefill": dict(train_launches(cfg, 0), flash_attention=n,
                            rmsnorm=norms, moe_gmm=moe),
            "tick": dict(train_launches(cfg, 0),
                         flash_decode=n * MESH_TICKS,
                         rmsnorm=norms * MESH_TICKS,
                         moe_gmm=moe * MESH_TICKS)}


def mesh_mla(seed: int, smi: str, card_dev: str = "cuda",
             smoke: bool = False) -> dict:
    """21(g): :func:`_mla_run` in two processes on the one card on the (1, 2)
    mesh, tensor parallel over MLA's heads: each served cut's prefill
    logits within 1e-5 of max |logit| of the unsharded prefill's and its
    four ticks' tokens equal to the unsharded ones, each rank's flash
    attentions and latent flash decodes on half the heads at the model's
    widths and its grouped matmuls on half the experts; each trained
    cut's step at the base lr held against the unsharded one in fp32 and
    float64 (``_hold_trained``); each rank's launches those of its cut
    and its op counts equal to the dry run's trace of the same cells on
    an abstract (1, 2) mesh.  Prints each rank's peak memory beside the
    unsharded run's."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.parallel.comm import AbstractMesh
    ranks, t_ranks = _two_ranks(_mla_run, seed, card_dev, smoke)
    t0 = time.perf_counter()
    am = AbstractMesh(MESH_TP, ("data", "model"))
    m = MESH_TP[1]
    result, launched = {}, {}
    for arch, n, part in MLA_CUTS:
        cfg = _mla_cfg(arch, n, smoke)
        key = f"{arch}/{part}"
        cells = (("train", MESH_SEQ, "train_counts"),) if part == "train" \
            else (("prefill", MESH_SEQ, "prefill_counts"),
                  ("decode", MESH_SEQ + MESH_TICKS, "tick_counts"))
        for kind, seq, ckey in cells:
            cell = dryrun.trace_cell(cfg, InputShape("cut", seq, 1, kind),
                                     am)["hlo_analysis"]
            want = json.loads(json.dumps({k: cell[k] for k in (
                "flops", "collective_bytes", "collective_counts")}))
            for r, rk in enumerate(ranks):
                check(rk[key][ckey] == want, f"21(g) {key}: rank {r}'s "
                      f"{kind} op counts {rk[key][ckey]} differ from the "
                      f"dry run's {want}")
        if card_dev == "cuda":
            for p, want in _mla_want_launches(cfg, part).items():
                for r, rk in enumerate(ranks):
                    check(rk[key][f"{p}_launches"] == want, f"21(g) {key}: "
                          f"rank {r}'s {p} launched "
                          f"{rk[key][f'{p}_launches']}, not {want}")
        r0 = ranks[0][key]
        for p in ("prefill", "tick", "train"):
            if f"{p}_launches" in r0:
                for k, v in r0[f"{p}_launches"].items():
                    launched[k] = launched.get(k, 0) + sum(
                        rk[key][f"{p}_launches"][k] for rk in ranks)
        if part == "serve":
            heads = cfg.n_heads // m
            attn = [heads, cfg.qk_nope + cfg.qk_rope, cfg.v_head]
            latent = [heads, cfg.kv_lora + cfg.qk_rope, cfg.kv_lora]
            experts = cfg.n_experts // m if cfg.family == "moe" else None
            for r, rk in enumerate(ranks):
                sh = rk[key]["shapes"]
                # the CPU rehearsal's prefill attention is the plain one
                check(sh["flash_attention"] == [attn] * cfg.n_layers
                      or smoke, f"21(g) {key}: rank {r}'s flash attentions "
                      f"took {sh['flash_attention']}, not {attn} a layer")
                check(sh["flash_decode"] == [latent] * cfg.n_layers
                      * MESH_TICKS, f"21(g) {key}: rank {r}'s flash "
                      f"decodes took {sh['flash_decode']}, not {latent}")
                check(sh["moe_gmm"] == ([experts] * 3 * (
                    1 + MESH_TICKS) if experts else []),
                      f"21(g) {key}: rank {r}'s grouped matmuls took "
                      f"{sh['moe_gmm']} experts")
            check(r0["logits_err"] <= 1e-5 * r0["logits_max"],
                  f"21(g) {key}: prefill logits off by {r0['logits_err']} "
                  f"(max |logit| {r0['logits_max']})")
            check(r0["tokens"] == r0["tokens_unsharded"]
                  == ranks[1][key]["tokens"], f"21(g) {key}: tokens "
                  f"{r0['tokens']} against the unsharded "
                  f"{r0['tokens_unsharded']}")
            print(f"  21(g) {cfg.name} {n} layers served, 1 x {MESH_SEQ} "
                  f"tokens on a {MESH_TP} mesh, two processes on one card "
                  f"over gloo: {heads} of {cfg.n_heads} heads a rank "
                  f"(flash attention {attn}, latent flash decode {latent})"
                  + (f", {experts} of {cfg.n_experts} experts a rank"
                     if experts else "") + f"; prefill logits |diff| "
                  f"{r0['logits_err']:.3e} of max {r0['logits_max']:.3f}; "
                  f"{MESH_TICKS} ticks' tokens equal {r0['tokens']}; "
                  f"launches a rank: prefill {r0['prefill_launches']}, "
                  f"ticks {r0['tick_launches']}; op counts = the dry "
                  f"run's (prefill {r0['prefill_counts']['collective_counts']}"
                  f", tick {r0['tick_counts']['collective_counts']}); peak "
                  f"memory a rank "
                  f"{[round(rk[key]['peak'] / 1e9, 3) for rk in ranks]} GB, "
                  f"unsharded {r0['peak_unsharded'] / 1e9:.3f} GB; rank 0's "
                  f"sharded seconds {r0['seconds']:.1f}; card {smi}")
        else:
            held = _hold_trained(f"21(g) {key}", r0)
            print(f"  21(g) {cfg.name} {n} layer(s) trained, 1 x {MESH_SEQ} "
                  f"tokens on a {MESH_TP} mesh, {held}; launches a rank "
                  f"{r0['train_launches']}; op counts = the dry run's "
                  f"({r0['train_counts']['collective_counts']}); peak memory "
                  f"a rank {[round(rk[key]['peak'] / 1e9, 3) for rk in ranks]}"
                  f" GB, unsharded {r0['peak_unsharded'] / 1e9:.3f} GB; rank "
                  f"0's sharded seconds {r0['seconds']:.1f}; card {smi}")
        result[key] = r0
    print(f"  21(g) seconds: the two processes {t_ranks:.1f}, the dry "
          f"run's traces {time.perf_counter() - t0:.1f}")
    return {"cuts": result, "launches": launched}


# 21(h): tensor and sequence parallelism of the hybrid on the card, two
# processes on the one card over gloo on the (1, 2) mesh of 21(d):
# full-width zamba2_7b cut to its first group (6 Mamba2 layers and one
# application of a shared attention block) and one rest layer, 56 of the
# 112 Mamba2 heads and 16 of the 32 attention heads a rank, served and
# trained
HYBRID_LAYERS = 7


def _hybrid_cfg(smoke: bool):
    """zamba2_7b at full width (reduced in the CPU rehearsal) cut to
    HYBRID_LAYERS: one group of ``attn_every`` (6) Mamba2 layers, one
    application of a shared attention block and one rest layer; fp32, one
    microbatch.  One group applies only the first of the shared weight
    sets, so the cut keeps that one (an unused set would take no
    gradient)."""
    from repro_torch.configs import get_config
    cfg = get_config("zamba2_7b")
    if smoke:
        cfg = cfg.reduced().replace(attn_every=6)
    return cfg.replace(n_layers=HYBRID_LAYERS, n_shared_attn=1,
                       dtype="float32", accum=1,
                       attn_impl="chunked" if smoke else "kernel")


def _hybrid_run(rank: int, seed: int, card_dev: str, smoke: bool) -> dict:
    """One rank of 21(h): the 1 x 128 mesh prefill of the cut zamba2_7b and
    four greedy ticks on this rank's blocks (its heads of the Mamba2
    layers' gated-norm scale and out_proj, in_proj and the conv gathered
    whole and sliced, half the attention heads, the MLP and the vocab; 64
    of the 128 rows of the stream): logits, tokens, launches, op counts,
    the wrappers' shapes, this rank's peak memory; then one train step at
    the base lr in fp32 and float64 (part A, ``_train_sharded``).  Then,
    on rank 0, the unsharded prefill, ticks and step from the same seed
    (``_train_unsharded``)."""
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.models.common import init_params
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import steps as st
    cuda = card_dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = _hybrid_cfg(smoke)
    mesh = make_mesh(MESH_TP, ("data", "model"), card_dev)
    rules = shd.default_rules()
    lay = st.state_layouts(cfg, mesh, rules)
    batch = to_dev(synthetic_batch(DataConfig(
        seq_len=MESH_SEQ, global_batch=1, vocab=cfg.vocab, seed=seed), 0),
        card_dev)
    prompt = {"tokens": batch["tokens"]}
    gen = lambda: torch.Generator(device=card_dev).manual_seed(seed)
    _fresh(cuda)
    t0 = time.perf_counter()
    params = _blocks_from_seed(api.param_spec(cfg), lay.params, gen(),
                               card_dev)
    out = _mesh_serve(params, st.make_prefill_step(
        cfg, MESH_SEQ + MESH_TICKS, mesh, rules, 1),
        st.make_serve_step(cfg, mesh, rules, 1), prompt, card_dev, sync)
    del params
    sync()
    out.update(serve_seconds=time.perf_counter() - t0,
               serve_peak=torch.cuda.max_memory_allocated() if cuda else 0)
    got, trained = _train_sharded(cfg, mesh, rules, lay, batch, gen,
                                  card_dev, sync, rank == 0, global_batch=1)
    out.update(got)
    if rank:
        out.pop("logits")
        return out
    _fresh(cuda)
    params = init_params(api.param_spec(cfg), gen(), card_dev)
    with torch.no_grad():
        want = _mesh_serve(params, api.prefill_fn(cfg, MESH_SEQ + MESH_TICKS),
                           st.make_serve_step(cfg), prompt, card_dev, sync)
    out["serve_peak_unsharded"] = torch.cuda.max_memory_allocated() \
        if cuda else 0
    del params
    logits = out.pop("logits")[..., :cfg.vocab]
    plain = want["logits"][..., :cfg.vocab]
    out.update(logits_err=(logits - plain).abs().max().item(),
               logits_max=plain.abs().max().item(),
               tokens_unsharded=want["tokens"])
    out.update(_train_unsharded(cfg, gen, card_dev, batch, trained, sync))
    return out


def _hybrid_want_launches(cfg) -> dict:
    """The launches a rank of 21(h) makes: a prefill's SSD scan a Mamba2
    layer, a flash attention a shared application, the split gated norm's
    two entries a Mamba2 layer, and the RMSNorm kernel for the Mamba2
    layers' pre-norms, the shared blocks' two and the final one; a tick
    the same but a flash decode for the attention and no scan (the SSD
    step is plain); a train step one flash attention a shared application
    (run without remat, as JAX's ``group_body`` runs it; the norms and the
    SSD are plain on the training route)."""
    n, groups = cfg.n_layers, cfg.n_layers // cfg.attn_every
    norms = {"rmsnorm": n + 2 * groups + 1, "rmsnorm_sumsq": n,
             "rmsnorm_scaled": n}
    zero = train_launches(cfg, 0)
    return {"prefill": dict(zero, mamba_scan=n, flash_attention=groups,
                            **norms),
            "tick": dict(zero, flash_decode=groups * MESH_TICKS,
                         **{k: v * MESH_TICKS for k, v in norms.items()}),
            "train": dict(zero, flash_attention=groups)}


def mesh_hybrid(seed: int, smi: str, card_dev: str = "cuda",
                smoke: bool = False) -> dict:
    """21(h): :func:`_hybrid_run` in two processes on the one card on the
    (1, 2) mesh, tensor parallel over the Mamba2 heads and the shared
    attention's: the prefill's logits within 1e-5 of max |logit| of the
    unsharded prefill's and its four ticks' tokens equal to the unsharded
    ones; each rank's SSD scans on half the Mamba2 heads, its flash
    attentions and flash decodes on half the attention heads at D 112,
    its split-norm entries on half the gated norm's channels, its
    launches those of its cut (``_hybrid_want_launches``) and its op
    counts the dry run's trace of the same cells on an abstract (1, 2)
    mesh; the train step at the base lr held against the unsharded one in
    fp32 and float64 (``_hold_trained``).  Prints each rank's peak memory
    beside the unsharded run's."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.parallel.comm import AbstractMesh
    cfg = _hybrid_cfg(smoke)
    ranks, t_ranks = _two_ranks(_hybrid_run, seed, card_dev, smoke)
    t0 = time.perf_counter()
    am = AbstractMesh(MESH_TP, ("data", "model"))
    for kind, seq, key in (("train", MESH_SEQ, "train_counts"),
                           ("prefill", MESH_SEQ, "prefill_counts"),
                           ("decode", MESH_SEQ + MESH_TICKS,
                            "tick_counts")):
        cell = dryrun.trace_cell(cfg, InputShape("cut", seq, 1, kind),
                                 am)["hlo_analysis"]
        want = json.loads(json.dumps({k: cell[k] for k in (
            "flops", "collective_bytes", "collective_counts")}))
        for r, got in enumerate(ranks):
            check(got[key] == want, f"21(h): rank {r}'s {kind} op counts "
                  f"{got[key]} differ from the dry run's {want}")
    t_trace = time.perf_counter() - t0
    m = MESH_TP[1]
    h = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    n, groups = cfg.n_layers, cfg.n_layers // cfg.attn_every
    attn = [cfg.n_heads // m, cfg.dh, cfg.dh]
    for r, rk in enumerate(ranks):
        sh = rk["shapes"]
        check(sh["mamba_scan"] == [h // m] * n or smoke, f"21(h): rank {r}'s "
              f"SSD scans took {sh['mamba_scan']} heads, not {h // m}")
        # the CPU rehearsal's prefill attention is the plain one
        check(sh["flash_attention"] == [attn] * groups or smoke,
              f"21(h): rank {r}'s flash attentions took "
              f"{sh['flash_attention']}, not {attn}")
        check(sh["flash_decode"] == [attn] * groups * MESH_TICKS,
              f"21(h): rank {r}'s flash decodes took {sh['flash_decode']}")
        width = cfg.ssm_expand * cfg.d_model // m
        for e in ("rmsnorm_sumsq", "rmsnorm_scaled"):
            check(sh[e] == [width] * n * (1 + MESH_TICKS), f"21(h): rank "
                  f"{r}'s {e} calls took widths {sh[e]}, not {width}")
    if card_dev == "cuda":
        for p, want in _hybrid_want_launches(cfg).items():
            for r, rk in enumerate(ranks):
                check(rk[f"{p}_launches"] == want, f"21(h): rank {r}'s {p} "
                      f"launched {rk[f'{p}_launches']}, not {want}")
    r0 = ranks[0]
    check(r0["logits_err"] <= 1e-5 * r0["logits_max"],
          f"21(h): prefill logits off by {r0['logits_err']} (max |logit| "
          f"{r0['logits_max']})")
    check(r0["tokens"] == r0["tokens_unsharded"] == ranks[1]["tokens"],
          f"21(h): tokens {r0['tokens']} against the unsharded "
          f"{r0['tokens_unsharded']}")
    held = _hold_trained("21(h)", r0)
    launched = {k: sum(rk[f"{p}_launches"][k] for rk in ranks
                       for p in ("prefill", "tick", "train"))
                for k in r0["train_launches"]}
    print(f"  21(h) {cfg.name} {n} layers ({groups} group(s) of "
          f"{cfg.attn_every} Mamba2 layers and a shared attention block, "
          f"{n % cfg.attn_every} rest), 1 x {MESH_SEQ} tokens on a {MESH_TP} "
          f"mesh, two processes on one card over gloo: {h // m} of {h} "
          f"Mamba2 heads and {attn[0]} of {cfg.n_heads} attention heads a "
          f"rank (SSD scans {r0['shapes']['mamba_scan']} heads, flash "
          f"attention {attn}, split norm {width} of "
          f"{cfg.ssm_expand * cfg.d_model} channels); prefill logits |diff| "
          f"{r0['logits_err']:.3e} of max {r0['logits_max']:.3f}; "
          f"{MESH_TICKS} ticks' tokens equal {r0['tokens']}; {held}; "
          f"launches a rank: prefill {r0['prefill_launches']}, ticks "
          f"{r0['tick_launches']}, step {r0['train_launches']}; op counts = "
          f"the dry run's (prefill "
          f"{r0['prefill_counts']['collective_counts']}, tick "
          f"{r0['tick_counts']['collective_counts']}, step "
          f"{r0['train_counts']['collective_counts']}); peak memory a rank "
          f"served {[round(rk['serve_peak'] / 1e9, 3) for rk in ranks]} GB "
          f"(unsharded {r0['serve_peak_unsharded'] / 1e9:.3f}), trained "
          f"{[round(rk['peak'] / 1e9, 3) for rk in ranks]} GB (unsharded "
          f"{r0['peak_unsharded'] / 1e9:.3f}); seconds: the two processes "
          f"{t_ranks:.1f} (rank 0's sharded serving "
          f"{r0['serve_seconds']:.1f}, step {r0['seconds']:.1f}), the dry "
          f"run's traces {t_trace:.1f}; card {smi}")
    return {**_trained_record(r0), "logits_err": r0["logits_err"],
            "logits_max": r0["logits_max"], "tokens": r0["tokens"],
            "shapes": r0["shapes"], "launches": launched,
            "counts": r0["train_counts"],
            "serve_peak_bytes": [rk["serve_peak"] for rk in ranks],
            "serve_peak_unsharded_bytes": r0["serve_peak_unsharded"],
            "peak_bytes": [rk["peak"] for rk in ranks],
            "peak_unsharded_bytes": r0["peak_unsharded"]}


def phase_mesh(seed: int, smi: str, card_dev: str = "cuda",
               smoke: bool = False) -> dict:
    """Phase 21: the mesh layer (``parallel.sharding``, ``comm``,
    ``collectives``, ``pipeline``, the sharded ``parallel.steps``) on a
    one-rank (1, 1) ("data", "model") mesh over NCCL, started on a file
    store under a temporary directory, and the dry run's counter against
    the step the card runs; then two processes on the card over gloo:
    the tensor- and sequence-parallel step (21(d), :func:`mesh_tp`), the
    FSDP step that gathers a layer at a time (21(e), :func:`mesh_fsdp`),
    the expert-parallel MoE steps (21(f), :func:`mesh_ep`), the
    tensor-parallel MLA steps (21(g), :func:`mesh_mla`) and the tensor-
    and sequence-parallel hybrid (21(h), :func:`mesh_hybrid`).
    ``card_dev="cpu"`` with ``smoke`` rehearses it on gloo with the
    reduced config and chunked attention (the CPU's attention is the
    oracle's, whose backward the card's does not share)."""
    import datetime
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import steps as st
    from repro_torch.parallel.comm import AbstractMesh
    cfg = _mesh_cfg(smoke)
    gc.collect()
    _release_host_memory()
    print(f"  the main process's host memory: {_rss_gb():.2f} GB")
    tmp = tempfile.mkdtemp(prefix="mesh_store_")
    dist.init_process_group("nccl" if card_dev == "cuda" else "gloo",
                            init_method=f"file://{tmp}/store", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), card_dev)
        out = mesh_step(cfg, seed, card_dev, mesh)
        out["collectives"] = mesh_collectives(card_dev, mesh)
        # (c) the dry run's count of this cell against the card's step
        cell = dryrun.trace_cell(cfg, InputShape("cut", MESH_SEQ, 1,
                                                 "train"),
                                 AbstractMesh((1, 1), ("data", "model")))
        check(cell["hlo_analysis"]["flops"] == out["flops"],
              f"the dry run counts {cell['hlo_analysis']['flops']} FLOPs, "
              f"the card's step {out['flops']}")
        check(cell["hlo_analysis"]["collective_bytes"]
              == out["collective_bytes"], "the dry run's collective bytes "
              f"{cell['hlo_analysis']['collective_bytes']} differ from the "
              f"card step's {out['collective_bytes']}")
        step, lay, batch = out.pop("step"), out.pop("layouts"), \
            out.pop("batch")
        state = st.shard_state(st.init_train_state(cfg, torch.Generator(
            device=card_dev).manual_seed(seed), card_dev), lay)
        if card_dev == "cuda":
            ms = median_event_ms(lambda: step(state, batch), iters=5,
                                 warmup=1)
        else:
            ms = float(np.median([cpu_ms(lambda: step(state, batch))
                                  for _ in range(3)]))
        del state
        h = cell["roofline_h100"]
        print(f"  dry run of the cut cell: {cell['hlo_analysis']['flops']} "
              f"FLOPs = the card step's count; step {ms:.3f} ms (median of "
              f"5) against the H100 roofline's t_bound "
              f"{h['t_bound'] * 1e3:.3f} ms ({h['bound']}-bound at "
              f"{h['peak_flops']:.3g} FLOP/s, {h['hbm_bytes_per_device']:.4g}"
              f" HBM bytes); peak estimate "
              f"{cell['memory']['peak_estimate_gb']} GB; card {smi}")
        out.update(step_ms=ms, t_bound_ms=h["t_bound"] * 1e3,
                   bound=h["bound"], dryrun_flops=cell["hlo_analysis"]
                   ["flops"], peak_estimate_gb=cell["memory"]
                   ["peak_estimate_gb"])
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["tp"] = mesh_tp(seed, smi, card_dev, smoke)
    gc.collect()
    torch.cuda.empty_cache()
    out["fsdp"] = mesh_fsdp(seed, smi, card_dev, smoke)
    gc.collect()
    torch.cuda.empty_cache()
    out["ep"] = mesh_ep(seed, smi, card_dev, smoke)
    gc.collect()
    torch.cuda.empty_cache()
    out["mla"] = mesh_mla(seed, smi, card_dev, smoke)
    gc.collect()
    torch.cuda.empty_cache()
    out["hybrid"] = mesh_hybrid(seed, smi, card_dev, smoke)
    print("[21] " + json.dumps({"mesh": {**{k: v for k, v in out.items()
                                            if k != "events_added"},
                                         "card": smi}}))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = 0

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[1] card: {smi}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library()
    print(f"[1] kernels built in {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.BUILD_SECONDS:.1f} s)")
    kernel_report()

    def phase(n, label, fn, *args):
        print(f"[{n}] {label}")
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[{n}] {time.perf_counter() - t0:.1f} s")
        return out

    rows = phase(2, "kernels against their plain versions", phase_kernels,
                 torch.Generator(device="cuda").manual_seed(seed))
    phase(3, "full-width 2-layer glm4_9b, card against CPU", phase_cut,
          "glm4_9b", 2, seed)
    by_path = {"glm4_9b": phase(4, "serving full glm4_9b", phase_serve,
                                "glm4_9b", seed, 128, 1,
                                functools.partial(lone_prefill,
                                                  ("flash_attention",)))}
    gc.collect()
    torch.cuda.empty_cache()        # glm4_9b's weights are gone
    phase(5, "full-width 13-layer zamba2_7b, card against CPU", phase_cut,
          "zamba2_7b", 13, seed)
    by_path["zamba2_7b"] = phase(
        6, "serving full zamba2_7b", phase_serve, "zamba2_7b", seed, 64, 1,
        functools.partial(lone_prefill, ("mamba_scan", "flash_attention")))
    gc.collect()
    torch.cuda.empty_cache()        # zamba2_7b's weights are gone
    phase(7, "full-width 3-layer deepseek_moe_16b, card against CPU",
          phase_cut, "deepseek_moe_16b", 3, seed)
    by_path["deepseek_moe_16b"] = phase(
        8, "serving full deepseek_moe_16b", phase_serve, "deepseek_moe_16b",
        seed, 128, 1, moe_decode_without_sync)
    gc.collect()
    torch.cuda.empty_cache()        # deepseek_moe_16b's weights are gone
    phase(9, "full 12-layer xlstm_125m, card against CPU", phase_cut,
          "xlstm_125m", 12, seed, 300)
    by_path["xlstm_125m"] = phase(
        10, "serving full xlstm_125m", phase_serve, "xlstm_125m", seed, 128,
        1, functools.partial(lone_prefill, ("slstm_seq",)), (300, 512))
    gc.collect()
    torch.cuda.empty_cache()        # xlstm_125m's weights are gone
    phase(11, "the cost model, card against CPU", phase_cost_model, seed,
          smi)
    phase(12, "the design-space exploration, card against CPU", phase_dse,
          seed, smi)
    phase(13, "the pricing service, card against CPU", phase_service, seed,
          smi)
    gc.collect()
    torch.cuda.empty_cache()
    train = phase(14, "training: full-width glm4_9b and the launcher",
                  phase_train, seed, smi)
    by_path["train"] = train["full"]["launches"]
    del train
    gc.collect()
    torch.cuda.empty_cache()        # glm4_9b's training state is gone
    phase(15, "full-width 2-layer minicpm3_4b (MLA), card against CPU",
          phase_cut, "minicpm3_4b", 2, seed)
    by_path["minicpm3_4b"] = phase(16, "serving full minicpm3_4b",
                                   phase_serve, "minicpm3_4b", seed, 128, 1)
    gc.collect()
    torch.cuda.empty_cache()        # minicpm3_4b's weights are gone
    phase(17, "full-width 2-layer llava_next_mistral_7b, card against CPU",
          phase_cut, "llava_next_mistral_7b", 2, seed, 256, 256)
    by_path["llava_next_mistral_7b"] = phase(
        18, "serving full llava_next_mistral_7b", phase_serve,
        "llava_next_mistral_7b", seed, 128, 1, None, (256, 512),
        vlm_image_request)
    gc.collect()
    torch.cuda.empty_cache()        # llava's weights are gone
    phase(19, "full-width 2 + 2-layer whisper_medium, card against CPU",
          phase_whisper_cut, seed)
    whisper = phase(20, "whisper_medium served and trained at full size",
                    phase_whisper, seed, smi)
    by_path["whisper_medium"] = whisper["served"]
    by_path["whisper_train"] = whisper["train_launches"]
    del whisper
    gc.collect()
    torch.cuda.empty_cache()        # whisper's tensors are gone
    mesh = phase(21, "the mesh layer on a one-rank NCCL mesh, the dry "
                     "run's counter, two-rank tensor- and sequence-"
                     "parallel, FSDP, expert-parallel, MLA and hybrid "
                     "steps",
                 phase_mesh,
                 seed, smi)
    by_path["mesh"] = mesh["launches"]
    by_path["mesh_tp"] = mesh["tp"]["launches"]
    by_path["mesh_fsdp"] = mesh["fsdp"]["launches"]
    by_path["mesh_ep"] = mesh["ep"]["launches"]
    by_path["mesh_mla"] = mesh["mla"]["launches"]
    by_path["mesh_hybrid"] = mesh["hybrid"]["launches"]
    del mesh
    gc.collect()
    torch.cuda.empty_cache()        # the mesh's tensors are gone
    phase(22, "full-width 2-layer deepseek_v2_236b (MLA + 160 experts), "
              "card against CPU", phase_cut, "deepseek_v2_236b", 2, seed)
    by_path["deepseek_v2_236b"] = phase(
        23, "serving full-width deepseek_v2_236b cut to 4 layers",
        phase_serve, "deepseek_v2_236b", seed, 128, 1, None, (256, 512),
        None, 4)

    timed = {"flash_attention": ("float32", "S=512"),
             "flash_decode": ("float32", "T=1024"),
             "rmsnorm": ("float32", "N=4 D=4096"),
             "rmsnorm_sumsq": ("float32", "N=512 W=3584"),
             "rmsnorm_scaled": ("float32", "N=512 W=3584"),
             "mamba_scan": ("float32", "S=512"),
             "moe_gmm": ("float32", "E=64 C=1 D=2048 F=1408"),
             "slstm_seq": ("float32", "B=1 S=512 r=0.02")}
    sources = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:75"),
        "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:62"),
        "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:27"),
        "rmsnorm_sumsq": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                          "src/repro/kernels/rmsnorm.py:27"),
        "rmsnorm_scaled": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                           "src/repro/kernels/rmsnorm.py:27"),
        "mamba_scan": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                       "src/repro/kernels/mamba_scan.py:62"),
        "moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                    "src/repro/kernels/moe_gmm.py:37"),
        "slstm_seq": ("src/repro_torch/kernels/csrc/slstm_seq.cu",
                      "src/repro/kernels/slstm_cell.py:65"),
    }
    kernels = []
    for name, (tag, size) in timed.items():
        r = rows[(name, tag, size)]
        per_path = {arch: n[name] for arch, n in by_path.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": sum(per_path.values()),
            "launches_by_path": per_path,
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
            "library_kernels": r["library_kernels"],
            # every phase-2 row of the kernel, this slice's shapes too
            "rows": [{"dtype": t, "shape": sz, "max_abs_err": x["err"],
                      "ms": x["ms"], "plain_ms": x["plain_ms"],
                      "bound_ms": x["bound"][0], "bound_by": x["bound"][1],
                      "library_ms": x["library_ms"]}
                     for (n, t, sz), x in rows.items() if n == name]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
