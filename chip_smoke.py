#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases; each raises (exit code 1) on failure, nothing is caught, and each
prints its seconds:

1. print the card (nvidia-smi name, power limit); build the CUDA kernels
   from ``src/repro_torch/kernels/csrc`` with nvcc and print the seconds;
   print ptxas's registers, shared memory and spills of the attention
   kernels, of the grouped matmul's tiled and streaming kernels, of the
   four flash-decode and of the eight SSD-scan instantiations, and count
   the tensor-core instructions (HGMMA, HMMA) of the attention, tiled
   grouped-matmul, flash-decode and SSD-scan kernels in the SASS
   (``cuobjdump -sass``): none in an attention, tiled, bf16 decode or scan
   kernel would mean a CUDA-core path (the fp32 decode kernels must have
   none); ptxas's lines of the twelve sLSTM instantiations, and the sLSTM
   kernel's cluster plan at xlstm_125m's heads;
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
   = 1, from a state), its final state compared too;
3. full-width glm4_9b cut to 2 layers, same weights on the card
   (kernels) and on the CPU (plain versions): a 128-token prefill and 8
   greedy decode steps must give logits within 1e-3 of max |logit| and
   the same tokens;
4. serve full glm4_9b (40 layers, fp32, random weights from a seed) with
   the continuous-batching engine: 4 slots, cache 1024, 8 requests of 32
   new tokens; every request must finish and every kernel must have run,
   with the launch counts the model's structure implies; the same
   requests are served three times, each on a fresh engine, so the
   decode-step time is read over repeats; then 16 decode ticks of a full
   pool on the host clock and 8 more under torch.profiler say how busy
   the card is and which kernels take its time; last, one 512-token
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
   ``price_accelerators`` on the card against the CPU.

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
            or "mamba_scan" in name or "slstm_seq" in name
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
    check(len(attention) == 6, f"expected 6 attention kernels in the SASS, "
                               f"found {attention}")
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
    check(len(decode) == 4, f"expected 4 flash_decode kernels, found "
                            f"{decode}")
    for fn in decode:
        nc, stages = re.findall(r"Li(\d+)E", fn)
        hmma = counts.get(fn, {}).get("HMMA", 0)
        print(f"  flash_decode_kernel<{dtype(fn)}, Dv chunks {nc}, stages "
              f"{stages}>: {hmma} HMMA in the SASS; ptxas: "
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
    for b in (1, 4):
        plan = sl.cluster_plan(b, 4, 192, torch.float32)
        print(f"  slstm_seq at xlstm_125m's heads, B = {b}: clusters of "
              f"{plan.cluster} blocks of {max(plan.cols)} columns, grid "
              f"{plan.grid}, {plan.threads} threads and {plan.smem} bytes of "
              f"shared memory a block")
    for dtype in (torch.float32, torch.bfloat16):
        print(f"  dynamic shared memory at D = Dv = 128, {dtype}: "
              f"attention {fa.smem_bytes(dtype, 128, 128)} bytes; decode, "
              f"a block of glm4_9b (G = 16) "
              f"{fd.smem_bytes(dtype, 128, 128, 16)}, of G = 1 "
              f"{fd.smem_bytes(dtype, 128, 128, 1)}; SSD scan at N = 64, "
              f"P tile 64 {ms.smem_bytes(dtype, 64, 64)}, P tile 32 "
              f"{ms.smem_bytes(dtype, 64, 32)}")


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

    def attention(s, h, hkv, d, dtype, tag):
        q = rnd(1, s, h, d, dtype=dtype)
        k, v = rnd(1, s, hkv, d, dtype=dtype), rnd(1, s, hkv, d, dtype=dtype)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        # SDPA on K and V expanded to every head before the timed call: one
        # MHA call, not its GQA path (the math kernel in fp32)
        ke = kt.repeat_interleave(h // hkv, dim=1)
        ve = vt.repeat_interleave(h // hkv, dim=1)
        kern = lambda: ops.flash_attention(q, k, v, causal=True)
        plain = lambda: ref.attention_ref(qt, kt, vt, causal=True)
        lib = lambda: F.scaled_dot_product_attention(qt, ke, ve,
                                                     is_causal=True)
        err = compare(f"flash_attention S={s} D={d} {tag}", kern(),
                      plain().transpose(1, 2), dtype)
        pairs = h * s * (s + 1) // 2
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * d * pairs
        if dtype == torch.float32:      # 3xTF32 on tensor cores
            return timed(kern, plain, lib, err, nbytes, 3 * flops, dtype,
                         TF32_FLOPS, sdpa=True)
        return timed(kern, plain, lib, err, nbytes, flops, dtype, sdpa=True)

    def decode(h, hkv, d, dtype, tag, lens=(1024, 700, 129, 1)):
        """4 slots of a 1024-row cache, ragged fill; one call must run one
        device kernel (the split keys merge in the same launch)."""
        from repro_torch.kernels import flash_decode as fd
        b, t = 4, 1024
        q = rnd(b, 1, h, d, dtype=dtype)
        k, v = rnd(b, t, hkv, d, dtype=dtype), rnd(b, t, hkv, d, dtype=dtype)
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(t, device="cuda")[None, :]
                < kv_len[:, None])[:, None, None, :]
        kern = lambda: ops.flash_decode(q, k, v, kv_len)
        plain = lambda: ref.decode_ref(q[:, 0], kt, vt, kv_len)
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        err = compare(f"flash_decode D={d} {tag}", kern()[:, 0], plain(),
                      dtype)
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
        nbytes = (2 * q.numel() + 2 * hkv * d * n_kv) * q.element_size() \
            + 4 * b
        split = fd.split_count(t, fd.groups_of(b, h, hkv),
                               torch.cuda.get_device_properties(0)
                               .multi_processor_count)
        return timed(kern, plain, lib, err, nbytes, 4 * d * h * n_kv, dtype,
                     sdpa=True, note=f"{split} splits, 1 device kernel")

    def rmsnorm(n, dm, dtype, tag):
        x, s_ = rnd(n, dm, dtype=dtype), rnd(dm, dtype=torch.float32)
        kern = lambda: ops.fused_rmsnorm(x, s_, eps=1e-5)
        plain = lambda: ref.rmsnorm_ref(x, s_, 1e-5)
        lib = lambda: F.rms_norm(x, (dm,), s_.to(dtype), eps=1e-5)
        err = compare(f"rmsnorm N={n} D={dm} {tag}", kern(), plain(), dtype)
        nbytes = 2 * x.numel() * x.element_size() + 4 * dm
        return timed(kern, plain, lib, err, nbytes, 4 * n * dm, dtype)

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
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        # RMSNorm: the decode step's 4 rows and a 512-token prefill, at
        # glm4_9b's d_model and zamba2's gated-norm width
        for n in (4, 512):
            for dm in (4096, 7168):
                rows[("rmsnorm", tag, f"N={n} D={dm}")] = rmsnorm(
                    n, dm, dtype, tag)
        # the SSD scan at zamba2's prefill (a ragged chunk, one chunk, the
        # served long prompts of four and eight chunks) and at one shape of
        # tests/test_kernels.py
        for s in (17, 64, 256, 512):
            rows[("mamba_scan", tag, f"S={s}")] = scan(
                1, s, 112, 64, 64, 64, dtype, tag)
        rows[("mamba_scan", tag, "B=2 S=64 H=3 P=16 N=8 L=16")] = scan(
            2, 64, 3, 16, 8, 16, dtype, tag)
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


def run_greedy(cfg, params, prompt, cache_len, steps):
    from repro_torch.models import transformer as tf
    dev = params["embed"]["embedding"].device
    tokens = torch.as_tensor(prompt[None, :], dtype=torch.long, device=dev)
    logits, cache = tf.lm_prefill(cfg, params, tokens, cache_len)
    out_logits, out_tokens = [logits.cpu()], []
    kv_len = torch.tensor([prompt.shape[0]], dtype=torch.int32, device=dev)
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


def phase_cut(arch, n_layers, seed, prompt_len=128):
    """Phases 3, 5, 7 and 9: a full-width model cut to ``n_layers``, the
    same weights on the card and on the CPU, a ``prompt_len``-token prefill
    and 8 greedy decode steps.  For an MoE model it also counts
    the (token, layer) top-k routes that differ between the two; a route
    that flips on a near-tie is reported, not hidden."""
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
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab, prompt_len)
    t0 = time.perf_counter()
    with RouteLog() as card_routes:
        gl, gt = run_greedy(cfg, p_gpu, prompt, 2 * prompt_len, 8)
    t1 = time.perf_counter()
    with RouteLog() as cpu_routes:
        cl, ct = run_greedy(cfg, p_cpu, prompt, 2 * prompt_len, 8)
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
    print(f"  {n_layers}-layer full-width {arch}: prefill {prompt_len} + 8 "
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
    norm.  One attention a dense, MoE or shared attention block; one SSD
    scan a Mamba2 layer; three grouped matmuls (gate, up, down) an MoE
    layer; one sLSTM recurrence an sLSTM block."""
    calls = n_prefill + n_steps
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
    return {"flash_attention": attn * n_prefill,
            "flash_decode": attn * n_steps,
            "mamba_scan": mamba * n_prefill, "moe_gmm": 3 * moe * calls,
            "rmsnorm": (2 * blocks + 1) * calls, "slstm_seq": slstm * calls}


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


def phase_serve(arch, seed, max_prompt, repeats: int = 3, then=None,
                long=(256, 512)):
    """Phases 4, 6, 8 and 10: a full model through the serving engine, the
    same 8 requests ``repeats`` times, each on a fresh engine.  Six prompts
    are drawn in [4, max_prompt], two have the ``long`` lengths.
    ``then(cfg, params)`` runs last, on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.common import count_params, init_params
    cfg = get_config(arch).replace(dtype="float32", attn_impl="kernel")
    spec = api.param_spec(cfg)
    n_params = count_params(spec)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(spec, torch.Generator(device="cuda").manual_seed(
        seed), "cuda")
    torch.cuda.synchronize()
    print(f"  {arch}: {n_params / 1e9:.3f} B params fp32 "
          f"({4 * n_params / 1e9:.1f} GB), init {time.perf_counter() - t0:.1f} s")
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
    return first


# the device kernels' names of a kernel family, in a profile
DEVICE_NAMES = {"flash_attention": "flash_attn", "mamba_scan": "mamba_scan",
                "slstm_seq": "slstm_seq_kernel"}


def lone_prefill(kernels, cfg, params, s: int = 512, repeats: int = 3):
    """The last step of phases 4, 6 and 10: one ``s``-token prefill through the
    engine's prefill function, alone on the card: a warm call, ``repeats``
    timed on the host clock (synchronised), then one under torch.profiler
    for the share of the device time of each of ``kernels`` (keys of
    ``DEVICE_NAMES``), each of which must run as often as the model's
    structure implies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
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
    want = structure_launches(cfg, 1, 0)
    for k in kernels:
        check(runs[k] == want[k], f"the profiled prefill ran {runs[k]} {k} "
                                  f"kernels, not {want[k]}")
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
                                "glm4_9b", seed, 128, 3,
                                functools.partial(lone_prefill,
                                                  ("flash_attention",)))}
    gc.collect()
    torch.cuda.empty_cache()        # glm4_9b's weights are gone
    phase(5, "full-width 13-layer zamba2_7b, card against CPU", phase_cut,
          "zamba2_7b", 13, seed)
    by_path["zamba2_7b"] = phase(
        6, "serving full zamba2_7b", phase_serve, "zamba2_7b", seed, 64, 3,
        functools.partial(lone_prefill, ("mamba_scan", "flash_attention")))
    gc.collect()
    torch.cuda.empty_cache()        # zamba2_7b's weights are gone
    phase(7, "full-width 3-layer deepseek_moe_16b, card against CPU",
          phase_cut, "deepseek_moe_16b", 3, seed)
    by_path["deepseek_moe_16b"] = phase(
        8, "serving full deepseek_moe_16b", phase_serve, "deepseek_moe_16b",
        seed, 128, 3, moe_decode_without_sync)
    gc.collect()
    torch.cuda.empty_cache()        # deepseek_moe_16b's weights are gone
    phase(9, "full 12-layer xlstm_125m, card against CPU", phase_cut,
          "xlstm_125m", 12, seed, 300)
    by_path["xlstm_125m"] = phase(
        10, "serving full xlstm_125m", phase_serve, "xlstm_125m", seed, 128,
        3, functools.partial(lone_prefill, ("slstm_seq",)), (300, 512))
    gc.collect()
    torch.cuda.empty_cache()        # xlstm_125m's weights are gone
    phase(11, "the cost model, card against CPU", phase_cost_model, seed,
          smi)

    timed = {"flash_attention": ("float32", "S=512"),
             "flash_decode": ("float32", "T=1024"),
             "rmsnorm": ("float32", "N=4 D=4096"),
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
            "library_kernels": r["library_kernels"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
