"""Time the MLA latent decode of a checkout's kernels, on the card.

  python tools/latent_rows.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(this checkout's by default), so an older checkout's kernels can be timed
by this script beside the current ones: run it for each in turns in one
call (older, newer, newer, older), since two calls may land on two cards.
It builds that checkout's kernels, then holds ``ops.flash_decode`` against
``ref.decode_ref`` and times it (CUDA events, ``launch/timing.py``'s
``device_ms``) at minicpm3_4b's latent decode (40 heads on one KV head,
key 288, value the key rows' first 256 columns) and, where that checkout's
kernel takes them, deepseek_v2_236b's (128 heads, key 576, value 512):
4 slots of a 1024-row cache at kv_len 1024/700/129/1 and at a served
fill of 544/160/68/9, in fp32 and bf16.  One line a row, then the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROWS = (("minicpm3_4b", 40, 288, 256, 96 ** -0.5),
        ("deepseek_v2_236b", 128, 576, 512, 192 ** -0.5))
FILLS = ((1024, 700, 129, 1), (544, 160, 68, 9))
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir, "src"))
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("latent_rows: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch.timing import device_ms
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    label = os.path.abspath(args.src)
    for model, h, d, dv, scale in ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).replace("torch.", "")
            rows = torch.randn(4, 1024, 1, d, generator=gen,
                               device="cuda").to(dtype)
            q = torch.randn(4, 1, h, d, generator=gen, device="cuda").to(dtype)
            k, v = rows, rows[..., :dv]
            for fill in FILLS:
                kv_len = torch.tensor(fill, dtype=torch.int32, device="cuda")
                kern = lambda: ops.flash_decode(q, k, v, kv_len, scale=scale)
                try:
                    got = kern()
                except ValueError as e:     # widths this checkout refuses
                    print(f"{label} {model} {tag} fill {fill}: refused: {e}")
                    break
                want = ref.decode_ref(q[:, 0], k.transpose(1, 2),
                                      v.transpose(1, 2), kv_len, scale=scale)
                err = (got[:, 0].float() - want.float()).abs().max().item()
                if not torch.allclose(got[:, 0].float(), want.float(),
                                      atol=TOL[tag], rtol=TOL[tag]):
                    raise RuntimeError(f"{model} {tag} {fill}: max abs err "
                                       f"{err}")
                print(f"{label} {model} {tag} D={d} Dv={dv} H={h} fill "
                      f"{'/'.join(map(str, fill))}: {device_ms(kern):.4f} ms,"
                      f" max abs err {err:.3e}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
