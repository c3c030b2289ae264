"""Device time of a call on the card, for ``chip_smoke.py`` and the
scripts in this package."""
from __future__ import annotations

import torch


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls.

    A sleep kernel first holds the stream while the host queues every
    call, so the events time the card's work back to back and not the
    host's launch rate.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)          # ~50 ms at the H100's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
