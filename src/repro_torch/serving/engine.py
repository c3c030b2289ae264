"""Slot-based continuous-batching serving engine, after
``repro/serving/engine.py`` and with the same scheduling:

* a fixed pool of ``n_slots`` sequence slots shares one decode KV cache
  (slot = batch row; a row is reused after its sequence finishes);
* arriving requests are prefilled one at a time and their cache (KV, the
  Mamba2 states of the hybrid, or the xLSTM's mLSTM and sLSTM states) is
  written into the slot's row; every tick decodes the whole pool, so new
  sequences join mid-flight;
* finished sequences (EOS, ``max_new_tokens`` or a full cache) free their
  slot.

The fill levels live on the device as an int32 tensor, which the decode
kernel reads, with a host mirror for the scheduling decisions; a tick's
one device-to-host copy is the argmax of its logits.  The xLSTM cache is
recurrent state only: there ``kv_len`` only counts the fill, which ends a
request at ``cache_len - 1`` as in the JAX engine.  Rows are not
independent in the MoE family: its decode dispatch gives every row of the
pool, a free one too, a share of one capacity per expert (JAX's
``capacity_factor=4.0``), so free and finished rows are fed exactly what
the JAX engine feeds them.

The engine serves the decoder-only families: the dense, MoE, hybrid and
xLSTM models, MLA's (its latent cache rows are views of one buffer, which
``transformer.init_cache`` makes and ``_put_row`` writes through) and the VLM,
whose requests are text prompts as in the JAX engine (an image prefill is
``api.prefill_fn`` with ``img_embeds``).  It raises for the
encoder-decoder, as the JAX engine does: Whisper is driven through
``api.prefill_fn`` / ``api.decode_fn``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig, InputShape
from ..models import api
from ..models.common import spec_map
from ..models.transformer import init_cache


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int = 32
    eos_id: int = -1                # -1: never stops early
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    n_slots: int = 8
    cache_len: int = 512


def _put_row(pool, one, slot_axes, slot: int) -> None:
    """Copy the one-row cache ``one`` into row ``slot`` of ``pool``; each
    leaf's slot axis comes from ``slot_axes``, the same tree of ints."""
    if isinstance(pool, dict):
        for k in pool:
            _put_row(pool[k], one[k], slot_axes[k], slot)
    else:
        pool.select(slot_axes, slot).copy_(one.select(slot_axes, 0))


class ServingEngine:
    """Serves decoder-only LMs on the device that ``params`` live on."""

    def __init__(self, cfg: ArchConfig, params, serve_cfg: ServeConfig):
        if cfg.family == "encdec":
            raise NotImplementedError(
                "the engine drives decoder-only LMs; an encoder-decoder is "
                "served through api.prefill_fn / api.decode_fn")
        self.cfg = cfg
        self.params = params
        self.sc = serve_cfg
        self.device = params["embed"]["embedding"].device
        shape = InputShape("engine", serve_cfg.cache_len,
                           serve_cfg.n_slots, "decode")
        spec = api.cache_spec(cfg, shape)
        self.cache = init_cache(spec, self.device)
        # the slot axis of every leaf is where its spec says "batch"; the
        # hybrid and xLSTM caches nest it under one or two stacking axes
        self._slot_axes = spec_map(lambda s: s.axes.index("batch"), spec)
        n = serve_cfg.n_slots
        self.kv_len = torch.zeros(n, dtype=torch.int32, device=self.device)
        self.kv_len_host = np.zeros(n, np.int64)
        self._active_rows = torch.zeros(n, dtype=torch.int32,
                                        device=self.device)
        self.tokens = torch.zeros((n, 1), dtype=torch.long,
                                  device=self.device)
        self.active: List[Optional[Request]] = [None] * n
        self.queue: deque = deque()
        self._decode = api.decode_fn(cfg)
        self._prefill = api.prefill_fn(cfg, serve_cfg.cache_len)
        self.steps = 0
        self.finished: List[Request] = []
        self.decode_s: List[float] = []   # wall time of each decode tick

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request):
        req.t_submit = time.time()
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    def _splice(self, slot: int, req: Request):
        """Prefill one request and write its KV into ``slot``."""
        plen = int(req.prompt.shape[0])
        tokens = torch.as_tensor(np.asarray(req.prompt)[None, :],
                                 dtype=torch.long, device=self.device)
        logits, cache1 = self._prefill(self.params, {"tokens": tokens})
        _put_row(self.cache, cache1, self._slot_axes, slot)
        next_tok = int(logits[0].argmax())
        req.output.append(next_tok)
        req.t_first = time.time()
        self.active[slot] = req
        self.kv_len[slot] = plen
        self.kv_len_host[slot] = plen
        self._active_rows[slot] = 1
        self.tokens[slot, 0] = next_tok

    # -- main loop ---------------------------------------------------------

    def step(self) -> int:
        """Admit + one decode tick for the whole pool. Returns #active."""
        for slot in self._free_slots():
            if not self.queue:
                break
            self._splice(slot, self.queue.popleft())
        if not any(r is not None for r in self.active):
            return 0
        t0 = time.perf_counter()
        logits, self.cache = self._decode(self.params, self.tokens,
                                          self.cache, self.kv_len)
        self.kv_len += self._active_rows
        nxt_dev = logits.argmax(dim=-1)
        nxt = nxt_dev.cpu().numpy()            # the tick's one sync
        self.decode_s.append(time.perf_counter() - t0)
        self.steps += 1
        for i, r in enumerate(self.active):
            if r is None:
                continue
            self.kv_len_host[i] += 1
            tok = int(nxt[i])
            r.output.append(tok)
            done = (len(r.output) >= r.max_new_tokens
                    or tok == r.eos_id
                    or self.kv_len_host[i] >= self.sc.cache_len - 1)
            if done:
                r.t_done = time.time()
                self.finished.append(r)
                self.active[i] = None
                self._active_rows[i] = 0
        # Only rows that go on take their new token; a finished or free row
        # keeps its last one, as in the JAX engine.  The MoE needs this: its
        # decode capacity is shared by every row of the pool, free ones too.
        self.tokens.copy_(torch.where(self._active_rows[:, None] > 0,
                                      nxt_dev[:, None], self.tokens))
        return sum(r is not None for r in self.active)

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        while (self.queue or any(r is not None for r in self.active)) \
                and self.steps < max_steps:
            self.step()
        return self.finished
