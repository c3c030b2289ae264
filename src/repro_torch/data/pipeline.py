"""Deterministic sharded data pipeline, after ``repro/data/pipeline.py``.

A copy of the JAX package's module, which is numpy alone: batches are
bit-equal to the reference's, and a shard written by either package
reads in the other.

Two sources behind one interface:

* synthetic    — stateless hash-based token streams: batch(step, shard)
                 is a pure function, so restarts NEVER replay or skip
                 data and any host can regenerate any shard (the
                 determinism property the fault-tolerance story needs).
* binary file  — fixed-record uint16/uint32 token shards, memory-mapped,
                 with the same (step, shard) -> records indexing.

Skip-ahead is O(1): resuming at step N just evaluates the index map at N.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    n_shards: int = 1           # data-parallel shards (hosts)
    shard_id: int = 0
    seed: int = 1234


# ---------------------------------------------------------------------------
# Synthetic source
# ---------------------------------------------------------------------------


def _philox(seed: int, step: int, shard: int, n: int) -> np.ndarray:
    """Counter-based deterministic stream (Philox via numpy Generator)."""
    key = np.uint64((seed << 24) ^ (step << 8) ^ shard)
    return np.random.Generator(np.random.Philox(key=key)).integers(
        0, 2 ** 31 - 1, size=n, dtype=np.int64)


def synthetic_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Tokens + next-token labels for (step, shard); pure function."""
    per_shard = cfg.global_batch // cfg.n_shards
    n = per_shard * (cfg.seq_len + 1)
    raw = _philox(cfg.seed, step, cfg.shard_id, n) % cfg.vocab
    raw = raw.reshape(per_shard, cfg.seq_len + 1)
    return {"tokens": raw[:, :-1].astype(np.int32),
            "labels": raw[:, 1:].astype(np.int32)}


# ---------------------------------------------------------------------------
# Binary-file source (fixed-record token shards)
# ---------------------------------------------------------------------------

MAGIC = b"RPTK0001"


class BinaryShardWriter:
    """Write a token shard: header (magic, dtype, seq_len+1) + records."""

    def __init__(self, path: Path, seq_len: int, dtype=np.uint16):
        self.path = Path(path)
        self.seq_len = seq_len
        self.dtype = np.dtype(dtype)
        self._f = open(self.path, "wb")
        self._f.write(MAGIC)
        self._f.write(np.uint32(self.dtype.itemsize).tobytes())
        self._f.write(np.uint32(seq_len + 1).tobytes())
        self.n = 0

    def add(self, record: np.ndarray):
        assert record.shape == (self.seq_len + 1,)
        self._f.write(record.astype(self.dtype).tobytes())
        self.n += 1

    def close(self):
        self._f.close()


class TokenDataset:
    """Memory-mapped fixed-record reader with (step, shard) indexing."""

    def __init__(self, path: Path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            magic = f.read(8)
            if magic != MAGIC:
                raise ValueError(f"{path}: bad magic {magic!r}")
            itemsize = int(np.frombuffer(f.read(4), np.uint32)[0])
            self.record_len = int(np.frombuffer(f.read(4), np.uint32)[0])
        self.dtype = {2: np.uint16, 4: np.uint32}[itemsize]
        header = 16
        self._mm = np.memmap(self.path, dtype=self.dtype, mode="r",
                             offset=header)
        self.n_records = self._mm.size // self.record_len
        self._mm = self._mm[:self.n_records * self.record_len].reshape(
            self.n_records, self.record_len)

    def batch(self, cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
        per_shard = cfg.global_batch // cfg.n_shards
        base = (step * cfg.global_batch + cfg.shard_id * per_shard)
        idx = (base + np.arange(per_shard)) % self.n_records
        recs = np.asarray(self._mm[idx], dtype=np.int64)
        return {"tokens": recs[:, :-1].astype(np.int32),
                "labels": recs[:, 1:].astype(np.int32)}


def make_batches(cfg: DataConfig, start_step: int = 0,
                 dataset: Optional[TokenDataset] = None
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite deterministic batch iterator with O(1) skip-ahead."""
    step = start_step
    while True:
        if dataset is not None:
            yield dataset.batch(cfg, step)
        else:
            yield synthetic_batch(cfg, step)
        step += 1
