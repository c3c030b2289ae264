"""The port's data pipeline (repro_torch.data) against the JAX package's:
batches bit-equal over configs, steps and shards, token shards written by
either package read in the other, and O(1) skip-ahead."""
import numpy as np
import pytest

import repro.data as J
import repro_torch.data as T
from torch_parity import equal

CONFIGS = [  # (seq_len, global_batch, vocab, n_shards, seed)
    (16, 8, 100, 1, 1234), (16, 8, 100, 2, 1234), (33, 12, 50304, 4, 7),
    (128, 4, 151552, 1, 0), (1, 6, 2, 3, 99)]


@pytest.mark.parametrize("seq,batch,vocab,shards,seed", CONFIGS)
def test_synthetic_batches_equal_the_reference(seq, batch, vocab, shards,
                                               seed):
    for shard in range(shards):
        jc = J.DataConfig(seq, batch, vocab, shards, shard, seed)
        tc = T.DataConfig(seq, batch, vocab, shards, shard, seed)
        for step in (0, 1, 5, 1000, 2 ** 20):
            jb, tb = J.synthetic_batch(jc, step), T.synthetic_batch(tc, step)
            assert jb.keys() == tb.keys()
            for k in jb:
                equal(jb[k], tb[k], what=f"{k} shard {shard} step {step}")


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_shards_read_across_packages(tmp_path, writer, reader, dtype):
    pkg = {"jax": J, "torch": T}
    rng = np.random.default_rng(3)
    recs = rng.integers(0, 60000, (13, 9))
    w = pkg[writer].BinaryShardWriter(tmp_path / "shard.bin", seq_len=8,
                                      dtype=dtype)
    for r in recs:
        w.add(r)
    w.close()
    mine = pkg[writer].TokenDataset(tmp_path / "shard.bin")
    theirs = pkg[reader].TokenDataset(tmp_path / "shard.bin")
    assert theirs.n_records == 13 and theirs.dtype == dtype
    for shards in (1, 2):
        for shard in range(shards):
            cfg = T.DataConfig(seq_len=8, global_batch=4, vocab=60000,
                               n_shards=shards, shard_id=shard)
            for step in range(5):
                a, b = mine.batch(cfg, step), theirs.batch(cfg, step)
                for k in a:
                    equal(a[k], b[k], what=f"{k} step {step}")
    np.testing.assert_array_equal(
        theirs.batch(T.DataConfig(8, 2, 60000), 0)["tokens"], recs[:2, :-1])


def test_bad_magic_is_refused(tmp_path):
    (tmp_path / "x.bin").write_bytes(b"NOTASHRD" + bytes(8))
    with pytest.raises(ValueError, match="bad magic"):
        T.TokenDataset(tmp_path / "x.bin")


def test_skip_ahead_is_one_evaluation(tmp_path):
    """Resuming at step N evaluates the index map at N: the same batches as
    walking there, for both sources, and as the reference's iterator."""
    cfg = T.DataConfig(seq_len=8, global_batch=4, vocab=50)
    walked = [b["tokens"] for _, b in zip(range(6), T.make_batches(cfg))]
    for n in range(6):
        equal(walked[n], next(T.make_batches(cfg, start_step=n))["tokens"])
    jumped = next(T.make_batches(cfg, start_step=10 ** 9))
    equal(next(J.make_batches(J.DataConfig(8, 4, 50),
                              start_step=10 ** 9))["tokens"],
          jumped["tokens"])
    w = T.BinaryShardWriter(tmp_path / "s.bin", seq_len=8)
    for r in np.arange(90).reshape(10, 9):
        w.add(r)
    w.close()
    ds = T.TokenDataset(tmp_path / "s.bin")
    it = T.make_batches(cfg, start_step=7, dataset=ds)
    equal(ds.batch(cfg, 7)["labels"], next(it)["labels"])
    equal(ds.batch(cfg, 8)["labels"], next(it)["labels"])
