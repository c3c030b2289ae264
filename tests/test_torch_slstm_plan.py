"""The launch plan of the port's sLSTM kernel (``slstm_cell.cluster_plan``).

The plan is pure arithmetic on the shapes, so it is checked here, on the
CPU, for every head dim the kernel takes; the kernel itself runs on the
card only (tests/test_torch_cuda.py, over the plan's cases).
"""
import pytest
import torch

from repro_torch.kernels import slstm_cell as sl

torch.set_num_threads(1)

SMEM_LIMIT = 227 * 1024         # shared memory a Hopper block can have


@pytest.mark.parametrize("dh", range(4, sl.MAX_HEAD_DIM + 1, 4))
def test_cluster_plan_partitions_the_columns(dh):
    """Over B = 1..8: the blocks of a cluster own Dh's columns in runs of
    multiples of 4, as evenly as they go; a block fits the card's shared
    memory and the kernel's threads; the cluster, at most 16 blocks, is
    the grid's first axis; up to 4 rows a cluster and no empty cluster."""
    for b in range(1, 9):
        plan = sl.cluster_plan(b, 4, dh, torch.float32)
        assert plan == sl.cluster_plan(b, 4, dh, torch.bfloat16)
        k, cols = plan.cluster, plan.cols
        assert 1 <= k <= 16 and len(cols) == k
        assert sum(cols) == dh and all(c > 0 and c % 4 == 0 for c in cols)
        assert max(cols) - min(cols) <= 4
        assert plan.grid[0] % k == 0 and plan.grid[0] == k
        assert plan.grid[1] == 4
        assert plan.smem <= SMEM_LIMIT
        assert plan.threads == 8 * max(cols) <= sl.MAX_THREADS
        rows, groups = plan.rows, plan.grid[2]
        assert 1 <= rows <= sl.MAX_ROWS
        assert (groups - 1) * rows < b <= groups * rows


def test_cluster_plan_at_xlstm_125m():
    """4 heads of 192: a prompt is 4 clusters of 16 blocks of 12 columns, a
    decode tick of 4 slots the same 4 clusters, each serving all 4 rows."""
    prompt = sl.cluster_plan(1, 4, 192, torch.float32)
    assert prompt == sl.Plan(16, (12,) * 16, 1, (16, 4, 1), 96, 4 * 2 * 192)
    tick = sl.cluster_plan(4, 4, 192, torch.float32)
    assert tick.rows == 4 and tick.grid == (16, 4, 1)
    assert tick.smem == 4 * 2 * 4 * 192


@pytest.mark.parametrize("k", range(1, 17))
def test_cluster_plan_takes_every_cluster_size(k):
    """Dh = 4 K is a cluster of K blocks of 4 columns (32 threads); from
    Dh = 64 on the cluster is 16 blocks."""
    plan = sl.cluster_plan(1, 4, 4 * k, torch.float32)
    assert plan.cluster == k and plan.cols == (4,) * k
    assert plan.threads == 32
    assert sl.cluster_plan(1, 4, 64 + 4 * k, torch.float32).cluster == 16


def test_cluster_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        sl.cluster_plan(1, 4, 192, torch.float16)
    for dh in (0, 6, 260):
        with pytest.raises(ValueError, match="head dim"):
            sl.cluster_plan(1, 4, dh, torch.float32)
