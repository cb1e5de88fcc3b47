"""K27 (the multi-process retile, ``csrc/retile.cu``) built for the CPU
with the host C++ compiler against ``csrc/emulator/cuda_runtime.h``
(``test_torch_kernels_emulated._build_emulated``) and held against its
plain PyTorch versions on the same inputs.

``retile_max``: the statistics of an exchange over 4 shards and 4
destinations (K10's int32 counts of each shard at its own 4 slots, each
shard's int32 row count, two string widths as host ints, an int64 array)
and of a leaf over 2 shards; the max and the bucket word exact, for
``min_bucket`` 1 and 128, counts from 0 to 2**31 - 1, and one entry over
2,000 words (several strides of the block).  ``retile_trim``: three
shards of every column type with a 9-byte string column, cut from 4,096
padded rows to 2,048 and to 128, and one shard at 8,192 rows with 5,000
real; every buffer to the byte, one launch a call; a shard already at or
under ``need`` comes back as it was.

Mutation check: a K27 whose max leaves out the last entry (here the last
shard's counts), built from an edited copy of ``retile.cu``, must
disagree with the plain version."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.ops.kernels import _build as B
from spark_rapids_tpu_torch.ops.kernels import retile as R
from test_torch_kernels_emulated import _build_emulated
from test_torch_kernels_emulated_generate import _mutant
from test_torch_retile import _shard

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def emu():
    out = _build_emulated()
    return B.Kernels(lambda: out, lambda t: None)


def _exchange_stats(seed, top=1 << 20):
    rng = np.random.default_rng(seed)
    stats = []
    for s in range(4):
        counts = rng.integers(0, top, 4).astype(np.int32)
        stats.append(R.Stat(4 * s, torch.from_numpy(counts)))
    for s in range(4):
        stats.append(R.Stat(16 + s, torch.tensor(int(rng.integers(0, top)),
                                                 dtype=torch.int32)))
    stats += [R.Stat(20, 7), R.Stat(21, 33), R.Stat(20, 12),
              R.Stat(22, torch.tensor([5, 1 << 40], dtype=torch.int64))]
    return stats, 24, 16


@pytest.mark.parametrize("min_bucket", [1, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_k27_max_matches_plain(emu, seed, min_bucket):
    stats, k, n_bucket = _exchange_stats(seed)
    before = R.RETILE_MAX_LAUNCHES.count
    got = R.retile_max(stats, k, n_bucket, min_bucket, CPU, kernels=emu)
    assert R.RETILE_MAX_LAUNCHES.count - before == 1
    want = R.retile_max_plain(stats, k, n_bucket, min_bucket, CPU)
    assert torch.equal(got, want)


def test_k27_max_edges(emu):
    # all zero: the bucket of max(0, 1); the extremes of int32
    zero = [R.Stat(0, torch.zeros(4, dtype=torch.int32))]
    for stats in (zero, [R.Stat(0, torch.tensor([2**31 - 1, 0, 3],
                                                dtype=torch.int32))]):
        assert torch.equal(R.retile_max(stats, 4, 3, 128, CPU, kernels=emu),
                           R.retile_max_plain(stats, 4, 3, 128, CPU))
    # one entry spanning several strides of the block
    long = [R.Stat(1, torch.arange(2000, dtype=torch.int64) * 3 % 1777),
            R.Stat(5, 5000), R.Stat(1999, 1 << 33)]
    got = R.retile_max(long, 2001, 1000, 128, CPU, kernels=emu)
    assert torch.equal(got, R.retile_max_plain(long, 2001, 1000, 128, CPU))


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.padded_rows == w.padded_rows
        assert int(g.num_rows) == int(w.num_rows)
        for gc, wc in zip(g.columns, w.columns):
            for a, b in ((gc.data, wc.data), (gc.validity, wc.validity),
                         (gc.lengths, wc.lengths)):
                assert (a is None) == (b is None)
                if b is not None:
                    assert a.dtype == b.dtype and a.shape == b.shape
                    assert torch.equal(a.contiguous().view(torch.uint8),
                                       b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("need", [2048, 128])
def test_k27_trim_matches_plain(emu, need):
    rng = np.random.default_rng(need)
    shards = [_shard(rng, r, 4096) for r in (100, 0, 77)] + [
        _shard(rng, 60, 128)]
    before = R.RETILE_TRIM_LAUNCHES.count
    got = R.retile_trim(shards, need, kernels=emu)
    assert R.RETILE_TRIM_LAUNCHES.count - before == 1
    _same(got, R.retile_trim_plain(shards, need))
    assert got[3] is shards[3]
    # one allocation behind every trimmed buffer
    bases = {c.data.untyped_storage().data_ptr() for g in got[:3]
             for c in g.columns}
    assert len(bases) == 1


def test_k27_trim_large(emu):
    rng = np.random.default_rng(9)
    shard = _shard(rng, 5000, 8192)
    _same(R.retile_trim([shard], 8192 // 2 + 1024, kernels=emu),
          R.retile_trim_plain([shard], 8192 // 2 + 1024))


def test_k27_max_without_last_entry_mutant_differs(emu):
    mutant = _mutant("retile", ("for (int e = 0; e < n_entries; ++e)",
                                "for (int e = 0; e < n_entries - 1; ++e)"))
    rng = np.random.default_rng(3)
    stats = [R.Stat(4 * s, torch.from_numpy(
        rng.integers(1, 1000, 4).astype(np.int32))) for s in range(4)]
    want = R.retile_max_plain(stats, 16, 16, 1, CPU)
    assert torch.equal(R.retile_max(stats, 16, 16, 1, CPU, kernels=emu),
                       want)
    assert not torch.equal(R.retile_max(stats, 16, 16, 1, CPU,
                                        kernels=mutant), want)
