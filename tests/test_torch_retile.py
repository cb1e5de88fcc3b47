"""K27's plain versions (``ops/kernels/retile.py``: the CPU path of the
multi-process retile, B.28) against numpy and against the reference's
``bucket_rows`` and trim (``spark_rapids_tpu/parallel/multiprocess.py:342
_retile``: the max of the shards' row counts, ``bucket_rows`` of it, every
column cut to that many rows).

* ``retile_max_plain``: seeded statistics (int32 and int64 device arrays
  at their own slots, host ints, overlapping slots) against numpy's
  element-wise max, and its bucket word against the reference's
  ``bucket_rows`` for every count up to 70,000 at ``min_bucket`` 1, 100
  and 128 and at powers of two and their neighbours up to 2**40.
* ``retile_trim_plain``: every column type, strings with lengths, against
  the reference's slices ``data[:, :need]`` of the stacked shards; batches
  at or under ``need`` rows come back as they were; the trimmed buffers
  are copies (the padded output can be freed)."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu.data.column import bucket_rows as ref_bucket_rows
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.column import (DeviceBatch, DeviceColumn,
                                                bucket_rows)
from spark_rapids_tpu_torch.ops.kernels import retile as R

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_max_plain_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    k, n_bucket = 23, 16
    want = np.zeros(k, np.int64)
    stats = []
    for shard in range(4):
        counts = rng.integers(0, 1 << 20, 4).astype(
            np.int32 if shard % 2 else np.int64)
        stats.append(R.Stat(shard * 4, torch.from_numpy(counts)))
        want[shard * 4:shard * 4 + 4] = np.maximum(
            want[shard * 4:shard * 4 + 4], counts)
        rows = int(rng.integers(0, 1 << 30))
        stats.append(R.Stat(16 + shard % 2,
                            torch.tensor(rows, dtype=torch.int32)))
        want[16 + shard % 2] = max(want[16 + shard % 2], rows)
        for j in range(3):  # string widths, several per slot
            w = int(rng.integers(1, 300))
            stats.append(R.Stat(18 + j, w))
            want[18 + j] = max(want[18 + j], w)
    got = R.retile_max_plain(stats, k, n_bucket, 128, CPU)
    assert got.dtype == torch.int64 and got.shape == (k + 1,)
    assert got[:k].tolist() == want.tolist()
    assert int(got[k]) == ref_bucket_rows(int(want[:n_bucket].max()), 128)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(R.retile_max(stats, k, n_bucket, 128, CPU), got)


@pytest.mark.parametrize("min_bucket", [1, 100, 128])
def test_bucket_word_matches_reference(min_bucket):
    counts = list(range(0, 70_001))
    for e in range(1, 41):
        counts += [(1 << e) - 1, 1 << e, (1 << e) + 1,
                   min_bucket << e, (min_bucket << e) + 1]
    top = torch.tensor(counts, dtype=torch.int64)
    # _bucket_plain is element-wise: one call over every count
    got = R._bucket_plain(top, min_bucket)
    want = [ref_bucket_rows(c, min_bucket) for c in counts]
    assert got.tolist() == want
    assert want == [bucket_rows(c, min_bucket) for c in counts]


def _shard(rng, rows, padded):
    """A batch of every column type and a string column, ``rows`` real
    rows of ``padded``."""
    cols = []
    for t, dt in ((T.BOOL, np.bool_), (T.INT32, np.int32),
                  (T.INT64, np.int64), (T.FLOAT64, np.float64),
                  (T.DATE32, np.int32), (T.INT8, np.int8)):
        data = rng.integers(-100, 100, padded).astype(dt)
        data[rows:] = 0
        valid = rng.random(padded) > 0.2
        valid[rows:] = False
        cols.append(DeviceColumn(t, torch.from_numpy(data),
                                 torch.from_numpy(valid)))
    lengths = rng.integers(0, 9, padded).astype(np.int32)
    lengths[rows:] = 0
    bm = rng.integers(1, 256, (padded, 9)).astype(np.uint8)
    bm[np.arange(9)[None, :] >= lengths[:, None]] = 0
    valid = np.arange(padded) < rows
    cols.append(DeviceColumn(T.STRING, torch.from_numpy(bm),
                             torch.from_numpy(valid),
                             torch.from_numpy(lengths)))
    schema = T.Schema([T.Field(f"c{i}", c.dtype)
                       for i, c in enumerate(cols)])
    return DeviceBatch(schema, cols, torch.tensor(rows, dtype=torch.int32))


def test_trim_plain_matches_reference_slices():
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    rows = [300, 17, 0, 1000]
    shards = [_shard(rng, r, 2048) for r in rows]
    need = ref_bucket_rows(max(rows), 128)
    assert need == 1024
    got = R.retile_trim_plain(shards, need)
    for ci in range(len(shards[0].columns)):
        for part in ("data", "validity", "lengths"):
            if getattr(shards[0].columns[ci], part) is None:
                continue
            stacked = jnp.asarray(np.stack(
                [getattr(s.columns[ci], part).numpy() for s in shards]))
            want = np.asarray(stacked[:, :need])
            for p, g in enumerate(got):
                t = getattr(g.columns[ci], part)
                assert t.shape[0] == need
                assert np.array_equal(t.numpy(), want[p])
                # a copy: the padded buffer can be freed
                assert t.data_ptr() != getattr(shards[p].columns[ci],
                                               part).data_ptr()
    assert [int(g.num_rows) for g in got] == rows


def test_trim_keeps_small_batches_and_counts_bytes():
    rng = np.random.default_rng(6)
    small, big = _shard(rng, 100, 128), _shard(rng, 200, 512)
    got = R.retile_trim_plain([small, big], 256)
    assert got[0] is small and got[1].padded_rows == 256
    assert R.retile_trim([small], 256) == [small]
    per_row = sum(t[0].numel() * t.element_size() for c in big.columns
                  for t in (c.data, c.validity, c.lengths) if t is not None)
    assert R.retile_trim_bytes([small, big], 256) == 2 * 256 * per_row
    # the wrapper takes the plain version for CPU tensors
    again = R.retile_trim([small, big], 256)
    for a, b in zip(again[1].columns, got[1].columns):
        assert torch.equal(a.data, b.data)
        assert torch.equal(a.validity, b.validity)


def test_stats_are_checked():
    one = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError):
        R.retile_max_plain([R.Stat(3, one)], 4, 1, 128, CPU)
    with pytest.raises(ValueError):
        R.retile_max_plain([R.Stat(0, one)], 4, 5, 128, CPU)
    with pytest.raises(TypeError):
        R.retile_max_plain([R.Stat(0, one.float())], 4, 1, 128, CPU)
    with pytest.raises(ValueError):
        R.retile_max_plain([R.Stat(0, -1)], 4, 1, 128, CPU)
