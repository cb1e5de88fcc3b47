"""The collectives of spark_rapids_tpu_torch/parallel/exchange.py (on CPU
tensors: K9, K10, K24 and K4 take their plain PyTorch versions) against
the JAX package's, run through its ``exchange_step`` on a 2- and a
4-device mesh, on the same numpy data (the helpers and column types of
``test_torch_parallel_exchange.py``).

* ``collective_exchange`` on 2 and 4 shards: shards of different row
  counts (one empty), strings of different widths on different shards
  (the reference's inputs padded to the widest, as its stacking needs),
  and a capacity below the largest count (rows past it dropped in
  both): every shard holds the reference's rows in the reference's
  order, to the byte; the exchange's record of the rows each shard sent
  and got.
* ``gather_replicate`` on 2 and 4 shards, one batch shared by the shards
  of one device."""
import jax
import numpy as np
import pytest

from spark_rapids_tpu.parallel import exchange as JX
from spark_rapids_tpu.parallel.mesh import DATA_AXIS, make_mesh as jmesh
from spark_rapids_tpu_torch.data.column import bucket_rows
from spark_rapids_tpu_torch.parallel import exchange as X
from test_torch_parallel_exchange import (_data, _equal, _port_batch,
                                          _ref_batch)


def _shards(n_dev, seed):
    """Per shard: numpy columns of a different row count (the last shard
    empty) and a different string width."""
    rng = np.random.default_rng(seed)
    out = []
    for d in range(n_dev):
        n = 0 if d == n_dev - 1 else int(rng.integers(40, 300))
        padded = 128 if n <= 128 else 256 if n <= 256 else 512
        out.append((_data(rng, n, padded, 3 + 4 * d), n))
    return out


def _ref_exchange(shards, n_dev, width, padded, step):
    mesh = jmesh(n_dev)
    batches = [_ref_batch(c, n, width, padded) for c, n in shards]
    spmd = jax.jit(JX.exchange_step(mesh, step))
    stacked = JX.stack_to_mesh(mesh, JX.stack_partitions(batches))
    return JX.unstack_partitions(spmd(stacked))


def _assert_shards_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        k = int(w.num_rows)
        assert int(g.num_rows) == k
        for gc, wc in zip(g.columns, w.columns):
            _equal(gc.data.numpy()[:k], np.asarray(wc.data)[:k])
            _equal(gc.validity.numpy()[:k], np.asarray(wc.validity)[:k])
            assert not gc.validity[k:].any()
            if wc.lengths is not None:
                _equal(gc.lengths.numpy()[:k], np.asarray(wc.lengths)[:k])


@pytest.mark.parametrize("n_dev,capacity", [(2, 0), (4, 0), (4, 32)],
                         ids=["2 shards", "4 shards", "4 shards, capacity 32"])
def test_collective_exchange_matches_reference(n_dev, capacity):
    shards = _shards(n_dev, 20 + n_dev + capacity)
    width = max(c["string"][0].shape[1] for c, _n in shards)
    padded = max(c["bigint"][0].shape[0] for c, _n in shards)

    def step(local):
        pids = JX.device_partition_ids(local, [0, 9], n_dev)
        return JX.collective_exchange(local, pids, n_dev, DATA_AXIS,
                                      capacity)

    want = _ref_exchange(shards, n_dev, width, padded, step)
    batches = [_port_batch(c, n) for c, n in shards]
    record = {}
    got = X.collective_exchange(
        batches, [X.device_partition_ids(b, [0, 9], n_dev) for b in batches],
        n_dev, capacity=capacity, record=record)
    _assert_shards_equal(got, want)
    rows = sum(n for _c, n in shards)
    assert record["rows_written"] == rows
    assert record["partition_rows"] == [int(w.num_rows) for w in want]
    if capacity == 0:
        assert sum(record["partition_rows"]) == rows
        assert record["capacity"] == bucket_rows(
            max(max(r) for r in record["rows_sent"]))
    else:
        assert sum(record["partition_rows"]) < rows


@pytest.mark.parametrize("n_dev", [2, 4])
def test_gather_replicate_matches_reference(n_dev):
    shards = _shards(n_dev, 40 + n_dev)
    width = max(c["string"][0].shape[1] for c, _n in shards)
    padded = max(c["bigint"][0].shape[0] for c, _n in shards)
    want = _ref_exchange(shards, n_dev, width, padded,
                         lambda local: JX.gather_replicate(local, DATA_AXIS))
    batches = [_port_batch(c, n) for c, n in shards]
    got = X.gather_replicate(batches)
    _assert_shards_equal(got, want)
    # shards on one device share the replicated batch
    assert all(g is got[0] for g in got)
