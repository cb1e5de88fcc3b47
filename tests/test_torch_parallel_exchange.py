"""The collective exchange of spark_rapids_tpu_torch/parallel (on CPU
tensors, where K9, K10, K24 and K4 take their plain PyTorch versions)
against the JAX package's ``parallel/exchange.py`` on the same numpy
data.

* ``device_partition_ids`` and ``bucket_rows`` (the reference's formula)
  for 1, 3 and 8 destinations: equal ids, rows and lane masks.
* The tiles (K10's build, then K24's ``exchange_tiles``) against the
  reference's ``_gather_tiles`` over ``bucket_rows`` as plain jnp
  functions, at capacities below, at and above the largest count, over
  every column type with nulls: every lane equal to the byte, validity,
  lengths and lane mask included.
* ``_compact`` against the reference's.
* ``stack_partitions`` / ``unstack_partitions`` round trip.

The collectives themselves are in ``test_torch_parallel_collectives.py``
(split so that xdist spreads the two files)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.data.column import DeviceBatch as JBatch
from spark_rapids_tpu.data.column import DeviceColumn as JColumn
from spark_rapids_tpu.parallel import exchange as JX
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.data.column import DeviceBatch, DeviceColumn
from spark_rapids_tpu_torch.parallel import exchange as X
from spark_rapids_tpu_torch.shuffle import device_shuffle as DS

TYPES = ("bigint", "boolean", "tinyint", "smallint", "int", "float",
         "double", "date", "timestamp", "string")
_NP = {"boolean": np.bool_, "tinyint": np.int8, "smallint": np.int16,
       "int": np.int32, "bigint": np.int64, "float": np.float32,
       "double": np.float64, "date": np.int32, "timestamp": np.int64}


def _data(rng, n, padded, width):
    """name -> (type, data, validity, lengths) in numpy: ``n`` rows with
    nulls, padded to ``padded``; the strings ``width`` bytes wide."""
    out = {}
    for t in TYPES:
        valid = np.zeros(padded, np.bool_)
        valid[:n] = rng.random(n) > 0.2
        lengths = None
        if t == "string":
            lengths = np.zeros(padded, np.int32)
            lengths[:n] = rng.integers(0, width + 1, n)
            data = rng.integers(1, 256, (padded, width)).astype(np.uint8)
            data[np.arange(width)[None, :] >= lengths[:, None]] = 0
        elif t == "bigint":  # the key: few values, so destinations repeat
            data = rng.integers(0, 40, padded).astype(np.int64)
        elif t in ("float", "double"):
            data = rng.normal(0, 1e3, padded).astype(_NP[t])
        elif t == "boolean":
            data = rng.random(padded) > 0.5
        else:
            info = np.iinfo(_NP[t])
            data = rng.integers(info.min, info.max, padded, dtype=np.int64
                                ).astype(_NP[t])
        out[t] = (data, valid, lengths)
    return out


def _pad_width(arr, width):
    return np.pad(arr, ((0, 0), (0, width - arr.shape[1])))


def _port_batch(cols, n, width=None):
    schema = PT.Schema([PT.Field(f"c_{t}", PT.from_name(t)) for t in cols])
    dcols = []
    for t, (data, valid, lengths) in cols.items():
        if width is not None and data.ndim == 2:
            data = _pad_width(data, width)
        dcols.append(DeviceColumn(
            PT.from_name(t), torch.from_numpy(data.copy()),
            torch.from_numpy(valid.copy()),
            None if lengths is None else torch.from_numpy(lengths.copy())))
    return DeviceBatch(schema, dcols, torch.tensor(n, dtype=torch.int32))


def _ref_batch(cols, n, width=None, padded=None):
    schema = JT.Schema([JT.Field(f"c_{t}", JT.from_name(t)) for t in cols])
    dcols = []
    for t, (data, valid, lengths) in cols.items():
        if width is not None and data.ndim == 2:
            data = _pad_width(data, width)
        if padded is not None:
            extra = padded - data.shape[0]
            data = np.pad(data, ((0, extra),) + ((0, 0),) * (data.ndim - 1))
            valid = np.pad(valid, (0, extra))
            lengths = None if lengths is None else np.pad(lengths, (0, extra))
        dcols.append(JColumn(JT.from_name(t), jnp.asarray(data),
                             jnp.asarray(valid),
                             None if lengths is None else
                             jnp.asarray(lengths)))
    return JBatch(schema, dcols, n)


def _equal(got, want):
    """Equal shapes and bits (floats compared as their bit patterns)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype.kind == "f":
        got = got.view(np.int64 if got.itemsize == 8 else np.int32)
        want = want.view(got.dtype)
    np.testing.assert_array_equal(got, want)


def _pids(rng, n, padded, num_parts):
    pids = np.full(padded, num_parts, np.int32)
    pids[:n] = rng.integers(0, num_parts, n)
    return pids


@pytest.mark.parametrize("num_parts", [1, 3, 8])
def test_partition_ids_and_bucket_rows_match_reference(num_parts):
    rng = np.random.default_rng(num_parts)
    n, padded = 300, 512
    cols = _data(rng, n, padded, 9)
    got = X.device_partition_ids(_port_batch(cols, n), [0, 9], num_parts)
    want = JX.device_partition_ids(_ref_batch(cols, n), [0, 9], num_parts)
    _equal(got.numpy(), want)
    pids = _pids(rng, n, padded, num_parts)
    for cap in (16, 128, 600):
        rows, valid = X.bucket_rows(torch.from_numpy(pids), num_parts, cap)
        jrows, jvalid = JX.bucket_rows(jnp.asarray(pids), num_parts, cap)
        _equal(rows.numpy(), jrows)
        _equal(valid.numpy(), jvalid)


@pytest.mark.parametrize("num_parts", [1, 3, 8])
def test_tiles_match_reference_gather_tiles(num_parts):
    """K10's build then K24 (plain) against ``bucket_rows`` +
    ``_gather_tiles``, every lane, at capacities below, at and above the
    largest destination count."""
    rng = np.random.default_rng(10 + num_parts)
    n, padded = 700, 1024
    cols = _data(rng, n, padded, 7)
    pids = _pids(rng, n, padded, num_parts)
    batch, ref = _port_batch(cols, n), _ref_batch(cols, n)
    order, counts, starts = DS.partition_order(
        torch.from_numpy(pids), batch.num_rows, num_parts)
    most = int(counts.max())
    for cap in (max(most // 2, 1), most, 2 * most + 5):
        tiles, lane = X._gather_tiles(batch, order, starts, counts, cap)
        jrows, jvalid = JX.bucket_rows(jnp.asarray(pids), num_parts, cap)
        want = JX._gather_tiles(ref, jrows, jvalid)
        _equal(lane.numpy(), np.asarray(jvalid).reshape(-1))
        for g, w in zip(tiles, want):
            shape = (num_parts * cap,) + tuple(w.data.shape[2:])
            _equal(g.data.numpy(), np.asarray(w.data).reshape(shape))
            _equal(g.validity.numpy(), np.asarray(w.validity).reshape(-1))
            if w.lengths is not None:
                _equal(g.lengths.numpy(), np.asarray(w.lengths).reshape(-1))


@pytest.mark.parametrize("num_parts", [1, 3, 8])
def test_tile_bytes_count_each_row_read_once(num_parts):
    """K24's bound reads each row some lane touches once (a lane past its
    count reads a row of the next destination, or the last row) and
    writes every lane, at capacities below, at and above the largest
    count."""
    rng = np.random.default_rng(20 + num_parts)
    n, padded = 700, 1024
    cols = _data(rng, n, padded, 7)
    batch = _port_batch(cols, n)
    order, counts, starts = DS.partition_order(
        torch.from_numpy(_pids(rng, n, padded, num_parts)), batch.num_rows,
        num_parts)
    row = sum(c.data[0].numel() * c.data.element_size() + 1
              + (4 if c.lengths is not None else 0) for c in batch.columns)
    most = int(counts.max())
    for cap in (max(most // 2, 1), most, 2 * most + 5, 4096):
        tiles, _lane = X._gather_tiles(batch, order, starts, counts, cap)
        gidx = torch.clamp(starts.to(torch.int64)[:, None]
                           + torch.arange(cap)[None, :], 0, padded - 1)
        read = int(torch.unique(gidx).numel())
        lanes = num_parts * cap
        assert DS.exchange_tiles_bytes(batch, tiles, starts, counts, cap) \
            == read * (4 + row) + lanes * (1 + row) + 8 * num_parts


def test_tiles_written_at_a_wider_string_width():
    rng = np.random.default_rng(3)
    n, padded = 200, 256
    cols = _data(rng, n, padded, 5)
    pids = _pids(rng, n, padded, 3)
    batch = _port_batch(cols, n)
    order, counts, starts = DS.partition_order(
        torch.from_numpy(pids), batch.num_rows, 3)
    widths = [None] * (len(TYPES) - 1) + [11]
    wide, lane = X._gather_tiles(batch, order, starts, counts, 128, widths)
    own, lane2 = X._gather_tiles(batch, order, starts, counts, 128)
    assert torch.equal(lane, lane2)
    assert wide[-1].data.shape[1] == 11
    assert torch.equal(wide[-1].data[:, :5], own[-1].data)
    assert not wide[-1].data[:, 5:].any()


def test_compact_matches_reference():
    rng = np.random.default_rng(4)
    n = 512
    cols = _data(rng, n, n, 6)
    present = rng.random(n) > 0.4
    batch, ref = _port_batch(cols, n), _ref_batch(cols, n)
    got = X._compact(batch.columns, torch.from_numpy(present), batch.schema)
    want = JX._compact(ref.columns, jnp.asarray(present), ref.schema)
    k = int(want.num_rows)
    assert int(got.num_rows) == k == int(present.sum())
    for g, w in zip(got.columns, want.columns):
        _equal(g.data.numpy()[:k], np.asarray(w.data)[:k])
        _equal(g.validity.numpy(), np.asarray(w.validity)[:g.padded_rows])


def test_stack_unstack_round_trip():
    rng = np.random.default_rng(8)
    batches = [_port_batch(_data(rng, n, 128, 4), n) for n in (5, 0, 128)]
    back = X.unstack_partitions(X.stack_partitions(batches))
    for b, r in zip(batches, back):
        assert int(b.num_rows) == int(r.num_rows)
        for c, rc in zip(b.columns, r.columns):
            assert torch.equal(c.data, rc.data)
            assert torch.equal(c.validity, rc.validity)
