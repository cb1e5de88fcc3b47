"""The port's Parquet codec (``spark_rapids_tpu_torch/io/parquet.py``)
against pyarrow, with no JAX.

* Every engine type, with and without nulls, and all-null, empty and
  one-row batches: pyarrow reads the port's file with the arrow schema
  the reference writes (``io/arrow_convert.py:44 dtype_to_arrow``) and
  the same values; the port's decoder reads it back bit for bit.
* A batch over several row groups, and a schema of 17 columns (Thrift
  list headers of 15 elements and more).
* Statistics (null count, min, max; none where a float chunk holds NaN;
  -0.0/+0.0 at a zero bound) and the footer's structs against the ones
  pyarrow writes for the same data (``use_dictionary=False``), decoded by
  the port's own Thrift reader.
* Codecs: snappy (literal-only framing, checked by pyarrow's Snappy),
  gzip and none; an unknown codec raises naming itself.
* The decoder on pyarrow's files (snappy with matches, several pages a
  chunk, RLE and bit-packed levels); ``NotImplementedError`` naming the
  encoding on a dictionary page, and on ``write_orc``.
"""
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data import strings as S
from spark_rapids_tpu_torch.data.column import HostBatch, HostColumn
from spark_rapids_tpu_torch.io import parquet as PQ

#: the arrow type of each engine type, as the reference writes it
ARROW = {T.BOOL: pa.bool_(), T.INT8: pa.int8(), T.INT16: pa.int16(),
         T.INT32: pa.int32(), T.INT64: pa.int64(),
         T.FLOAT32: pa.float32(), T.FLOAT64: pa.float64(),
         T.DATE32: pa.date32(), T.TIMESTAMP: pa.timestamp("us", tz="UTC"),
         T.STRING: pa.string()}
TYPES = list(ARROW)


def _column(t, n, rng, null_share):
    valid = rng.random(n) >= null_share
    if t.is_string:
        words = ["", "a", "a\x00", "b", "zz top", "é€", "x" * 70]
        vals = [words[i] for i in rng.integers(0, len(words), n)]
        bm, ln = S.encode(vals, valid)
        return HostColumn(t, bm, valid, ln)
    if t == T.BOOL:
        data = rng.random(n) > 0.5
    elif t.is_floating:
        data = rng.normal(0, 1e3, n).astype(t.np_dtype)
        data[::7] = -0.0
    else:
        info = np.iinfo(t.np_dtype)
        data = rng.integers(info.min, info.max, n, dtype=t.np_dtype,
                            endpoint=True)
    data = np.where(valid, data, 0).astype(t.np_dtype)
    return HostColumn(t, data, valid)


def _batch(types, n, seed=0, null_share=0.0):
    rng = np.random.default_rng(seed)
    cols = [_column(t, n, rng, null_share) for t in types]
    return HostBatch(T.Schema([T.Field(f"c{i}_{t.sql_name}", t)
                               for i, t in enumerate(types)]), cols)


def _arrow(batch):
    """The batch as the reference's ``host_batch_to_arrow`` builds it."""
    arrays = []
    for f, c in zip(batch.schema, batch.columns):
        mask = None if c.validity is None else ~c.validity
        if f.dtype.is_string:
            vals = S.decode(c.data, c.lengths, c.validity).tolist()
            arrays.append(pa.array(vals, type=pa.string()))
        elif f.dtype == T.TIMESTAMP:
            arrays.append(pa.array(c.data.astype("datetime64[us]"),
                                   type=ARROW[f.dtype], mask=mask))
        elif f.dtype == T.DATE32:
            arrays.append(pa.array(c.data.astype("datetime64[D]"),
                                   type=pa.date32(), mask=mask))
        else:
            arrays.append(pa.array(c.data, type=ARROW[f.dtype], mask=mask))
    return pa.Table.from_arrays(arrays, schema=pa.schema(
        [pa.field(f.name, ARROW[f.dtype], f.nullable)
         for f in batch.schema]))


def _same_batch(got, want):
    assert got.schema == want.schema
    for g, w in zip(got.columns, want.columns):
        v = w.is_valid()
        assert np.array_equal(g.is_valid(), v)
        if w.dtype.is_string:
            assert np.array_equal(g.lengths[v], w.lengths[v])
            width = max(g.data.shape[1], w.data.shape[1])
            gm, wm = S.pad_width(g.data, width), S.pad_width(w.data, width)
            inside = np.arange(width)[None, :] < w.lengths[:, None]
            assert np.array_equal(np.where(inside, gm, 0)[v],
                                  np.where(inside, wm, 0)[v])
        else:
            assert np.array_equal(g.data[v].view(np.uint8),
                                  w.data[v].view(np.uint8))
            assert not g.data[~v].astype(bool).any()


def _check_round_trip(batch, path, **kw):
    PQ.write_file(path, batch, **kw)
    got = pq.ParquetFile(path).read()
    want = _arrow(batch)
    assert got.schema.equals(want.schema, check_metadata=False), \
        (got.schema, want.schema)
    for name in want.column_names:
        g = got.column(name).combine_chunks()
        w = want.column(name).combine_chunks()
        assert g.is_null().to_pylist() == w.is_null().to_pylist(), name
        if pa.types.is_date32(w.type) or pa.types.is_timestamp(w.type):
            ints = pa.int32() if pa.types.is_date32(w.type) else pa.int64()
            g, w = g.view(ints), w.view(ints)  # beyond Python's dates
        if pa.types.is_floating(w.type):  # bit for bit
            gv, wv = g.fill_null(0).to_numpy(), w.fill_null(0).to_numpy()
            assert gv.tobytes() == wv.tobytes(), name
        else:
            assert g.to_pylist() == w.to_pylist(), name
    _same_batch(PQ.read_file(path), batch)


@pytest.mark.parametrize("null_share", [0.0, 0.3, 1.0],
                         ids=["no_nulls", "nulls", "all_null"])
@pytest.mark.parametrize("t", TYPES, ids=[t.sql_name for t in TYPES])
def test_type_round_trip(tmp_path, t, null_share):
    _check_round_trip(_batch([t], 300, 1, null_share),
                      os.path.join(str(tmp_path), "f.parquet"))


@pytest.mark.parametrize("n", [0, 1], ids=["empty", "one_row"])
def test_small_batches(tmp_path, n):
    _check_round_trip(_batch(TYPES, n, 2, 0.3),
                      os.path.join(str(tmp_path), "f.parquet"))


def test_row_groups_and_wide_schema(tmp_path):
    """1,000 rows at 64 a row group (16 groups: list headers past 15),
    17 columns (a 18-element schema list)."""
    batch = _batch(TYPES + TYPES[:7], 1000, 3, 0.2)
    path = os.path.join(str(tmp_path), "f.parquet")
    _check_round_trip(batch, path, row_group_rows=64)
    meta = pq.ParquetFile(path).metadata
    assert meta.num_row_groups == 16 and meta.num_columns == 17
    assert [meta.row_group(i).num_rows for i in range(16)] == \
        [64] * 15 + [40]


@pytest.mark.parametrize("codec", ["snappy", "gzip", "none",
                                   "UNCOMPRESSED"])
def test_codecs(tmp_path, codec):
    path = os.path.join(str(tmp_path), "f.parquet")
    _check_round_trip(_batch(TYPES, 500, 4, 0.2), path, compression=codec)
    col = pq.ParquetFile(path).metadata.row_group(0).column(0)
    assert col.compression == {"none": "UNCOMPRESSED"}.get(
        codec, codec.upper())


@pytest.mark.parametrize("n", [1, 60, 61, 256, 257, 65536, 65537,
                               (1 << 24) + 3])
def test_snappy_literal_framing(n):
    """pyarrow's Snappy decompresses the port's framing: the varint
    preamble, then one literal (tag ``(59 + k) << 2`` and ``n - 1`` in
    k little-endian bytes past 60 bytes)."""
    raw = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8) \
        .tobytes()
    framed = PQ.snappy_literal_header(n) + raw
    assert pa.Codec("snappy").decompress(framed, n).to_pybytes() == raw
    assert PQ.snappy_decompress(framed) == raw


def test_unknown_codec_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="zstd"):
        PQ.write_file(os.path.join(str(tmp_path), "f.parquet"),
                      _batch([T.INT64], 5), compression="zstd")


def _pyarrow_file(batch, path, **kw):
    pq.write_table(_arrow(batch), path, **kw)
    return path


@pytest.mark.parametrize("null_share", [0.0, 0.4], ids=["valid", "nulls"])
def test_statistics_and_footer_match_pyarrow(tmp_path, null_share):
    batch = _batch(TYPES, 400, 5, null_share)
    nan_batch = _batch([T.FLOAT64, T.FLOAT32], 50, 6)
    for c in nan_batch.columns:
        c.data[3] = np.nan
    zero = HostBatch(T.Schema([T.Field("z", T.FLOAT64)]),
                     [HostColumn(T.FLOAT64, np.array([0.0, 0.0, -0.0]))])
    for i, b in enumerate((batch, nan_batch, zero)):
        mine = os.path.join(str(tmp_path), f"port{i}.parquet")
        theirs = _pyarrow_file(b, os.path.join(str(tmp_path),
                                               f"pa{i}.parquet"),
                               use_dictionary=False, store_schema=False)
        PQ.write_file(mine, b)
        pm, tm = pq.ParquetFile(mine).metadata, pq.ParquetFile(theirs) \
            .metadata
        for ci in range(len(b.schema)):
            ps = pm.row_group(0).column(ci).statistics
            ts = tm.row_group(0).column(ci).statistics
            assert ps.null_count == ts.null_count
            has_nan = b.schema[ci].dtype.is_floating and \
                np.isnan(b.columns[ci].data).any()
            assert ps.has_min_max == (not has_nan and
                                      b.columns[ci].is_valid().any())
            if ps.has_min_max:
                for a, c in ((ps.min_raw, ts.min_raw),
                             (ps.max_raw, ts.max_raw)):
                    assert np.asarray(a).tobytes() == np.asarray(c) \
                        .tobytes() if not isinstance(a, bytes) else a == c
        # the footers' structs, decoded by the port's Thrift reader
        fp = PQ.read_metadata(open(mine, "rb").read())
        ft = PQ.read_metadata(open(theirs, "rb").read())
        assert fp[2] == ft[2]  # SchemaElements, LogicalType unions
        assert fp[3] == ft[3] and fp[7] == ft[7]  # rows, column orders
        for ci, (cp, ct) in enumerate(zip(fp[4][0][1], ft[4][0][1])):
            mp, mt = cp[3], ct[3]
            for fid in (1, 3, 4, 5):  # type, path, codec, values
                assert mp[fid] == mt[fid], fid
            assert set(mp[2]) <= set(mt[2])  # encodings
            sp, st = mp[12], mt[12]
            # null count, max and min values (pyarrow gives a float
            # chunk with NaN the bounds of its other values; none here)
            nan = b.schema[ci].dtype.is_floating and \
                np.isnan(b.columns[ci].data).any()
            for fid in (3,) if nan else (3, 5, 6):
                assert sp.get(fid) == st.get(fid), (fid, sp, st)


@pytest.mark.parametrize("codec", ["snappy", "gzip", "none"])
def test_decoder_reads_pyarrow_files(tmp_path, codec):
    """Snappy with matches, pages of ~1 KB (several a chunk), RLE and
    bit-packed definition levels."""
    batch = _batch(TYPES, 3000, 7, 0.1)
    for c in batch.columns[:3]:  # long runs of valid and null rows
        v = np.ones(3000, np.bool_)
        v[1000:1400] = False
        c.validity = v
        if c.dtype.is_string:
            c.lengths = np.where(v, c.lengths, 0).astype(np.int32)
        c.data[~v] = 0
    path = _pyarrow_file(batch, os.path.join(str(tmp_path), "pa.parquet"),
                         use_dictionary=False, compression=codec,
                         data_page_size=1024, row_group_size=2000)
    meta = pq.ParquetFile(path).metadata
    assert meta.num_row_groups == 2
    _same_batch(PQ.read_file(path), batch)


def test_dictionary_page_and_orc_raise(tmp_path):
    path = _pyarrow_file(_batch([T.STRING], 100, 8),
                         os.path.join(str(tmp_path), "dict.parquet"))
    with pytest.raises(NotImplementedError, match="dictionary page"):
        PQ.read_file(path)
    sess = Session(device="cpu")
    df = sess.create_dataframe({"x": [1, 2, 3]})
    with pytest.raises(NotImplementedError, match="ORC"):
        df.write_orc(os.path.join(str(tmp_path), "orc"))


def _lineitem(sf):
    from spark_rapids_tpu_torch.benchmarks import tpch_datagen

    cols = tpch_datagen.draw_all(sf, 42)
    names = [c for c in cols if c.startswith("l_")]
    return HostBatch(T.Schema([T.Field(c, cols[c].dtype) for c in names]),
                     [cols[c] for c in names])


def _store_sales(sf):
    from spark_rapids_tpu_torch.benchmarks import tpcxbb_datagen

    return tpcxbb_datagen.tables(sf, 99, ["store_sales"])["store_sales"]


@pytest.mark.parametrize("table", [_store_sales, _lineitem],
                         ids=["store_sales", "lineitem"])
def test_file_bytes_against_pyarrow(tmp_path, table):
    """One file of a generated table (SF 0.01) by each of the port's
    codecs and by pyarrow's default writer (snappy with dictionaries):
    literal-only snappy adds only its framing to the uncompressed bytes,
    gzip is smaller than both, and pyarrow's default file is smaller
    than the port's snappy file (the cost of a compressor without
    matches).  ``pytest -s`` prints the bytes."""
    hb = table(0.01)
    path = str(tmp_path / "f.parquet")
    got = {c: PQ.write_file(path, hb, c) for c in ("snappy", "gzip", "none")}
    pq.write_table(_arrow(hb), path)
    got["pyarrow"] = os.path.getsize(path)
    print(f"{table.__name__[1:]}: {hb.num_rows} rows x {len(hb.schema)} "
          f"columns, file bytes {got}")
    pages = len(hb.schema) * -(-hb.num_rows // PQ.ROW_GROUP_ROWS)
    assert got["none"] < got["snappy"] <= got["none"] + 16 * pages
    assert got["gzip"] < got["none"]
    assert got["pyarrow"] < got["snappy"]
