"""The dynamic-partition Parquet write of spark_rapids_tpu_torch (on CPU
tensors, where K1 and K4 take their plain versions) against the JAX
package's device write on the same numpy data.

Cases: the reference's write tests of ``tests/test_io.py`` run through
the port: dynamic partitions (``:60``), string, null, NaN, -0.0 and
escaped partition values (``:119-178``), tagging, explain marks, strict
mode and write stats (``:180-206``), and the unpartitioned write of
three partitions (``:40``'s write half); and the datagen modules'
``write_parquet``.  Both packages write into
temporary directories and pyarrow reads every file back: the relative
paths are equal, each file's arrow schema and rows (in order, floats bit
for bit) are equal, and the trackers' rows per file are equal.  The
round trips through ``read_parquet`` (``:40``, ``:83``) wait for the
port's scan.

The reference runs with AQE off (a write's partition ids name its
files) and with most XLA optimizations off, for quick compiles.
"""
import os

import jax
import numpy as np
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plan.logical import WriteFile as JWriteFile
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.data.column import HostBatch
from spark_rapids_tpu_torch.io import parquet as PQ
from spark_rapids_tpu_torch.plan.logical import WriteFile as PWriteFile

REF_CONF = {"spark.rapids.tpu.sql.adaptive.enabled": False}


@pytest.fixture(scope="module", autouse=True)
def quick_reference_compiles():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _mixed():
    """``tests/test_io.py:mixed_df_data`` and its schema."""
    rng = np.random.RandomState(17)
    n = 500
    data = {"k": rng.randint(0, 4, n), "v": (rng.rand(n) * 100).round(6),
            "s": [None if i % 29 == 0 else f"name-{i % 37}"
                  for i in range(n)],
            "d": rng.randint(0, 20000, n).astype("int32")}

    def schema(T):
        return T.Schema([T.Field("k", T.INT64), T.Field("v", T.FLOAT64),
                         T.Field("s", T.STRING), T.Field("d", T.DATE32)])

    return data, schema


def _files(root):
    out = []
    for d, _dirs, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


def _same_table(got, want, where):
    assert got.schema.equals(want.schema, check_metadata=False), \
        (where, got.schema, want.schema)
    assert got.num_rows == want.num_rows, where
    for name in want.column_names:
        g = got.column(name).combine_chunks()
        w = want.column(name).combine_chunks()
        assert g.is_null().to_pylist() == w.is_null().to_pylist(), \
            (where, name)
        if g.type.to_pandas_dtype() in (np.float32, np.float64):
            gv = g.fill_null(0).to_numpy()
            wv = w.fill_null(0).to_numpy()
            assert np.array_equal(gv.view(f"u{gv.itemsize}"),
                                  wv.view(f"u{wv.itemsize}")), (where, name)
        else:
            assert g.to_pylist() == w.to_pylist(), (where, name)


def _same_dirs(pout, jout):
    """The same relative paths, a ``_SUCCESS`` among them, and each data
    file's schema and rows; the port's decoder reads each port file."""
    files = _files(pout)
    assert files == _files(jout)
    assert any(os.path.basename(f) == "_SUCCESS" for f in files)
    for rel in files:
        if rel.endswith(".parquet"):
            mine = pq.ParquetFile(os.path.join(pout, rel))
            _same_table(mine.read(),
                        pq.ParquetFile(os.path.join(jout, rel)).read(), rel)
            back = PQ.read_file(os.path.join(pout, rel))
            assert back.num_rows == mine.metadata.num_rows
    return files


def _write_both(tmp_path, data, schema_fn=None, n_partitions=2, **kw):
    """Write ``data`` with both packages; returns (port dir, reference
    dir, port session, reference session) after comparing the files."""
    psess = Session(device="cpu")
    jsess = jsrt.Session(REF_CONF)
    pout = os.path.join(str(tmp_path), "port")
    jout = os.path.join(str(tmp_path), "ref")
    pdf = psess.create_dataframe(
        data, schema_fn(PT) if schema_fn else None, n_partitions=n_partitions)
    jdf = jsess.create_dataframe(
        data, schema_fn(JT) if schema_fn else None, n_partitions=n_partitions)
    pdf.write_parquet(pout, **kw)
    jdf.write_parquet(jout, **kw)
    _same_dirs(pout, jout)
    prows = {os.path.relpath(f["path"], pout): f["rows"]
             for f in psess.last_write_stats.files}
    jrows = {os.path.relpath(f["path"], jout): f["rows"]
             for f in jsess.last_write_stats.files}
    assert prows == jrows
    return pout, jout, psess, jsess


def test_dynamic_partition_write(tmp_path):
    data, schema = _mixed()
    pout, _j, _p, _s = _write_both(tmp_path, data, schema,
                                   partition_by=["k"])
    dirs = sorted(d for d in os.listdir(pout) if d.startswith("k="))
    assert dirs == ["k=0", "k=1", "k=2", "k=3"]


def test_unpartitioned_write_three_partitions(tmp_path):
    data, schema = _mixed()
    pout, _j, psess, _s = _write_both(tmp_path, data, schema,
                                      n_partitions=3)
    assert sorted(p for p in os.listdir(pout) if p.startswith("part-")) \
        == [f"part-0000{i}.parquet" for i in range(3)]
    assert psess.last_write_stats.metrics["numOutputRows"].value == 500


@pytest.mark.parametrize("case", ["string_null", "nan", "negative_zero",
                                  "escaped"])
def test_hive_partition_values(tmp_path, case):
    g = {"string_null": ["a", "b", None, "a"],
         "nan": [float("nan"), float("nan"), 1.0, float("nan")],
         "negative_zero": [0.0, -0.0, 1.5, -0.0],
         "escaped": ["a/b", "x=y", "plain", "a/b"]}[case]
    pout, _j, psess, _s = _write_both(
        tmp_path, {"g": g, "x": [1, 2, 3, 4]}, partition_by=["g"])
    dirs = sorted(d for d in os.listdir(pout) if "=" in d)
    want = {"string_null": ["g=__HIVE_DEFAULT_PARTITION__", "g=a", "g=b"],
            "nan": ["g=1.0", "g=nan"],
            "negative_zero": ["g=0.0", "g=1.5"],
            "escaped": ["g=a%2Fb", "g=plain", "g=x%3Dy"]}[case]
    assert dirs == want
    # no row lost: every group's rows are in its directory's files
    assert psess.last_write_stats.metrics["numOutputRows"].value == 4
    assert sum(f["rows"] for f in psess.last_write_stats.files) == 4


def test_write_goes_through_rewrite_engine(tmp_path):
    """``*`` in explain, ``!`` for bucketed output and for ORC (no
    encoder here; its conversion raises), the device write under strict
    test mode, per-file stats that add up to the directory listing."""
    data, schema = _mixed()
    psess = Session(device="cpu")
    jsess = jsrt.Session(REF_CONF)
    pdf = psess.create_dataframe(data, schema(PT))
    jdf = jsess.create_dataframe(data, schema(JT))
    for part, bucket in ((["k"], None), ([], ["k"])):
        ex = psess.explain(PWriteFile(pdf.plan, "parquet", "/x", {}, part,
                                      bucket))
        jx = jsess.explain(JWriteFile(jdf.plan, "parquet", "/x", {}, part,
                                      bucket))
        assert ex.splitlines()[0][:2] == jx.splitlines()[0][:2]
        assert ex.splitlines()[0].startswith(
            "! DataWritingCommandExec" if bucket else
            "* DataWritingCommandExec")
    assert "bucketed" in psess.explain(PWriteFile(
        pdf.plan, "parquet", "/x", {}, [], ["k"])).splitlines()[0]
    orc = psess.explain(PWriteFile(pdf.plan, "orc", "/x", {}, ["k"]))
    assert orc.startswith("! DataWritingCommandExec") and "ORC" in orc
    with pytest.raises(NotImplementedError, match="ORC"):
        pdf.write_orc(os.path.join(str(tmp_path), "orc"))
    missing = psess.explain(PWriteFile(pdf.plan, "parquet", "/x", {},
                                       ["nope"]))
    assert missing.startswith("! ") and "nope not found" in missing

    strict = Session({"spark.rapids.tpu.sql.test.enabled": True},
                     device="cpu")
    out = os.path.join(str(tmp_path), "strict")
    strict.create_dataframe(data, schema(PT)).write_parquet(
        out, partition_by=["k"])
    st = strict.last_write_stats
    assert st.metrics["numOutputRows"].value == 500
    assert st.files and all(f["rows"] > 0 and f["bytes"] > 0
                            for f in st.files)
    assert st.metrics["numFiles"].value == len(st.files)
    listed = [os.path.join(out, f) for f in _files(out)
              if f.endswith(".parquet")]
    assert sorted(f["path"] for f in st.files) == sorted(listed)
    assert st.metrics["numOutputBytes"].value == \
        sum(os.path.getsize(p) for p in listed)


def test_datagen_write_parquet(tmp_path):
    """``tpch_datagen.write_parquet`` writes the reference's eight tables
    as the reference's does; ``tpcxbb_datagen.write_parquet`` writes
    every generated table, read back equal by the port's decoder."""
    from spark_rapids_tpu.benchmarks import tpch_datagen as JD
    from spark_rapids_tpu_torch.benchmarks import tpch_datagen as PD
    from spark_rapids_tpu_torch.benchmarks import tpcxbb_datagen as PB

    pout = os.path.join(str(tmp_path), "port")
    jout = os.path.join(str(tmp_path), "ref")
    PD.write_parquet(Session(device="cpu"), pout, 0.001, 42)
    JD.write_parquet(jsrt.Session(REF_CONF), jout, 0.001, 42)
    files = _same_dirs(pout, jout)
    assert sorted({f.split(os.sep)[0] for f in files}) == sorted(
        PD.reference_tables(0.001, 42))
    bout = os.path.join(str(tmp_path), "bb")
    PB.write_parquet(Session(device="cpu"), bout, 0.001, 99)
    for name, want in PB.tables(0.001, 99).items():
        parts = [PQ.read_file(os.path.join(bout, name, p)) for p in
                 sorted(os.listdir(os.path.join(bout, name)))
                 if p.endswith(".parquet")]
        got = HostBatch.concat(parts)
        assert got.schema == want.schema and got.to_rows() == \
            want.to_rows(), name
