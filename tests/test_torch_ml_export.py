"""The ML export (``spark_rapids_tpu_torch/ml``) against the reference's
(``spark_rapids_tpu/ml``), the cases of the reference's
``tests/test_ml_and_validation.py:29-97`` on the same data: the
``exportColumnarRdd`` gate, the batches staying device batches (their
rows adding up to the query's), the feature matrix of chosen columns
and of the default numeric ones, the rows with a null dropped, the
round trip through ``from_device_batches`` and the export of an
aggregate.  Each matrix equals the reference's bit for bit (float32;
NaN and -0.0 included), but the columns derived from an average, within
1 float32 ULP (the two packages sum in another order before the cast);
the port runs on CPU tensors, where ``to_feature_matrix`` takes K26's
plain version."""
import numpy as np
import pytest
import torch

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import ml as jml
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plan import functions as JF
from spark_rapids_tpu_torch import Session, ml
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.data.column import DeviceBatch
from spark_rapids_tpu_torch.plan import functions as PF

EXPORT = {"spark.rapids.tpu.sql.exportColumnarRdd": True}


def _sessions(export=True):
    conf = {"spark.rapids.tpu.sql.exportColumnarRdd": export}
    return jsrt.Session(conf), Session(conf, device="cpu")


def _data(n=500):
    rng = np.random.default_rng(0)
    x = rng.random(n)
    x[:3] = [np.nan, -0.0, np.inf]
    return {"k": (np.arange(n) % 11).astype(np.int64), "x": x,
            "y": rng.random(n).astype(np.float32),
            "s": np.array([f"r{i}" for i in range(n)], dtype=object)}


def _dfs(sess_pair, n=500):
    j, p = sess_pair
    return j.create_dataframe(_data(n)), p.create_dataframe(_data(n))


def _same(got: torch.Tensor, want, ulp_columns=()):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert tuple(got.shape) == want.shape
    g = got.numpy().view(np.int32)
    w = want.view(np.int32)
    for j in range(want.shape[1]):
        if j in ulp_columns:
            assert np.abs(g[:, j].astype(np.int64) - w[:, j]).max() <= 1
        else:
            assert np.array_equal(g[:, j], w[:, j]), j


def test_export_requires_conf():
    _j, p = _dfs(_sessions(export=False))
    with pytest.raises(RuntimeError, match="exportColumnarRdd"):
        ml.columnar_batches(p)


def test_columnar_batches_stay_on_device():
    j, p = _dfs(_sessions())
    jb = jml.columnar_batches(j.filter(JF.col("x") > 0.5))
    pq = p.filter(PF.col("x") > 0.5)
    batches = ml.columnar_batches(pq)
    assert batches and all(isinstance(b, DeviceBatch) for b in batches)
    assert all(b.device == torch.device("cpu") for b in batches)
    total = sum(int(b.num_rows) for b in batches)
    assert total == sum(int(b.num_rows) for b in jb) == len(pq.collect())


def test_feature_matrix_matches_reference_and_collect():
    j, p = _dfs(_sessions())
    X = ml.feature_matrix(p, ["x", "y"])
    assert X.shape == (500, 2) and X.dtype == torch.float32
    _same(X, jml.feature_matrix(j, ["x", "y"]))
    rows = p.collect()
    assert X[:, 1].tolist() == [r[2] for r in rows]


def test_feature_matrix_default_numeric_columns():
    j, p = _dfs(_sessions())
    X = ml.feature_matrix(p)  # k, x, y (the string column skipped)
    assert X.shape == (500, 3)
    _same(X, jml.feature_matrix(j))


def test_feature_matrix_drops_null_rows():
    """Rows with a NULL in any selected feature are dropped, not exported
    as fabricated 0.0 values."""
    js, ps = _sessions()
    data = {"x": np.array([1.0, 2.0, 3.0, 4.0]),
            "g": np.array([0, 1, 0, 1])}
    j = js.create_dataframe(data, JT.Schema(
        [JT.Field("x", JT.FLOAT64), JT.Field("g", JT.INT64)]))
    p = ps.create_dataframe(data, PT.Schema(
        [PT.Field("x", PT.FLOAT64), PT.Field("g", PT.INT64)]))
    j = j.with_column("x", JF.when(JF.col("g") == JF.lit(1),
                                   JF.col("x")).end())
    p = p.with_column("x", PF.when(PF.col("g") == PF.lit(1),
                                   PF.col("x")).end())
    X = ml.feature_matrix(p, ["x", "g"])
    assert X.shape == (2, 2)
    assert sorted(X[:, 0].tolist()) == [2.0, 4.0]
    _same(X, jml.feature_matrix(j, ["x", "g"]))


def test_round_trip_from_device_batches():
    js, ps = _sessions()
    j, p = _dfs((js, ps), n=100)
    df2 = ml.from_device_batches(ps, ml.columnar_batches(p))
    want = jml.from_device_batches(js, jml.columnar_batches(j)).collect()
    def rows(r):  # NaN equal to NaN
        return sorted(map(repr, r))

    assert rows(p.collect()) == rows(df2.collect()) == rows(want)


def test_aggregated_export():
    """Export after an aggregation: the transition peeled off a
    multi-stage device plan; the average within 1 ULP."""
    j, p = _dfs(_sessions())
    g = p.group_by("k").agg(PF.sum("k").alias("sk"),
                            PF.avg("y").alias("ay")).sort("k")
    batches = ml.columnar_batches(g)
    assert sum(int(b.num_rows) for b in batches) == 11
    jg = j.group_by("k").agg(JF.sum("k").alias("sk"),
                             JF.avg("y").alias("ay")).sort("k")
    _same(ml.feature_matrix(g), jml.feature_matrix(jg), ulp_columns=(2,))
