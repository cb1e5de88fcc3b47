"""TPC-H Q1 and Q6 through spark_rapids_tpu_torch (on CPU tensors, where
every kernel wrapper takes its plain PyTorch version) against the JAX
package's device session on the same lineitem rows.

Keys and counts are equal, floats agree to rel 1e-9 (sums run in another
order), Q1's rows come in the same order, the explain reports carry the
same marks and exec names, and each aggregate sees one batch."""
import re

import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch.benchmarks import tpch, tpch_datagen
from spark_rapids_tpu_torch.interop import (from_reference_arrays,
                                            to_reference_arrays)

ROWS = 20_000


@pytest.fixture(scope="module")
def frames():
    fields, arrays = to_reference_arrays(
        tpch_datagen.lineitem(n_rows=ROWS, seed=7))
    jschema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in fields])
    jdf = jsrt.Session().create_dataframe(
        {n: arrays[n] for n, _ in fields}, jschema, n_partitions=1)
    sess = Session(device="cpu")
    pdf = sess.create_dataframe(
        from_reference_arrays(fields, [arrays[n] for n, _ in fields]),
        n_partitions=1)
    return sess, {"lineitem": pdf}, {"lineitem": jdf}


def _assert_rows_close(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=0)
            else:
                assert a == b


@pytest.mark.parametrize("q", [1, 6])
def test_query_matches_reference(frames, q):
    sess, ptables, jtables = frames
    got = tpch.QUERIES[q](ptables).collect()
    want = getattr(jtpch, f"q{q}")(jtables).collect()
    _assert_rows_close(got, want)
    assert sess.last_metrics[
        "TpuHashAggregateExec[partial].numInputBatches"] == 1
    assert sess.last_metrics[
        "TpuHashAggregateExec[final].numInputBatches"] == 1


def test_q1_groups_and_order(frames):
    sess, ptables, _ = frames
    rows = tpch.q1(ptables).collect()
    keys = [(r[0], r[1]) for r in rows]
    assert keys == sorted(keys)
    assert sum(r[-1] for r in rows) <= ROWS


def _marks(report):
    return [tuple(re.match(r"\s*([*!@]) (\w+)", line).groups())
            for line in report.splitlines()]


@pytest.mark.parametrize("q", [1, 6])
def test_explain_marks_match_reference(frames, q):
    _sess, ptables, jtables = frames
    got = tpch.QUERIES[q](ptables).explain()
    want = getattr(jtpch, f"q{q}")(jtables).explain()
    assert _marks(got) == _marks(want)
    assert ("!", "LocalScanExec") in _marks(got)


def test_device_plan_shape_matches_reference(frames):
    """The converted plans name the same execs in the same places."""
    sess, ptables, jtables = frames
    df = tpch.q1(ptables)
    got = str(sess.physical_plan(df.plan))
    jdf = jtpch.q1(jtables)
    want = str(jdf.session.physical_plan(jdf.plan))
    names = lambda s: re.findall(r"^\s*(\w+)", s, re.M)  # noqa: E731
    assert names(got) == names(want)


def test_partial_aggregate_merges_several_batches():
    """A partition split into several batches must not merge wrongly:
    since the chunked partial aggregate (ROADMAP B.25) it is merged batch
    by batch, and Q6 over 4,096-row batches gives the one-batch answer
    (floats rel 1e-12: the running merge sums in another order)."""
    conf = {"spark.rapids.tpu.sql.reader.batchSizeRows": 4096,
            "spark.rapids.tpu.sql.batchSizeBytes": 1}
    sess = Session(conf, device="cpu")
    tables = tpch_datagen.dataframes(sess, n_rows=10_000, seed=1)
    got = tpch.q6(tables).collect()
    assert sess.last_metrics[
        "TpuHashAggregateExec[partial].numInputBatches"] > 2
    one = Session(device="cpu")
    want = tpch.q6(tpch_datagen.dataframes(one, n_rows=10_000,
                                           seed=1)).collect()
    assert one.last_metrics[
        "TpuHashAggregateExec[partial].numInputBatches"] == 2
    assert len(got) == len(want) == 1
    assert got[0][0] == pytest.approx(want[0][0], rel=1e-12)


def test_int_keys_min_max_count_star():
    """A small grouped query beyond Q1/Q6: int keys, min/max, count(*)."""
    from spark_rapids_tpu_torch import f

    sess = Session(device="cpu")
    df = sess.create_dataframe({"k": [3, 1, 3, None, 1, 3],
                                "v": [1.5, -2.0, None, 4.0, 8.0, 0.5]})
    rows = (df.group_by("k")
            .agg(f.min("v").alias("lo"), f.max("v").alias("hi"),
                 f.count().alias("n"))
            .sort("k").collect())
    assert rows == [(None, 4.0, 4.0, 1), (1, -2.0, 8.0, 2),
                    (3, 0.5, 1.5, 3)]
