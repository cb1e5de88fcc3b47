"""TPC-H Q12, Q13 and Q14 through spark_rapids_tpu_torch (on CPU tensors,
where every kernel wrapper and the fused segments take their plain
versions) against the JAX package's device session with its default
conf (fusion on), on the same tables from the port's generator, joins
shuffled as at SF1: at one partition at sf 0.001 (1,500 orders, 6,000
lines, 150 customers, 200 parts) and at two at sf 0.002, so that a
partition holds as many rows in both.  Keys and counts are equal, floats
agree to rel 1e-9, rows come in the same order (Q13's sort by count,
then key, descending), and each query ran its one fused segment over
every input batch."""
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch.benchmarks import tpch, tpch_datagen
from spark_rapids_tpu_torch.interop import (from_reference_tables,
                                            to_reference_tables)

#: partitions -> scale factor: the same rows a partition at both
SF = {1: 0.001, 2: 0.002}
SHUFFLED = {"spark.rapids.tpu.sql.broadcastSizeThreshold": 0}


def _assert_rows_close(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=0)
            else:
                assert a == b


@pytest.mark.parametrize("n_partitions", [1, 2])
@pytest.mark.parametrize("q", [12, 13, 14])
def test_query_matches_reference(q, n_partitions):
    ref_tables = to_reference_tables(
        tpch_datagen.tables(q, sf=SF[n_partitions], seed=3))
    jsess = jsrt.Session(SHUFFLED)
    jt = {}
    for name, (fields, arrays) in ref_tables.items():
        schema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in fields])
        jt[name] = jsess.create_dataframe(
            {n: arrays[n] for n, _ in fields}, schema,
            n_partitions=n_partitions)
    sess = Session(SHUFFLED, device="cpu")
    pt = {name: sess.create_dataframe(b, n_partitions=n_partitions)
          for name, b in from_reference_tables(ref_tables).items()}
    got = tpch.QUERIES[q](pt).collect()
    want = getattr(jtpch, f"q{q}")(jt).collect()
    _assert_rows_close(got, want)
    m = sess.last_metrics
    # the segment's table arrives as one reader batch a partition
    assert m["TpuFusedSegmentExec.numInputBatches"] == n_partitions
    assert m["TpuHashJoinExec.numJoinedPairs"] == n_partitions
    if q == 12:
        assert [r[0] for r in got] == ["MAIL", "SHIP"]
    if q == 13:
        # every customer counted once
        assert sum(r[1] for r in got) == 150 * n_partitions
