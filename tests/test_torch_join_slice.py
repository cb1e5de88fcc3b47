"""TPC-H Q3 and Q4 through spark_rapids_tpu_torch (on CPU tensors, where
every kernel wrapper takes its plain PyTorch version) against the JAX
package's device session, on the same tables from the port's generator
at sf 0.002 (3,000 orders, 12,000 lines, 300 customers), one partition.

Both run with the default conf (broadcast joins at this size) and with
``broadcastSizeThreshold=0`` (shuffled joins).  Keys and counts are
equal, ``revenue`` agrees to rel 1e-9, rows come in the same order, the
explain reports carry the same marks and exec names, the converted plans
name the same execs (Q3's customer Filter -> Project fused into one
segment in both, as the reference's default conf plans it; with fusion
off in both, the unfused plan), and each join saw one batch per side.
One DataFrame-level join of each other type (left, right, full, anti) is
held against the reference as well.  Q4 at 1,024-row reader batches and
a 1-byte ``batchSizeBytes`` (every join side several batches, the grace
join) returns the reference's rows too."""
import re

import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.benchmarks import tpch, tpch_datagen
from spark_rapids_tpu_torch.interop import (from_reference_tables,
                                            to_reference_tables)

SF = 0.002
CONFS = {
    "broadcast": {},
    "shuffled": {"spark.rapids.tpu.sql.broadcastSizeThreshold": 0},
}
NO_FUSION = {"spark.rapids.tpu.sql.fusion.enabled": False}


def _frames(conf, q):
    ref_tables = to_reference_tables(tpch_datagen.tables(q, sf=SF, seed=3))
    jsess = jsrt.Session(conf)
    jt = {}
    for name, (fields, arrays) in ref_tables.items():
        schema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in fields])
        jt[name] = jsess.create_dataframe(
            {n: arrays[n] for n, _ in fields}, schema, n_partitions=1)
    sess = Session(conf, device="cpu")
    pt = {name: sess.create_dataframe(b, n_partitions=1)
          for name, b in from_reference_tables(ref_tables).items()}
    return sess, pt, jt


@pytest.fixture(scope="module", params=sorted(CONFS))
def frames(request):
    conf = CONFS[request.param]
    return request.param, {q: _frames(conf, q) for q in (3, 4)}


def _assert_rows_close(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=0)
            else:
                assert a == b


def _marks(report):
    return [tuple(re.match(r"\s*([*!@]) (\w+)", line).groups())
            for line in report.splitlines()]


def _names(plan_string):
    return re.findall(r"^\s*(\w+)", plan_string, re.M)


@pytest.mark.parametrize("q", [3, 4])
def test_query_matches_reference(frames, q):
    mode, by_q = frames
    sess, pt, jt = by_q[q]
    got = tpch.QUERIES[q](pt).collect()
    want = getattr(jtpch, f"q{q}")(jt).collect()
    _assert_rows_close(got, want)
    if q == 3:
        assert len(got) == 10
    m = sess.last_metrics
    pairs = m["TpuHashJoinExec.numJoinedPairs"]
    assert pairs == (2 if q == 3 else 1)
    assert m["TpuHashJoinExec.numLeftBatches"] == pairs
    assert m["TpuHashJoinExec.numRightBatches"] == pairs


@pytest.mark.parametrize("fusion", ["default", "off"])
@pytest.mark.parametrize("q", [3, 4])
def test_explain_and_plan_match_reference(frames, q, fusion):
    mode, by_q = frames
    sess, pt, jt = by_q[q]
    df = tpch.QUERIES[q](pt)
    jdf = getattr(jtpch, f"q{q}")(jt)
    assert _marks(df.explain()) == _marks(jdf.explain())
    if fusion == "off":  # the unfused route, planned by both
        conf = {**CONFS[mode], **NO_FUSION}
        sess, jsess = Session(conf, device="cpu"), jsrt.Session(conf)
    else:
        jsess = jdf.session
    got = str(sess.physical_plan(df.plan))
    want = str(jsess.physical_plan(jdf.plan))
    assert _names(got) == _names(want)
    join = "TpuBroadcastHashJoin" if mode == "broadcast" \
        else "TpuShuffledHashJoin"
    assert _names(got).count(join) == (2 if q == 3 else 1)
    fused = 1 if fusion == "default" and q == 3 else 0
    assert _names(got).count("TpuFusedSegment") == fused


_L = {"k": [1, 2, 2, None, 5, 7, 2], "a": [1.0, 2.0, None, 4.0, 5.0, 6.0,
                                           7.0],
      "s": ["x", "yy", None, "x", "é", "", "zz"]}
_R = {"k2": [2, 5, 5, None, 9, 2], "b": ["yy", "x", None, "é", "s", "x"]}


@pytest.mark.parametrize("keys", [("k", "k2"), ("s", "b")],
                         ids=["bigint", "string"])
@pytest.mark.parametrize("how", ["left", "right", "full", "anti", "inner",
                                 "semi"])
@pytest.mark.parametrize("mode", sorted(CONFS))
def test_dataframe_join_matches_reference(how, mode, keys):
    conf = CONFS[mode]
    lschema = [("k", "bigint"), ("a", "double"), ("s", "string")]
    rschema = [("k2", "bigint"), ("b", "string")]

    def frames(mk_schema, sess, create):
        return (create(sess, _L, mk_schema(lschema)),
                create(sess, _R, mk_schema(rschema)))

    jl, jr = frames(
        lambda fs: JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in fs]),
        jsrt.Session(conf),
        lambda s, d, sch: s.create_dataframe(
            {n: np.array(v, dtype=object) for n, v in d.items()}, sch,
            n_partitions=1))
    pl, pr = frames(
        lambda fs: PT.Schema([PT.Field(n, PT.from_name(t)) for n, t in fs]),
        Session(conf, device="cpu"),
        lambda s, d, sch: s.create_dataframe(d, sch, n_partitions=1))
    on = ([keys[0]], [keys[1]])
    want = jl.join(jr, on=on, how=how).collect()
    got = pl.join(pr, on=on, how=how).collect()
    assert got == want
    assert len(got) > 0


@pytest.mark.parametrize("q", [3, 4])
def test_size_estimate_matches_reference(frames, q):
    """The broadcast decision rests on the tables' size estimates."""
    _mode, by_q = frames
    _sess, pt, jt = by_q[q]
    for name in pt:
        got = sum(b.estimate_bytes() for b in pt[name].plan.batches)
        want = sum(b.estimate_bytes() for b in jt[name].plan.batches)
        assert got == want


def test_q4_multi_batch_sides_join_by_grace():
    """Join sides that reach the join as several batches a partition join
    bucket by bucket (the grace join) and return the reference's rows."""
    conf = {"spark.rapids.tpu.sql.reader.batchSizeRows": 1024,
            "spark.rapids.tpu.sql.batchSizeBytes": 1,
            "spark.rapids.tpu.shuffle.targetBatchRows": 0,
            "spark.rapids.tpu.sql.broadcastSizeThreshold": 0}
    ref_tables = to_reference_tables(tpch_datagen.tables(4, sf=SF, seed=3))
    jsess = jsrt.Session(conf)
    jt = {}
    for name, (fields, arrays) in ref_tables.items():
        schema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in fields])
        jt[name] = jsess.create_dataframe(
            {n: arrays[n] for n, _ in fields}, schema)
    want = jtpch.q4(jt).collect()
    sess = Session(conf, device="cpu")
    tables = {name: sess.create_dataframe(b)
              for name, b in from_reference_tables(ref_tables).items()}
    got = tpch.q4(tables).collect()
    m = sess.last_metrics
    assert m["TpuHashJoinExec.numLeftBatches"] > m[
        "TpuHashJoinExec.numJoinedPairs"]
    assert m["TpuHashJoinExec.numGracePairs"] > 0
    assert m["TpuHashJoinExec.graceMaxLevel"] >= 1
    assert got == want and len(got) == 5
