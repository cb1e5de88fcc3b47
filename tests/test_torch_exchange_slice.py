"""The multi-partition exchange of spark_rapids_tpu_torch (on CPU
tensors, where every kernel wrapper takes its plain PyTorch version)
against the JAX package's device session.

* TPC-H Q1, Q3, Q4 and Q6 at sf 0.002 with the tables over 2 or 3
  partitions and ``shuffle.partitions`` 2, 3 or 8, the reference with its
  default conf: rows equal, floats to rel 1e-9, in the same order.  The
  joins run shuffled (``broadcastSizeThreshold=0``), as at SF1, and once
  broadcast.
* The exchange exec alone over one and two input batches, for hash,
  round robin and range partitioning: every output partition holds the
  reference's rows in the reference's order (the reference with
  ``adaptive.enabled=false``, the static plan the port implements).
* ``repartition`` with and without keys, and every join type over hash
  exchanges at two partitions.
* ``create_dataframe`` with no ``n_partitions`` gives the same plan shape
  and explain marks in both packages (two partitions), and
  ``shuffle.mode=host`` raises, naming the missing spill tier."""
import re

import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.plan import functions as JF
from spark_rapids_tpu.plan import physical as JP
from spark_rapids_tpu.plan.overrides import TpuOverrides as JOverrides
from spark_rapids_tpu.plan.planner import Planner as JPlanner
from spark_rapids_tpu.plan.transitions import \
    TpuTransitionOverrides as JTransitions
from spark_rapids_tpu.shuffle import partitioning as JPart
from spark_rapids_tpu_torch import Session, f
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.benchmarks import tpch, tpch_datagen
from spark_rapids_tpu_torch.interop import (from_reference_tables,
                                            to_reference_tables)
from spark_rapids_tpu_torch.plan import functions as PF
from spark_rapids_tpu_torch.plan import physical as PP
from spark_rapids_tpu_torch.plan.overrides import TpuOverrides as POverrides
from spark_rapids_tpu_torch.plan.planner import Planner as PPlanner
from spark_rapids_tpu_torch.plan.transitions import \
    TpuTransitionOverrides as PTransitions
from spark_rapids_tpu_torch.shuffle import partitioning as PPart

SF = 0.002
SHUFFLED = {"spark.rapids.tpu.sql.broadcastSizeThreshold": 0}
STATIC = {"spark.rapids.tpu.sql.adaptive.enabled": False}


def _assert_rows_close(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=0)
            else:
                assert a == b


def _tpch_frames(q, conf, n_partitions):
    ref_tables = to_reference_tables(tpch_datagen.tables(q, sf=SF, seed=3))
    jsess = jsrt.Session(conf)
    jt = {}
    for name, (fields, arrays) in ref_tables.items():
        schema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in fields])
        jt[name] = jsess.create_dataframe(
            {n: arrays[n] for n, _ in fields}, schema,
            n_partitions=n_partitions)
    sess = Session(conf, device="cpu")
    pt = {name: sess.create_dataframe(b, n_partitions=n_partitions)
          for name, b in from_reference_tables(ref_tables).items()}
    return sess, pt, jt


@pytest.mark.parametrize("shuffle_partitions", [2, 3, 8])
@pytest.mark.parametrize("n_partitions", [2, 3])
@pytest.mark.parametrize("q", [1, 3, 4, 6])
def test_query_matches_reference(q, n_partitions, shuffle_partitions):
    conf = {"spark.rapids.tpu.sql.shuffle.partitions": shuffle_partitions}
    if q in (3, 4):
        conf.update(SHUFFLED)
    sess, pt, jt = _tpch_frames(q, conf, n_partitions)
    got = tpch.QUERIES[q](pt).collect()
    want = getattr(jtpch, f"q{q}")(jt).collect()
    _assert_rows_close(got, want)
    # every multi-partition exchange yielded each row it was given once
    for pl in sess.last_placements:
        assert sum(pl["partition_rows"]) == pl["rows_written"], pl
    kinds = " ".join(pl["exchange"] for pl in sess.last_placements)
    if q != 6:
        assert "RangePartitioning" in kinds and "HashPartitioning" in kinds


@pytest.mark.parametrize("q", [3, 4])
def test_broadcast_joins_match_reference(q):
    sess, pt, jt = _tpch_frames(q, {}, 2)
    _assert_rows_close(tpch.QUERIES[q](pt).collect(),
                       getattr(jtpch, f"q{q}")(jt).collect())


def test_final_aggregate_merges_exchange_slices():
    """A final aggregate whose partition arrives as several slices (here
    ``batchSizeBytes=1`` keeps every slice its own batch, as SF1's Q1
    slices of ~465 MB each do under the 512 MB default) merges them as
    the reference's chunked path does: same rows, same order, same float
    sums."""
    conf = {**STATIC, "spark.rapids.tpu.sql.batchSizeBytes": 1}
    sess, pt, jt = _tpch_frames(1, conf, 2)

    def query(t, F):
        li = t["lineitem"]
        price = F.col("l_extendedprice") * (F.lit(1.0) - F.col("l_discount"))
        return (li.group_by("l_returnflag", "l_linestatus")
                .agg(F.sum(price).alias("s"), F.avg("l_quantity").alias("a"),
                     F.count("l_tax").alias("n")))

    got = query(pt, PF).collect()
    want = query(jt, JF).collect()
    assert [tuple(map(repr, r)) for r in got] == \
        [tuple(map(repr, r)) for r in want]
    m = sess.last_metrics
    assert m["TpuHashAggregateExec[partial].numInputBatches"] == 2
    assert m["TpuHashAggregateExec[final].numInputBatches"] == 4


# --------------------------------------------------------------------------
# the exchange exec alone
# --------------------------------------------------------------------------
_DATA = {
    "k": [3, None, 7, 7, -2, 11, 0, None, 5, 3, 8, -9, 4, 4, 12, 1, 6, 2,
          9, 10, -1, 13, 3, 0],
    "s": ["b", "a", None, "é", "", "abcd", "zz", "b", "ab", "abcdefg",
          None, "x" * 40, "x" * 40 + "y", "m", "q", "a", "c", "éé", "b",
          "n", "o", "p", "", "k"],
    "v": [1.5, -0.0, 0.0, None, 2.5, -1.0, 3.25, 7.0, float("nan"), 4.0,
          -2.0, 0.5, 0.25, 9.0, -3.5, 6.0, 1.0, 2.0, 8.5, -7.0, 5.5, 0.75,
          1.25, 3.0],
}
_SCHEMA = [("k", "bigint"), ("s", "string"), ("v", "double")]


def _run_exchange(pkg, n_in, kind, n_out):
    """Per-partition rows of one exchange over ``_DATA`` split into
    ``n_in`` input batches."""
    if pkg == "ref":
        sess = jsrt.Session(STATIC)
        schema = JT.Schema([JT.Field(n, JT.from_name(t))
                            for n, t in _SCHEMA])
        df = sess.create_dataframe(
            {n: np.array(v, dtype=object) for n, v in _DATA.items()},
            schema, n_partitions=n_in)
        Pl, P, Part, F, Ov, Tr = (JPlanner, JP, JPart, JF, JOverrides,
                                  JTransitions)
        ctx = JP.ExecContext(sess.conf, sess)
    else:
        sess = Session(STATIC, device="cpu")
        schema = PT.Schema([PT.Field(n, PT.from_name(t))
                            for n, t in _SCHEMA])
        df = sess.create_dataframe(_DATA, schema, n_partitions=n_in)
        Pl, P, Part, F, Ov, Tr = (PPlanner, PP, PPart, PF, POverrides,
                                  PTransitions)
        ctx = PP.ExecContext(sess.conf, sess.device)
    scan = Pl(sess.conf).plan(df.plan)
    col = lambda n: F.col(n).expr  # noqa: E731
    if kind == "hash":
        part = Part.HashPartitioning([col("s"), col("k")], n_out)
    elif kind == "round_robin":
        part = Part.RoundRobinPartitioning(n_out)
    else:
        part = Part.RangePartitioning(
            [F.SortKey(col("v"), False), F.SortKey(col("s"), True)], n_out)
    phys = P.ShuffleExchangeExec(scan, part.bind(scan.schema))
    phys = Tr(sess.conf).apply(Ov(sess.conf).apply(phys))
    data = phys.execute(ctx)
    return [[r for b in data.iterator(p) for r in b.to_rows()]
            for p in range(data.n_partitions)]


def _same_partition_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # NaN != NaN: compare by repr
        assert [tuple(map(repr, r)) for r in g] == \
            [tuple(map(repr, r)) for r in w]


@pytest.mark.parametrize("n_out", [2, 3])
@pytest.mark.parametrize("n_in", [1, 2])
@pytest.mark.parametrize("kind", ["hash", "round_robin", "range"])
def test_exchange_partitions_match_reference(kind, n_in, n_out):
    got = _run_exchange("port", n_in, kind, n_out)
    want = _run_exchange("ref", n_in, kind, n_out)
    _same_partition_rows(got, want)
    assert sum(len(p) for p in got) == len(_DATA["k"])
    assert sum(1 for p in got if p) > 1


# --------------------------------------------------------------------------
# repartition, the default partition count, shuffle.mode
# --------------------------------------------------------------------------
def _frames(conf, n_partitions=None):
    jschema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in _SCHEMA])
    pschema = PT.Schema([PT.Field(n, PT.from_name(t)) for n, t in _SCHEMA])
    jdata = {n: np.array(v, dtype=object) for n, v in _DATA.items()}
    kw = {} if n_partitions is None else {"n_partitions": n_partitions}
    jdf = jsrt.Session(conf).create_dataframe(jdata, jschema, **kw)
    psess = Session(conf, device="cpu")
    return psess, psess.create_dataframe(_DATA, pschema, **kw), jdf


@pytest.mark.parametrize("keys", [["k"], ["s", "k"], []],
                         ids=["bigint", "string-bigint", "round-robin"])
def test_repartition_matches_reference(keys):
    _sess, pdf, jdf = _frames({})
    for n in (3, 5):
        got = pdf.repartition(n, *keys).collect()
        want = jdf.repartition(n, *keys).collect()
        assert [tuple(map(repr, r)) for r in got] == \
            [tuple(map(repr, r)) for r in want]
    # a keyed aggregate and a sort after the repartition
    got = (pdf.repartition(4, *keys).group_by("s")
           .agg(f.sum("k").alias("sk"), f.count().alias("n"))
           .sort("s").collect())
    want = (jdf.repartition(4, *keys).group_by("s")
            .agg(JF.sum("k").alias("sk"), JF.count().alias("n"))
            .sort("s").collect())
    assert got == want


def _marks(report):
    return [tuple(re.match(r"\s*([*!@]) (\w+)", line).groups())
            for line in report.splitlines()]


def _names(plan_string):
    return re.findall(r"^\s*(\w+)", plan_string, re.M)


def test_default_partitioning_plans_like_reference():
    """``create_dataframe`` with no ``n_partitions`` splits over two
    partitions in both packages, so the same DataFrame code plans the
    same exchanges: hash exchanges under the joins and the aggregate, a
    range exchange under the global sort."""
    psess, pdf, jdf = _frames({**STATIC, **SHUFFLED})
    assert pdf.plan.n_partitions == jdf.plan.n_partitions == 2

    def query(df, F):
        other = df.select(F.col("k").alias("k2"), F.col("s").alias("s2"))
        return (df.join(other, on=(["k"], ["k2"]), how="inner")
                .group_by("s").agg(F.sum("v").alias("sv"))
                .sort(F.col("sv").desc()))

    p, j = query(pdf, PF), query(jdf, JF)
    assert _marks(p.explain()) == _marks(j.explain())
    got = str(psess.physical_plan(p.plan))
    want = str(j.session.physical_plan(j.plan))
    assert _names(got) == _names(want)
    assert "RangePartitioning(2)" in got and "RangePartitioning(2)" in want
    assert got.count("HashPartitioning") == want.count("HashPartitioning") \
        == 3
    assert [tuple(map(repr, r)) for r in p.collect()] == \
        [tuple(map(repr, r)) for r in j.collect()]


_L = {"k": [1, 2, 2, None, 5, 7, 2], "a": [1.0, 2.0, None, 4.0, 5.0, 6.0,
                                           7.0],
      "s": ["x", "yy", None, "x", "é", "", "zz"]}
_R = {"k2": [2, 5, 5, None, 9, 2], "b": ["yy", "x", None, "é", "s", "x"]}


@pytest.mark.parametrize("keys", [("k", "k2"), ("s", "b")],
                         ids=["bigint", "string"])
@pytest.mark.parametrize("how", ["left", "right", "full", "anti", "inner",
                                 "semi"])
def test_dataframe_joins_at_two_partitions_match_reference(how, keys):
    """Every join type over hash exchanges at the default two partitions;
    the output order is the partitions' order, so the reference runs its
    static plan."""
    conf = {**STATIC, **SHUFFLED}
    lschema = [("k", "bigint"), ("a", "double"), ("s", "string")]
    rschema = [("k2", "bigint"), ("b", "string")]
    jsess, psess = jsrt.Session(conf), Session(conf, device="cpu")

    def jframe(d, fs):
        return jsess.create_dataframe(
            {n: np.array(v, dtype=object) for n, v in d.items()},
            JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in fs]))

    def pframe(d, fs):
        return psess.create_dataframe(
            d, PT.Schema([PT.Field(n, PT.from_name(t)) for n, t in fs]))

    on = ([keys[0]], [keys[1]])
    want = jframe(_L, lschema).join(jframe(_R, rschema), on=on,
                                    how=how).collect()
    got = pframe(_L, lschema).join(pframe(_R, rschema), on=on,
                                   how=how).collect()
    assert got == want and len(got) > 0


def test_host_shuffle_mode_raises():
    _sess, pdf, _jdf = _frames({"spark.rapids.tpu.shuffle.mode": "host"})
    with pytest.raises(NotImplementedError, match="spill tier.*A6"):
        pdf.repartition(3, "k").collect()
