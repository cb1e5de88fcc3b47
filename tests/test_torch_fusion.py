"""Whole-stage fusion in spark_rapids_tpu_torch (on CPU tensors, where
the fused segment runs its plain composition) against the JAX package.

* The device plans of TPC-H Q1, Q3, Q4, Q6, Q12, Q13 and Q14 (sf 0.001,
  one and two partitions) equal the reference's with its default conf
  (fusion on) and with fusion off in both: the same exec names, the same
  ``TpuFusedSegment[...]`` lines, the same explain marks.  Fusion on
  gives one segment each in Q3, Q12, Q13 and Q14 and none in Q1, Q4 and
  Q6: four distinct generated sources, the same at both partition
  counts.
* One fused Filter -> Project segment over every expression K12's code
  generator covers (300 rows in a 512-row bucket, with nulls, NaN, -0.0,
  integer overflow and zero divisors): each output column equals the
  unfused port plan's and the reference's (fusion on), by ``repr`` —
  bit for bit, floats included.
* ``fusion.maxSegmentExecs`` splits a five-exec chain as the reference
  does, with the same rows.
* A LIKE pattern with ``_`` is tagged off the device as in the
  reference, and the port raises naming the reason."""
import datetime as dt
import re

import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import f as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import f as PF
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.benchmarks import tpch, tpch_datagen
from spark_rapids_tpu_torch.data.column import host_to_device
from spark_rapids_tpu_torch.interop import (from_reference_tables,
                                            to_reference_tables)

SF = 0.001
NO_FUSION = {"spark.rapids.tpu.sql.fusion.enabled": False}
QUERIES = (1, 3, 4, 6, 12, 13, 14)
FUSED = {3, 12, 13, 14}


def _marks(report):
    return [tuple(re.match(r"\s*([*!@]) (\w+)", line).groups())
            for line in report.splitlines()]


def _names(plan_string):
    return re.findall(r"^\s*(\w+)", plan_string, re.M)


def _segments(plan_string):
    return re.findall(r"TpuFusedSegment\[.*", plan_string)


@pytest.fixture(scope="module")
def ref_tables():
    return {q: to_reference_tables(tpch_datagen.tables(q, sf=SF, seed=3))
            for q in QUERIES}


def _plans(tables, conf, n_partitions):
    jsess = jsrt.Session(conf)
    jt = {}
    for name, (fields, arrays) in tables.items():
        schema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in fields])
        jt[name] = jsess.create_dataframe(
            {n: arrays[n] for n, _ in fields}, schema,
            n_partitions=n_partitions)
    psess = Session(conf, device="cpu")
    pt = {name: psess.create_dataframe(b, n_partitions=n_partitions)
          for name, b in from_reference_tables(tables).items()}
    return psess, pt, jt


@pytest.mark.parametrize("fusion", ["default", "off"])
@pytest.mark.parametrize("q", QUERIES)
def test_plans_match_reference(ref_tables, q, fusion):
    conf = {"spark.rapids.tpu.sql.broadcastSizeThreshold": 0}
    if fusion == "off":
        conf.update(NO_FUSION)
    keys = set()
    for n_partitions in (1, 2):
        psess, pt, jt = _plans(ref_tables[q], conf, n_partitions)
        df, jdf = tpch.QUERIES[q](pt), getattr(jtpch, f"q{q}")(jt)
        assert _marks(df.explain()) == _marks(jdf.explain())
        plan = psess.physical_plan(df.plan)
        got, want = str(plan), str(jdf.session.physical_plan(jdf.plan))
        assert _names(got) == _names(want)
        assert _segments(got) == _segments(want)
        n_seg = 1 if fusion == "default" and q in FUSED else 0
        assert len(_segments(got)) == n_seg
        keys |= {p.program.key for p in _walk(plan)
                 if type(p).__name__ == "TpuFusedSegmentExec"}
    assert len(keys) == n_seg  # one source serves both partition counts


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)


def test_four_distinct_segment_sources(ref_tables):
    keys = set()
    for q in FUSED:
        psess, pt, _jt = _plans(ref_tables[q], {}, 2)
        keys |= {p.program.key for p in _walk(
            psess.physical_plan(tpch.QUERIES[q](pt).plan))
            if type(p).__name__ == "TpuFusedSegmentExec"}
    assert len(keys) == 4


# --------------------------------------------------------------------------
# every expression of the code generator, fused and unfused
# --------------------------------------------------------------------------
N_ROWS = 300
_FIELDS = [("i", "int"), ("l", "bigint"), ("d", "double"), ("f", "float"),
           ("dt", "date"), ("s", "string"), ("s2", "string")]
_WORDS = ["", "a", "ab", "abc", "cab", "xaby", "é", "éab", "special",
          "abcdefghij", "al"]


def _expression_data():
    rng = np.random.default_rng(17)

    def nulls(values, p=0.15):
        return [None if rng.random() < p else v for v in values]

    i32 = rng.integers(-5, 6, N_ROWS).astype(np.int64)
    i32[:4] = [2 ** 31 - 1, -2 ** 31, 0, 2 ** 30 + 7]
    i64 = rng.integers(-9, 10, N_ROWS)
    i64[:3] = [2 ** 63 - 1, -2 ** 63, 2 ** 62]
    d = rng.choice([0.0, -0.0, np.nan, 1.5, -2.25, 3.0, np.inf, 0.1],
                   N_ROWS)
    f = rng.choice([0.5, -0.0, np.nan, 2.75, -1.0], N_ROWS)
    return {
        "i": nulls(i32.tolist()),
        "l": nulls(i64.tolist()),
        "d": nulls(d.tolist()),
        "f": nulls(f.tolist()),
        "dt": nulls(rng.integers(8700, 9200, N_ROWS).tolist()),
        "s": nulls(rng.choice(_WORDS, N_ROWS).tolist()),
        "s2": nulls(rng.choice(_WORDS, N_ROWS).tolist()),
    }


#: name -> expression over the columns, for either package's functions
EXPRESSIONS = {
    "add_int32_wraps": lambda F: F.col("i") + F.col("i"),
    "sub_promotes": lambda F: F.col("l") - F.col("i"),
    "mul_int64_wraps": lambda F: F.col("l") * F.lit(3),
    "mul_float_double": lambda F: F.col("d") * F.col("f"),
    "div_zero_is_null": lambda F: F.col("d") / F.col("i"),
    "literal_arith": lambda F: (F.lit(1.0) - F.col("d")) * F.lit(0.1),
    "lt_nan": lambda F: F.col("d") < F.lit(0.5),
    "eq_neg_zero": lambda F: F.col("d") == F.lit(-0.0),
    "ge_date": lambda F: F.col("dt") >= F.lit(dt.date(1994, 1, 1)),
    "le_mixed_ints": lambda F: F.col("l") <= F.col("i"),
    "ne_float": lambda F: F.col("f") != F.col("d"),
    "str_eq": lambda F: F.col("s") == F.lit("ab"),
    "str_lt_column": lambda F: F.col("s") < F.col("s2"),
    "str_gt": lambda F: F.col("s") > F.lit("abc"),
    "str_ge_le": lambda F: (F.col("s") >= F.lit("a"))
    & (F.col("s2") <= F.lit("é")),
    "not": lambda F: ~(F.col("i") > F.lit(0)),
    "and_or_kleene": lambda F: ((F.col("i") > F.lit(0))
                                & (F.col("d") < F.lit(1.0)))
    | (F.col("s") == F.lit("ab")),
    "is_null": lambda F: F.col("d").is_null(),
    "is_not_null": lambda F: F.col("s").is_not_null(),
    "if_promotes": lambda F: F.if_(F.col("d") > F.lit(0.0), F.col("i"),
                                   F.col("l")),
    "if_string": lambda F: F.if_(F.col("i") > F.lit(0), F.col("s"),
                                 F.lit("zzzzzzzzzzzzzz")),
    "if_null_branch": lambda F: F.if_(F.col("s").is_null(), F.lit(None),
                                      F.col("d")),
    "inset_null_member": lambda F: F.col("i").isin(1, 2, None),
    "inset_double": lambda F: F.col("d").isin(0.0, 1.5, float("nan")),
    "inset_date": lambda F: F.col("dt").isin(8800, 8801, 8802),
    "inset_string": lambda F: F.col("s").isin("ab", "é", ""),
    "contains": lambda F: F.col("s").contains("ab"),
    "startswith": lambda F: F.col("s").startswith("a"),
    "endswith": lambda F: F.col("s").endswith("ab"),
    "like_prefix": lambda F: F.col("s").like("ab%"),
    "like_middle": lambda F: F.col("s").like("%a%b%"),
    "like_suffix": lambda F: F.col("s2").like("%al"),
    "like_exact": lambda F: F.col("s").like("abc"),
    "like_empty": lambda F: F.col("s").like(""),
    "like_any": lambda F: F.col("s2").like("%"),
    "literal_string": lambda F: F.lit("lit"),
    "literal_int": lambda F: F.lit(7),
    "column": lambda F: F.col("s2"),
}


def _filter(F):
    return F.col("l").is_not_null() | (F.col("f") > F.lit(0.0))


def _expression_query(df, F):
    return df.filter(_filter(F)).select(
        *[e(F).alias(name) for name, e in EXPRESSIONS.items()])


def every_expression_frame():
    """(session, DataFrame, device batch of its table) of the port: a
    Filter -> Project over every expression of ``EXPRESSIONS``, on CPU
    tensors."""
    sess = Session(device="cpu")
    schema = PT.Schema([PT.Field(n, PT.from_name(t)) for n, t in _FIELDS])
    df = sess.create_dataframe(_expression_data(), schema, n_partitions=1)
    batch = host_to_device(df.plan.batches[0], 128, "cpu")
    return sess, _expression_query(df, PF), batch


@pytest.fixture(scope="module")
def expression_rows():
    data = _expression_data()
    jschema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in _FIELDS])
    jdf = jsrt.Session().create_dataframe(
        {n: np.array(v, dtype=object) for n, v in data.items()}, jschema,
        n_partitions=1)
    want = _expression_query(jdf, JF).collect()
    psess, pdf, _batch = every_expression_frame()
    plan = str(psess.physical_plan(pdf.plan))
    assert plan.count("TpuFusedSegment[2:") == 1
    fused = pdf.collect()
    unfused = Session(NO_FUSION, device="cpu").create_dataframe(
        data, PT.Schema([PT.Field(n, PT.from_name(t)) for n, t in _FIELDS]),
        n_partitions=1)
    unfused = _expression_query(unfused, PF).collect()
    assert psess.last_metrics["TpuFusedSegmentExec.numInputBatches"] == 1
    assert 0 < len(want) < N_ROWS
    return fused, unfused, want


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_fused_expression_matches_unfused_and_reference(expression_rows,
                                                        name):
    fused, unfused, want = expression_rows
    j = list(EXPRESSIONS).index(name)
    got = [repr(r[j]) for r in fused]
    assert got == [repr(r[j]) for r in unfused]
    assert got == [repr(r[j]) for r in want]
    assert len(set(got)) > 1 or name.startswith("literal")


# --------------------------------------------------------------------------
# maxSegmentExecs, and a pattern the device does not take
# --------------------------------------------------------------------------
def _chain(df, F):
    return (df.filter(F.col("l").is_not_null())
            .select("i", "l", "d", "s")
            .filter(F.col("d") > F.lit(-1.0))
            .select("i", "d", "s")
            .filter(F.col("s").is_not_null()))


def _frames(conf):
    data = _expression_data()
    jdf = jsrt.Session(conf).create_dataframe(
        {n: np.array(v, dtype=object) for n, v in data.items()},
        JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in _FIELDS]),
        n_partitions=1)
    psess = Session(conf, device="cpu")
    pdf = psess.create_dataframe(
        data, PT.Schema([PT.Field(n, PT.from_name(t)) for n, t in _FIELDS]),
        n_partitions=1)
    return psess, pdf, jdf


@pytest.mark.parametrize("max_execs", [2, 3, 16])
def test_max_segment_execs_splits_a_chain(max_execs):
    conf = {"spark.rapids.tpu.sql.fusion.maxSegmentExecs": max_execs}
    psess, pdf, jdf = _frames(conf)
    p, j = _chain(pdf, PF), _chain(jdf, JF)
    got = str(psess.physical_plan(p.plan))
    want = str(j.session.physical_plan(j.plan))
    assert _names(got) == _names(want)
    assert _segments(got) == _segments(want)
    sizes = [int(n) for n in re.findall(r"TpuFusedSegment\[(\d+):", got)]
    assert sizes == {2: [2, 2], 3: [3, 2], 16: [5]}[max_execs]
    assert [tuple(map(repr, r)) for r in p.collect()] == \
        [tuple(map(repr, r)) for r in j.collect()]


def test_like_with_underscore_stays_off_the_device():
    psess, pdf, jdf = _frames({})
    p = pdf.filter(PF.col("s").like("a_"))
    j = jdf.filter(JF.col("s").like("a_"))
    assert _marks(p.explain()) == _marks(j.explain())
    assert ("!", "FilterExec") in _marks(p.explain())
    with pytest.raises(NotImplementedError, match="'_'.*host regex"):
        p.collect()
