"""The expressions of the ML-prep slice against the reference: Remainder
(``%``), Pmod, UnaryMinus, Abs, Greatest, Least and CaseWhen (strings,
numbers, mixed types, with and without ELSE), IntegralDivide and
UnaryPositive, over nulls in every column, NaN, +-0.0, +-inf, zero and
-1 divisors and the integer types' extremes
(``test_torch_kernels_emulated_export.arith_data``).  The port runs each
query fused (a Filter -> Project segment: K12's rules, on their plain
composition on CPU tensors) and with fusion off (the torch bodies); the
reference's device session runs the same query on the same data.  Rows
must be equal, in order: floats by ``repr`` (NaN and the sign of zero
included), the rest exactly."""
import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import f as JF
from spark_rapids_tpu import types as JT
from test_torch_kernels_emulated_export import (ARITH_FIELDS, arith_data,
                                                arith_frame, arith_query,
                                                unnamed_query)

NO_FUSION = {"spark.rapids.tpu.sql.fusion.enabled": False}
QUERIES = {"named": arith_query, "unnamed": unnamed_query}


def _reference(query):
    jschema = JT.Schema([JT.Field(n, JT.from_name(t))
                         for n, t in ARITH_FIELDS])
    jdf = jsrt.Session().create_dataframe(
        {n: np.array(v, dtype=object) for n, v in arith_data().items()},
        jschema, n_partitions=1)
    q = query(jdf, JF)
    return q.columns, q.collect()


@pytest.fixture(scope="module")
def rows():
    out = {}
    for name, query in QUERIES.items():
        names, want = _reference(query)
        sess, df, _b = arith_frame(query)
        plan = str(sess.physical_plan(df.plan))
        assert plan.count("TpuFusedSegment[2:") == 1, plan
        fused = df.collect()
        _s, unfused_df, _b = arith_frame(query, NO_FUSION)
        unfused = unfused_df.collect()
        assert "TpuFusedSegment" not in str(
            _s.physical_plan(unfused_df.plan))
        out[name] = (names, want, fused, unfused)
    return out


def _columns():
    out = []
    for name, query in QUERIES.items():
        sess, df, _b = arith_frame(query)
        out += [(name, c) for c in df.columns]
    return out


@pytest.mark.parametrize("query,column", _columns())
def test_expression_matches_reference(rows, query, column):
    names, want, fused, unfused = rows[query]
    j = names.index(column)
    expect = [repr(r[j]) for r in want]
    assert len(expect) > 100
    assert [repr(r[j]) for r in fused] == expect
    assert [repr(r[j]) for r in unfused] == expect
    assert len(set(expect)) > 1
