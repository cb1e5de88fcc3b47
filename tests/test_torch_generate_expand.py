"""Generate (explode), Expand, Union, Coalesce and NaNvl in
spark_rapids_tpu_torch (on CPU tensors, where K22, K23 and K12 take their
plain versions) against the JAX package's device session on the same
numpy data.

* Every case of the reference's ``tests/test_generate.py`` (numeric
  elements, row-major order, strings, nulls, explode then aggregate),
  explode with ``pos``, and k = 3 and k = 5 over a batch of 37 rows
  padded to 128 (the exploded batch keeps ``padded * k`` rows, as the
  reference's does).
* Expand: a column widened to its field's type, typed nulls of numbers
  and strings, literals converted to the field's type, a computed entry,
  and string widths that differ across the projections (a null literal
  one byte wide against a column), collected and then aggregated (the
  coalesce pads the widths).
* An untyped null in an Expand's string field (ROADMAP C.12): the rows
  collected equal the reference's; a group-by over it raises in both.
* ``union`` of two and of three frames; ``coalesce`` and ``nanvl`` over
  nulls, NaNs, mixed types and strings.
* Plans and fused segments equal the reference's (a Project -> Generate
  and a Project -> Expand segment with fusion on, none with it off).

Rows compare exactly, floats included: both packages compute the same
IEEE operations row by row, and the one float sum (explode then
aggregate) adds integers."""
import re

import jax
import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import f as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import f as PF
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.plan import logical as PL

NO_FUSION = {"spark.rapids.tpu.sql.fusion.enabled": False}


@pytest.fixture(scope="module", autouse=True)
def quick_reference_compiles():
    """The reference's kernels compiled without most XLA optimizations,
    for this module only."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _data(n=50):
    rng = np.random.default_rng(4)
    return {"a": np.arange(n, dtype=np.int64), "b": rng.random(n),
            "s": np.array([f"x{i % 7}" for i in range(n)], dtype=object)}


class _Pkg:
    def __init__(self, sess, F, L, T):
        self.sess, self.F, self.L, self.T = sess, F, L, T

    def frame(self, data, n_partitions=2):
        return self.sess.create_dataframe(dict(data),
                                          n_partitions=n_partitions)


def _pkgs(conf=None):
    conf = dict(conf or {})
    return (_Pkg(Session(conf, device="cpu"), PF, PL, PT),
            _Pkg(jsrt.Session(conf), JF, JL, JT))


def _rows(build, data=None, conf=None, n_partitions=2):
    """``build(frame, package)`` in both packages: (port rows, reference
    rows, port frame, reference frame)."""
    port, ref = _pkgs(conf)
    data = _data() if data is None else data
    pq = build(port.frame(data, n_partitions), port)
    jq = build(ref.frame(data, n_partitions), ref)
    return pq.collect(), jq.collect(), pq, jq


def _names(plan_string):
    return re.findall(r"^\s*(\w+)", plan_string, re.M)


def _segments(plan_string):
    return re.findall(r"TpuFusedSegment\[.*", plan_string)


def _explode(elements):
    return lambda df, p: df.explode(elements(p.F), name="e")


REFERENCE_CASES = {
    "numeric": lambda F: [F.col("a"), F.col("a") * F.lit(10), F.lit(-1)],
    "strings": lambda F: [F.col("s"), F.lit("fixed"),
                          F.concat(F.col("s"), F.lit("!"))],
    "nulls": lambda F: [F.col("a"), F.lit(None, None),
                        F.col("a") + F.lit(1)],
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_explode_matches_reference(case):
    got, want, pq, _jq = _rows(_explode(REFERENCE_CASES[case]))
    assert "* GenerateExec -> will run on the device" in pq.explain()
    assert got == want and len(got) == 150


def test_explode_preserves_row_major_order():
    port, _ref = _pkgs()
    rows = port.sess.create_dataframe({"a": np.array([7, 8])}) \
        .explode([PF.lit(1), PF.lit(2), PF.lit(3)], name="e").collect()
    assert rows == [(7, 1), (7, 2), (7, 3), (8, 1), (8, 2), (8, 3)]


@pytest.mark.parametrize("fusion", ["on", "off"])
def test_explode_then_aggregate_matches_reference(fusion):
    got, want, _pq, _jq = _rows(
        lambda df, p: df.explode([p.F.col("a"), p.F.col("a") * p.F.lit(2)],
                                 name="e")
        .group_by("s").agg(p.F.sum("e").alias("t")).sort("s"),
        conf=NO_FUSION if fusion == "off" else None)
    assert got == want and len(got) == 7


def _generate(df, p, elements, position=True, name="amount"):
    return type(df)(df.session, p.L.Generate(
        df.plan, [e.expr for e in elements], name, position=position))


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("fusion", ["on", "off"])
def test_generate_with_position_over_a_padded_batch(k, fusion):
    """37 rows (padded to 128) at one partition, after a Project (one
    segment with fusion on): 37 * k rows, pos 0..k-1 row-major."""
    data = _data(37)

    def build(df, p):
        F = p.F
        elems = [F.col("b"), F.col("b") * F.lit(2.0), F.col("a"),
                 F.lit(None), F.lit(0.25)][:k]
        return _generate(df.select("a", "b", "s"), p, elems)

    got, want, pq, jq = _rows(build, data, n_partitions=1,
                              conf=NO_FUSION if fusion == "off" else None)
    assert got == want and len(got) == 37 * k
    assert [r[3] for r in got[:k]] == list(range(k))
    got_plan = str(pq.session.physical_plan(pq.plan))
    want_plan = str(jq.session.physical_plan(jq.plan))
    assert _names(got_plan) == _names(want_plan)
    assert _segments(got_plan) == _segments(want_plan)
    assert bool(_segments(got_plan)) == (fusion == "on")
    assert "TpuGenerate[" in got_plan


def _expand(df, p, projections, names):
    return type(df)(df.session, p.L.Expand(df.plan, projections, names))


def _expand_case(df, p):
    F, T = p.F, p.T
    base = df.select("a", "s", F.col("b").alias("b"),
                     F.col("a").cast(T.INT32).alias("a32"))
    projections = [
        [F.col("s").expr, F.col("a").expr, F.col("b").expr,
         F.lit(0).expr],
        [F.lit(None, T.STRING).expr, F.col("a32").expr,
         (F.col("b") * F.lit(-1.0)).expr, F.lit(1).expr],
        [F.lit("a much longer literal").expr, F.lit(None, T.INT64).expr,
         F.lit(7).expr, F.lit(2, T.INT64).expr],
    ]
    return _expand(base, p, projections, ["s", "a", "b", "gid"])


@pytest.mark.parametrize("fusion", ["on", "off"])
def test_expand_matches_reference(fusion):
    conf = NO_FUSION if fusion == "off" else None
    got, want, pq, jq = _rows(_expand_case, conf=conf)
    assert got == want and len(got) == 150
    got_plan = str(pq.session.physical_plan(pq.plan))
    want_plan = str(jq.session.physical_plan(jq.plan))
    assert _names(got_plan) == _names(want_plan)
    assert _segments(got_plan) == _segments(want_plan)
    assert ("TpuExpand[3 projections]]" in got_plan) == (fusion == "on")
    got, want, _pq, _jq = _rows(
        lambda df, p: _expand_case(df, p).group_by("s", "gid").agg(
            p.F.count("*").alias("n"), p.F.sum("a").alias("sa"),
            p.F.max("b").alias("mb")).sort("gid", "s"), conf=conf)
    assert got == want and len(got) == 7 + 1 + 1


def test_untyped_null_in_a_string_field():
    """ROADMAP C.12: the field keeps type NULL in both packages; the rows
    collected agree, and a group-by over it raises in both (its device
    coalesce meets a one-dimensional column among string matrices)."""
    def expanded(df, p):
        return _expand(df.select("s", "a"), p,
                       [[p.F.col("s").expr, p.F.col("a").expr],
                        [p.F.lit(None).expr, p.F.col("a").expr]],
                       ["s", "a"])

    got, want, _pq, _jq = _rows(expanded, n_partitions=1)
    assert got == want and got[-1] == (None, 49)
    port, ref = _pkgs()
    for pkg in (port, ref):
        q = expanded(pkg.frame(_data(), 1), pkg).group_by("s").agg(
            pkg.F.count("*").alias("n"))
        with pytest.raises(IndexError):
            q.collect()


@pytest.mark.parametrize("n_frames", [2, 3])
def test_union_matches_reference(n_frames):
    def build(df, p):
        F = p.F
        parts = [df.select("a", "s"),
                 df.filter(F.col("a") < F.lit(10)).select(
                     (F.col("a") * F.lit(100)).alias("a"), "s"),
                 df.select(F.col("a").alias("a"), F.lit("u").alias("s"))]
        out = parts[0]
        for part in parts[1:n_frames]:
            out = out.union(part)
        return out

    got, want, pq, _jq = _rows(build)
    assert got == want and len(got) == [None, None, 60, 110][n_frames]
    assert "* UnionExec -> will run on the device" in pq.explain()
    got, want, _pq, _jq = _rows(
        lambda df, p: build(df, p).unionAll(build(df, p)).sort("a", "s"))
    assert got == want


def test_coalesce_and_nanvl_match_reference():
    n = 60
    rng = np.random.default_rng(8)
    b = rng.normal(size=n)
    b[::5] = np.nan
    data = {"a": np.arange(n, dtype=np.int64), "b": b,
            "s": np.array([None if i % 4 == 0 else f"w{i % 9}"
                           for i in range(n)], dtype=object)}

    def build(df, p):
        F = p.F
        a_or_null = F.if_(F.col("a") > F.lit(40), F.lit(None, p.T.INT64),
                          F.col("a"))
        return df.filter(F.col("a") >= F.lit(0)).select(
            F.coalesce(a_or_null, F.lit(-1)).alias("c1"),
            F.coalesce(F.lit(None, p.T.FLOAT64), F.col("b"),
                       F.col("a")).alias("c2"),
            F.coalesce(F.col("s"), F.lit("none at all")).alias("c3"),
            F.nanvl(F.col("b"), F.lit(0.5)).alias("n1"),
            F.nanvl(F.col("b"), F.lit(None, p.T.FLOAT64)).alias("n2"),
            F.nanvl(F.col("a"), F.col("b")).alias("n3"))

    for conf in (None, NO_FUSION):
        got, want, _pq, _jq = _rows(build, data, conf=conf)
        assert len(got) == n
        assert repr(got) == repr(want)
    # row 0: b is NaN, so nanvl takes its second argument
    assert got[0][3] == 0.5 and got[0][4] is None and got[45][0] == -1
    # an untyped null among string children is skipped (the reference's
    # device coalesce raises on it, ROADMAP C.12)
    port, ref = _pkgs()
    q = port.frame(data).select(PF.coalesce(PF.lit(None), PF.col("s")))
    assert [r[0] for r in q.collect()] == list(data["s"])
    with pytest.raises(IndexError):
        ref.frame(data).select(JF.coalesce(JF.lit(None),
                                           JF.col("s"))).collect()
