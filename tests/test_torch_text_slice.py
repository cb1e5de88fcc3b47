"""The text path in spark_rapids_tpu_torch (on CPU tensors) against the
JAX package's device session on the same seeded lineitem, at one and two
partitions, with fusion on (the default) and off in both packages.

* Ingest: ``tpch_datagen.lineitem_text`` (every field a string, as dbgen
  prints it) cast by one ``select`` to TPC-H's types under the three cast
  gates, then the reference's own Q1 and Q6.  Keys and counts equal the
  reference's (fusion on; fusion off against the oracle) and
  ``tpch_oracle``'s answers on the typed columns, floats to rel 1e-9
  (sums in another order); the plans name the same execs and
  the same fused segments (the cast Project fuses with Q1's and Q6's
  Filter).  The cast table itself: the keys, quantities, discounts, taxes
  and dates exact, ``l_extendedprice`` within 1 ULP of the typed column
  (``mant * 0.01`` is not always the correctly rounded ``mant / 100``)
  and equal to the reference's bit for bit.
* Export: the typed columns formatted and concatenated into dbgen's line
  by one ``select`` (K17, K18), and again behind a filter (one fused
  segment, K12): the same rows as the reference's and, byte for byte with
  the lengths, ``tpch_datagen.export_lines``.
* The generator's text against Python's own formatting."""
import re

import jax
import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import f as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import f as PF
from spark_rapids_tpu_torch.benchmarks import tpch, tpch_datagen, \
    tpch_oracle
from spark_rapids_tpu_torch.benchmarks.tpch_text import (CAST_CONF,
                                                         export_select,
                                                         filtered_export,
                                                         typed_select)
from spark_rapids_tpu_torch.data import strings as dstrings
from spark_rapids_tpu_torch.interop import (from_reference_arrays,
                                            to_reference_arrays)

ROWS = 4000
NO_FUSION = {"spark.rapids.tpu.sql.fusion.enabled": False}
CASES = [(p, fusion) for p in (1, 2) for fusion in ("on", "off")]


def _conf(fusion):
    return {**CAST_CONF, **(NO_FUSION if fusion == "off" else {})}


def _pair(batch, conf, n_partitions):
    """(port session, port DataFrame, reference DataFrame) of ``batch``."""
    fields, arrays = to_reference_arrays(batch)
    jschema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in fields])
    jdf = jsrt.Session(conf).create_dataframe(
        {n: arrays[n] for n, _ in fields}, jschema,
        n_partitions=n_partitions)
    psess = Session(conf, device="cpu")
    pdf = psess.create_dataframe(
        from_reference_arrays(fields, [arrays[n] for n, _ in fields]),
        n_partitions=n_partitions)
    return psess, pdf, jdf


def _names(plan_string):
    return re.findall(r"^\s*(\w+)", plan_string, re.M)


def _segments(plan_string):
    return re.findall(r"TpuFusedSegment\[.*", plan_string)


def _same_plan(psess, pq, jq):
    got = str(psess.physical_plan(pq.plan))
    want = str(jq.session.physical_plan(jq.plan))
    assert _names(got) == _names(want)
    assert _segments(got) == _segments(want)
    return got


def _close(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=0)
            else:
                assert a == b


@pytest.fixture(scope="module", autouse=True)
def quick_reference_compiles():
    """The reference's kernels compiled without most XLA optimizations,
    for this module only (the flag is restored for the next module)."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def text():
    return tpch_datagen.lineitem_text(n_rows=ROWS, seed=11)


@pytest.mark.parametrize("n_partitions,fusion", CASES)
def test_ingest_queries_match_reference_and_oracle(text, n_partitions,
                                                   fusion):
    text_batch, typed = text
    psess, pdf, jdf = _pair(text_batch, _conf(fusion), n_partitions)
    ptables = {"lineitem": typed_select(pdf, PF)}
    jtables = {"lineitem": typed_select(jdf, JF)}
    for q in (1, 6):
        pq, jq = tpch.QUERIES[q](ptables), getattr(jtpch, f"q{q}")(jtables)
        plan = _same_plan(psess, pq, jq)
        assert ("TpuFusedSegment[" in plan) == (fusion == "on")
        got = pq.collect()
        if fusion == "on":  # the reference's rows do not depend on fusion
            _close(got, jq.collect())
        want = getattr(tpch_oracle, f"numpy_q{q}")(typed)
        tpch_oracle.check_rows(got, want, f"Q{q}")


@pytest.mark.parametrize("n_partitions", [1, 2])
def test_cast_table_matches_typed_columns(text, n_partitions):
    text_batch, typed = text
    psess, pdf, jdf = _pair(text_batch, CAST_CONF, n_partitions)
    got = typed_select(pdf, PF)._result_batch()
    want = typed_select(jdf, JF).collect()
    assert got.num_rows == ROWS == len(want)
    cols = {f.name: c for f, c in zip(got.schema, got.columns)}
    for name, t in zip(typed.schema.names, typed.columns):
        g = cols[name]
        assert g.validity is None, name
        if name == "l_extendedprice":
            ulps = np.abs(g.data.view(np.int64) - t.data.view(np.int64))
            assert int(ulps.max()) <= 1
            assert 0 < int((ulps == 1).sum()) < ROWS // 4
        elif t.dtype.is_string:
            assert np.array_equal(g.data, t.data)
            assert np.array_equal(g.lengths, t.lengths)
        else:
            assert g.data.dtype == t.data.dtype
            assert np.array_equal(g.data, t.data), name
    j = typed.schema.names.index("l_extendedprice")
    assert [repr(r[j]) for r in got.to_rows()] == [repr(r[j]) for r in want]


@pytest.fixture(scope="module")
def export_table():
    return tpch_datagen.export_table(n_rows=ROWS, seed=11)


@pytest.mark.parametrize("n_partitions,fusion", CASES)
def test_export_matches_reference_and_bytes(export_table, n_partitions,
                                            fusion):
    psess, pdf, jdf = _pair(export_table, _conf(fusion), n_partitions)
    want_bm, want_len = tpch_datagen.export_lines(export_table)
    sm = export_table.column("l_shipmode")
    mode = dstrings.decode(sm.data, sm.lengths)
    cases = [(filtered_export, mode != "AIR")]
    if fusion == "on":  # a lone Project plans alike with fusion on or off
        cases.append((export_select, np.ones(ROWS, bool)))
    for query, keep in cases:
        pq, jq = query(pdf, PF), query(jdf, JF)
        plan = _same_plan(psess, pq, jq)
        fused = query is filtered_export and fusion == "on"
        assert ("TpuFusedSegment[" in plan) == fused
        out = pq._result_batch()
        assert [tuple(r) for r in out.to_rows()] == \
            [tuple(r) for r in jq.collect()]
        line = out.columns[0]
        assert line.validity is None
        w = line.data.shape[1]
        assert w >= want_bm.shape[1]
        exp = np.zeros((int(keep.sum()), w), dtype=np.uint8)
        exp[:, :want_bm.shape[1]] = want_bm[keep]
        assert np.array_equal(line.lengths, want_len[keep])
        assert np.array_equal(line.data, exp)


def test_text_generator_matches_python_formatting():
    text_batch, typed = tpch_datagen.lineitem_text(n_rows=3000, seed=4)
    t = {f.name: dstrings.decode(c.data, c.lengths)
         for f, c in zip(text_batch.schema, text_batch.columns)}
    v = {f.name: c for f, c in zip(typed.schema, typed.columns)}
    assert list(t["l_orderkey"]) == [str(x) for x in v["l_orderkey"].data]
    assert list(t["l_quantity"]) == [str(int(x))
                                     for x in v["l_quantity"].data]
    for name in ("l_extendedprice", "l_discount", "l_tax"):
        assert list(t[name]) == ["%.2f" % x for x in v[name].data], name
    assert list(t["l_shipdate"]) == [str(np.datetime64(int(x), "D"))
                                     for x in v["l_shipdate"].data]
    exp = tpch_datagen.export_table(n_rows=300, seed=4)
    bm, ln = tpch_datagen.export_lines(exp)
    cols = {f.name: c for f, c in zip(exp.schema, exp.columns)}

    def field(n, i):
        c = cols[n]
        if c.dtype.is_string:
            return dstrings.decode_one(c.data[i], c.lengths[i])
        if n in ("l_shipdate", "l_commitdate", "l_receiptdate"):
            return str(np.datetime64(int(c.data[i]), "D"))
        return str(int(c.data[i]))

    want = ["".join(field(n, i) + "|" for n in tpch_datagen.EXPORT_COLUMNS)
            for i in range(300)]
    assert list(dstrings.decode(bm, ln)) == want
    us = np.random.default_rng(4).integers(-10 ** 16, 10 ** 17, 300)
    bm, ln = tpch_datagen.timestamp_text(us)
    assert list(dstrings.decode(bm, ln)) == [
        str(np.datetime64(int(x), "us")).replace("T", " ") for x in us]
    big = np.array([0, 7, 10, 99, 100, 5_999_997, 10 ** 12], np.int64)
    bm, ln = tpch_datagen.int_text(big)
    assert list(dstrings.decode(bm, ln)) == [str(x) for x in big]
