"""TPC-H orders and customer cleaned as text (``benchmarks/tpch_clean.py``)
in spark_rapids_tpu_torch (on CPU tensors) against the JAX package's
device session on the same seeded tables, at one and two partitions,
with fusion on (the default) and off in both packages, under
``CLEAN_CONF``.

* ``orders_profile`` (3,000 orders) and ``customer_clean`` (300
  customers): the reference's rows, integers and strings exact,
  ``avg_len`` within relative 1e-9; the plans name the same execs and the
  same fused segments (``customer_clean``'s Filter -> Project fuses;
  ``orders_profile``'s lone Project does not, in either package).
* ``tpch_clean``'s Python oracles against the reference's rows, so the
  yardstick the card's run is held against is itself held against the
  reference."""
import re

import jax
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import f as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import f as PF
from spark_rapids_tpu_torch.benchmarks import tpch_clean, tpch_datagen
from spark_rapids_tpu_torch.interop import (from_reference_arrays,
                                            to_reference_arrays)

SF = 0.002
NO_FUSION = {"spark.rapids.tpu.sql.fusion.enabled": False}
CASES = [(q, p, fusion) for q in sorted(tpch_clean.QUERIES)
         for p in (1, 2) for fusion in ("on", "off")]


@pytest.fixture(scope="module", autouse=True)
def quick_reference_compiles():
    """The reference's kernels compiled without most XLA optimizations,
    for this module only (the flag is restored for the next module)."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def tables():
    cols = tpch_datagen.draw_all(sf=SF, seed=13)
    return {name: tpch_datagen.tables(name, sf=SF, seed=13, cols=cols)[t]
            for name, (_q, t) in tpch_clean.QUERIES.items()}


def _pair(batch, conf, n_partitions):
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


@pytest.mark.parametrize("name,n_partitions,fusion", CASES)
def test_query_matches_reference(tables, name, n_partitions, fusion):
    conf = {**tpch_clean.CLEAN_CONF,
            **(NO_FUSION if fusion == "off" else {})}
    query, _table = tpch_clean.QUERIES[name]
    psess, pdf, jdf = _pair(tables[name], conf, n_partitions)
    pq, jq = query(pdf, PF), query(jdf, JF)
    got_plan = str(psess.physical_plan(pq.plan))
    want_plan = str(jq.session.physical_plan(jq.plan))
    assert _names(got_plan) == _names(want_plan)
    assert _segments(got_plan) == _segments(want_plan)
    fused = fusion == "on" and name == "customer_clean"
    assert ("TpuFusedSegment[" in got_plan) == fused
    got, want = pq.collect(), jq.collect()
    tpch_clean.check_rows(got, want, name)
    if name == "orders_profile":
        assert [r[0] for r in got] == [1, 2, 3, 4, 5]
    else:
        assert 0 < len(got) < tables[name].num_rows


@pytest.mark.parametrize("name", sorted(tpch_clean.QUERIES))
def test_oracle_matches_reference(tables, name):
    query, _table = tpch_clean.QUERIES[name]
    _psess, _pdf, jdf = _pair(tables[name], tpch_clean.CLEAN_CONF, 2)
    want = query(jdf, JF).collect()
    tpch_clean.check_rows(tpch_clean.ORACLES[name](tables[name]), want,
                          name)
