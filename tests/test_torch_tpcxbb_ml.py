"""TPCx-BB's machine-learning prep queries (``benchmarks/tpcxbb.py``:
q5, q20, q25, q26, q28, the reference's code) in spark_rapids_tpu_torch
(on CPU tensors) against the JAX package's device session on
``tpcxbb_datagen``'s tables at sf 0.002, seed 99, each cut to its
query's columns (``tpcxbb.query_tables``).

* Each query at one and two partitions equals the reference's rows (run
  once, at two partitions): keys, counts and strings exactly, floats
  within relative 1e-9, in the query's order.
* q20's ``greatest`` sits in a fused Project -> Filter -> Project segment
  (K12), q28's ``CASE WHEN`` in a lone Project under the aggregate (no
  segment), in both packages' plans.
* The numpy oracles (``tpcxbb.ORACLES``) equal the reference's rows.

Each reference query starts from a reset kernel cache (ROADMAP C.3) and
compiles without most XLA optimizations."""
import re

import jax
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.benchmarks import tpcxbb as jtpcxbb
from spark_rapids_tpu.exec import kernel_cache
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch.benchmarks import tpcxbb, tpcxbb_datagen
from spark_rapids_tpu_torch.benchmarks.tpch_oracle import check_rows
from spark_rapids_tpu_torch.interop import to_reference_arrays

SF = 0.002


@pytest.fixture(scope="module", autouse=True)
def quick_reference_compiles():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def host():
    gen = tpcxbb_datagen.generate(SF, 99)
    return {q: tpcxbb.query_tables(gen, q) for q in tpcxbb.ML_PREP}


def _reference(q, tables):
    sess = jsrt.Session()
    t = {}
    for n, b in tables.items():
        fields, arrays = to_reference_arrays(b)
        schema = JT.Schema([JT.Field(a, JT.from_name(ty))
                            for a, ty in fields])
        t[n] = sess.create_dataframe({a: arrays[a] for a, _ in fields},
                                     schema)
    return sess, getattr(jtpcxbb, f"q{q}")(t)


@pytest.fixture(scope="module")
def want(host):
    cache = {}

    def rows(q):
        if q not in cache:
            kernel_cache.GLOBAL.reset()
            cache[q] = _reference(q, host[q])[1].collect()
        return cache[q]

    return rows


def _port(q, tables, n_partitions):
    sess = Session(device="cpu")
    return sess, tpcxbb.QUERIES[q]({
        n: sess.create_dataframe(b, n_partitions=n_partitions)
        for n, b in tables.items()})


@pytest.mark.parametrize("q", tpcxbb.ML_PREP)
def test_query_and_oracle_match_reference(host, want, q):
    rows = want(q)
    assert rows
    for n_partitions in (1, 2):
        _s, df = _port(q, host[q], n_partitions)
        check_rows(df.collect(), rows, f"q{q}/{n_partitions}")
    check_rows(tpcxbb.ORACLES[q](host[q]), rows, f"oracle q{q}")


def _segments(plan_string):
    return re.findall(r"TpuFusedSegment\[[^\n]*", plan_string)


def test_greatest_fuses_and_case_when_stays_a_lone_project(host):
    sess, q20 = _port(20, host[20], 2)
    segs = _segments(str(sess.physical_plan(q20.plan)))
    assert len(segs) == 1 and "Greatest(orders, 1)" in segs[0], segs
    jsess, jq20 = _reference(20, host[20])
    assert len(_segments(str(jsess.physical_plan(jq20.plan)))) == 1
    sess, q28 = _port(28, host[28], 2)
    plan = str(sess.physical_plan(q28.plan))
    assert not _segments(plan) and "CASE WHEN" in plan, plan
    jsess, jq28 = _reference(28, host[28])
    assert not _segments(str(jsess.physical_plan(jq28.plan)))
