"""TPC-DS q67's rollup, the store_sales unpivot
(``benchmarks/tpcxbb_rollup.py``) and TPCx-BB q24
(``benchmarks/tpcxbb.py``) in spark_rapids_tpu_torch (on CPU tensors)
against the JAX package's device session, on ``tpcxbb_datagen``'s tables
at sf 0.002, seed 99 (8,000 store sales, 200 items, 5 stores).

* Each query at one and two partitions, with fusion on (the default)
  and off, equals the reference's rows: keys, counts and ranks exactly,
  sums within relative 1e-9 (the partitions' sums add in another order),
  in the queries' order.  The reference runs each query once, at two
  partitions with fusion on: its rows do not depend on the partitioning
  or on fusion, which change only where float sums are split.
* The plans name the reference's execs in the same places and the same
  fused segments: q67's Project -> Expand, the unpivot's Project ->
  Generate (with fusion on; none with it off).
* The numpy oracles (``tpcxbb_rollup.ORACLES``, ``tpcxbb.oracle_q24``)
  equal the reference's rows, so the answers the card's run is held
  against are held against the reference.
* The chunked partial aggregate (ROADMAP B.25): the unpivot at one
  partition over 1,024-row reader batches and a 1-byte
  ``batchSizeBytes``, so each partial aggregate merges eight batches,
  equals the reference's run of the same conf (which aggregates the
  same batches, chunked), sums within rel 1e-9; q67 at one and two
  partitions and a 64 KiB ``batchSizeBytes`` (each of its 8 Expand
  batches reaches the partial aggregate alone; at two, each partition's
  sort gets two batches and merges them) equals the reference's rows.

Each reference query starts from a reset kernel cache (ROADMAP C.3) and
compiles without most XLA optimizations."""
import re

import jax
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import f as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.benchmarks import tpcxbb as jtpcxbb
from spark_rapids_tpu.exec import kernel_cache
from spark_rapids_tpu.ops import windowexprs as JW
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch.benchmarks import tpcxbb, tpcxbb_datagen
from spark_rapids_tpu_torch.benchmarks import tpcxbb_rollup as R
from spark_rapids_tpu_torch.benchmarks.tpch_oracle import check_rows
from spark_rapids_tpu_torch.interop import to_reference_arrays

SF = 0.002
NAMES = ["q67", "store_unpivot", "q24"]
NO_FUSION = {"spark.rapids.tpu.sql.fusion.enabled": False}
CHUNKED = {"spark.rapids.tpu.sql.reader.batchSizeRows": 1024,
           "spark.rapids.tpu.sql.batchSizeBytes": 1}


@pytest.fixture(scope="module", autouse=True)
def quick_reference_compiles():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def host():
    gen = tpcxbb_datagen.generate(SF, 99)
    return {q: R.query_tables(gen, q) for q in NAMES}


def _port(q, tables, conf, n_partitions):
    sess = Session(conf, device="cpu")
    t = {n: sess.create_dataframe(b, n_partitions=n_partitions)
         for n, b in tables.items()}
    return sess, (tpcxbb.q24(t) if q == "q24" else R.QUERIES[q](t))


def _reference(q, tables, conf, n_partitions):
    sess = jsrt.Session(conf)
    t = {}
    for n, b in tables.items():
        fields, arrays = to_reference_arrays(b)
        schema = JT.Schema([JT.Field(a, JT.from_name(ty))
                            for a, ty in fields])
        t[n] = sess.create_dataframe({a: arrays[a] for a, _ in fields},
                                     schema, n_partitions=n_partitions)
    if q == "q24":
        return sess, jtpcxbb.q24(t)
    return sess, R.QUERIES[q](t, JF, JL, JW)


@pytest.fixture(scope="module")
def want(host):
    """Each query's rows from the reference, computed once."""
    cache = {}

    def rows(q):
        if q not in cache:
            kernel_cache.GLOBAL.reset()
            _sess, jq = _reference(q, host[q], {}, 2)
            cache[q] = jq.collect()
        return cache[q]

    return rows


def _names(plan_string):
    return re.findall(r"^\s*(\w+)", plan_string, re.M)


def _segments(plan_string):
    return re.findall(r"TpuFusedSegment\[.*", plan_string)


@pytest.mark.parametrize("q,n_partitions,fusion", [
    (q, p, fusion) for q in NAMES for p in (1, 2) for fusion in ("on",
                                                                 "off")])
def test_query_matches_reference(host, want, q, n_partitions, fusion):
    conf = NO_FUSION if fusion == "off" else {}
    psess, pq = _port(q, host[q], conf, n_partitions)
    jsess, jq = _reference(q, host[q], conf, n_partitions)
    got_plan = str(psess.physical_plan(pq.plan))
    want_plan = str(jsess.physical_plan(jq.plan))
    assert _names(got_plan) == _names(want_plan)
    assert _segments(got_plan) == _segments(want_plan)
    member = {"q67": "TpuExpand[8 projections]]",
              "store_unpivot": "TpuGenerate[3 elements, pos]]"}.get(q)
    if member is not None:
        assert any(s.endswith(member) for s in _segments(got_plan)) == \
            (fusion == "on")
    got = pq.collect()
    check_rows(got, want(q), f"{q} at {n_partitions} partition(s), "
               f"fusion {fusion}")
    assert psess.last_metrics[
        "TpuHashAggregateExec[partial].numInputBatches"] >= n_partitions
    if q == "q67":
        assert len(got) == R.TOP and got[0][:7] == (None,) * 7
    elif q == "store_unpivot":
        assert len(got) == 3 * 5  # five stores
        assert sum(r[2] for r in got) == \
            3 * host[q]["store_sales"].num_rows


@pytest.mark.parametrize("q", NAMES)
def test_oracle_matches_reference(host, want, q):
    oracle = tpcxbb.oracle_q24 if q == "q24" else R.ORACLES[q]
    check_rows(oracle(host[q]), want(q), f"{q} numpy oracle")


def test_chunked_partial_aggregate_matches_reference(host, want):
    q = "store_unpivot"
    psess, pq = _port(q, host[q], CHUNKED, 1)
    got = pq.collect()
    assert psess.last_metrics[
        "TpuHashAggregateExec[partial].numInputBatches"] == 8
    kernel_cache.GLOBAL.reset()
    _jsess, jq = _reference(q, host[q], CHUNKED, 1)
    check_rows(got, jq.collect(), "the chunked unpivot")
    check_rows(got, want(q), "the chunked unpivot")
    # at 64 KiB every Expand batch reaches the partial aggregate alone
    # (two exceed 64 KiB); at one partition the sort gets one batch, at
    # two the range exchange hands each partition a slice of each window
    # output at bucket_rows of its rows: the two slices of one partition
    # fit the 64 KiB target together and coalesce, the other partition's
    # two reach its sort, which the tile merge sorts
    for n_partitions, sort_batches in ((1, 1), (2, 3)):
        psess, pq = _port("q67", host["q67"],
                          {"spark.rapids.tpu.sql.batchSizeBytes": 1 << 16},
                          n_partitions)
        check_rows(pq.collect(), want("q67"), "the chunked q67")
        assert psess.last_metrics[
            "TpuHashAggregateExec[partial].numInputBatches"] \
            == 8 * n_partitions
        assert psess.last_metrics["TpuSortExec.numInputBatches"] \
            == sort_batches
