"""All 22 TPC-H queries through spark_rapids_tpu_torch (on CPU tensors,
where every kernel wrapper and fused segment takes its plain version)
against the JAX package's device session with its default conf (fusion
on), at one partition, on the reference generator's own tables
(``tpch_datagen.generate(0.0007, 7)``, ``tests/test_tpch.py``'s scale and
seed, which the port reproduces bit for bit).

* Rows: ``testing/asserts.py`` rules, ``tests/test_tpch.py:27``'s
  ``_UNORDERED`` set, floats rel 1e-9, everything else equal.
* Plans: the same exec names, explain marks and ``TpuFusedSegment[...]``
  lines as the reference's, query by query.
* ``tpch_oracle``: each numpy oracle equals the reference's rows, so the
  yardstick ``chip_smoke.py`` holds the card's rows against is itself
  held against the reference.

The reference's rows are computed once a query for the module, with its
kernel cache reset before each query (ROADMAP C.3: it keys LIKE and
``isin`` kernels on the child alone), and its XLA kernels compiled with
``jax_disable_most_optimizations`` while the module runs: the same
results, about 40% less compile time, which is most of these tests'
cost.  The two-partition runs are in
``test_torch_tpch_two_partitions_*.py``, split so that the test workers
spread them."""
import re

import jax
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.benchmarks import tpch_datagen as jgen
from spark_rapids_tpu.exec import kernel_cache
from spark_rapids_tpu.testing.asserts import assert_rows_equal
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch.benchmarks import tpch, tpch_datagen
from spark_rapids_tpu_torch.benchmarks import tpch_oracle
from test_tpch import _UNORDERED

SF = 0.0007
SEED = 7
QUERIES = tuple(range(1, 23))


def _names(plan_string):
    return re.findall(r"^\s*(\w+)", plan_string, re.M)


def _segments(plan_string):
    return re.findall(r"TpuFusedSegment\[.*", plan_string)


def _marks(report):
    return [tuple(re.match(r"\s*([*!@]) (\w+)", line).groups())
            for line in report.splitlines()]


class Slice:
    """Both packages' tables at one partition count, the reference's rows
    per query (computed once, on first use), and the port's host
    batches."""

    def __init__(self, n_partitions):
        self.n_partitions = n_partitions
        self.jsess = jsrt.Session()
        self.jt = {name: self.jsess.create_dataframe(
            cols, schema, n_partitions=n_partitions)
            for name, (schema, cols) in jgen.generate(SF, SEED).items()}
        self.host = tpch_datagen.reference_tables(SF, SEED)
        self.psess = Session(device="cpu")
        self.pt = {t: self.psess.create_dataframe(
            b, n_partitions=n_partitions) for t, b in self.host.items()}
        self._want = {}

    def want(self, q):
        if q not in self._want:
            kernel_cache.GLOBAL.reset()
            self._want[q] = jtpch.QUERIES[q](self.jt).collect()
        return self._want[q]

    def check_rows(self, q):
        got = tpch.QUERIES[q](self.pt).collect()
        assert_rows_equal(self.want(q), got, ignore_order=q in _UNORDERED,
                          approximate_float=1e-9)
        return got

    def check_plan(self, q):
        df, jdf = tpch.QUERIES[q](self.pt), jtpch.QUERIES[q](self.jt)
        got = str(self.psess.physical_plan(df.plan))
        want = str(self.jsess.physical_plan(jdf.plan))
        assert _names(got) == _names(want)
        assert _segments(got) == _segments(want)
        assert _marks(df.explain()) == _marks(jdf.explain())
        return _segments(got)


@pytest.fixture(scope="module", autouse=True)
def quick_reference_compiles():
    """The reference's kernels compiled without most XLA optimizations,
    for this module only (the flag is restored for the next module)."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def one():
    return Slice(1)


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(one, q):
    assert one.check_rows(q)  # every query returns rows at this scale


@pytest.mark.parametrize("q", QUERIES)
def test_plan_matches_reference(one, q):
    segments = one.check_plan(q)
    if q == 22:
        # the customer segment, Substring on K12, twice (both sides of
        # the cross join with the average balance)
        assert sum("Substring(c_phone) AS cntrycode" in s
                   for s in segments) == 2
    if q in (7, 8):
        assert any("Year(" in s for s in segments)


@pytest.mark.parametrize("q", QUERIES)
def test_oracle_matches_reference(one, q):
    want = tpch_oracle.answer(q, one.host, {})
    assert_rows_equal(one.want(q), want, ignore_order=q in _UNORDERED,
                      approximate_float=1e-9)
