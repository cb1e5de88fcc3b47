"""TPC-H Q1–Q11 through spark_rapids_tpu_torch against the JAX
package's device session at the default two partitions, on
``tpch_datagen.generate(0.0007, 7)``: rows (``_UNORDERED`` as
``tests/test_tpch.py:27``, floats rel 1e-9) and plans (exec names,
explain marks and fused segments) as in ``test_torch_tpch_slice.py``,
which holds the helpers (and the fixture that compiles the reference's
kernels without most XLA optimizations) and the one-partition runs."""
import pytest

from test_torch_tpch_slice import Slice, quick_reference_compiles  # noqa: F401

QUERIES = tuple(range(1, 12))


@pytest.fixture(scope="module")
def two():
    return Slice(2)


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(two, q):
    assert two.check_rows(q)


@pytest.mark.parametrize("q", QUERIES)
def test_plan_matches_reference(two, q):
    two.check_plan(q)
