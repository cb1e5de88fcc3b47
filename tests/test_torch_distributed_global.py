"""Global (keyless) aggregates through the distributed runner of
spark_rapids_tpu_torch on the CPU (plain PyTorch versions).

TPC-H Q6 (``tpch_datagen.tables(6, 0.002, 7)``) and TPCx-BB q24 (a union
of two global sums, ``tpcxbb_datagen.generate(0.002, 99)``) over two and
four shards return the one row per global aggregate that the port's own
``collect()`` returns (floats rel 1e-9, in order).  The final aggregate
over the rows gathered to shard 0 runs there alone (ROADMAP C.13).

The JAX package's runner runs that aggregate on every shard, so over
four shards it returns Q6's value and three rows of nulls: held here as
the stated difference (its one call compiles a shard_map program, so
this file makes only that one)."""
import jax
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.parallel.mesh import make_mesh as jmesh
from spark_rapids_tpu.parallel.runner import run_distributed as jrun
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch.benchmarks import (tpch, tpch_datagen, tpcxbb,
                                               tpcxbb_datagen)
from spark_rapids_tpu_torch.benchmarks import tpcxbb_rollup as R
from spark_rapids_tpu_torch.interop import (from_reference_tables,
                                            to_reference_tables)
from spark_rapids_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_tpu_torch.parallel.runner import run_distributed

SF, SEED = 0.002, 7


@pytest.fixture(scope="module", autouse=True)
def quick_reference_compiles():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def q24_tables():
    return R.query_tables(tpcxbb_datagen.generate(SF, 99), "q24")


def _assert_rows_close(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=0)
            else:
                assert a == b


def _frame(sess, query, q24_tables, n_shards):
    if query == "q6":
        tables = tpch_datagen.tables(6, sf=SF, seed=SEED)
        return tpch.q6({n: sess.create_dataframe(b, n_partitions=n_shards)
                        for n, b in tables.items()})
    return tpcxbb.q24({n: sess.create_dataframe(b, n_partitions=n_shards)
                       for n, b in q24_tables.items()})


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("query", ["q6", "q24"])
def test_global_aggregate_matches_local_collect(query, n_shards,
                                                q24_tables):
    sess = Session(device="cpu")
    df = _frame(sess, query, q24_tables, n_shards)
    want = df.collect()
    assert len(want) == (1 if query == "q6" else 2)
    got = run_distributed(sess, df,
                          mesh=make_mesh(n_shards, device="cpu")).to_rows()
    _assert_rows_close(got, want)


def test_q6_differs_from_reference_runner_by_its_null_rows():
    """C.13: the reference's runner returns one row a shard (the value on
    shard 0, nulls elsewhere); the port returns the one row."""
    ref_tables = to_reference_tables(tpch_datagen.tables(6, sf=SF,
                                                         seed=SEED))
    jsess = jsrt.Session()
    jt = {}
    for name, (fields, arrays) in ref_tables.items():
        schema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in fields])
        jt[name] = jsess.create_dataframe({n: arrays[n] for n, _ in fields},
                                          schema, n_partitions=4)
    ref = jrun(jsess, jtpch.q6(jt), mesh=jmesh(4)).to_rows()
    sess = Session(device="cpu")
    pt = {name: sess.create_dataframe(b, n_partitions=4)
          for name, b in from_reference_tables(ref_tables).items()}
    got = run_distributed(sess, tpch.q6(pt),
                          mesh=make_mesh(4, device="cpu")).to_rows()
    assert len(ref) == 4 and len(got) == 1
    values = [r for r in ref if r != (None,)]
    assert len(values) == 1 and ref.count((None,)) == 3
    _assert_rows_close(got, values)
