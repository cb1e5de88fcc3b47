"""TPC-H through the distributed runner of spark_rapids_tpu_torch on the
CPU (plain PyTorch versions), on ``tpch_datagen.tables(q, 0.002, 7)``:

* Q5 (six tables, five joins) over four shards against the JAX
  package's ``run_distributed`` over a 4-device virtual mesh, on the
  same data and plan conf (in order: Q5 sorts by revenue);
* Q18 (a semi join on a grouped subquery, a sort and a limit) over four
  shards, and Q1 over one, against the port's own ``collect()``.

Rows equal, floats to rel 1e-9, in order where the query orders.  The
reference's call alone takes ~17 s on one CPU, so this file holds it."""
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.parallel.mesh import make_mesh as jmesh
from spark_rapids_tpu.parallel.runner import run_distributed as jrun
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch.benchmarks import tpch, tpch_datagen
from spark_rapids_tpu_torch.interop import (from_reference_tables,
                                            to_reference_tables)
from spark_rapids_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_tpu_torch.parallel.runner import run_distributed

SF, SEED = 0.002, 7


def _assert_rows_close(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=0)
            else:
                assert a == b


def _port_tables(sess, q):
    return {name: sess.create_dataframe(b) for name, b in
            tpch_datagen.tables(q, sf=SF, seed=SEED).items()}


def test_q5_four_shards_matches_reference_runner():
    ref_tables = to_reference_tables(tpch_datagen.tables(5, sf=SF,
                                                         seed=SEED))
    jsess = jsrt.Session()
    jt = {}
    for name, (fields, arrays) in ref_tables.items():
        schema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in fields])
        jt[name] = jsess.create_dataframe({n: arrays[n] for n, _ in fields},
                                          schema)
    want = jrun(jsess, jtpch.q5(jt), mesh=jmesh(4)).to_rows()
    sess = Session(device="cpu")
    pt = {name: sess.create_dataframe(b)
          for name, b in from_reference_tables(ref_tables).items()}
    got = run_distributed(sess, tpch.q5(pt),
                          mesh=make_mesh(4, device="cpu")).to_rows()
    _assert_rows_close(got, want)
    for pl in sess.last_placements:
        assert sum(pl["partition_rows"]) == pl["rows_written"] or \
            pl["exchange"].endswith("build side")


@pytest.mark.parametrize("q,n_shards", [(18, 4), (1, 1)])
def test_query_matches_local_collect(q, n_shards):
    sess = Session(device="cpu")
    df = tpch.QUERIES[q](_port_tables(sess, q))
    got = run_distributed(sess, df,
                          mesh=make_mesh(n_shards, device="cpu")).to_rows()
    _assert_rows_close(got, df.collect())
