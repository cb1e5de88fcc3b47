"""The distributed runner of spark_rapids_tpu_torch/parallel over four
shards on the CPU (``make_mesh(4, device="cpu")``, where every kernel
wrapper takes its plain PyTorch version) against the JAX package's
``run_distributed`` over a 4-device virtual mesh, on the same data: the
cases of ``tests/test_distributed.py``.

* A filter and aggregate, a join shuffled and broadcast, a global sort
  above a join and aggregate (in order), a range exchange (the rows each
  shard holds equal the reference's), a sort over three keys with no
  gather to one shard and a descending sort with nulls first (in order),
  and a hash exchange that sends every row to one shard.
* The counterpart of the reference's broadcast-reuse case: the build
  side is replicated once a query, and the all-equal-key 600 x 100 join
  loses no row (the port sizes the join from its total; no retry).
* One shard; a conf naming the reference's transport class (unread: the
  port has one transport); ``recovery=`` refused; ``make_mesh`` refusing
  more CUDA devices than there are; the metrics and placements a run
  leaves on the session."""
import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import f as jf
from spark_rapids_tpu.parallel.mesh import make_mesh as jmesh
from spark_rapids_tpu.parallel.runner import (
    DistributedRunner as JRunner, run_distributed as jrun)
from spark_rapids_tpu.plan import functions as JF
from spark_rapids_tpu.plan.physical import ExecContext as JContext
from spark_rapids_tpu_torch import Session, f
from spark_rapids_tpu_torch.exec.joins import TpuBroadcastHashJoinExec
from spark_rapids_tpu_torch.parallel.collective import \
    DeviceCollectiveTransport
from spark_rapids_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_tpu_torch.parallel.runner import (DistributedRunner,
                                                    run_distributed)
from spark_rapids_tpu_torch.plan import functions as F
from spark_rapids_tpu_torch.plan.physical import ExecContext

N_SHARDS = 4
SHUFFLED = {"spark.rapids.tpu.sql.broadcastSizeThreshold": 0}


def _mesh(n=N_SHARDS):
    return make_mesh(n, device="cpu")


def _assert_rows_equal(got, exp, ordered=False):
    """Equal rows, floats to rel 1e-9; as multisets unless ``ordered``."""
    assert len(got) == len(exp), (len(got), len(exp))
    if not ordered:
        key = lambda r: tuple((v is None, v) for v in r)  # noqa: E731
        got, exp = sorted(got, key=key), sorted(exp, key=key)
    for g, e in zip(got, exp):
        assert len(g) == len(e)
        for a, b in zip(g, e):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=1e-9), (g, e)
            else:
                assert a == b, (g, e)


def _both(query, conf=None, ordered=False):
    """``query(session, F, f)`` through both runners on four shards."""
    conf = conf or {}
    jsess = jsrt.Session(dict(conf))
    want = jrun(jsess, query(jsess, JF, jf), mesh=jmesh(N_SHARDS)).to_rows()
    sess = Session(dict(conf), device="cpu")
    got = run_distributed(sess, query(sess, F, f), mesh=_mesh()).to_rows()
    _assert_rows_equal(got, want, ordered)
    return sess, got


def test_filter_agg_matches_reference():
    rng = np.random.RandomState(0)
    data = {"k": rng.randint(0, 20, 300), "v": rng.rand(300) * 100}

    def q(sess, F_, f_):
        df = sess.create_dataframe(dict(data))
        return (df.filter(f_.col("v") > 10).group_by("k")
                .agg(F_.sum("v").alias("s"), F_.count("v").alias("c")))

    sess, got = _both(q)
    assert len(got) == 20
    m = sess.last_metrics
    assert m["shuffle.collectiveTimeNs"] > 0
    (pl,) = sess.last_placements
    assert pl["rows_written"] == sum(pl["partition_rows"])
    assert len(pl["partition_rows"]) == N_SHARDS


@pytest.mark.parametrize("conf", [SHUFFLED, {}],
                         ids=["shuffled", "broadcast"])
def test_join_modes_match_reference(conf):
    rng = np.random.RandomState(1)
    orders = {"o_custkey": rng.randint(0, 50, 400),
              "o_total": rng.rand(400) * 1000}
    cust = {"c_custkey": np.arange(50), "c_nation": rng.randint(0, 5, 50)}

    def q(sess, F_, f_):
        o = sess.create_dataframe(dict(orders))
        c = sess.create_dataframe(dict(cust))
        j = o.join(c, on=(["o_custkey"], ["c_custkey"]), how="inner")
        return j.group_by("c_nation").agg(
            F_.sum("o_total").alias("rev"), F_.count("o_total").alias("n"))

    sess, _ = _both(q, conf)
    labels = [p["exchange"] for p in sess.last_placements]
    assert any("build side" in x for x in labels) == (conf == {})


def test_global_sort_order_matches_reference():
    rng = np.random.RandomState(9)
    fact = {"k": rng.randint(0, 30, 600), "v": rng.rand(600) * 50}
    dim = {"dk": np.arange(30), "grp": rng.randint(0, 4, 30)}

    def q(sess, F_, f_):
        fd = sess.create_dataframe(dict(fact))
        dd = sess.create_dataframe(dict(dim))
        j = fd.join(dd, on=(["k"], ["dk"]), how="inner") \
            .filter(f_.col("v") > 5)
        return (j.group_by("grp")
                .agg(F_.sum("v").alias("s"), F_.count("v").alias("n"))
                .sort(f_.col("s").desc()))

    _both(q, SHUFFLED, ordered=True)


def test_range_exchange_places_rows_as_reference():
    """The sort's range exchange places every row on the reference's
    shard (the same sampled bounds), spreading them over all shards."""
    rng = np.random.RandomState(33)
    data = {"v": rng.randint(-10000, 10000, 4000),
            "w": rng.rand(4000).round(6)}
    counts = {}

    class JCapture(JRunner):
        def _collect_output(self, out, stages):
            counts["ref"] = np.asarray(out.num_rows).tolist()
            return super()._collect_output(out, stages)

    class Capture(DistributedRunner):
        def _collect_output(self, out, stages):
            counts["port"] = [int(b.num_rows) for b in out]
            return super()._collect_output(out, stages)

    jsess = jsrt.Session()
    jdf = jsess.create_dataframe(dict(data)).sort(jf.col("v"))
    want = JCapture(jmesh(N_SHARDS)).run(
        jsess.physical_plan(jdf.plan), JContext(jsess.conf, jsess))
    sess = Session(device="cpu")
    df = sess.create_dataframe(dict(data)).sort(f.col("v"))
    got = Capture(_mesh()).run(sess.physical_plan(df.plan),
                               ExecContext(sess.conf, sess.device))
    _assert_rows_equal(got.to_rows(), want.to_rows(), ordered=True)
    assert counts["port"] == counts["ref"]
    assert min(counts["port"]) > 0


def test_range_sort_without_gather_matches_reference():
    rng = np.random.RandomState(21)
    n = 4000
    data = {"v": rng.randint(-10000, 10000, n),
            "x": (rng.rand(n) * 100).round(6),
            "s": [f"tag{i % 17}" for i in range(n)]}

    def q(sess, F_, f_):
        return sess.create_dataframe(dict(data)).sort(
            f_.col("v"), f_.col("x"), f_.col("s"))

    sess, got = _both(q, ordered=True)
    (pl,) = sess.last_placements
    assert "Range" in pl["exchange"] and min(pl["partition_rows"]) > 0


def test_range_sort_desc_nulls_matches_reference():
    rng = np.random.RandomState(23)
    n = 1500
    vals = [None if i % 11 == 0 else int(v)
            for i, v in enumerate(rng.randint(-500, 500, n))]
    data = {"v": vals, "i": list(range(n))}

    def q(sess, F_, f_):
        return sess.create_dataframe(dict(data)).sort(
            F_.SortKey(f_.col("v").expr, False, True), f_.col("i"))

    _both(q, ordered=True)


def test_skewed_hash_exchange_matches_reference():
    """Every row has the same key: one shard receives them all."""
    rng = np.random.RandomState(5)
    data = {"k": np.full(900, 7), "v": rng.rand(900)}

    def q(sess, F_, f_):
        return sess.create_dataframe(dict(data)).group_by("k").agg(
            F_.sum("v").alias("s"), F_.count("v").alias("n"))

    sess, got = _both(q)
    assert got[0][2] == 900
    (pl,) = sess.last_placements
    assert sorted(pl["partition_rows"])[:-1] == [0] * (N_SHARDS - 1)


def test_broadcast_build_replicated_once_and_no_row_lost():
    """Every key equal: 600 x 100 = 60,000 output rows, far above the
    inputs; the port sizes the join from its total, so no row is lost,
    and the build side is replicated once a query."""
    left = {"k": np.zeros(600, dtype=np.int64),
            "v": np.arange(600, dtype=np.int64)}
    right = {"rk": np.zeros(100, dtype=np.int64),
             "w": np.arange(100, dtype=np.int64)}
    sess = Session(device="cpu")
    j = sess.create_dataframe(dict(left)).join(
        sess.create_dataframe(dict(right)), on=(["k"], ["rk"]), how="inner")
    phys = sess.physical_plan(j.plan)

    def walk(n):
        yield n
        for c in n.children:
            yield from walk(c)

    assert any(isinstance(n, TpuBroadcastHashJoinExec) for n in walk(phys))

    class Counting(DeviceCollectiveTransport):
        replicates = 0

        def replicate(self, batches, label="replicate"):
            Counting.replicates += 1
            return super().replicate(batches, label)

    mesh = _mesh()
    got = DistributedRunner(mesh, transport=Counting(mesh)).run(
        phys, ExecContext(sess.conf, sess.device)).to_rows()
    assert Counting.replicates == 1
    _assert_rows_equal(got, j.collect())
    assert len(got) == 60000


def test_reference_transport_conf_is_not_read():
    """One conf dict drives both packages: a conf that names the
    reference's transport class runs over the port's own transport."""
    sess = Session({"spark.rapids.tpu.shuffle.transport.class":
                    "spark_rapids_tpu.parallel.collective."
                    "IciCollectiveTransport", **SHUFFLED}, device="cpu")
    df = sess.create_dataframe({"k": np.arange(200) % 7,
                                "v": np.arange(200.0)})
    q = df.group_by("k").agg(F.sum("v").alias("s"))
    got = run_distributed(sess, q, mesh=_mesh(2)).to_rows()
    _assert_rows_equal(got, q.collect())
    assert sess.last_placements


def test_one_shard_matches_local_collect():
    rng = np.random.RandomState(3)
    data = {"k": rng.randint(0, 9, 500), "v": rng.rand(500)}
    sess = Session(SHUFFLED, device="cpu")
    df = sess.create_dataframe(dict(data))
    q = df.join(df.group_by("k").agg(F.max("v").alias("m")), on="k") \
        .sort(f.col("k"), f.col("v"))
    got = run_distributed(sess, q, mesh=_mesh(1)).to_rows()
    _assert_rows_equal(got, q.collect(), ordered=True)


def test_refusals():
    df = Session(device="cpu").create_dataframe({"k": [1, 2, 3]})
    with pytest.raises(NotImplementedError, match="recovery"):
        run_distributed(Session(device="cpu"), df, mesh=_mesh(2),
                        recovery=object())
    with pytest.raises(ValueError, match="device="):
        make_mesh(64)
    with pytest.raises(ValueError, match="cannot run over"):
        run_distributed(Session(device="cpu"), df,
                        mesh=make_mesh(2, device="meta"))
