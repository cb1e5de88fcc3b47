"""The multi-process runner of spark_rapids_tpu_torch
(``parallel/multiprocess.py``) in two OS processes over gloo on the CPU,
two shards each (four shards), on ``tpch_datagen.tables(q, 0.002, 7)``.

This file is also the workers' script: ``python
tests/test_torch_multiprocess.py <coordinator> <rank> <mode> <out>``
joins the job (``init_multiprocess(..., device="cpu", local_shards=2)``),
runs ``mode``'s cells through ``run_distributed_mp`` and pickles every
cell's rows, the leaf partitions it drained and its placements to
``<out>/rank<rank>.pkl``.

* Q3 and Q18 (every table in four partitions): rows on both processes
  equal to the port's single-process ``run_distributed`` over four CPU
  shards, in order;
* Q5 also against the JAX package's ``run_distributed`` over a 4-device
  virtual mesh (the one reference call here, ~17 s);
* the reference worker's cells (``tests/mp_worker_script.py``): a
  shuffled join + group-by (``broadcastSizeThreshold`` 0, the port's
  transport named by ``shuffle.transport.class``) and a global sort by a
  float (the reference's transport named: the one the runner needs),
  whole rows compared in order;
* partition ownership: each process drained a disjoint set of every
  leaf's partitions, together covering all of them;
* a dead peer: a process that exits before its first collective makes the
  other raise ``TpuPeerLost`` within its 2 s deadline;
* the transport: ``shuffle.transport.class`` picks it by reflection; an
  unknown class, or one that does not fit the runner, raises;
* the leaf drain's deadline: ``fault.stageTimeoutMs`` past with
  partitions left raises ``TpuStageTimeout`` (one process, in this one).

Floats rel 1e-9, everything else equal."""
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

SF, SEED = 0.002, 7
QUERIES = (3, 18, 5)
SHARDS = 4
PROC_TRANSPORT = \
    "spark_rapids_tpu_torch.parallel.collective.ProcessGroupTransport"


def _orders_cust():
    """The reference worker's data (``tests/mp_worker_script.py``)."""
    rng = np.random.RandomState(123)
    orders = {"o_custkey": rng.randint(0, 60, 500),
              "o_total": (rng.rand(500) * 1000).round(6)}
    cust = {"c_custkey": np.arange(60), "c_nation": rng.randint(0, 6, 60)}
    return orders, cust


def _cells(sess):
    """Each cell's DataFrame on ``sess`` (the same plans on every process
    and in the single-process runs)."""
    from spark_rapids_tpu_torch import f as F
    from spark_rapids_tpu_torch.benchmarks import tpch, tpch_datagen
    from spark_rapids_tpu_torch.interop import (from_reference_tables,
                                                to_reference_tables)

    out = {}
    for q in QUERIES:
        tabs = from_reference_tables(to_reference_tables(
            tpch_datagen.tables(q, sf=SF, seed=SEED)))
        out[f"q{q}"] = tpch.QUERIES[q]({
            t: sess.create_dataframe(b, n_partitions=SHARDS)
            for t, b in tabs.items()})
    orders, cust = _orders_cust()
    o = sess.create_dataframe(dict(orders), n_partitions=SHARDS)
    c = sess.create_dataframe(dict(cust), n_partitions=SHARDS)
    out["join_group"] = o.join(c, on=(["o_custkey"], ["c_custkey"]),
                               how="inner").group_by("c_nation").agg(
        F.sum("o_total").alias("rev"), F.count("o_total").alias("n"))
    out["sort"] = sess.create_dataframe(dict(orders), n_partitions=SHARDS) \
        .sort(F.col("o_total").desc())
    return out


#: the conf of the cells that force shuffled joins (the reference
#: worker's), each with a transport named explicitly: the port's, and the
#: reference's (which names the one the runner needs)
SHUFFLED = {name: {"spark.rapids.tpu.sql.broadcastSizeThreshold": 0,
                   "spark.rapids.tpu.shuffle.transport.class": path}
            for name, path in (
                ("join_group", PROC_TRANSPORT),
                ("sort", "spark_rapids_tpu.parallel.collective."
                 "IciCollectiveTransport"))}


def _worker(coordinator, rank, mode, out_dir):
    from spark_rapids_tpu_torch import Session
    from spark_rapids_tpu_torch.fault.errors import TpuPeerLost
    from spark_rapids_tpu_torch.parallel.multiprocess import (
        init_multiprocess, run_distributed_mp)

    mesh = init_multiprocess(coordinator, 2, rank, device="cpu",
                             local_shards=2)
    result = {"owned": mesh.owned_shards(rank)}
    if mode == "dead":
        if rank == 1:
            os._exit(0)  # gone before its first collective
        sess = Session({"spark.rapids.tpu.fault.peer.collectiveTimeoutMs":
                        2000}, device="cpu")
        df = _cells(sess)["q3"]
        t0 = time.monotonic()
        try:
            run_distributed_mp(sess, df, mesh)
            result["raised"] = None
        except TpuPeerLost as e:
            result["raised"] = f"TpuPeerLost: {e}"
        except Exception as e:  # noqa: BLE001 — reported to the test
            result["raised"] = f"{type(e).__name__}: {e}"
        result["seconds"] = time.monotonic() - t0
    else:
        for name in ("q3", "q18", "q5", "join_group", "sort"):
            sess = Session(SHUFFLED.get(name, {}), device="cpu")
            rows = run_distributed_mp(sess, _cells(sess)[name],
                                      mesh).to_rows()
            result[name] = {"rows": rows, "drained": sess.last_drained,
                            "placements": sess.last_placements,
                            "metrics": sess.last_metrics}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)
    sys.stdout.flush()
    # a survivor of a lost peer leaves its abandoned collective behind
    os._exit(0)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------
def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(mode, out_dir, timeout=240):
    coordinator = f"127.0.0.1:{_free_port()}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), coordinator, str(r),
         mode, str(out_dir)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=repo)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{mode} workers timed out:\n" + "\n".join(
            o or "" for o in outs))
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {r} rc {p.returncode}:\n" \
            + out[-4000:]
        path = os.path.join(out_dir, f"rank{r}.pkl")
        if mode == "dead" and r == 1:
            assert not os.path.exists(path)
            continue
        with open(path, "rb") as fh:
            results.append(pickle.load(fh))
    return results


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    return _launch("queries", tmp_path_factory.mktemp("mp"))


@pytest.fixture(scope="module")
def single():
    """Each cell over four shards of one process."""
    from spark_rapids_tpu_torch import Session
    from spark_rapids_tpu_torch.parallel.mesh import make_mesh
    from spark_rapids_tpu_torch.parallel.runner import run_distributed

    out = {}
    for name in ("q3", "q18", "q5", "join_group", "sort"):
        sess = Session({"spark.rapids.tpu.sql.broadcastSizeThreshold": 0}
                       if name in ("join_group", "sort") else {},
                       device="cpu")
        out[name] = run_distributed(sess, _cells(sess)[name], mesh=make_mesh(
            SHARDS, device="cpu")).to_rows()
    return out


def _assert_rows_close(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=0)
            else:
                assert a == b


@pytest.mark.parametrize("name", ["q3", "q18", "q5", "join_group", "sort"])
def test_rows_equal_single_process_runner(workers, single, name):
    for res in workers:
        _assert_rows_close(res[name]["rows"], single[name])


def test_q5_matches_reference_runner(workers):
    import spark_rapids_tpu as jsrt
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.benchmarks import tpch as jtpch
    from spark_rapids_tpu.parallel.mesh import make_mesh as jmesh
    from spark_rapids_tpu.parallel.runner import run_distributed as jrun
    from spark_rapids_tpu_torch.benchmarks import tpch_datagen
    from spark_rapids_tpu_torch.interop import to_reference_tables

    ref_tables = to_reference_tables(tpch_datagen.tables(5, sf=SF,
                                                         seed=SEED))
    jsess = jsrt.Session()
    jt = {}
    for name, (fields, arrays) in ref_tables.items():
        schema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in fields])
        jt[name] = jsess.create_dataframe(
            {n: arrays[n] for n, _ in fields}, schema, n_partitions=SHARDS)
    want = jrun(jsess, jtpch.q5(jt), mesh=jmesh(SHARDS)).to_rows()
    for res in workers:
        _assert_rows_close(res["q5"]["rows"], want)


def test_sort_whole_rows_against_collect(workers):
    from spark_rapids_tpu import Session as JSession
    from spark_rapids_tpu.plan import functions as JF

    orders, _cust = _orders_cust()
    want = JSession(tpu_enabled=False).create_dataframe(dict(orders)).sort(
        JF.col("o_total").desc()).collect()
    for res in workers:
        got = res["sort"]["rows"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[0] == w[0] and abs(g[1] - w[1]) < 1e-9


@pytest.mark.parametrize("name", ["q3", "q18", "q5", "join_group", "sort"])
def test_partition_ownership_disjoint_and_covering(workers, name):
    a, b = (res[name]["drained"] for res in workers)
    assert workers[0]["owned"] == [0, 1] and workers[1]["owned"] == [2, 3]
    assert len(a) == len(b) and a
    for mine, theirs in zip(a, b):
        assert mine and theirs and not set(mine) & set(theirs)
        assert sorted(mine + theirs) == list(range(len(mine + theirs)))
        assert all(p % SHARDS in (0, 1) for p in mine)


def test_placements_and_counters(workers):
    for res in workers:
        for name in ("q3", "join_group", "sort"):
            places = res[name]["placements"]
            assert places
            for pl in places:
                if pl["capacity"] is not None:
                    assert sum(pl["partition_rows"]) == pl["rows_written"]
            m = res[name]["metrics"]
            assert m["shuffle.processCollectives"] > 0
            assert m["shuffle.processBytesSent"] > 0
            assert m["shuffle.collectiveTimeNs"] > 0
            # CPU tensors: nothing staged through host memory
            assert m["shuffle.hostStagedBytes"] == 0
    # every process sees the same placements
    for name in ("q3", "join_group"):
        assert [(p["exchange"], p["rows_sent"], p["partition_rows"])
                for p in workers[0][name]["placements"]] == \
            [(p["exchange"], p["rows_sent"], p["partition_rows"])
             for p in workers[1][name]["placements"]]


def test_dead_peer_raises_peer_lost(tmp_path):
    (res,) = _launch("dead", tmp_path)
    assert res["raised"] is not None and \
        res["raised"].startswith("TpuPeerLost"), res["raised"]
    assert res["seconds"] < 2.0 + 3.0, res


def test_transport_by_reflection():
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.parallel.collective import (
        DeviceCollectiveTransport, make_transport)
    from spark_rapids_tpu_torch.parallel.mesh import Mesh, make_mesh

    key = "spark.rapids.tpu.shuffle.transport.class"
    mesh = make_mesh(2, device="cpu")
    device = "spark_rapids_tpu_torch.parallel.collective." \
        "DeviceCollectiveTransport"
    ici = "spark_rapids_tpu.parallel.collective.IciCollectiveTransport"
    # the default and the reference's transport: the runner's own
    for conf in ({}, {key: ici}, {key: device}):
        assert isinstance(make_transport(TpuConf(conf), mesh),
                          DeviceCollectiveTransport)
    # a transport that does not fit the runner
    two = Mesh([mesh.devices[0]] * 4, owners=[0, 0, 1, 1])
    with pytest.raises(ValueError, match="within one process"):
        make_transport(TpuConf({key: device}), two, across_processes=True)
    with pytest.raises(ValueError, match="between processes"):
        make_transport(TpuConf({key: PROC_TRANSPORT}), mesh)
    for bad in ("spark_rapids_tpu_torch.parallel.collective.NoSuchTransport",
                "no_such_module.Transport",
                "spark_rapids_tpu.parallel.collective.Other"):
        with pytest.raises(ValueError, match="names (no class|a class of "
                           "the reference)"):
            make_transport(TpuConf({key: bad}), mesh)


def test_stage_timeout_raises(monkeypatch):
    """A leaf drain still holding partitions once ``fault.stageTimeoutMs``
    has passed raises ``TpuStageTimeout`` out of ``run_distributed_mp``
    (a group of one process, here; every drain sleeps 50 ms)."""
    import torch.distributed as dist

    from spark_rapids_tpu_torch import Session
    from spark_rapids_tpu_torch import f as F
    from spark_rapids_tpu_torch.fault.errors import TpuStageTimeout
    from spark_rapids_tpu_torch.parallel import multiprocess as MPR

    source = MPR.MultiProcessRunner._leaf_source
    drained = []

    def slow_source(node, ctx):
        n_parts, drain = source(node, ctx)

        def slow(p):
            drained.append(p)
            time.sleep(0.05)
            return drain(p)
        return n_parts, slow

    def query(ms):
        sess = Session({"spark.rapids.tpu.fault.stageTimeoutMs": ms},
                       device="cpu")
        df = sess.create_dataframe({"k": np.arange(40) % 3,
                                    "v": np.arange(40.0)}, n_partitions=6)
        return sess, df.group_by("k").agg(F.sum("v").alias("s"))

    monkeypatch.setattr(MPR.MultiProcessRunner, "_leaf_source",
                        staticmethod(slow_source))
    mesh = MPR.init_multiprocess(f"127.0.0.1:{_free_port()}", 1, 0,
                                 device="cpu", local_shards=2)
    try:
        sess, q = query(0)
        got = MPR.run_distributed_mp(sess, q, mesh).to_rows()
        assert sorted(got) == sorted(q.collect())
        assert sorted(drained) == list(range(6))
        drained.clear()
        sess, q = query(20)
        with pytest.raises(TpuStageTimeout, match="stageTimeoutMs=20ms"):
            MPR.run_distributed_mp(sess, q, mesh)
        assert 1 <= len(drained) < 6
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])
