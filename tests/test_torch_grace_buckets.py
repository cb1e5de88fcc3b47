"""The grace join's bucketing in spark_rapids_tpu_torch (on CPU tensors,
where every wrapper takes its plain PyTorch version) against the JAX
package.

* K9's plain version from the grace seeds (``0x5D1E_995 + 1_000_003 *
  level``) and from a seed past 2**31 equals the reference's
  ``hash_device_batch(cols, seed=s)`` bit for bit, and its ``pmod`` for
  m = 2, 7 and 64: int, bigint, double (with -0.0, NaN and the
  infinities), date and string keys alone, and all five folded together.
* ``_bucket_side`` of the port's shuffled join gives the reference's row
  count in every bucket, for the same batch, keys (a bigint and a string)
  and seed, at levels 0 and 1, over 2 and 8 buckets; each port
  bucket holds exactly the rows of that bucket, in batch order.
* TPC-H Q3 at sf 0.002 with ``reader.batchSizeRows`` 1024 and
  ``batchSizeBytes`` 1 (every join side several batches, shuffled joins)
  takes the grace path and returns the reference's rows (revenue rel
  1e-9, in order).  Q4 at the same conf is
  ``test_torch_join_slice.py::test_q4_multi_batch_sides_join_by_grace``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.data.column import host_to_device as j_upload
from spark_rapids_tpu.exec.joins import TpuShuffledHashJoinExec as JJoin
from spark_rapids_tpu.memory.spill import SpillFramework
from spark_rapids_tpu.utils import hashing as jh
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch.benchmarks import tpch, tpch_datagen
from spark_rapids_tpu_torch.data.column import HostBatch
from spark_rapids_tpu_torch.data.column import host_to_device as p_upload
from spark_rapids_tpu_torch.exec import joins as PJ
from spark_rapids_tpu_torch.interop import (from_reference_tables,
                                            to_reference_tables)
from spark_rapids_tpu_torch.utils import hashing as ph
from test_torch_kernels_hash import _pair

SF = 0.002
MULTI_BATCH = {"spark.rapids.tpu.sql.reader.batchSizeRows": 1024,
               "spark.rapids.tpu.sql.batchSizeBytes": 1,
               "spark.rapids.tpu.sql.broadcastSizeThreshold": 0}
SEEDS = [PJ.GRACE_SEED + PJ.GRACE_SEED_STEP * level for level in (0, 1, 6)]
KEYS = ["int", "bigint", "double", "date", "string"]


@pytest.fixture(scope="module", autouse=True)
def quick_reference_compiles():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(autouse=True)
def fresh_spill_framework():
    SpillFramework.reset()
    yield
    SpillFramework.reset()


@pytest.mark.parametrize("seed", SEEDS + [0x9E3779B9])
@pytest.mark.parametrize("names", [[t] for t in KEYS] + [KEYS],
                         ids=KEYS + ["all"])
def test_seeded_hash_matches_reference(names, seed):
    jcols, pcols = _pair(names, seed=seed % 1000 + len(names))
    want = np.asarray(jh.hash_device_batch(jcols, seed=seed))
    got = ph.hash_batch_plain(pcols, seed)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ph.hash_device_batch(pcols, seed=seed)
                                  .numpy(), want)
    for m in (2, 7, 64):
        np.testing.assert_array_equal(
            ph.hash_pids(pcols, m, seed=seed).numpy(),
            np.asarray(jh.pmod(jnp.asarray(want), m)))


def _join_pair(n=3000, seed=5):
    """The same two-key join planned by both packages (shuffled), and one
    left batch of ``n`` rows uploaded by each."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-50, 50, n)
    s = [None if i % 17 == 0 else f"s{v}" for i, v in
         enumerate(rng.integers(0, 30, n))]
    left = {"k": [None if i % 13 == 0 else int(v) for i, v in enumerate(k)],
            "s": s, "a": list(range(n))}
    right = {"k": [1, 2], "s": ["s1", "s2"], "b": [1.0, 2.0]}
    conf = {"spark.rapids.tpu.sql.broadcastSizeThreshold": 0}
    jsess = jsrt.Session(conf)
    jdf = jsess.create_dataframe(left).join(
        jsess.create_dataframe(right), on=["k", "s"], how="inner")
    psess = Session(conf, device="cpu")
    pdf = psess.create_dataframe(left).join(
        psess.create_dataframe(right), on=["k", "s"], how="inner")

    def join_exec(plan, cls):
        stack = [plan]
        while stack:
            node = stack.pop()
            if isinstance(node, cls):
                return node
            stack.extend(node.children)
        raise AssertionError(f"no {cls.__name__} in the plan")

    jx = join_exec(jsess.physical_plan(jdf.plan), JJoin)
    px = join_exec(psess.physical_plan(pdf.plan), PJ.TpuShuffledHashJoinExec)
    hb = HostBatch.from_pydict(left)
    jb = jsess.create_dataframe(left).plan.batches[0]
    return jx, px, j_upload(jb), p_upload(hb, device="cpu"), hb


@pytest.mark.parametrize("m", [2, 8])
@pytest.mark.parametrize("level", [0, 1])
def test_bucket_side_counts_match_reference(level, m):
    jx, px, jb, pb, hb = _join_pair()
    seed = PJ.GRACE_SEED + PJ.GRACE_SEED_STEP * level
    fw = SpillFramework.get()
    ids, want = jx._bucket_side([jb], jx.left_keys, m, fw, seed)
    for bucket in ids:  # untrack the reference's spillable buckets
        for bid in bucket:
            fw.remove_batch(bid)
    buckets, got = px._bucket_side([pb], px.left_keys, m, seed)
    assert got == want and sum(got) == hb.num_rows
    # each bucket holds its rows, in batch order
    keys = px._keys_of(p_upload(hb, device="cpu"), px.left_keys)
    pids = ph.hash_pids(keys, m, seed=seed).numpy()[:hb.num_rows]
    a = np.asarray(hb.column("a").data)
    for i in range(m):
        rows = a[pids == i]
        assert len(rows) == got[i]
        if got[i]:
            (piece,) = buckets[i]
            assert int(piece.num_rows) == got[i]
            np.testing.assert_array_equal(
                piece.columns[2].data[:got[i]].numpy(), rows)
            assert not piece.columns[2].validity[got[i]:].any()
        else:
            assert buckets[i] == []


def test_q3_multi_batch_sides_join_by_grace():
    ref_tables = to_reference_tables(tpch_datagen.tables(3, sf=SF, seed=3))
    jsess = jsrt.Session(MULTI_BATCH)
    jt = {}
    for name, (fields, arrays) in ref_tables.items():
        schema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in fields])
        jt[name] = jsess.create_dataframe(
            {n: arrays[n] for n, _ in fields}, schema)
    want = jtpch.q3(jt).collect()
    sess = Session(MULTI_BATCH, device="cpu")
    pt = {name: sess.create_dataframe(b)
          for name, b in from_reference_tables(ref_tables).items()}
    got = tpch.q3(pt).collect()
    m = sess.last_metrics
    assert m["TpuHashJoinExec.numLeftBatches"] > m[
        "TpuHashJoinExec.numJoinedPairs"]
    assert m["TpuHashJoinExec.numGracePairs"] > 0
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2:] == w[2:]
        assert g[1] == pytest.approx(w[1], rel=1e-9, abs=0)
