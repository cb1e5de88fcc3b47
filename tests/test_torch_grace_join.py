"""The grace hash join of spark_rapids_tpu_torch (on CPU tensors, where
every wrapper takes its plain PyTorch version) against the JAX package's
device session, on the reference's own out-of-core cases
(``tests/test_out_of_core.py:122-191``) and the same numpy data.

* Inner, left, right, full, semi and anti joins of 3,000 x 2,000 rows
  on 40 keys under the reference's ``SMALL`` conf (256-row reader
  batches, a 16 KiB ``batchSizeBytes``, 64-row buckets) with
  ``broadcastSizeThreshold`` 0: both sides reach the shuffled join as
  several batches, so it joins bucket by bucket.  Rows equal as
  multisets (grace output comes in bucket order).  The reference's
  right join alone takes ~45 s here (it compiles ~900 programs).

The recursion case is ``test_torch_grace_recursion.py``.
"""
import jax
import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.memory.spill import SpillFramework
from spark_rapids_tpu_torch import Session

SMALL = {
    "spark.rapids.tpu.sql.reader.batchSizeRows": 256,
    "spark.rapids.tpu.sql.batchSizeBytes": 16 * 1024,
    "spark.rapids.tpu.sql.bucketMinRows": 64,
    "spark.rapids.tpu.sql.broadcastSizeThreshold": 0,
}


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


def _both(conf, left, right, how):
    """The join's rows from the reference's device session and from the
    port, each sorted by repr, and the port session."""
    out = []
    for sess in (jsrt.Session(dict(conf)), Session(dict(conf),
                                                   device="cpu")):
        df = sess.create_dataframe(left).join(sess.create_dataframe(right),
                                              on="k", how=how)
        out.append(sorted(map(repr, df.collect())))
    return out[0], out[1], sess


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi",
                                 "anti"])
def test_grace_join_matches_reference(how):
    rng = np.random.RandomState(19)
    n_l, n_r = 3000, 2000
    left = {"k": rng.randint(0, 40, n_l).tolist(), "a": list(range(n_l))}
    right = {"k": rng.randint(0, 40, n_r).tolist(),
             "b": [float(i) for i in range(n_r)]}
    want, got, sess = _both(SMALL, left, right, how)
    assert got == want
    assert len(got) > 0 or how == "anti"  # every left key has a match
    m = sess.last_metrics
    assert m["TpuHashJoinExec.numGracePairs"] > 0
    assert m["TpuHashJoinExec.numGraceBuckets"] >= 2 * m[
        "TpuHashJoinExec.numJoinedPairs"]
    assert all(r["left_batches"] > 1 or r["right_batches"] > 1
               for r in sess.last_joins)
