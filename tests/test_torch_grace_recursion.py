"""The grace join's recursion in spark_rapids_tpu_torch (on CPU
tensors) against the JAX package's device session, on the reference's
case ``tests/test_out_of_core.py:147-191`` and the same numpy data: one
shuffle partition of 6,000 x 4,000 rows on 2,000 keys at a 1 KiB
``batchSizeBytes``, ~150x the target, so level-0 buckets are split
again.  A spy on ``_join_grace`` in both packages sees the same set of
levels, the deepest at least 1, and the rows are equal as multisets.
The reference's call takes ~60 s on one CPU (its compiles), the port's
~1 s, so this file holds it alone."""
import numpy as np

from spark_rapids_tpu.exec.joins import TpuHashJoinExec as JJoin
from spark_rapids_tpu_torch.exec.joins import TpuHashJoinExec as PJoin
from test_torch_grace_join import (_both, fresh_spill_framework,  # noqa: F401
                                   quick_reference_compiles)


def test_grace_join_recursion_levels_match_reference(monkeypatch):
    levels = {"ref": [], "port": []}

    def spy(cls, key):
        orig = cls._join_grace

        def wrapped(self, l, r, total, target, level=0, *args, **kwargs):
            levels[key].append(level)
            return orig(self, l, r, total, target, level, *args, **kwargs)
        monkeypatch.setattr(cls, "_join_grace", wrapped)

    spy(JJoin, "ref")
    spy(PJoin, "port")
    rng = np.random.RandomState(31)
    n_l, n_r = 6000, 4000
    left = {"k": rng.randint(0, 2000, n_l).tolist(), "a": list(range(n_l))}
    right = {"k": rng.randint(0, 2000, n_r).tolist(),
             "b": [float(i) for i in range(n_r)]}
    conf = {
        "spark.rapids.tpu.sql.shuffle.partitions": 1,
        "spark.rapids.tpu.sql.batchSizeBytes": 1024,
        "spark.rapids.tpu.sql.reader.batchSizeRows": 8192,
        "spark.rapids.tpu.sql.bucketMinRows": 64,
        "spark.rapids.tpu.sql.broadcastSizeThreshold": 0,
        "spark.rapids.tpu.sql.adaptive.enabled": False,
    }
    want, got, sess = _both(conf, left, right, "inner")
    assert got == want and len(got) > 0
    assert set(levels["port"]) == set(levels["ref"])
    assert max(levels["port"]) >= 1
    assert sess.last_metrics["TpuHashJoinExec.graceMaxLevel"] == max(
        levels["port"])
