"""The out-of-core sort (``exec/sort.py``: each batch sorted into a run,
the runs tiled and merged) in spark_rapids_tpu_torch on CPU tensors
against the JAX package's device session, which sorts the same batches
with its tile merge (``spark_rapids_tpu/exec/sort.py:_sort_chunked``).

* The three cases of the reference's ``tests/test_out_of_core.py``
  external sort (ints, floats and strings, ascending; a descending key
  with nulls first; a string key first) under the same conf (256-row
  reader batches, a 16 KiB ``batchSizeBytes``, 64-row buckets), at one
  and two partitions: every partition reaches the sort as several
  batches, and the rows equal a Python sort of the same rows exactly,
  in order; one case also equals the reference's rows.
* A partition of one batch still sorts in one go, and the merge's
  output batches hold every row once.
* q67 at two partitions with a small ``batchSizeBytes`` (the cell that
  needs the merge on the card) is in ``test_torch_rollup_slice.py``.

The reference run starts from a reset spill catalog and compiles
without most XLA optimizations."""
import jax
import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import f as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.memory.spill import SpillFramework
from spark_rapids_tpu.plan import functions as JFN
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import f as PF
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.plan import functions as PFN

SMALL = {
    "spark.rapids.tpu.sql.reader.batchSizeRows": 256,
    "spark.rapids.tpu.sql.batchSizeBytes": 16 * 1024,
    "spark.rapids.tpu.sql.bucketMinRows": 64,
}


@pytest.fixture(scope="module", autouse=True)
def quick_reference_compiles():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


FIELDS = [("k", "int"), ("v", "bigint"), ("x", "double"), ("s", "string")]


def _data(n, seed):
    rng = np.random.default_rng(seed)
    null = rng.random((4, n)) < 0.05
    k = rng.integers(-20, 21, n)
    v = rng.integers(-1000, 1001, n)
    x = rng.normal(0, 100.0, n)
    s = ["".join(chr(97 + c) for c in rng.integers(0, 3, rng.integers(0, 9)))
         for _ in range(n)]
    cols = [k.tolist(), v.tolist(), x.tolist(), s]
    return {name: [None if null[i, r] else cols[i][r] for r in range(n)]
            for i, (name, _t) in enumerate(FIELDS)}


# (rows, seed, keys as (column, ascending, nulls first))
ASC = (True, True)
CASES = {
    "ints_floats_strings": (3000, 11, [("v",) + ASC, ("k",) + ASC,
                                       ("x",) + ASC, ("s",) + ASC]),
    "desc_nulls_first": (2500, 13, [("v", False, True), ("k",) + ASC,
                                    ("x",) + ASC, ("s",) + ASC]),
    "strings_first": (2000, 17, [("s",) + ASC, ("v",) + ASC,
                                 ("k",) + ASC, ("x",) + ASC]),
}


def _sorted(pkg, data, keys, n_partitions):
    if pkg == "port":
        sess, F, FN, T = Session(SMALL, device="cpu"), PF, PFN, PT
    else:
        SpillFramework.reset()
        sess, F, FN, T = jsrt.Session(SMALL), JF, JFN, JT
    schema = T.Schema([T.Field(n, T.from_name(t)) for n, t in FIELDS])
    df = sess.create_dataframe(data, schema, n_partitions=n_partitions)
    return sess, df.sort(*[FN.SortKey(F.col(c).expr, a, nf)
                           for c, a, nf in keys])


def _oracle(data, keys):
    """The rows sorted in Python: nulls first where asked, a descending
    key negated (the keys are ints, floats without NaN, and ASCII)."""
    names = [n for n, _t in FIELDS]
    rows = list(zip(*(data[n] for n in names)))

    def key(r):
        out = []
        for c, asc, nulls_first in keys:
            v = r[names.index(c)]
            if v is None:
                out.append((0 if nulls_first else 2,))
            else:
                out.append((1, v if asc else -v))
        return out

    return sorted(rows, key=key)


@pytest.mark.parametrize("n_partitions", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_external_sort_matches_oracle(case, n_partitions):
    """Rows with equal keys are equal rows here, so the order is the
    oracle's exactly."""
    n, seed, keys = CASES[case]
    data = _data(n, seed)
    psess, pq = _sorted("port", data, keys, n_partitions)
    got = pq.collect()
    assert psess.last_metrics["TpuSortExec.numInputBatches"] \
        >= 2 * n_partitions
    assert [repr(r) for r in got] == [repr(r) for r in _oracle(data, keys)]


def test_external_sort_matches_reference():
    """The reference's tile merge over the same batches gives the same
    rows (its compiles take most of this file's time: one case)."""
    n, seed, keys = CASES["desc_nulls_first"]
    data = _data(n, seed)
    _psess, pq = _sorted("port", data, keys, 2)
    got = pq.collect()
    _jsess, jq = _sorted("reference", data, keys, 2)
    want = jq.collect()
    SpillFramework.reset()
    assert len(got) == n
    assert [repr(r) for r in got] == [repr(r) for r in want]


def test_one_batch_sorts_in_one_go():
    data = _data(500, 3)
    sess = Session(device="cpu")
    df = sess.create_dataframe(data, PT.Schema(
        [PT.Field(n, PT.from_name(t)) for n, t in FIELDS]), n_partitions=1)
    rows = df.sort("v", "k").collect()
    assert sess.last_metrics["TpuSortExec.numInputBatches"] == 1
    key = [(r[1] is not None, r[1], r[0] is not None, r[0]) for r in rows]
    assert key == sorted(key)


def test_merge_emits_every_row_once():
    """The tile merge's output batches, concatenated, are the input's
    rows sorted: none lost, none repeated."""
    from spark_rapids_tpu_torch.data.column import (HostBatch,
                                                    device_to_host,
                                                    host_to_device)
    from spark_rapids_tpu_torch.exec.sort import TpuSortExec
    from spark_rapids_tpu_torch.ops.expression import BoundReference

    schema = PT.Schema([PT.Field(n, PT.from_name(t)) for n, t in FIELDS])
    data = _data(1200, 5)
    hb = HostBatch.from_pydict(data, schema)
    batches = [host_to_device(hb.slice(a, b), 64, "cpu")
               for a, b in ((0, 500), (500, 520), (520, 520), (520, 1200))]
    keys = [PFN.SortKey(BoundReference(1, PT.INT64, True), True, True),
            PFN.SortKey(BoundReference(0, PT.INT32, True), True, True)]
    sorter = TpuSortExec.__new__(TpuSortExec)
    sorter.keys = keys
    out = list(sorter._sort_chunked(batches))
    assert len(out) > 1
    rows = [r for b in out for r in device_to_host(b).to_rows()]
    key = lambda r: ((r[1] is not None, r[1] if r[1] is not None else 0),
                     (r[0] is not None, r[0] if r[0] is not None else 0))
    assert sorted(map(repr, rows)) == sorted(map(repr, hb.to_rows()))
    assert [key(r) for r in rows] == sorted(key(r) for r in rows)
