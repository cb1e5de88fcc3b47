"""The plain versions of K10 (packed partition build and slice) and K11
(range partition ids) in spark_rapids_tpu_torch, held against the JAX
package's ``shuffle/device_shuffle.py:packed_build``/``packed_slice`` and
``exec/exchange.py:range_key_passes``/``range_pids_from_bounds``/
``pick_bounds_host`` on the same numpy inputs.  Exact: the counts, the
starts and every column of every slice (data, validity, lengths) at the
block's padded size; the range key passes (the reference's uint64 passes
turned into the port's signed-order int64 in the test), the bounds and
every partition id.

The batch has int64, string (bytes >= 0x80, strings longer than the
32-byte range prefix, and strings that agree on it), float64 (NaN,
-0.0) and date columns with null rows and padding rows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.data.column import DeviceBatch as JBatch
from spark_rapids_tpu.data.column import DeviceColumn as JCol
from spark_rapids_tpu.exec import exchange as jex
from spark_rapids_tpu.ops.expression import BoundReference as JRef
from spark_rapids_tpu.plan.functions import SortKey as JKey
from spark_rapids_tpu.shuffle import device_shuffle as jds
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.data.column import DeviceBatch as PBatch
from spark_rapids_tpu_torch.data.column import DeviceColumn as PCol
from spark_rapids_tpu_torch.exec import exchange as pex
from spark_rapids_tpu_torch.ops.expression import BoundReference as PRef
from spark_rapids_tpu_torch.plan.functions import SortKey as PKey
from spark_rapids_tpu_torch.shuffle import device_shuffle as pds

PADDED, ROWS = 256, 201
NAMES = [("k", "bigint"), ("s", "string"), ("d", "double"),
         ("t", "date")]
WORDS = ["", "a", "ab", "abc", "é", "éé", "x" * 40, "x" * 40 + "y",
         "x" * 33, "z"]
SIGN = np.int64(-2 ** 63)


def _strings(rng):
    raw = [w.encode() for w in rng.choice(WORDS, PADDED)]
    w = max(len(b) for b in raw) + 2
    bm = np.zeros((PADDED, w), dtype=np.uint8)
    for i, b in enumerate(raw):
        bm[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    return bm, np.array([len(b) for b in raw], dtype=np.int32)


def _batches(seed):
    """The same batch as the reference's and the port's DeviceBatch."""
    rng = np.random.default_rng(seed)
    bm, ln = _strings(rng)
    arrays = [
        (rng.integers(-5, 6, PADDED).astype(np.int64), None),
        (bm, ln),
        (rng.choice([np.nan, -0.0, 0.0, 1.5, -3.0, 2.5], PADDED), None),
        (rng.integers(9000, 9005, PADDED).astype(np.int32), None),
    ]
    rows = np.arange(PADDED) < ROWS
    jcols, pcols = [], []
    for (name, t), (data, lengths) in zip(NAMES, arrays):
        valid = (rng.random(PADDED) > 0.15) & rows
        jcols.append(JCol(JT.from_name(t), jnp.asarray(data),
                          jnp.asarray(valid),
                          None if lengths is None else jnp.asarray(lengths)))
        pcols.append(PCol(PT.from_name(t), torch.from_numpy(data),
                          torch.from_numpy(valid),
                          None if lengths is None
                          else torch.from_numpy(lengths)))
    jschema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in NAMES])
    pschema = PT.Schema([PT.Field(n, PT.from_name(t)) for n, t in NAMES])
    return (JBatch(jschema, jcols, jnp.int32(ROWS)),
            PBatch(pschema, pcols, torch.tensor(ROWS, dtype=torch.int32)))


def _same_columns(pcols, jcols):
    for p, j in zip(pcols, jcols):
        np.testing.assert_array_equal(p.validity.numpy(),
                                      np.asarray(j.validity))
        np.testing.assert_array_equal(p.data.numpy(), np.asarray(j.data))
        if j.lengths is not None:
            np.testing.assert_array_equal(p.lengths.numpy(),
                                          np.asarray(j.lengths))


@pytest.mark.parametrize("n_out", [2, 3, 8])
def test_packed_build_and_slices_match_reference(n_out):
    jb, pb = _batches(seed=n_out)
    rng = np.random.default_rng(100 + n_out)
    pids = rng.integers(0, n_out, PADDED).astype(np.int32)
    jblock, jcounts, jstarts = jds.packed_build(jb, jnp.asarray(pids), n_out)
    pblock, pcounts, pstarts = pds.packed_build(pb, torch.from_numpy(pids),
                                                n_out)
    np.testing.assert_array_equal(pcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(pstarts.numpy(), np.asarray(jstarts))
    assert int(pcounts.sum()) == ROWS
    assert int(pblock.num_rows) == ROWS
    _same_columns(pblock.columns, jblock.columns)
    for p in range(n_out):
        start, count = int(pstarts[p]), int(pcounts[p])
        js = jds.packed_slice(jblock, jnp.int32(start), jnp.int32(count))
        ps = pds.packed_slice(pblock, start, count)
        assert ps.padded_rows == PADDED and int(ps.num_rows) == count
        assert int(js.num_rows) == count
        _same_columns(ps.columns, js.columns)


def _keys(which, ascending):
    """(reference keys, port keys) over the batch's columns."""
    jk, pk = [], []
    for i, asc in zip(which, ascending):
        t = JT.from_name(NAMES[i][1])
        jk.append(JKey(JRef(i, t, True, NAMES[i][0]), asc))
        pk.append(PKey(PRef(i, PT.from_name(NAMES[i][1]), True,
                            NAMES[i][0]), asc))
    return jk, pk


def _signed(u64) -> np.ndarray:
    """The reference's uint64 passes in the port's signed-order int64."""
    return np.asarray(u64).view(np.int64) ^ SIGN


@pytest.mark.parametrize("which,ascending", [
    ([2, 3], [False, True]),       # Q3's sort: revenue desc, date
    ([1, 0], [True, True]),        # a string first: no pass after it
    ([0, 1, 2], [True, False, True]),
    ([3], [False]),
], ids=["double-date", "string-first", "int-string-double", "date-desc"])
@pytest.mark.parametrize("n_out", [2, 3, 8])
def test_range_passes_bounds_and_pids_match_reference(which, ascending,
                                                      n_out):
    jb, pb = _batches(seed=7 * n_out + len(which))
    jk, pk = _keys(which, ascending)
    jpasses = _signed(jex.range_key_passes(jb, jk))
    ppasses = pex.range_key_passes(pb, pk)
    np.testing.assert_array_equal(ppasses.numpy(), jpasses)
    # samples of the whole batch as the write path takes them
    psamp = pex.range_samples(ppasses, pb.num_rows)
    idx = (np.arange(pex.RANGE_SAMPLES_PER_BATCH) * ROWS
           ) // pex.RANGE_SAMPLES_PER_BATCH
    np.testing.assert_array_equal(psamp.numpy(), jpasses[:, idx])
    usamp = np.asarray(jex.range_key_passes(jb, jk))[:, idx]
    jbounds = jex.pick_bounds_host(usamp, n_out)
    pbounds = pex.pick_bounds_host(psamp.numpy(), n_out)
    np.testing.assert_array_equal(pbounds, _signed(jbounds))
    jpids = np.asarray(jex.range_pids_from_bounds(
        jnp.asarray(np.asarray(jex.range_key_passes(jb, jk))),
        jnp.asarray(jbounds)))
    ppids = pex.range_pids_from_bounds(ppasses, torch.from_numpy(pbounds))
    np.testing.assert_array_equal(ppids.numpy(), jpids)
    assert ppids.min() >= 0 and ppids.max() < n_out


def test_string_prefix_is_cut_and_later_keys_dropped():
    _jb, pb = _batches(seed=1)
    _jk, pk = _keys([1, 0], [True, True])
    passes = pex.range_key_passes(pb, pk)
    # null rank + 32 prefix bytes as four passes; the int key adds none
    assert passes.shape == (5, PADDED)
