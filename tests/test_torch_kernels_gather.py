"""Plain version of K4 (stream compaction and gather) in
spark_rapids_tpu_torch, held against the JAX package's ``compact`` and
``gather_batch`` on the same numpy inputs.  Exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.data.column import DeviceBatch as JBatch
from spark_rapids_tpu.data.column import DeviceColumn as JCol
from spark_rapids_tpu.ops.kernels import gather as jg
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.data.column import DeviceBatch as PBatch
from spark_rapids_tpu_torch.data.column import DeviceColumn as PCol
from spark_rapids_tpu_torch.ops.kernels import gather as pg

N = 128
N_REAL = 117


def _batches(seed):
    """A batch of a double, a date and an 11-byte string column (with
    nulls and padding rows), for both packages."""
    rng = np.random.default_rng(seed)
    w = 11
    lengths = rng.integers(0, w + 1, N).astype(np.int32)
    bm = rng.integers(97, 123, (N, w)).astype(np.uint8)
    bm[np.arange(w)[None, :] >= lengths[:, None]] = 0
    specs = [
        ("double", np.round(rng.uniform(-1e3, 1e3, N), 2), None),
        ("date", rng.integers(9000, 9400, N).astype(np.int32), None),
        ("string", bm, lengths),
    ]
    names = ["d", "t", "s"]
    jcols, pcols = [], []
    for tname, data, ln in specs:
        valid = (rng.random(N) > 0.1) & (np.arange(N) < N_REAL)
        jcols.append(JCol(JT.from_name(tname), jnp.asarray(data),
                          jnp.asarray(valid),
                          None if ln is None else jnp.asarray(ln)))
        pcols.append(PCol(PT.from_name(tname), torch.from_numpy(data),
                          torch.from_numpy(valid),
                          None if ln is None else torch.from_numpy(ln)))
    jb = JBatch(JT.Schema([JT.Field(n, c.dtype) for n, c in
                           zip(names, jcols)]), jcols, N_REAL)
    pb = PBatch(PT.Schema([PT.Field(n, c.dtype) for n, c in
                           zip(names, pcols)]), pcols,
                torch.tensor(N_REAL, dtype=torch.int32))
    return jb, pb


def _assert_batches_equal(got: PBatch, want: JBatch):
    assert int(got.num_rows) == int(want.num_rows)
    for g, w in zip(got.columns, want.columns):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(g.validity.numpy(),
                                      np.asarray(w.validity))
        if w.lengths is not None:
            np.testing.assert_array_equal(g.lengths.numpy(),
                                          np.asarray(w.lengths))


@pytest.mark.parametrize("mask", ["random", "all_false", "all_true",
                                  "first_half"])
def test_compact_matches_reference(mask):
    jb, pb = _batches(3)
    rng = np.random.default_rng(4)
    keep = {"random": rng.random(N) > 0.4,
            "all_false": np.zeros(N, dtype=bool),
            "all_true": np.ones(N, dtype=bool),
            "first_half": np.arange(N) < N // 2}[mask]
    want = jg.compact(jb, jnp.asarray(keep))
    got = pg.compact(pb, torch.from_numpy(keep))
    assert got.num_rows.dtype == torch.int32 and got.num_rows.dim() == 0
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("with_mask", [False, True])
def test_gather_batch_matches_reference(with_mask):
    jb, pb = _batches(5)
    rng = np.random.default_rng(6)
    order = rng.permutation(N).astype(np.int32)
    mask = (rng.random(N) > 0.5) if with_mask else None
    want = jg.gather_batch(jb, jnp.asarray(order), 77,
                           None if mask is None else jnp.asarray(mask))
    got = pg.gather_batch(pb, torch.from_numpy(order),
                          torch.tensor(77, dtype=torch.int32),
                          None if mask is None else torch.from_numpy(mask))
    _assert_batches_equal(got, want)


def test_gather_array_takes_rows_of_a_byte_matrix():
    bm = torch.arange(24, dtype=torch.uint8).reshape(6, 4)
    got = pg.gather_array(bm, torch.tensor([5, 0, 5], dtype=torch.int32))
    assert got.tolist() == [bm[5].tolist(), bm[0].tolist(), bm[5].tolist()]
