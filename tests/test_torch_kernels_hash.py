"""The plain version of K9 (Spark Murmur3, seed 42) in
spark_rapids_tpu_torch, held against the JAX package's
``utils/hashing.py:hash_device_batch`` and ``pmod`` on the same numpy
inputs.  Exact: every hash and every partition id for n_out 2, 3 and 8.

Every hashable type alone and all of them folded together: int8, int16,
int32, int64, bool, date32, timestamp, float32 and float64 (with -0.0,
0.0, NaN and the infinities), and strings with empty rows, lengths with
0-3 tail bytes and bytes >= 0x80 (signed tail bytes); every column has
null rows, and the string matrix is wider than its longest string."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.data.column import DeviceColumn as JCol
from spark_rapids_tpu.utils import hashing as jh
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.data.column import DeviceColumn as PCol
from spark_rapids_tpu_torch.utils import hashing as ph

N = 512
TYPES = ["tinyint", "smallint", "int", "bigint", "boolean", "date",
         "timestamp", "float", "double", "string"]


def _column(name, rng):
    """(data, lengths) of one column of type ``name``."""
    if name == "string":
        w = 11  # wider than the longest string (9 bytes)
        bm = np.zeros((N, w), dtype=np.uint8)
        ln = rng.integers(0, 10, N).astype(np.int32)
        for i, n in enumerate(ln):
            bm[i, :n] = rng.integers(0, 256, n)
        return bm, ln
    if name in ("float", "double"):
        v = rng.choice([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.25,
                        3.0e7, 1e-3], N)
        return v.astype(np.float32 if name == "float" else np.float64), None
    if name == "boolean":
        return rng.random(N) > 0.5, None
    dtype = {"tinyint": np.int8, "smallint": np.int16, "int": np.int32,
             "date": np.int32, "bigint": np.int64,
             "timestamp": np.int64}[name]
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, N, dtype=dtype,
                        endpoint=True), None


def _pair(names, seed):
    """The same columns as the reference's and the port's DeviceColumns."""
    rng = np.random.default_rng(seed)
    jcols, pcols = [], []
    for name in names:
        data, ln = _column(name, rng)
        valid = rng.random(N) > 0.2
        jcols.append(JCol(JT.from_name(name), jnp.asarray(data),
                          jnp.asarray(valid),
                          None if ln is None else jnp.asarray(ln)))
        pcols.append(PCol(PT.from_name(name), torch.from_numpy(data),
                          torch.from_numpy(valid),
                          None if ln is None else torch.from_numpy(ln)))
    return jcols, pcols


@pytest.mark.parametrize("names", [[t] for t in TYPES] + [TYPES],
                         ids=TYPES + ["all"])
def test_hash_matches_reference(names):
    jcols, pcols = _pair(names, seed=len(names[0]) * 7 + len(names))
    want = np.asarray(jh.hash_device_batch(jcols))
    got = ph.hash_device_batch(pcols)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for n_out in (2, 3, 8):
        want_p = np.asarray(jh.pmod(jnp.asarray(want), n_out))
        got_p = ph.hash_pids(pcols, n_out)
        np.testing.assert_array_equal(got_p.numpy(), want_p)
        assert got_p.min() >= 0 and got_p.max() < n_out


def test_string_tails_and_signed_bytes():
    """Lengths 0-7 over bytes >= 0x80: every tail length, each tail byte
    sign-extended; the aligned word count comes from the lengths, not
    from the matrix width."""
    w = 8
    bm = np.full((8, w), 0xE9, dtype=np.uint8)
    ln = np.arange(8, dtype=np.int32)
    bm[np.arange(w)[None, :] >= ln[:, None]] = 0
    valid = np.ones(8, dtype=bool)
    want = np.asarray(jh.hash_device_batch([JCol(
        JT.STRING, jnp.asarray(bm), jnp.asarray(valid), jnp.asarray(ln))]))
    got = ph.hash_device_batch([PCol(
        PT.STRING, torch.from_numpy(bm), torch.from_numpy(valid),
        torch.from_numpy(ln))])
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want.tolist())) == 8


def test_null_rows_pass_the_running_hash():
    jcols, pcols = _pair(["bigint", "string"], seed=5)
    for c in pcols:
        c.validity[:] = False
    got = ph.hash_device_batch(pcols)
    assert bool((got == ph.SEED).all())
