"""Plain versions of K1 (key passes + sort permutation), K2 (segment ids)
and K3 (segmented reduction) in spark_rapids_tpu_torch, held against the
JAX package's device functions on the same numpy inputs.

Permutations, key passes and segment ids must be bit-identical; float
sums agree to rel 1e-9 (another summation order); everything else must
be equal (NaN equal to NaN)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.data.column import DeviceColumn as JCol
from spark_rapids_tpu.ops.kernels import segment as jseg
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.data.column import DeviceColumn as PCol
from spark_rapids_tpu_torch.ops.kernels import segment as pseg

N = 96       # rows per case: padded rows included
N_REAL = 83  # rows below num_rows; the rest are padding

KINDS = ["int32", "int64", "float64", "date", "bool", "str1", "str11"]


def _column(kind, rng, n=N):
    """(type name, data, validity, lengths) with nulls, and for floats
    NaN, +-0.0 and +-inf; strings share prefixes and differ in length."""
    valid = rng.random(n) > 0.15
    lengths = None
    if kind == "int32":
        data = rng.integers(-4, 4, n).astype(np.int32)
        tname = "int"
    elif kind == "int64":
        data = rng.choice(np.array([-2 ** 62, -7, 0, 7, 2 ** 62 + 1]), n)
        tname = "bigint"
    elif kind == "float64":
        data = rng.choice(np.array([0.0, -0.0, 1.5, -2.5, np.inf, -np.inf,
                                    np.nan, 1e300]), n)
        tname = "double"
    elif kind == "date":
        data = rng.integers(9000, 9006, n).astype(np.int32)
        tname = "date"
    elif kind == "bool":
        data = rng.random(n) > 0.5
        tname = "boolean"
    else:
        w = 1 if kind == "str1" else 11
        alphabet = np.frombuffer(b"ABN" if w == 1 else b"ab", dtype=np.uint8)
        data = alphabet[rng.integers(0, len(alphabet), (n, w))]
        if w > 1:
            data[:, :4] = np.frombuffer(b"pre_", dtype=np.uint8)
        lengths = (rng.integers(1, w + 1, n) if w > 1
                   else np.ones(n)).astype(np.int32)
        data = np.where(np.arange(w)[None, :] < lengths[:, None], data, 0
                        ).astype(np.uint8)
        tname = "string"
    return tname, data, valid, lengths


def _both(spec):
    tname, data, valid, lengths = spec
    j = JCol(JT.from_name(tname), jnp.asarray(data), jnp.asarray(valid),
             None if lengths is None else jnp.asarray(lengths))
    p = PCol(PT.from_name(tname), torch.from_numpy(np.array(data)),
             torch.from_numpy(np.array(valid)),
             None if lengths is None else torch.from_numpy(lengths))
    return j, p


def _signed_order(u) -> np.ndarray:
    """The reference's uint64 pass as this package's signed-order int64."""
    return np.asarray(u).astype(np.uint64).view(np.int64) ^ np.int64(
        -2 ** 63)


def _pad_mask():
    return np.arange(N) < N_REAL


@pytest.mark.parametrize("desc,nulls_first",
                         [(False, True), (True, False), (False, False),
                          (True, True)])
@pytest.mark.parametrize("kind", KINDS)
def test_key_passes_match_reference(kind, desc, nulls_first):
    rng = np.random.default_rng(KINDS.index(kind))
    j, p = _both(_column(kind, rng))
    want = jseg.key_passes_device([j], [desc], [nulls_first])
    got = pseg.key_passes([p], [desc], [nulls_first])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _signed_order(w))


@pytest.mark.parametrize("kinds", [
    ["str1", "str1"], ["float64", "int32"], ["str11", "bool"],
    ["date", "int64", "float64"], ["int32"], ["str11"]])
@pytest.mark.parametrize("desc", [False, True])
def test_lexsort_and_segment_ids_match_reference(kinds, desc):
    rng = np.random.default_rng(len(kinds) * 7 + desc)
    pairs = [_both(_column(k, rng)) for k in kinds]
    jcols = [j for j, _ in pairs]
    pcols = [p for _, p in pairs]
    pad = _pad_mask()
    descs = [desc ^ (i % 2 == 1) for i in range(len(kinds))]
    nfs = [i % 2 == 0 for i in range(len(kinds))]
    want = np.asarray(jseg.lexsort_device(jcols, descs, nfs,
                                          pad_valid=jnp.asarray(pad)))
    got = pseg.lexsort_device(pcols, descs, nfs,
                              pad_valid=torch.from_numpy(pad))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)

    # segment ids over the keys in sorted order, padding rows last
    from spark_rapids_tpu.ops.kernels import gather as jg
    from spark_rapids_tpu_torch.ops.kernels import gather as pg

    order_j = jnp.asarray(want)
    order_p = torch.from_numpy(np.array(want))
    sj = [jg.gather_column(c, order_j) for c in jcols]
    sp = [pg.gather_column(c, order_p) for c in pcols]
    want_ids = np.asarray(jseg.segment_ids_device(
        sj, pad_valid=jnp.asarray(pad[want])))
    got_ids = pseg.segment_ids_device(sp, pad_valid=torch.from_numpy(
        pad[want]))
    assert got_ids.dtype == torch.int32
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)


def _sorted_ids(rng):
    """Segment ids of a sorted one-byte key with padding rows last (each
    padding row its own segment), as the aggregate builds them."""
    keys = np.sort(rng.integers(0, 4, N_REAL))
    change = np.ones(N, dtype=bool)
    change[1:N_REAL] = keys[1:] != keys[:-1]
    return (np.cumsum(change) - 1).astype(np.int32)


VALUE_KINDS = {
    "float64": lambda rng: rng.choice(np.array(
        [0.0, -0.0, 1.25, -3.5, np.inf, -np.inf, np.nan, 1e17]), N),
    "float64_finite": lambda rng: np.round(rng.uniform(-1e6, 1e6, N), 2),
    "int64": lambda rng: rng.integers(-2 ** 40, 2 ** 40, N),
    "int32": lambda rng: rng.integers(-1000, 1000, N).astype(np.int32),
    "bool": lambda rng: rng.random(N) > 0.5,
}
OPS = ["count", "sum", "min", "max", "first", "last", "first_any",
       "last_any"]


def _assert_same(got, want, rel=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if rel is not None and np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=rel, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


# the reference has no min/max over booleans
REDUCE_CASES = [(v, op) for v in sorted(VALUE_KINDS) for op in OPS
                if not (v == "bool" and op in ("min", "max"))]


@pytest.mark.parametrize("vkind,op", REDUCE_CASES)
def test_segment_reduce_matches_reference(vkind, op):
    rng = np.random.default_rng(sorted(VALUE_KINDS).index(vkind) * 11
                                + OPS.index(op))
    ids = _sorted_ids(rng)
    values = VALUE_KINDS[vkind](rng)
    valid = (rng.random(N) > 0.2) & _pad_mask()
    present = _pad_mask()
    want_v, want_ok = jseg.segment_reduce_device(
        jnp.asarray(values), jnp.asarray(valid), jnp.asarray(ids), N, op,
        present=jnp.asarray(present))
    got_v, got_ok = pseg.segment_reduce_device(
        torch.from_numpy(np.array(values)), torch.from_numpy(valid),
        torch.from_numpy(ids), N, op, present=torch.from_numpy(present))
    _assert_same(got_ok, want_ok)
    _assert_same(got_v, want_v, rel=1e-9 if op == "sum" else None)


def test_segment_min_index_matches_reference_segment_starts():
    import jax

    rng = np.random.default_rng(5)
    ids = _sorted_ids(rng)
    want = jax.ops.segment_min(jnp.arange(N, dtype=jnp.int64),
                               jnp.asarray(ids), num_segments=N)
    got = pseg.segment_min_index(torch.from_numpy(ids), N)
    _assert_same(got, want)


def test_no_key_segments_drop_ids_past_the_segment_count():
    """The no-key aggregate numbers padding rows row + 1, so the last id
    equals the segment count and must be dropped, as JAX drops it."""
    lane = np.arange(N, dtype=np.int32)
    ids = np.where(_pad_mask(), 0, lane + 1).astype(np.int32)
    values = np.round(np.random.default_rng(2).uniform(0, 100, N), 2)
    valid = _pad_mask()
    want_v, want_ok = jseg.segment_reduce_device(
        jnp.asarray(values), jnp.asarray(valid), jnp.asarray(ids), N, "sum")
    got_v, got_ok = pseg.segment_reduce_device(
        torch.from_numpy(values), torch.from_numpy(valid),
        torch.from_numpy(ids), N, "sum")
    _assert_same(got_ok, want_ok)
    _assert_same(got_v, want_v, rel=1e-9)
