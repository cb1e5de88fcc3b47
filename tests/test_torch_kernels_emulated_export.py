"""K26 (the ML export's feature matrix, ``csrc/feature_matrix.cu``) and
K12's rules for CaseWhen, Greatest, Least, Pmod, Remainder,
IntegralDivide, Abs and UnaryMinus, built for the CPU with the host C++
compiler against ``csrc/emulator/cuda_runtime.h``
(``test_torch_kernels_emulated._build_emulated``) and held against their
plain PyTorch versions on the same inputs.

K26 runs over every input type (bool, int8, int16, int32, int64, float32,
float64, date, timestamp), with nulls in each column, NaN, +-inf, -0.0
and int64 values past 2**24 (where the float32 rounding matters, also
against numpy's ``astype(np.float32)``), at 0, 1, 2,047, 2,048 and 2,049
logical rows (a tile is 2,048), over several batches of one output, and
for k = 1 to 16 columns.  Every comparison is bit for bit, with the
launch counts.  K12 runs a Filter -> Project segment of the new rules
over nulls, NaN, +-0.0, zero and -1 divisors and integer extremes, data,
validity and lengths compared in full.

Mutation check: a K26 that ignores each tile's offset, built from an
edited copy of ``feature_matrix.cu``, must disagree with the plain
version on a batch of several tiles."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import f as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.column import (DeviceBatch, DeviceColumn,
                                                HostBatch, bucket_rows,
                                                host_to_device)
from spark_rapids_tpu_torch.ops.kernels import _build as B
from spark_rapids_tpu_torch.ops.kernels import export as K
from test_torch_kernels_emulated import (_build_emulated,
                                         _build_generated_emulated)
from test_torch_kernels_emulated_generate import (_check, _mutant,
                                                  _segments)

TYPES = [T.BOOL, T.INT8, T.INT16, T.INT32, T.INT64, T.FLOAT32, T.FLOAT64,
         T.DATE32, T.TIMESTAMP]
I64 = np.iinfo(np.int64)


@pytest.fixture(scope="module")
def emu():
    out = _build_emulated()
    return B.Kernels(lambda: out, lambda t: None, _build_generated_emulated)


def _values(rng, dtype, n):
    if dtype == T.BOOL:
        return rng.random(n) > 0.5
    if dtype.is_floating:
        v = rng.normal(0, 1e6, n)
        special = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e300, -1e-300,
                   16777217.0]
        v[:min(n, len(special))] = special[:n]
        with np.errstate(over="ignore"):  # 1e300 to float32: inf
            return v.astype(dtype.np_dtype)
    if dtype in (T.INT64, T.TIMESTAMP):
        v = rng.integers(-2**62, 2**62, n, dtype=np.int64)
        special = [I64.min, I64.max, 2**24 + 1, 2**53 + 1, -(2**24 + 3),
                   (2**24 + 1) * 3]
        v[:min(n, len(special))] = special[:n]
        return v
    info = np.iinfo(dtype.np_dtype)
    return rng.integers(info.min, info.max, n, dtype=np.int64,
                        endpoint=True).astype(dtype.np_dtype)


def _batch(types, n, seed, null_every=7):
    """A device batch (CPU tensors) of ``types`` with ``n`` logical rows
    padded to their bucket: column c null on every ``null_every``-th row
    from row c, garbage data and validity on the padding rows."""
    rng = np.random.default_rng(seed)
    p = bucket_rows(n)
    cols = []
    for c, dt in enumerate(types):
        data = _values(rng, dt, p)
        valid = rng.random(p) > 0.5   # the padding rows: anything
        valid[:n] = True
        if null_every:
            valid[c % null_every:n:null_every] = False
        cols.append(DeviceColumn(dt, torch.from_numpy(data),
                                 torch.from_numpy(valid)))
    schema = T.Schema([T.Field(f"c{i}", dt) for i, dt in enumerate(types)])
    return DeviceBatch(schema, cols, torch.tensor(n, dtype=torch.int32))


def _same_bits(got, want):
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _k26(emu, batches, names):
    want = K.feature_matrix_plain(batches, names)
    before = K.FEATURE_LAUNCHES.count
    got = K.feature_matrix(batches, names, kernels=emu)
    kept = [int(b.num_rows) > 0 for b in batches]
    # per batch: the count and the scan, then the write where rows remain
    assert K.FEATURE_LAUNCHES.count - before == 2 * len(batches) + sum(
        1 for b, m in zip(batches, kept) if m and _kept_rows(b, names))
    _same_bits(got, want)
    return got


def _kept_rows(batch, names):
    n = int(batch.num_rows)
    v = torch.ones(n, dtype=torch.bool)
    for name in names:
        v &= batch.columns[batch.schema.index_of(name)].validity[:n]
    return int(v.sum())


@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049])
def test_k26_every_type_matches_plain(emu, n):
    b = _batch(TYPES, n, seed=n)
    names = [f.name for f in b.schema]
    got = _k26(emu, [b], names)
    assert got.shape == (_kept_rows(b, names), len(TYPES))


def test_k26_no_nulls_keeps_every_row(emu):
    b = _batch(TYPES, 300, seed=3, null_every=0)
    got = _k26(emu, [b], [f.name for f in b.schema])
    assert got.shape == (300, len(TYPES))


@pytest.mark.parametrize("k", [1, 2, 5, 16])
def test_k26_k_columns_match_plain(emu, k):
    types = [TYPES[i % len(TYPES)] for i in range(k)]
    b = _batch(types, 2100, seed=k, null_every=11)
    _k26(emu, [b], [f.name for f in b.schema])


def test_k26_several_batches_and_a_subset_match_plain(emu):
    types = [T.INT64, T.FLOAT64, T.INT32, T.BOOL]
    batches = [_batch(types, n, seed=n) for n in (700, 0, 1, 2049, 37)]
    _k26(emu, batches, ["c3", "c0", "c1"])
    got = _k26(emu, batches, ["c2"])
    assert got.shape[0] == sum(_kept_rows(b, ["c2"]) for b in batches)


def test_k26_int64_rounds_as_numpy(emu):
    """int64 past 2**24 to float32: round to nearest even, as numpy's
    astype does (both sides of every tie and the type's extremes)."""
    edge = np.array([2**24 + 1, 2**24 + 3, -(2**24 + 1), 2**25 + 2,
                     2**25 + 6, 2**53 + 1, 2**62 + 2**38, I64.min, I64.max,
                     (1 << 40) + (1 << 16) + 1], dtype=np.int64)
    rng = np.random.default_rng(8)
    data = np.concatenate([edge, rng.integers(I64.min, I64.max, 500,
                                              dtype=np.int64)])
    n = len(data)
    p = bucket_rows(n)
    col = DeviceColumn(T.INT64, torch.from_numpy(np.pad(data, (0, p - n))),
                       torch.ones(p, dtype=torch.bool))
    b = DeviceBatch(T.Schema([T.Field("x", T.INT64)]), [col],
                    torch.tensor(n, dtype=torch.int32))
    got = _k26(emu, [b], ["x"])
    want = data.astype(np.float32)
    assert np.array_equal(got[:, 0].numpy().view(np.int32),
                          want.view(np.int32))


def test_k26_strings_are_refused():
    hb = HostBatch.from_pydict({"s": ["a", "b"]},
                               T.Schema([T.Field("s", T.STRING)]))
    b = host_to_device(hb, 128, "cpu")
    with pytest.raises(TypeError, match="string"):
        K.feature_matrix([b], ["s"])


def test_k26_without_tile_offsets_mutant_differs():
    mutant = _mutant("feature_matrix",
                     ("long long at = tile_offsets[blockIdx.x];",
                      "long long at = 0;"))
    b = _batch([T.INT32, T.FLOAT64], 5000, seed=21, null_every=5)
    names = ["c0", "c1"]
    want = K.feature_matrix_plain([b], names)
    got = K.feature_matrix([b], names, kernels=mutant)
    assert got.shape == want.shape
    assert not torch.equal(got.view(torch.int32), want.view(torch.int32))


# --------------------------------------------------------------------------
# K12: the rules of the new expressions
# --------------------------------------------------------------------------
ARITH_FIELDS = [("a", "bigint"), ("b", "bigint"), ("i", "int"),
                ("x", "double"), ("y", "double"), ("f", "float"),
                ("s", "string")]


def arith_data():
    """Columns (name -> Python values) of ``ARITH_FIELDS``: integers
    with the type's extremes, zero and -1 divisors; doubles and floats
    with NaN, +-0.0 and +-inf; nulls in every column; strings."""
    n = 300
    rng = np.random.default_rng(17)
    i64 = rng.integers(-10**6, 10**6, n, dtype=np.int64)
    i64[:6] = [I64.min, I64.max, -7, 7, 0, -1]
    d = rng.integers(-4, 5, n, dtype=np.int64)   # zero and -1 divisors
    d[:6] = [-1, -1, 2, -2, 3, 0]
    x = rng.normal(0, 10, n)
    y = rng.normal(0, 10, n)
    x[:8] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 5.5, np.nan, -0.0]
    y[:8] = [1.0, 0.0, -0.0, np.nan, -2.0, -0.0, np.nan, -0.0]
    i32 = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    i32[:3] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, -5]

    def nulls(vals, every):
        return [None if i % every == 3 else v for i, v in
                enumerate(vals.tolist())]

    return {"a": nulls(i64, 13), "b": nulls(d, 11), "i": nulls(i32, 9),
            "x": nulls(x, 7), "y": nulls(y, 5),
            "f": nulls(y.astype(np.float32), 6),
            "s": [None if i % 8 == 2 else f"v{i % 5}" for i in range(n)]}


def arith_frame(query=None, conf=None):
    """(session, DataFrame, device batch of its table): ``query`` (by
    default ``arith_query``, a Filter -> Project over every new
    expression of this slice) over ``arith_data`` on CPU tensors."""
    sess = Session(conf, device="cpu")
    hb = HostBatch.from_pydict(arith_data(), T.Schema(
        [T.Field(n, T.from_name(t)) for n, t in ARITH_FIELDS]))
    df = sess.create_dataframe(hb, n_partitions=1)
    return sess, (query or arith_query)(df, F), \
        host_to_device(hb, 128, "cpu")


def arith_query(df, F):
    """The new expressions over ``arith_frame``'s columns (``F`` is the
    package's functions module, so the reference runs the same query)."""
    c = F.col
    return df.filter(c("i").is_null() |
                     (c("i") > F.lit(-1_500_000_000))).select(
        c("a").alias("a"),
        (c("a") % c("b")).alias("rem"),
        (c("i") % F.lit(-1)).alias("rem_i32_neg1"),
        (c("x") % c("y")).alias("rem_f64"),
        (c("f") % (c("f") * c("f"))).alias("rem_f32"),
        F.pmod(c("a"), c("b")).alias("pmod"),
        F.pmod(c("i"), F.lit(7)).alias("pmod_i32"),
        F.pmod(c("x"), c("y")).alias("pmod_f64"),
        (-c("a")).alias("neg"),
        (-c("i")).alias("neg_i32"),
        (-c("x")).alias("neg_f64"),
        F.abs(c("a")).alias("abs"),
        F.abs(c("i")).alias("abs_i32"),
        F.abs(c("x")).alias("abs_f64"),
        F.abs(c("f")).alias("abs_f32"),
        F.greatest(c("x"), c("y")).alias("greatest"),
        F.greatest(c("y"), c("x")).alias("greatest_yx"),
        F.greatest(c("a"), c("i"), F.lit(0)).alias("greatest_int"),
        F.greatest(c("f"), c("x")).alias("greatest_mixed"),
        F.least(c("x"), c("y")).alias("least"),
        F.least(c("y"), c("x")).alias("least_yx"),
        F.least(c("a"), c("b")).alias("least_int"),
        F.when(c("a") > F.lit(0), F.lit("pos"))
        .when(c("a") == F.lit(0), c("s"))
        .otherwise(F.lit("negative")).alias("case_str"),
        F.when(c("x") > F.lit(1.0), c("a")).when(c("x") < F.lit(-1.0),
                                                  c("i"))
        .end().alias("case_num"),
        F.when(c("s") == F.lit("v1"), c("x")).otherwise(c("f"))
        .alias("case_mixed"),
    )


def unnamed_query(df, F):
    """The two expressions neither package's functions module names:
    ``a div b`` (IntegralDivide, also of the int32 column by -1) and
    unary ``+``, behind a filter so that they fuse."""
    ar = F.ar
    c = F.col
    return df.filter(c("b").is_not_null()).select(
        F.Column(ar.IntegralDivide(c("a").expr, c("b").expr)).alias("idiv"),
        F.Column(ar.IntegralDivide(c("i").expr, F.lit(-1).expr))
        .alias("idiv_i32"),
        F.Column(ar.IntegralDivide(c("x").expr, F.lit(3).expr))
        .alias("idiv_f64"),
        F.Column(ar.UnaryPositive(c("x").expr)).alias("pos"))


def test_k12_new_expressions_match_plain(emu):
    sess, df, batch = arith_frame()
    [seg] = _segments(sess, df)
    [(b, keep)] = _check(emu, seg, batch)
    assert 0 < int(keep.sum()) < 300


def test_k12_integral_divide_and_unary_plus_match_plain(emu):
    sess, df, batch = arith_frame(unnamed_query)
    [seg] = _segments(sess, df)
    _check(emu, seg, batch)
