"""K25 (the grace join's bucket split: ``split_by_bucket``, K10's order
and K10's split ``k10_split`` of ``csrc/gather.cu``) and K9 from a seed
(``csrc/hashing.cu``), built for the CPU with the host C++ compiler
against ``csrc/emulator/cuda_runtime.h``
(``test_torch_kernels_emulated._build_emulated``) and held against their
plain PyTorch versions on the same inputs.

Shapes: 700 logical rows padded to 1,024 (the padding rows follow the
last row and belong to no bucket), over every column type with nulls
(one-byte to eight-byte elements, string matrices 6 and 13 bytes wide);
bucket ids from K9 with the grace seeds, pmod m, for m = 1, 2, 7 and 64
(so some buckets are empty at m = 64), and a draw that leaves most of 7
buckets empty; ``split_by_bucket`` on the emulated kernels against
``partition_order_plain`` and ``partition_split_plain``.  Every bucket
is compared to the byte, data, validity, lengths and row count, padding
rows included (zero and invalid); one split launch a batch, counted in
``SPLIT_LAUNCHES``.

Mutation check: a split that ignores each bucket's start in the order,
built from an edited copy of ``gather.cu``, must disagree with the plain
version.

Also B.26, the write's sort by its partition columns
(``exec/write.py:TpuDataWritingCommandExec._sort_by_keys``: K1's
lexsort, padding rows last, then K4's gather of every column), on the
emulated K1 and K4 against its plain version (``lexsort_plain`` and
torch indexing), by one int64 key (a store_sales date key with nulls)
and by two one-byte string keys (lineitem's flags, with nulls), the row
number riding along: 200 rows padded to 256, since an emulated launch
costs 0.05-1 s with the machine's load and B.26 makes 20-30 of them;
every column compared to the byte, padding rows included."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.column import DeviceBatch, DeviceColumn
from spark_rapids_tpu_torch.exec import joins as PJ
from spark_rapids_tpu_torch.exec import write as W
from spark_rapids_tpu_torch.ops.kernels import _build as B
from spark_rapids_tpu_torch.ops.kernels import gather as G
from spark_rapids_tpu_torch.ops.kernels import segment as S
from spark_rapids_tpu_torch.shuffle import device_shuffle as DS
from spark_rapids_tpu_torch.utils import hashing as H
from test_torch_kernels_emulated import _build_emulated
from test_torch_kernels_emulated_generate import _mutant

N, P = 700, 1024
_NP = {T.BOOL: np.bool_, T.INT8: np.int8, T.INT16: np.int16,
       T.INT32: np.int32, T.INT64: np.int64, T.FLOAT32: np.float32,
       T.FLOAT64: np.float64, T.DATE32: np.int32, T.TIMESTAMP: np.int64}
SEEDS = [H.SEED] + [PJ.GRACE_SEED + PJ.GRACE_SEED_STEP * level
                    for level in range(PJ.GRACE_MAX_LEVEL + 1)]


@pytest.fixture(scope="module")
def emu():
    out = _build_emulated()
    return B.Kernels(lambda: out, lambda t: None)


def _batch(seed):
    """Every column type with nulls, and two string columns of widths 6
    and 13; real rows first, then padding."""
    rng = np.random.default_rng(seed)
    cols = []
    for t in list(_NP) + [T.STRING, T.STRING]:
        valid = np.zeros(P, np.bool_)
        valid[:N] = rng.random(N) > 0.2
        lengths = None
        if t.is_string:
            width = 6 if not any(c.dtype.is_string for c in cols) else 13
            lengths = rng.integers(0, width + 1, P).astype(np.int32)
            data = rng.integers(1, 256, (P, width)).astype(np.uint8)
            data[np.arange(width)[None, :] >= lengths[:, None]] = 0
        elif t == T.BOOL:
            data = rng.random(P) > 0.5
        else:
            data = rng.integers(-2**60, 2**60, P).astype(_NP[t])
        cols.append(DeviceColumn(
            t, torch.from_numpy(data), torch.from_numpy(valid),
            None if lengths is None else torch.from_numpy(lengths)))
    schema = T.Schema([T.Field(f"c{i}", c.dtype)
                       for i, c in enumerate(cols)])
    return DeviceBatch(schema, cols, torch.tensor(N, dtype=torch.int32))


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is None:
            continue
        assert int(g.num_rows) == int(w.num_rows)
        for gc, wc in zip(g.columns, w.columns):
            assert gc.data.shape == wc.data.shape
            assert gc.data.dtype == wc.data.dtype
            assert torch.equal(gc.data.contiguous().view(torch.uint8),
                               wc.data.contiguous().view(torch.uint8))
            assert torch.equal(gc.validity, wc.validity)
            assert (gc.lengths is None) == (wc.lengths is None)
            if wc.lengths is not None:
                assert torch.equal(gc.lengths, wc.lengths)


def _split(emu, batch, pids, m):
    order, counts, starts = DS.partition_order(pids, batch.num_rows, m,
                                               kernels=emu)
    want_order = DS.partition_order_plain(pids, batch.num_rows, m)
    assert all(torch.equal(a, b) for a, b in zip((order, counts, starts),
                                                 want_order))
    before = DS.SPLIT_LAUNCHES.count
    got, counts = DS.split_by_bucket(batch, pids, m, kernels=emu)
    assert counts == want_order[1].tolist()
    assert DS.SPLIT_LAUNCHES.count - before == (1 if sum(counts) else 0)
    return got, DS.partition_split_plain(batch, want_order[0],
                                         counts), counts


@pytest.mark.parametrize("m", [1, 2, 7, 64])
def test_k25_matches_plain(emu, m):
    batch = _batch(m)
    keys = [batch.columns[4], batch.columns[-2]]  # bigint and string keys
    pids = H.hash_pids(keys, m, kernels=emu, seed=PJ.GRACE_SEED)
    got, want, counts = _split(emu, batch, pids, m)
    _same(got, want)
    assert sum(counts) == N
    # each bucket's rows are the batch's rows of that bucket, in order
    c0 = batch.columns[4]
    for b, part in enumerate(got):
        rows = torch.nonzero(pids[:N] == b)[:, 0]
        assert (part is None) == (len(rows) == 0)
        if part is not None:
            k = len(rows)
            assert torch.equal(part.columns[4].data[:k], c0.data[rows])
            assert not part.columns[4].validity[k:].any()
            assert not part.columns[-1].lengths[k:].any()
            assert not part.columns[-1].data[k:].any()


def test_k25_mostly_empty_buckets(emu):
    batch = _batch(5)
    pids = torch.full((P,), 3, dtype=torch.int32)
    pids[:40] = 6
    pids[N:] = 0  # padding rows: never in a bucket
    got, want, counts = _split(emu, batch, pids, 7)
    assert counts == [0, 0, 0, N - 40, 0, 0, 40]
    assert [g is None for g in got] == [True] * 3 + [False] + [True] * 2 \
        + [False]
    _same(got, want)
    assert got[6].padded_rows == 128 and got[3].padded_rows == 1024


@pytest.mark.parametrize("seed", SEEDS)
def test_k9_seeded_matches_plain(emu, seed):
    batch = _batch(seed % 97)
    cols = batch.columns
    got = H.hash_device_batch(cols, kernels=emu, seed=seed)
    assert torch.equal(got, H.hash_batch_plain(cols, seed))
    for m in (2, 7, 64):
        assert torch.equal(H.hash_pids(cols[2:5] + cols[-1:], m,
                                       kernels=emu, seed=seed),
                           H.pmod(H.hash_batch_plain(cols[2:5] + cols[-1:],
                                                     seed), m))


def test_k25_without_starts_mutant_differs(emu):
    """A split that reads every bucket from the front of the order, built
    from an edited copy of ``gather.cu``, must disagree."""
    mutant = _mutant("gather", ("const long long from = s_part[2] + l0;",
                                "const long long from = l0;"))
    batch = _batch(21)
    pids = H.hash_pids([batch.columns[4]], 7, kernels=emu,
                       seed=PJ.GRACE_SEED)
    order, counts, _starts = DS.partition_order(pids, batch.num_rows, 7,
                                                kernels=emu)
    got = DS.partition_split(batch, order, counts.tolist(), kernels=mutant)
    want = DS.partition_split_plain(batch, order, counts.tolist())
    with pytest.raises(AssertionError):
        _same(got, want)


def _write_batch(seed, n=200, padded=256):
    """A store_sales date key (int64), lineitem's two flags (one byte
    each) and the row number; real rows first, then invalid zero
    padding."""
    rng = np.random.default_rng(seed)
    valid = np.zeros(padded, np.bool_)
    valid[:n] = rng.random(n) > 0.1
    date = np.zeros(padded, np.int64)
    date[:n] = rng.integers(0, 40, n)
    cols = [DeviceColumn(T.INT64, torch.from_numpy(np.where(valid, date, 0)),
                         torch.from_numpy(valid))]
    for letters in ("ANR", "FO"):
        v = np.zeros(padded, np.bool_)
        v[:n] = rng.random(n) > 0.05
        data = np.zeros((padded, 1), np.uint8)
        data[:n, 0] = np.frombuffer(letters.encode(), np.uint8)[
            rng.integers(0, len(letters), n)]
        data[~v] = 0
        cols.append(DeviceColumn(T.STRING, torch.from_numpy(data),
                                 torch.from_numpy(v),
                                 torch.from_numpy(v.astype(np.int32))))
    live = np.arange(padded) < n
    cols.append(DeviceColumn(T.INT32, torch.from_numpy(np.where(
        live, np.arange(padded, dtype=np.int32), 0)), torch.from_numpy(live)))
    names = ["ss_sold_date_sk", "l_returnflag", "l_linestatus", "row"]
    schema = T.Schema([T.Field(nm, c.dtype) for nm, c in zip(names, cols)])
    return DeviceBatch(schema, cols, torch.tensor(n, dtype=torch.int32))


@pytest.mark.parametrize("keys", [["ss_sold_date_sk"],
                                  ["l_returnflag", "l_linestatus"]],
                         ids=["int64", "two_flags"])
def test_b26_sort_by_keys_matches_plain(emu, keys):
    batch = _write_batch(len(keys))
    child = type("Child", (), {"schema": batch.schema, "children": []})()
    plan = type("Plan", (), {"partition_by": keys})()
    ex = W.TpuDataWritingCommandExec(child, plan)
    counters = (S.SORT_LAUNCHES, G.GATHER_LAUNCHES)
    before = [c.count for c in counters]
    got = ex._sort_by_keys(batch, kernels=emu)
    k1, k4 = [c.count - b for c, b in zip(counters, before)]
    assert k1 > 0 and k4 > 0
    cols = [batch.columns[batch.schema.index_of(k)] for k in keys]
    order = S.lexsort_plain(cols, pad_valid=batch.row_mask())
    want = G.gather_batch(batch, order, batch.num_rows)
    assert int(got.num_rows) == int(want.num_rows) == 200
    for g, w in zip(got.columns, want.columns):
        assert torch.equal(g.validity, w.validity)
        assert torch.equal(g.data, w.data)
        assert (g.lengths is None) == (w.lengths is None)
        if w.lengths is not None:
            assert torch.equal(g.lengths, w.lengths)
    row = got.columns[-1].data[:200].numpy()
    assert sorted(row.tolist()) == list(range(200))
