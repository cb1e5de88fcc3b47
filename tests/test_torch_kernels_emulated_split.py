"""K10's build and split (``shuffle/device_shuffle.py:partition_order`` and
``partition_split``; ``csrc/shuffle.cu`` and ``csrc/gather.cu
k10_split``) built for the CPU with the host C++ compiler against
``csrc/emulator/cuda_runtime.h``
(``test_torch_kernels_emulated._build_emulated``) and held against their
plain PyTorch versions on the same inputs, bit for bit.

The partition ids come as the exchange makes them: Murmur3 of a key
(hash), ``(row + offset) % n_out`` (round robin) and K11's bounds over a
float key (range), at 2, 3, 200 and 300 partitions (300 takes the wide
build: global counts and K1's sort).  Batches hold 1-D columns of every
element size and string columns of widths 1, 15, 63 and 147, with nulls,
over four 2,048-row tiles and a ragged fifth, padding rows past the row
count; some partitions are empty, and a batch of no rows writes nothing.
A batch of more columns than one launch's table takes two launches.
Each partition's lanes past its count must be zero, invalid and of
length 0, at ``bucket_rows(count)`` rows.

Mutations it catches (each built from an edited copy of ``gather.cu``):
padding lanes left valid, and a block that reads its rows' indices one
place late in the order.  The
emulator runs a launch's blocks one after another, so it cannot show a
race: the card's repeated runs in chip_smoke.py and
``tools/k10_k2_split.py`` are that check.  Run:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_kernels_emulated_split.py -q``."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.column import (DeviceBatch, DeviceColumn,
                                                bucket_rows)
from spark_rapids_tpu_torch.ops.kernels import _build as B
from spark_rapids_tpu_torch.ops.kernels import gather as G
from spark_rapids_tpu_torch.shuffle import device_shuffle as DS
from spark_rapids_tpu_torch.utils import hashing as H

from test_torch_kernels_emulated import _build_emulated
from test_torch_kernels_emulated_generate import _mutant

N = 4 * B.TILE + 333
N_REAL = N - 101


@pytest.fixture(scope="module")
def emu():
    out = _build_emulated()
    return B.Kernels(lambda: out, lambda t: None)


def _valid(rng, n):
    return torch.from_numpy(rng.random(n) > 0.15)


def _string(rng, n, w):
    bm = rng.integers(1, 256, (n, w)).astype(np.uint8)
    ln = rng.integers(0, w + 1, n).astype(np.int32)
    bm[np.arange(w)[None, :] >= ln[:, None]] = 0
    return DeviceColumn(T.STRING, torch.from_numpy(bm), _valid(rng, n),
                        torch.from_numpy(ln))


def _batch(rng, n=N, n_real=N_REAL, widths=(1, 15, 63, 147), extra=0):
    """A float key, 1-D columns of every element size, strings of each
    width and ``extra`` more int32 columns."""
    cols = [
        DeviceColumn(T.FLOAT64, torch.from_numpy(rng.choice(
            [0.0, -0.0, np.nan, 1.5, -2.25, 7.0, 1e300], n)),
            _valid(rng, n)),
        DeviceColumn(T.BOOL, torch.from_numpy(rng.random(n) > 0.5),
                     _valid(rng, n)),
        DeviceColumn(T.INT8, torch.from_numpy(
            rng.integers(-128, 128, n).astype(np.int8)), _valid(rng, n)),
        DeviceColumn(T.INT16, torch.from_numpy(
            rng.integers(-999, 999, n).astype(np.int16)), _valid(rng, n)),
        DeviceColumn(T.INT32, torch.from_numpy(
            rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)),
            _valid(rng, n)),
        DeviceColumn(T.INT64, torch.from_numpy(
            rng.integers(-2 ** 62, 2 ** 62, n)), _valid(rng, n)),
    ] + [_string(rng, n, w) for w in widths] + [
        DeviceColumn(T.INT32, torch.from_numpy(
            rng.integers(0, 9, n).astype(np.int32)), _valid(rng, n))
        for _ in range(extra)]
    schema = T.Schema([T.Field(f"c{k}", c.dtype) for k, c in enumerate(cols)])
    return DeviceBatch(schema, cols, torch.tensor(n_real, dtype=torch.int32))


def _pids(kind, batch, n_out):
    """Partition ids as the exchange makes them, on their plain versions."""
    n = batch.padded_rows
    if kind == "hash":
        return H.pmod(H.hash_batch_plain(batch.columns[4:5]), n_out)
    if kind == "round_robin":
        return ((torch.arange(n, dtype=torch.int32) + 5) % n_out).to(
            torch.int32)
    # the first bound lies below every key: partition 0 stays empty
    bounds = torch.from_numpy(np.linspace(-3.0, 8.0, n_out - 1))
    return torch.searchsorted(bounds, batch.columns[0].data,
                              right=True).to(torch.int32)


def _bits(t):
    """A tensor's bytes (NaN equal to NaN of the same bits)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _same_parts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is None:
            continue
        assert torch.equal(g.num_rows, w.num_rows)
        assert g.num_rows.dtype == torch.int32
        for gc, wc in zip(g.columns, w.columns):
            assert gc.data.shape == wc.data.shape
            assert torch.equal(_bits(gc.data), _bits(wc.data))
            assert torch.equal(gc.validity, wc.validity)
            assert (gc.lengths is None) == (wc.lengths is None)
            if wc.lengths is not None:
                assert torch.equal(gc.lengths, wc.lengths)


def _padding_is_empty(parts, counts):
    for p, cnt in enumerate(counts):
        if cnt == 0:
            assert parts[p] is None
            continue
        assert parts[p].padded_rows == bucket_rows(cnt)
        for c in parts[p].columns:
            assert not c.data[cnt:].any()
            assert not c.validity[cnt:].any()
            if c.lengths is not None:
                assert not c.lengths[cnt:].any()


@pytest.mark.parametrize("n_out", [2, 3, 200, 300])
@pytest.mark.parametrize("kind", ["hash", "round_robin", "range"])
def test_k10_build_and_split_match_plain(emu, kind, n_out):
    rng = np.random.default_rng(100 + n_out)
    batch = _batch(rng, widths=(15, 147) if n_out >= 200 else
                   (1, 15, 63, 147))
    pids = _pids(kind, batch, n_out)
    want = DS.partition_order_plain(pids, batch.num_rows, n_out)
    DS.BUILD_LAUNCHES.reset()
    got = DS.partition_order(pids, batch.num_rows, n_out, kernels=emu)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # histogram and look-back scatter; past 255 partitions the global
    # counts and scan (the order from K1's sort, counted there)
    assert DS.BUILD_LAUNCHES.count == 2
    counts = want[1].tolist()
    assert sum(counts) == N_REAL
    if kind == "range":
        assert counts[0] == 0
    DS.PARTITION_SPLIT_LAUNCHES.reset()
    parts = DS.partition_split(batch, got[0], counts, kernels=emu)
    assert DS.PARTITION_SPLIT_LAUNCHES.count == 1
    _same_parts(parts, DS.partition_split_plain(batch, want[0], counts))
    _padding_is_empty(parts, counts)


def test_k10_split_keeps_batch_order_and_rows(emu):
    """Each partition holds its rows in batch order (the build is
    stable, as the reference's compaction), every real row once."""
    rng = np.random.default_rng(5)
    batch = _batch(rng, widths=(15,))
    pids = _pids("hash", batch, 7)
    order, counts, _starts = DS.partition_order(pids, batch.num_rows, 7,
                                                kernels=emu)
    parts = DS.partition_split(batch, order, counts.tolist(), kernels=emu)
    rows = []
    key = batch.columns[4].data
    for p, pb in enumerate(parts):
        if pb is None:
            continue
        n = int(pb.num_rows)
        want_rows = torch.nonzero(pids[:N_REAL] == p).flatten()
        assert torch.equal(pb.columns[4].data[:n], key[want_rows])
        rows += want_rows.tolist()
    assert sorted(rows) == list(range(N_REAL))


def test_k10_split_wider_than_a_table(emu):
    """More columns than one launch's table: the split takes two
    launches, each column written once."""
    rng = np.random.default_rng(9)
    batch = _batch(rng, widths=(63,), extra=G.TABLE_COLUMNS)
    assert len(batch.columns) > G.TABLE_COLUMNS
    pids = _pids("round_robin", batch, 3)
    order, counts, _s = DS.partition_order(pids, batch.num_rows, 3,
                                           kernels=emu)
    DS.PARTITION_SPLIT_LAUNCHES.reset()
    parts = DS.partition_split(batch, order, counts.tolist(), kernels=emu)
    assert DS.PARTITION_SPLIT_LAUNCHES.count == 2
    _same_parts(parts, DS.partition_split_plain(batch, order,
                                                counts.tolist()))


@pytest.mark.parametrize("n,n_real", [(256, 0), (256, 1), (256, 130),
                                      (N, 1000)])
def test_k10_split_small_and_empty_batches(emu, n, n_real):
    """No rows: no launch, every partition None; one row and 130 rows (a
    partition past one 128-row bucket) write bucket_rows lanes; 1,000
    rows of a 5-tile batch leave four tiles of padding alone (the build
    places their rows without the look-back)."""
    rng = np.random.default_rng(11 + n_real)
    batch = _batch(rng, n=n, n_real=n_real, widths=(1, 147))
    pids = _pids("hash", batch, 2)
    got = DS.partition_order(pids, batch.num_rows, 2, kernels=emu)
    for g, w in zip(got, DS.partition_order_plain(pids, batch.num_rows, 2)):
        assert torch.equal(g, w)
    order, counts = got[0], got[1].tolist()
    DS.PARTITION_SPLIT_LAUNCHES.reset()
    parts = DS.partition_split(batch, order, counts, kernels=emu)
    assert DS.PARTITION_SPLIT_LAUNCHES.count == (1 if n_real else 0)
    _same_parts(parts, DS.partition_split_plain(batch, order, counts))
    _padding_is_empty(parts, counts)
    if not n_real:
        assert parts == [None, None]


def test_k10_split_bytes_counts_the_work():
    batch = _batch(np.random.default_rng(2), n=256, n_real=200,
                   widths=(15,))
    counts = [150, 0, 50]
    per_row = sum(G._row_bytes(c.data) + 1 +
                  (4 if c.lengths is not None else 0)
                  for c in batch.columns)
    # pids twice, order written and read; rows read and written; the
    # padding lanes (256 - 150 and 128 - 50) written
    want = 200 * (8 + 8) + 200 * 2 * per_row + (106 + 78) * per_row
    assert DS.split_bytes(batch, counts) == want


def test_k10_build_too_few_status_words_is_an_error(emu):
    """The build refuses a status buffer shorter than n_out words a tile
    (cudaErrorInvalidValue) rather than wait on a word no tile writes;
    n_out words a tile suffice."""
    lib = emu.library("shuffle")
    n, n_out = 3 * B.TILE, 3
    pids = (torch.arange(n, dtype=torch.int32) * 7) % n_out
    num_rows = torch.tensor(n - 5, dtype=torch.int32)
    hist = torch.zeros(2 * DS.BUILD_HIST_WORDS, dtype=torch.int32)
    status = torch.zeros(n_out * 3, dtype=torch.int64)
    counts = torch.zeros(n_out, dtype=torch.int32)
    starts = torch.zeros(n_out, dtype=torch.int32)
    order = torch.zeros(n, dtype=torch.int32)
    half = DS.BUILD_HIST_WORDS

    def build(words):
        return lib.k10_build(pids.data_ptr(), num_rows.data_ptr(), n, n_out,
                             hist[:half].data_ptr(), hist[half:].data_ptr(),
                             status.data_ptr(), words, 1, counts.data_ptr(),
                             starts.data_ptr(), order.data_ptr(), None)

    assert build(n_out * 3 - 1) != 0
    assert build(n_out * 3) == 0
    want = DS.partition_order_plain(pids, num_rows, n_out)
    assert all(torch.equal(a, b)
               for a, b in zip((order, counts, starts), want))


def test_k10_mutant_valid_padding_differs(emu):
    """Padding lanes written valid: the partitions' validity past their
    counts differs from the plain version's."""
    mutant = _mutant("gather", (
        "if (d.dst_valid != nullptr) d.dst_valid[from + r] = false;",
        "if (d.dst_valid != nullptr) d.dst_valid[from + r] = true;"))
    rng = np.random.default_rng(21)
    batch = _batch(rng, widths=(15,))
    pids = _pids("hash", batch, 3)
    order, counts, _s = DS.partition_order_plain(pids, batch.num_rows, 3)
    counts = counts.tolist()
    want = DS.partition_split_plain(batch, order, counts)
    _same_parts(DS.partition_split(batch, order, counts, kernels=emu), want)
    bad = DS.partition_split(batch, order, counts, kernels=mutant)
    assert not all(torch.equal(g.columns[0].validity, w.columns[0].validity)
                   for g, w in zip(bad, want) if w is not None)


def test_k10_mutant_late_order_differs(emu):
    """A block that reads its rows' indices one place late in the order:
    with one block a partition (200 partitions of under 128 rows), every
    partition gets the next row of the order in each lane."""
    mutant = _mutant("gather", (
        "const long long from = s_part[2] + l0;",
        "const long long from = s_part[2] + l0 + 1;"))
    rng = np.random.default_rng(22)
    batch = _batch(rng, widths=(15,))
    pids = _pids("round_robin", batch, 200)
    order, counts, _s = DS.partition_order_plain(pids, batch.num_rows, 200)
    counts = counts.tolist()
    want = DS.partition_split_plain(batch, order, counts)
    _same_parts(DS.partition_split(batch, order, counts, kernels=emu), want)
    bad = DS.partition_split(batch, order, counts, kernels=mutant)
    assert not torch.equal(bad[1].columns[4].data, want[1].columns[4].data)


def test_exchange_reads_split_partitions():
    """The exchange's reader yields the split's batches: the same rows a
    partition as the rows of ``pids == p`` in batch order (plain versions,
    CPU tensors)."""
    rng = np.random.default_rng(31)
    batch = _batch(rng, n=512, n_real=400, widths=(15,))
    pids = _pids("hash", batch, 3)
    order, counts, _s = DS.partition_order(pids, batch.num_rows, 3)
    parts = DS.partition_split(batch, order, counts.tolist())
    for p in range(3):
        keep = G.compact_plain(batch, pids == p)
        n = int(keep.num_rows)
        assert int(parts[p].num_rows) == n
        for a, b in zip(parts[p].columns, keep.columns):
            assert torch.equal(_bits(a.data[:n]), _bits(b.data[:n]))
            assert torch.equal(a.validity[:n], b.validity[:n])
