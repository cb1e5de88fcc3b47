"""K4 (gather and compaction) built for the CPU with the host C++ compiler
against ``csrc/emulator/cuda_runtime.h``
(``test_torch_kernels_emulated._build_emulated``) and held against its
plain PyTorch versions on the same inputs, bit for bit.

The batches hold 1-D columns of every element size and byte matrices of
widths 1, 3, 15, 16, 17, 63 and 147 (a row of one unit, of 1-byte units
at odd widths, of 16-byte units, a tail unit); arrays whose bases are cut
from a larger buffer at offsets that leave them 1- or 4-byte aligned;
indices out of range on both sides (clamped as XLA clamps them, against
the plain version of the clamped indices); a mask
and none; more columns than one launch's table (the call splits); an
empty call, a call of no output rows and a 0-row batch; compactions that
keep every row, none, or some, with a row count below the padding, over
four 2,048-row scan tiles and a ragged fifth.  Each call's launches are
counted: one a gather of up to ``G.TABLE_COLUMNS`` columns, two scan
launches and one move a compaction.

Mutations it catches (each built from an edited copy of ``gather.cu``):
a move that leaves the row mask out of the validity, and a wide
byte-matrix copy that reads every unit of a row from the row's first
unit.  The
emulator runs a launch's blocks one after another in index order, so it
cannot show a race between blocks: the card's repeated runs in
chip_smoke.py and ``tools/k3_k4_split.py`` are that check.  Run:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_kernels_emulated_gather.py -q``."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.column import DeviceBatch, DeviceColumn
from spark_rapids_tpu_torch.ops.kernels import _build as B
from spark_rapids_tpu_torch.ops.kernels import gather as G

from test_torch_kernels_emulated import _build_emulated
from test_torch_kernels_emulated_generate import _mutant

N = 4 * B.TILE + 333
N_REAL = N - 101
WIDTHS = [1, 3, 15, 16, 17, 63, 147]


@pytest.fixture(scope="module")
def emu():
    out = _build_emulated()
    return B.Kernels(lambda: out, lambda t: None)


def _strings(rng, n, w, offset=0):
    """A string column of width ``w`` with lengths and nulls; with
    ``offset``, its bytes start that many bytes into a larger buffer."""
    buf = torch.from_numpy(rng.integers(0, 256, n * w + offset)
                           .astype(np.uint8))
    bm = buf[offset:].view(n, w)
    lengths = torch.from_numpy(rng.integers(0, w + 1, n).astype(np.int32))
    return DeviceColumn(T.STRING, bm, torch.from_numpy(rng.random(n) > 0.2),
                        lengths)


def _numeric(rng, n):
    """1-D columns of every element size, with nulls."""
    def valid():
        return torch.from_numpy(rng.random(n) > 0.15)
    return [
        DeviceColumn(T.BOOL, torch.from_numpy(rng.random(n) > 0.5), valid()),
        DeviceColumn(T.INT8, torch.from_numpy(
            rng.integers(-128, 128, n).astype(np.int8)), valid()),
        DeviceColumn(T.INT16, torch.from_numpy(
            rng.integers(-9999, 9999, n).astype(np.int16)), valid()),
        DeviceColumn(T.INT32, torch.from_numpy(
            rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)), valid()),
        DeviceColumn(T.FLOAT64, torch.from_numpy(rng.standard_normal(n)),
                     valid()),
    ]


def _order(rng, n_out, n_src, outside=False):
    """A random order; with ``outside``, some indices below 0 and past the
    end (the kernel clamps them as XLA does)."""
    o = rng.integers(0, n_src, n_out)
    if outside:
        o[rng.random(n_out) < 0.02] = -3
        o[rng.random(n_out) < 0.02] = n_src + 5
    return torch.from_numpy(o.astype(np.int32))


def _same_cols(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.data.dtype == w.data.dtype and torch.equal(g.data, w.data)
        assert torch.equal(g.validity, w.validity)
        assert (g.lengths is None) == (w.lengths is None)
        if w.lengths is not None:
            assert torch.equal(g.lengths, w.lengths)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("width", WIDTHS)
def test_k4_gather_columns_one_launch(emu, width, masked):
    rng = np.random.default_rng(width * 2 + masked)
    cols = [_strings(rng, N, width)] + _numeric(rng, N)
    n_out = N - 700
    order = _order(rng, n_out, N)
    mask = torch.from_numpy(rng.random(n_out) > 0.3) if masked else None
    want = [G.gather_column_plain(c, order, mask) for c in cols]
    G.GATHER_LAUNCHES.reset()
    got = G.gather_columns(cols, order, mask, kernels=emu)
    assert G.GATHER_LAUNCHES.count == 1
    _same_cols(got, want)
    # gather_batch and gather_column are the same launch
    G.GATHER_LAUNCHES.reset()
    b = DeviceBatch(T.Schema([T.Field(f"c{k}", c.dtype)
                              for k, c in enumerate(cols)]), cols,
                    torch.tensor(N_REAL, dtype=torch.int32))
    _same_cols(G.gather_batch(b, order, b.num_rows, mask,
                              kernels=emu).columns, want)
    _same_cols([G.gather_column(cols[0], order, mask, kernels=emu)],
               want[:1])
    assert G.GATHER_LAUNCHES.count == 2


@pytest.mark.parametrize("offset", [1, 3, 4, 12])
def test_k4_gather_arrays_at_unaligned_bases(emu, offset):
    """Arrays cut from a larger buffer: the widest unit that divides the
    row width and both addresses is smaller than the row."""
    rng = np.random.default_rng(40 + offset)
    n = B.TILE + 77
    bms = [_strings(rng, n, w, offset).data for w in (16, 17, 32, 147)]
    i32 = torch.from_numpy(rng.integers(-99, 99, n + 4).astype(np.int32))
    arrays = bms + [i32[offset % 4 or 1:][:n],
                    torch.from_numpy(rng.random(n + 1) > 0.5)[1:]]
    order = _order(rng, n, n, outside=True)
    want = [x[torch.clamp(order, 0, n - 1).to(torch.int64)] for x in arrays]
    G.GATHER_LAUNCHES.reset()
    got = G.gather_arrays(arrays, order, kernels=emu)
    assert G.GATHER_LAUNCHES.count == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # a column's validity and lengths clamp the same way
    col = _strings(rng, n, 9, offset)
    safe = torch.clamp(order, 0, n - 1)
    _same_cols(G.gather_columns([col], order, kernels=emu),
               [G.gather_column_plain(col, safe)])


def test_k4_gather_wider_than_a_table(emu):
    rng = np.random.default_rng(3)
    n = 3 * B.TILE
    cols = [_strings(rng, n, 5)] * 3 + _numeric(rng, n) * 8
    assert len(cols) > G.TABLE_COLUMNS
    order = _order(rng, n, n)
    mask = torch.from_numpy(rng.random(n) > 0.5)
    G.GATHER_LAUNCHES.reset()
    got = G.gather_columns(cols, order, mask, kernels=emu)
    assert G.GATHER_LAUNCHES.count == -(-len(cols) // G.TABLE_COLUMNS)
    _same_cols(got, [G.gather_column_plain(c, order, mask) for c in cols])
    arrays = [c.data for c in cols] * 2
    G.GATHER_LAUNCHES.reset()
    got = G.gather_arrays(arrays, order, kernels=emu)
    assert G.GATHER_LAUNCHES.count == -(-len(arrays) // G.TABLE_COLUMNS)
    assert all(torch.equal(g, w) for g, w in zip(
        got, G.gather_arrays(arrays, order)))


def test_k4_empty_calls(emu):
    rng = np.random.default_rng(9)
    cols = [_strings(rng, 300, 7)] + _numeric(rng, 300)
    G.GATHER_LAUNCHES.reset()
    assert G.gather_columns([], _order(rng, 10, 300), kernels=emu) == []
    assert G.gather_arrays([], _order(rng, 10, 300), kernels=emu) == []
    assert G.GATHER_LAUNCHES.count == 0
    # no output rows: no launch
    empty = torch.zeros(0, dtype=torch.int32)
    got = G.gather_columns(cols, empty, kernels=emu)
    _same_cols(got, [G.gather_column_plain(c, empty) for c in cols])
    assert G.GATHER_LAUNCHES.count == 0
    # a batch of no rows: no launch
    b0 = DeviceBatch(T.Schema([T.Field("x", T.INT32)]),
                     [_numeric(rng, 0)[3]], torch.tensor(0, dtype=torch.int32))
    G.COMPACT_LAUNCHES.reset()
    got = G.compact(b0, torch.zeros(0, dtype=torch.bool), kernels=emu)
    assert G.COMPACT_LAUNCHES.count == 0 and int(got.num_rows) == 0
    assert got.columns[0].data.shape == (0,)


@pytest.mark.parametrize("n_real", [N, N_REAL, 5])
@pytest.mark.parametrize("kept", ["all", "none", "some"])
def test_k4_compact_one_move(emu, kept, n_real):
    rng = np.random.default_rng(len(kept) + n_real)
    cols = [_strings(rng, N, 3), _strings(rng, N, 147)] + _numeric(rng, N)
    b = DeviceBatch(T.Schema([T.Field(f"c{k}", c.dtype)
                              for k, c in enumerate(cols)]), cols,
                    torch.tensor(n_real, dtype=torch.int32))
    keep = {"all": torch.ones(N, dtype=torch.bool),
            "none": torch.zeros(N, dtype=torch.bool),
            "some": torch.from_numpy(rng.random(N) > 0.4)}[kept]
    want = G.compact_plain(b, keep)
    G.COMPACT_LAUNCHES.reset()
    got = G.compact(b, keep, kernels=emu)
    assert G.COMPACT_LAUNCHES.count == 2 + 1
    assert int(got.num_rows) == int(want.num_rows)
    _same_cols(got.columns, want.columns)


def test_k4_compact_order_and_invert(emu):
    rng = np.random.default_rng(21)
    keep = torch.from_numpy(rng.random(N) > 0.6)
    want = G.compact_order(keep)
    G.COMPACT_LAUNCHES.reset()
    got = G.compact_order(keep, kernels=emu)
    assert G.COMPACT_LAUNCHES.count == 3
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
    G.GATHER_LAUNCHES.reset()
    assert torch.equal(G.invert_permutation(got[0], emu),
                       G.invert_permutation(want[0]))
    assert G.GATHER_LAUNCHES.count == 1


def test_k4_mutant_without_row_mask_differs(emu):
    """A move that stores the source's validity without the row's flag:
    a masked gather and a compaction's dropped rows keep their nulls'
    complement."""
    mutant = _mutant("gather", (
        "d.dst_valid[to] = val[k] && ok[r];", "d.dst_valid[to] = val[k];"))
    rng = np.random.default_rng(77)
    cols = _numeric(rng, N)
    order = _order(rng, N, N)
    mask = torch.from_numpy(rng.random(N) > 0.5)
    want = [G.gather_column_plain(c, order, mask) for c in cols]
    _same_cols(G.gather_columns(cols, order, mask, kernels=emu), want)
    bad = G.gather_columns(cols, order, mask, kernels=mutant)
    assert not all(torch.equal(g.validity, w.validity)
                   for g, w in zip(bad, want))
    b = DeviceBatch(T.Schema([T.Field(f"c{k}", c.dtype)
                              for k, c in enumerate(cols)]), cols,
                    torch.tensor(N_REAL, dtype=torch.int32))
    keep = torch.from_numpy(rng.random(N) > 0.5)
    assert not all(torch.equal(g.validity, w.validity) for g, w in zip(
        G.compact(b, keep, kernels=mutant).columns,
        G.compact_plain(b, keep).columns))


def test_k4_mutant_first_unit_only_differs(emu):
    """A byte-matrix copy that reads each unit of a row from the row's
    first unit."""
    mutant = _mutant("gather", ("const E a = s0[c];", "const E a = s0[0];"))
    rng = np.random.default_rng(78)
    cols = [_strings(rng, N, 147)]
    order = _order(rng, N, N)
    want = [G.gather_column_plain(c, order) for c in cols]
    _same_cols(G.gather_columns(cols, order, kernels=emu), want)
    bad = G.gather_columns(cols, order, kernels=mutant)
    assert not torch.equal(bad[0].data, want[0].data)
