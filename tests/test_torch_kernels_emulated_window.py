"""K7 (the join output's gather) and K14 (the window kernel) built for
the CPU with the host C++ compiler against ``csrc/emulator/cuda_runtime.h``
(``test_torch_kernels_emulated._build_emulated``) and held against their
plain PyTorch versions on the same inputs: K7 bit for bit, K14 exactly
(counts, integer sums, min/max, first/last, ranks) or, for float sums
and averages, within rel 1e-9 of max(|result|, sum of |v|), as a prefix
difference carries the prefix's rounding.

K14 runs over 8,525 rows: four 2,048-row scan tiles and a ragged fifth
(eight 1,024-row halo tiles and a ragged ninth), with
a segment longer than a tile, segments across tile borders, a partition
whose values are all null, NaN and -0.0 for min/max and int64 sums that
wrap; every frame of ``K14_CASES`` plus frames at the edge of the halo
(one launch) and just beyond it (the staged path), and n = 0 and 1.  K7
runs a join output of every element size and of byte matrices whose
widths are no multiple of 4 or 16, -1 indices, a slot mask with a tail,
sides of different row counts, and more columns than one launch's table.

The emulator runs a launch's blocks one after another in index order, so
it cannot show a race between blocks: the card's repeated runs in
chip_smoke.py are that check."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.column import DeviceColumn
from spark_rapids_tpu_torch.ops.kernels import _build as B
from spark_rapids_tpu_torch.ops.kernels import gather as G
from spark_rapids_tpu_torch.ops.kernels import join as J
from spark_rapids_tpu_torch.ops.kernels import segment as S
from spark_rapids_tpu_torch.ops.kernels import window as W

from test_torch_kernels_emulated import FRAMES, K14_CASES, _build_emulated

N = 4 * B.TILE + 333
N_REAL = N - 101
#: frames at the halo's edge (one launch) and just beyond it (staged)
HALO_FRAMES = {"rows_-32_32": (-W.HALO, W.HALO),
               "rows_-33_0": (-W.HALO - 1, 0),
               "rows_1_3": (1, 3), "rows_-5_-2": (-5, -2),
               "rows_0_33": (0, W.HALO + 1)}


@pytest.fixture(scope="module")
def emu():
    out = _build_emulated()
    return B.Kernels(lambda: out, lambda t: None)


# --------------------------------------------------------------------------
# K14
# --------------------------------------------------------------------------
def _window_input(n=N, n_real=N_REAL, seed=16):
    """Rows sorted by (k, t): key 0 holds ~40% of the rows (a segment
    longer than a tile), the others cross tile borders; the order, the
    sorted segment ids, the row mask and the keys."""
    rng = np.random.default_rng(seed)
    k = np.where(rng.random(n) < 0.4, 0, rng.integers(1, 9, n))
    kc = DeviceColumn(T.INT32, torch.from_numpy(k.astype(np.int32)),
                      torch.from_numpy(rng.random(n) > 0.02))
    tc = DeviceColumn(T.INT32, torch.from_numpy(
        rng.integers(0, 500, n).astype(np.int32)),
        torch.from_numpy(rng.random(n) > 0.05))
    rm = torch.arange(n) < n_real
    order = S.lexsort_plain([kc, tc], [False, True], [True, False], rm)
    rm_s = rm[order.long()]
    seg = S.segment_ids_plain([G.gather_column_plain(kc, order)], rm_s)
    return rng, order, rm, seg, torch.from_numpy(k)


def _values(rng, dtype, n):
    if dtype == "float64":
        return torch.from_numpy(rng.choice(
            [0.0, -0.0, np.nan, 1.5, -2.25, np.inf, 7.0, 1e9], n))
    if dtype == "float64_finite":
        return torch.from_numpy(rng.random(n) * 1e6 - 3e5)
    if dtype == "int64":
        # sums of five wrap past 2**63
        return torch.from_numpy(rng.integers(2 ** 61, 2 ** 62, n)
                                * rng.choice([-1, 1], n))
    if dtype == "bool":
        return torch.from_numpy(rng.random(n) > 0.5)
    return torch.from_numpy(rng.integers(-100, 100, n).astype(dtype))


def _check(kind, got, want, values):
    assert got[1].dtype == want[1].dtype and torch.equal(got[1], want[1])
    g, w = got[0], want[0]
    assert g.dtype == w.dtype and g.shape == w.shape
    if kind in ("sum", "avg") and values.dtype.is_floating_point:
        scale = float(values.abs().sum())
        assert torch.all((g - w).abs()
                         <= 1e-9 * torch.clamp(w.abs(), min=scale))
    elif w.dtype.is_floating_point:
        ib = torch.int64 if w.dtype == torch.float64 else torch.int32
        assert torch.equal(g.view(ib), w.view(ib))
    else:
        assert torch.equal(g, w)


def _frame_case(emu, kind, dtype, lower, upper, n=N, n_real=N_REAL):
    rng, order, rm, seg, k = _window_input(n, n_real)
    start, end = W.segment_bounds_plain(seg)
    values = valid = None
    if dtype is not None:
        values = _values(rng, dtype, n)
        # key 5's rows are all null: a segment with no valid row
        valid = torch.from_numpy(rng.random(n) > 0.25) & (k != 5)
    launches = []
    for ignore in ((False, True) if kind in ("first", "last") else (False,)):
        args = (kind, lower, upper, ignore, values, valid, order, rm, seg,
                start, end)
        want = W.frame_aggregate_plain(*args)
        W.WINDOW_LAUNCHES.reset()
        got = W.frame_aggregate(*args, kernels=emu)
        launches.append(W.WINDOW_LAUNCHES.count)
        _check(kind, got, want, values)
    return launches


@pytest.mark.parametrize("kind,dtype,frame", K14_CASES)
def test_k14_frames_over_several_tiles(emu, kind, dtype, frame):
    lower, upper = FRAMES[frame]
    launches = _frame_case(emu, kind, dtype, lower, upper)
    v_dtype = None if dtype is None else _values(
        np.random.default_rng(0), dtype, 1).dtype
    if W.in_halo(kind, lower, upper, v_dtype):
        assert launches == [1] * len(launches)


@pytest.mark.parametrize("frame", sorted(HALO_FRAMES))
@pytest.mark.parametrize("kind,dtype", [
    ("sum", "int64"), ("count", "float64"), ("min", "float64"),
    ("max", "int16"), ("first", "int32"), ("last", "float64"),
    ("avg", "float64_finite")])
def test_k14_halo_edges(emu, kind, dtype, frame):
    """Frames at the halo's edge take one launch; one row further, or a
    float sum, takes the staged path: the same answers either way."""
    lower, upper = HALO_FRAMES[frame]
    launches = _frame_case(emu, kind, dtype, lower, upper)
    v_dtype = _values(np.random.default_rng(0), dtype, 1).dtype
    halo = W.in_halo(kind, lower, upper, v_dtype)
    assert halo == (max(abs(lower), abs(upper)) <= W.HALO
                    and kind != "avg")
    if halo:
        assert launches == [1] * len(launches)
    elif kind == "sum" or kind == "avg" or kind == "count":
        assert launches == [4]
    elif kind in ("min", "max"):
        n_levels = max(1, min(upper - lower + 1, N).bit_length())
        assert launches == [4 + n_levels - 1]
    else:
        assert launches == [2, 5]


@pytest.mark.parametrize("n,n_real", [(0, 0), (1, 1), (1, 0)])
def test_k14_tiny_inputs(emu, n, n_real):
    for kind, dtype, frame in [("count", None, "rows_-2_2"),
                               ("sum", "int64", "rows_-4_0"),
                               ("sum", "float64_finite", "unbounded"),
                               ("min", "float64", "running"),
                               ("max", "int64", "wide"),
                               ("first", "float64", "rows_-4_0"),
                               ("last", "bool", "reverse")]:
        lower, upper = FRAMES[frame]
        _frame_case(emu, kind, dtype, lower, upper, n, n_real)
    rng, order, rm, seg, _k = _window_input(n, n_real)
    for g, w in zip(W.segment_bounds(seg, kernels=emu),
                    W.segment_bounds_plain(seg)):
        assert torch.equal(g, w)


def test_k14_bounds_and_ranks_over_several_tiles(emu):
    _rng, order, rm, seg, _k = _window_input()
    W.WINDOW_LAUNCHES.reset()
    start, end = W.segment_bounds(seg, kernels=emu)
    assert W.WINDOW_LAUNCHES.count == 3
    ws, we = W.segment_bounds_plain(seg)
    assert torch.equal(start, ws) and torch.equal(end, we)
    # the long segment spans more than a tile
    assert int((we - ws).max()) > B.TILE
    ok_ids = torch.maximum(torch.from_numpy(np.cumsum(
        np.random.default_rng(3).random(N) > 0.6).astype(np.int32)), seg)
    ok_start = W.segment_bounds_plain(ok_ids)[0]
    for kind in W.RANK_KINDS:
        got = W.rank_values(kind, order, rm, ws, ok_ids, ok_start,
                            kernels=emu)
        want = W.rank_values_plain(kind, order, rm, ws, ok_ids, ok_start)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --------------------------------------------------------------------------
# K7
# --------------------------------------------------------------------------
def _side(rng, n, widths):
    """A join side of n rows: 1-, 2-, 4- and 8-byte columns and one byte
    matrix a width in ``widths`` (with lengths)."""
    cols = [
        DeviceColumn(T.BOOL, torch.from_numpy(rng.random(n) > 0.5),
                     torch.from_numpy(rng.random(n) > 0.1)),
        DeviceColumn(T.INT8, torch.from_numpy(
            rng.integers(-128, 128, n).astype(np.int8)),
            torch.from_numpy(rng.random(n) > 0.1)),
        DeviceColumn(T.INT16, torch.from_numpy(
            rng.integers(-999, 999, n).astype(np.int16)),
            torch.from_numpy(rng.random(n) > 0.1)),
        DeviceColumn(T.INT32, torch.from_numpy(
            rng.integers(-9, 9, n).astype(np.int32)),
            torch.from_numpy(rng.random(n) > 0.1)),
        DeviceColumn(T.FLOAT64, torch.from_numpy(rng.uniform(-9, 9, n)),
                     torch.from_numpy(rng.random(n) > 0.1)),
    ]
    for w in widths:
        ln = rng.integers(0, w + 1, n).astype(np.int32)
        bm = rng.integers(1, 256, (n, w)).astype(np.uint8)
        bm[np.arange(w)[None, :] >= ln[:, None]] = 0
        cols.append(DeviceColumn(T.STRING, torch.from_numpy(bm),
                                 torch.from_numpy(rng.random(n) > 0.1),
                                 torch.from_numpy(ln)))
    return cols


def _pairs(rng, n_out, n_total, nl, nr):
    """Slot indices with -1 (null sides) and a slot mask whose tail past
    ``n_total`` is false."""
    lidx = rng.integers(-1, nl, n_out).astype(np.int32)
    ridx = rng.integers(-1, nr, n_out).astype(np.int32)
    return (torch.from_numpy(lidx), torch.from_numpy(ridx),
            torch.arange(n_out) < n_total)


def _same_cols(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert g.data.dtype == w.data.dtype and torch.equal(g.data, w.data)
        assert torch.equal(g.validity, w.validity)
        assert (w.lengths is None) == (g.lengths is None)
        if w.lengths is not None:
            assert torch.equal(g.lengths, w.lengths)


def test_k7_gather_pair_one_launch(emu):
    """Both sides of a join output (sides of 700 and 1,900 rows, widths
    3, 16, 21 and 37) in ONE launch, bit for bit; 1,300 slots over three
    512-slot blocks, the last 139 past the output's rows."""
    rng = np.random.default_rng(7)
    left = _side(rng, 700, (3, 16))
    right = _side(rng, 1900, (21, 37))
    lidx, ridx, slot_valid = _pairs(rng, 1300, 1161, 700, 1900)
    want = J.gather_pair_plain(left, lidx, right, ridx, slot_valid)
    J.GATHER_SIDE_LAUNCHES.reset()
    got = J.gather_pair(left, lidx, right, ridx, slot_valid, kernels=emu)
    assert J.GATHER_SIDE_LAUNCHES.count == 1
    _same_cols(got, want)
    # the gather_side call of the same kernel
    J.GATHER_SIDE_LAUNCHES.reset()
    _same_cols(J.gather_side(right, ridx, slot_valid, kernels=emu),
               J.gather_side_plain(right, ridx, slot_valid))
    assert J.GATHER_SIDE_LAUNCHES.count == 1


def test_k7_gather_pair_wider_than_a_table(emu):
    """More columns than one launch's table: as few launches as fit."""
    rng = np.random.default_rng(8)
    left = _side(rng, 300, (5, 9, 13)) * 3
    right = _side(rng, 450, (7, 33)) * 3
    assert len(left) + len(right) > J.GATHER_TABLE_COLUMNS
    lidx, ridx, slot_valid = _pairs(rng, 600, 555, 300, 450)
    want = J.gather_pair_plain(left, lidx, right, ridx, slot_valid)
    J.GATHER_SIDE_LAUNCHES.reset()
    got = J.gather_pair(left, lidx, right, ridx, slot_valid, kernels=emu)
    assert J.GATHER_SIDE_LAUNCHES.count == -(-(len(left) + len(right))
                                            // J.GATHER_TABLE_COLUMNS)
    _same_cols(got, want)


def test_k7_gather_pair_unaligned_rows(emu):
    """A byte matrix viewed from its second column (base address 1 byte
    off): the kernel's copy units fall back to single bytes."""
    rng = np.random.default_rng(9)
    wide = _side(rng, 400, (24,))[-1]
    shifted = DeviceColumn(T.STRING, wide.data[:, 1:].contiguous()[:, :20],
                           wide.validity, torch.clamp(wide.lengths, max=20))
    off = DeviceColumn(T.STRING, torch.from_numpy(np.ascontiguousarray(
        wide.data.numpy().reshape(-1)[1:1 + 400 * 20].reshape(400, 20))),
        wide.validity, torch.clamp(wide.lengths, max=20))
    lidx, ridx, slot_valid = _pairs(rng, 256, 256, 400, 400)
    left, right = [shifted], [off]
    _same_cols(J.gather_pair(left, lidx, right, ridx, slot_valid,
                             kernels=emu),
               J.gather_pair_plain(left, lidx, right, ridx, slot_valid))
