"""K24 (the distributed exchange's tiles, ``csrc/shuffle.cu``), built for
the CPU with the host C++ compiler against ``csrc/emulator/cuda_runtime.h``
(``test_torch_kernels_emulated._build_emulated``), fed by K10's emulated
build and held against its plain PyTorch version on the same inputs.

Shapes: 700 logical rows padded to 1,024 over 1, 3 and 8 destinations,
at capacities below, at and above the largest destination count, over
every column type with nulls (one-byte to eight-byte elements, a string
matrix); string tiles written at the source width and wider; 40 columns
(two launches, the lane mask written once); no column at all (the lane
mask alone).  Every lane is compared to the byte: data, validity,
lengths, the lane mask, and the launch counts.

Mutation check: a K24 whose tile validity ignores the lane mask, built
from an edited copy of ``shuffle.cu``, must disagree with the plain
version."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.column import DeviceBatch, DeviceColumn
from spark_rapids_tpu_torch.ops.kernels import _build as B
from spark_rapids_tpu_torch.shuffle import device_shuffle as DS
from test_torch_kernels_emulated import _build_emulated
from test_torch_kernels_emulated_generate import _mutant

N, P = 700, 1024
_NP = {T.BOOL: np.bool_, T.INT8: np.int8, T.INT16: np.int16,
       T.INT32: np.int32, T.INT64: np.int64, T.FLOAT32: np.float32,
       T.FLOAT64: np.float64, T.DATE32: np.int32, T.TIMESTAMP: np.int64}


@pytest.fixture(scope="module")
def emu():
    out = _build_emulated()
    return B.Kernels(lambda: out, lambda t: None)


def _batch(seed, n_cols=None, width=6):
    """Every column type with nulls (or ``n_cols`` int64 columns)."""
    rng = np.random.default_rng(seed)
    types = [T.INT64] * n_cols if n_cols is not None else \
        list(_NP) + [T.STRING]
    cols = []
    for t in types:
        valid = np.zeros(P, np.bool_)
        valid[:N] = rng.random(N) > 0.2
        lengths = None
        if t.is_string:
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


def _build(emu, n_parts, seed):
    rng = np.random.default_rng(seed)
    pids = torch.from_numpy(rng.integers(0, n_parts, P).astype(np.int32))
    nr = torch.tensor(N, dtype=torch.int32)
    got = DS.partition_order(pids, nr, n_parts, kernels=emu)
    want = DS.partition_order_plain(pids, nr, n_parts)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


def _same(got, want):
    tiles, lane = got
    wtiles, wlane = want
    assert torch.equal(lane, wlane)
    assert len(tiles) == len(wtiles)
    for g, w in zip(tiles, wtiles):
        assert g.data.shape == w.data.shape and g.data.dtype == w.data.dtype
        assert torch.equal(g.data.contiguous().view(torch.uint8),
                           w.data.contiguous().view(torch.uint8))
        assert torch.equal(g.validity, w.validity)
        assert (g.lengths is None) == (w.lengths is None)
        if w.lengths is not None:
            assert torch.equal(g.lengths, w.lengths)


@pytest.mark.parametrize("n_parts", [1, 3, 8])
def test_k24_matches_plain(emu, n_parts):
    batch = _batch(n_parts)
    order, counts, starts = _build(emu, n_parts, 100 + n_parts)
    most = int(counts.max())
    for cap in (max(most // 3, 1), most, most + 37):
        before = DS.TILE_LAUNCHES.count
        got = DS.exchange_tiles(batch, order, starts, counts, cap,
                                kernels=emu)
        assert DS.TILE_LAUNCHES.count - before == 1
        _same(got, DS.exchange_tiles_plain(batch, order, starts, counts,
                                           cap))


def test_k24_wider_string_tiles_match_plain(emu):
    batch = _batch(7)
    order, counts, starts = _build(emu, 3, 7)
    widths = [None] * (len(batch.columns) - 1) + [19]
    got = DS.exchange_tiles(batch, order, starts, counts, 300, widths,
                            kernels=emu)
    assert got[0][-1].data.shape == (900, 19)
    _same(got, DS.exchange_tiles_plain(batch, order, starts, counts, 300,
                                       widths))


def test_k24_many_columns_and_none(emu):
    batch = _batch(9, n_cols=40)
    order, counts, starts = _build(emu, 4, 9)
    cap = int(counts.max())
    before = DS.TILE_LAUNCHES.count
    got = DS.exchange_tiles(batch, order, starts, counts, cap, kernels=emu)
    assert DS.TILE_LAUNCHES.count - before == 2
    _same(got, DS.exchange_tiles_plain(batch, order, starts, counts, cap))
    empty = DeviceBatch(T.Schema([]), [], batch.num_rows)
    got = DS.exchange_tiles(empty, order, starts, counts, cap, kernels=emu)
    _same(got, DS.exchange_tiles_plain(empty, order, starts, counts, cap))


def test_k24_without_lane_mask_mutant_differs(emu):
    mutant = _mutant("shuffle", ("c.dst_valid[t] = c.src_valid[row] && in;",
                                 "c.dst_valid[t] = c.src_valid[row];"))
    batch = _batch(11)
    order, counts, starts = _build(emu, 3, 11)
    cap = int(counts.max()) + 50
    got, _lane = DS.exchange_tiles(batch, order, starts, counts, cap,
                                   kernels=mutant)
    want, _lane = DS.exchange_tiles_plain(batch, order, starts, counts, cap)
    assert not torch.equal(got[0].validity, want[0].validity)
