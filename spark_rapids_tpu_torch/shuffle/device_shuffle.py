"""K10 — the device exchange's packed partition blocks.

Counterpart of ``spark_rapids_tpu/shuffle/device_shuffle.py``: a shuffle
write groups the rows of each input batch by destination partition into
ONE flat device block (``packed_build``: a stable grouping by partition
id, then K4's gather) and records per-partition ``counts``/``starts``;
readers slice their contiguous range out of the resident block
(``packed_slice``) at the block's padded size.  ``fetch_counts`` is the
write path's one batched host readback per chunk of blocks, and
``resolve_mode`` the ``spark.rapids.tpu.shuffle.mode`` choice.

K24 (``exchange_tiles``) is the distributed exchange's tiling
(``spark_rapids_tpu/parallel/exchange.py:bucket_rows`` and
``_gather_tiles``): from K10's build of a shard's rows it writes every
column's ``[n_parts * capacity]`` tile and the lane mask, which the
transport of ``parallel/`` swaps between shards.  ``collective_timer``
wall-clocks each collective into ``collectiveTimeNs``.

The wrappers launch ``csrc/shuffle.cu`` for CUDA tensors and take the
plain PyTorch version only for CPU tensors, unless ``kernels=`` names the
libraries to launch.

``ShuffleStats`` keeps ``deviceBytes`` and ``collectiveTimeNs``.  Not
ported, for later slices: the host-staged path and its CRC stamping
(``shuffle.mode=host`` needs the spill tier, ROADMAP A6, and raises),
fallbacks and checkpoint bytes.
"""
from __future__ import annotations

import ctypes
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..data.column import DeviceBatch, DeviceColumn
from ..ops.kernels import _build as B
from ..ops.kernels import gather as G
from ..ops.kernels import segment as S
from .. import types as T

#: CUDA kernels launched by K10's build and slice
BUILD_LAUNCHES = B.LaunchCounter("packed_build")
SLICE_LAUNCHES = B.LaunchCounter("packed_slice")
#: CUDA kernels launched by K24
TILE_LAUNCHES = B.LaunchCounter("exchange_tiles")

#: the widest fan-out of the shared-memory build (one thread per bucket)
MAX_SHARED_FANOUT = 255
#: columns one slice launch copies (csrc/shuffle.cu MAX_SLICE_COLS)
MAX_SLICE_COLS = 32


class ShuffleStats:
    """Process-wide shuffle counters: ``deviceBytes``, the bytes of the
    packed blocks written on the card, and ``collectiveTimeNs``, the wall
    of the distributed runner's collectives (the port runs its exchanges
    on one thread, so no lock)."""

    _KEYS = ("deviceBytes", "collectiveTimeNs")

    def __init__(self):
        self._values: Dict[str, int] = {k: 0 for k in self._KEYS}

    def reset(self) -> None:
        for k in self._KEYS:
            self._values[k] = 0

    def add(self, name: str, v: int = 1) -> None:
        self._values[name] = self._values.get(name, 0) + v

    def counters(self) -> Dict[str, int]:
        return dict(self._values)

    def metrics_since(self, mark: Optional[Dict[str, int]]
                      ) -> Dict[str, int]:
        """The ``shuffle.*`` counter deltas since ``mark`` (a
        ``counters()`` snapshot)."""
        return {f"shuffle.{k}": v - (mark or {}).get(k, 0)
                for k, v in self.counters().items()}


#: THE process-wide instance
GLOBAL = ShuffleStats()


@contextmanager
def collective_timer():
    """Wall-clock one collective of the distributed runner into
    ``collectiveTimeNs``."""
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        GLOBAL.add("collectiveTimeNs", time.perf_counter_ns() - t0)


def resolve_mode(conf_mode: str) -> str:
    """The exchange data path for one shuffle write: ``device`` for
    ``device`` and for ``auto`` (the port keeps no arena, so it always
    has headroom); ``host`` needs the spill tier and raises."""
    mode = (conf_mode or "auto").lower()
    if mode not in ("device", "host", "auto"):
        raise ValueError(
            f"shuffle.mode must be device|host|auto, got {conf_mode!r}")
    if mode == "host":
        raise NotImplementedError(
            "spark.rapids.tpu.shuffle.mode=host stages every exchange block "
            "in host memory, which needs the spill tier (ROADMAP A6); it is "
            "not ported yet")
    return "device"


def fetch_counts(handles: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 num_rows: Sequence[torch.Tensor]
                 ) -> List[Tuple[List[int], List[int], int]]:
    """The ONE host readback of a write chunk: every block's ``counts``
    and ``starts`` (int32[n_out] each) and its input batch's row count,
    in one copy; returns ``(counts, starts, rows)`` per block as host
    ints."""
    if not handles:
        return []
    flat = torch.stack([torch.cat([c, s, n.to(torch.int32).reshape(1)])
                        for (c, s), n in zip(handles, num_rows)]).cpu()
    n_out = handles[0][0].shape[0]
    return [(row[:n_out].tolist(), row[n_out:2 * n_out].tolist(),
             int(row[2 * n_out])) for row in flat]


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------
def partition_order_plain(pids: torch.Tensor, num_rows: torch.Tensor,
                          n_out: int):
    """Plain version of K10's build: the stable argsort of
    ``where(row < num_rows, pids, n_out)`` and each partition's count and
    start."""
    lane = torch.arange(pids.shape[0], dtype=torch.int32,
                        device=pids.device)
    b = torch.where(lane < num_rows, pids.to(torch.int64),
                    torch.full((), n_out, dtype=torch.int64,
                               device=pids.device))
    order = torch.sort(b, stable=True).indices.to(torch.int32)
    counts = torch.bincount(b, minlength=n_out + 1)[:n_out]
    starts = torch.cumsum(counts, 0) - counts
    return order, counts.to(torch.int32), starts.to(torch.int32)


def partition_order(pids: torch.Tensor, num_rows: torch.Tensor, n_out: int,
                    kernels: Optional[B.Kernels] = None):
    """K10: rows grouped by partition id, stably, padding rows (at or past
    ``num_rows``) after every real row; returns ``(order int32[n],
    counts int32[n_out], starts int32[n_out])``.  ``pids`` of real rows
    must lie in ``[0, n_out)``."""
    kernels = B.kernels_for(pids, kernels)
    if kernels is None:
        return partition_order_plain(pids, num_rows, n_out)
    lib = kernels.library("shuffle")
    n = pids.shape[0]
    dev = pids.device
    st = kernels.stream(pids)
    pids = pids.to(torch.int32).contiguous()
    num_rows = num_rows.to(torch.int32).contiguous()
    counts = torch.empty(n_out, dtype=torch.int32, device=dev)
    starts = torch.empty(n_out, dtype=torch.int32, device=dev)
    if n_out <= MAX_SHARED_FANOUT:
        scratch = torch.empty((n_out + 1) * B.tiles(n), dtype=torch.int32,
                              device=dev)
        order = torch.empty(n, dtype=torch.int32, device=dev)
        B.launch(BUILD_LAUNCHES, lib, "k10_build", B.ptr(pids),
                 B.ptr(num_rows), n, n_out, B.ptr(scratch), B.ptr(counts),
                 B.ptr(starts), B.ptr(order), st)
        return order, counts, starts
    # a fan-out past the shared histogram: counts and starts from the
    # global histogram, the order from K1's radix sort of the bucket ids
    scratch = torch.zeros(n_out + 1, dtype=torch.int32, device=dev)
    B.launch(BUILD_LAUNCHES, lib, "k10_counts_wide", B.ptr(pids),
             B.ptr(num_rows), n, n_out, B.ptr(scratch), B.ptr(counts),
             B.ptr(starts), st)
    rm = torch.arange(n, dtype=torch.int32, device=dev) < num_rows
    # padding rows are null keys, so they tie and keep their row order
    key = DeviceColumn(T.INT32, pids, rm)
    order = S.lexsort_device([key], pad_valid=rm, kernels=kernels)
    return order, counts, starts


def packed_build(batch: DeviceBatch, pids: torch.Tensor, n_out: int,
                 kernels: Optional[B.Kernels] = None):
    """Group ``batch``'s rows by destination partition inside one flat
    block: ``(block, counts, starts)``, where ``counts[p]``/``starts[p]``
    delimit partition ``p``'s contiguous rows and padding rows come last
    (the reference's ``packed_build``)."""
    order, counts, starts = partition_order(pids, batch.num_rows, n_out,
                                            kernels)
    return G.gather_batch(batch, order, batch.num_rows), counts, starts


# ---------------------------------------------------------------------------
# slice
# ---------------------------------------------------------------------------
def packed_slice_plain(block: DeviceBatch, start: int,
                       count: int) -> DeviceBatch:
    padded = block.padded_rows
    lane = torch.arange(padded, dtype=torch.int64, device=block.device)
    idx = torch.clamp(start + lane, 0, max(padded - 1, 0))
    mask = lane < count
    cols = [G.gather_column_plain(c, idx, mask) for c in block.columns]
    return DeviceBatch(block.schema, cols, torch.full(
        (), count, dtype=torch.int32, device=block.device))


def packed_slice(block: DeviceBatch, start: int, count: int,
                 kernels: Optional[B.Kernels] = None) -> DeviceBatch:
    """K10: partition rows ``[start, start + count)`` of a packed block,
    moved to the front of a batch of the block's padded size (a
    clipped-index gather; validity AND lane < count).  ``start`` and
    ``count`` are host ints from ``fetch_counts``."""
    kernels = B.kernels_for(block.columns[0].validity, kernels)
    if kernels is None:
        return packed_slice_plain(block, start, count)
    lib = kernels.library("shuffle")
    padded = block.padded_rows
    dev = block.device
    st = kernels.stream(block.columns[0].validity)
    cols, desc = [], []
    for c in block.columns:
        data = c.data.contiguous()
        valid = c.validity.contiguous()
        out = DeviceColumn(c.dtype, torch.empty_like(data),
                           torch.empty_like(valid),
                           None if c.lengths is None
                           else torch.empty_like(c.lengths.contiguous()))
        lengths = None if c.lengths is None else c.lengths.contiguous()
        cols.append(out)
        desc.append([B.ptr(data), B.ptr(out.data), B.ptr(valid),
                     B.ptr(out.validity), B.ptr(lengths) or 0,
                     B.ptr(out.lengths) or 0, G._row_bytes(data)])
    for at in range(0, len(desc), MAX_SLICE_COLS):
        part = desc[at:at + MAX_SLICE_COLS]
        flat = [v for d in part for v in d]
        B.launch(SLICE_LAUNCHES, lib, "k10_slice",
                 (ctypes.c_longlong * len(flat))(*flat), len(part), padded,
                 start, count, st)
    return DeviceBatch(block.schema, cols, torch.full(
        (), count, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# K24: the distributed exchange's tiles
# ---------------------------------------------------------------------------
def tile_rows_plain(order: torch.Tensor, starts: torch.Tensor,
                    counts: torch.Tensor, capacity: int):
    """The reference's ``bucket_rows`` on K10's build: ``rows[d, lane] =
    order[clip(starts[d] + lane, 0, n - 1)]`` (int64[P, C]) and ``valid =
    lane < counts[d]`` (bool[P, C])."""
    n = order.shape[0]
    lane = torch.arange(capacity, dtype=torch.int64, device=order.device)
    gidx = starts.to(torch.int64)[:, None] + lane[None, :]
    valid = lane[None, :] < counts.to(torch.int64)[:, None]
    rows = order.to(torch.int64)[torch.clamp(gidx, 0, n - 1)]
    return rows, valid


def _tile_width(c: DeviceColumn, width: Optional[int]) -> int:
    return c.data.shape[1] if width is None else width


def exchange_tiles_plain(batch: DeviceBatch, order: torch.Tensor,
                         starts: torch.Tensor, counts: torch.Tensor,
                         capacity: int,
                         widths: Optional[Sequence[Optional[int]]] = None):
    """Plain version of K24: the reference's ``_gather_tiles`` by
    ``tile_rows_plain``'s rows, flattened to ``[P * C]``, string tiles
    zero-padded to ``widths``; returns ``(tiles, lane_valid)``."""
    rows, valid = tile_rows_plain(order, starts, counts, capacity)
    rows, valid = rows.reshape(-1), valid.reshape(-1)
    widths = widths or [None] * len(batch.columns)
    tiles = []
    for c, w in zip(batch.columns, widths):
        data = c.data[rows]
        if data.dim() == 2:
            data = torch.nn.functional.pad(
                data, (0, _tile_width(c, w) - data.shape[1]))
        tiles.append(DeviceColumn(
            c.dtype, data, c.validity[rows] & valid,
            None if c.lengths is None else c.lengths[rows]))
    return tiles, valid


def exchange_tiles(batch: DeviceBatch, order: torch.Tensor,
                   starts: torch.Tensor, counts: torch.Tensor,
                   capacity: int,
                   widths: Optional[Sequence[Optional[int]]] = None,
                   kernels: Optional[B.Kernels] = None):
    """K24: every column of ``batch`` cut into ``[P * capacity]`` tiles by
    destination, from K10's ``partition_order`` of the batch (``order``,
    ``starts``, ``counts``): lane ``l`` of destination ``d`` holds row
    ``order[clip(starts[d] + l, 0, n - 1)]``, its validity AND ``l <
    counts[d]``; rows past the capacity are dropped.  A string tile is
    ``widths[i]`` bytes wide (None: the column's own width).  Returns
    ``(tiles, lane_valid bool[P * capacity])``."""
    kernels = B.kernels_for(order, kernels)
    if kernels is None:
        return exchange_tiles_plain(batch, order, starts, counts, capacity,
                                    widths)
    n = order.shape[0]
    n_parts = counts.shape[0]
    total = n_parts * capacity
    dev = order.device
    st = kernels.stream(order)
    widths = widths or [None] * len(batch.columns)
    tiles, desc = [], []
    for c, w in zip(batch.columns, widths):
        data = c.data.contiguous()
        valid = c.validity.contiguous()
        shape = (total, _tile_width(c, w)) if data.dim() == 2 else (total,)
        out = DeviceColumn(c.dtype,
                           torch.empty(shape, dtype=data.dtype, device=dev),
                           torch.empty(total, dtype=torch.bool, device=dev),
                           None if c.lengths is None else torch.empty(
                               total, dtype=torch.int32, device=dev))
        lengths = None if c.lengths is None else \
            c.lengths.to(torch.int32).contiguous()
        tiles.append(out)
        desc.append([B.ptr(data), B.ptr(out.data), B.ptr(valid),
                     B.ptr(out.validity), B.ptr(lengths) or 0,
                     B.ptr(out.lengths) or 0, G._row_bytes(data),
                     G._row_bytes(out.data)])
    lane_valid = torch.empty(total, dtype=torch.bool, device=dev)
    order = order.to(torch.int32).contiguous()
    starts = starts.to(torch.int32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    for at in range(0, max(len(desc), 1), MAX_SLICE_COLS):
        part = desc[at:at + MAX_SLICE_COLS]
        flat = [v for d in part for v in d] or [0]
        B.launch(TILE_LAUNCHES, kernels.library("shuffle"), "k24_tiles",
                 (ctypes.c_longlong * len(flat))(*flat), len(part), n,
                 B.ptr(order), B.ptr(starts), B.ptr(counts), n_parts,
                 capacity, B.ptr(lane_valid) if at == 0 else None, st)
    return tiles, lane_valid


def exchange_tiles_bytes(batch: DeviceBatch, tiles: Sequence[DeviceColumn],
                         starts: torch.Tensor, counts: torch.Tensor,
                         capacity: int) -> int:
    """Bytes K24 must move: every lane's tile entry (data, validity,
    lengths) and lane-mask entry written once; starts and counts read;
    and each row that some lane reads (its order entry, data, validity and
    lengths) read once.  A lane past ``counts[d]`` reads a row of
    destination ``d + 1`` or, past the end, row ``n - 1``, so the rows read
    are the union of ``[starts[d], min(starts[d] + capacity, n))`` over
    the destinations, not one a lane."""
    n = batch.padded_rows
    n_parts = counts.shape[0]
    lanes = n_parts * capacity
    spans = sorted((min(s, n - 1), max(min(s + capacity, n), min(s, n - 1)
                                       + 1))
                   for s in starts.tolist())
    read, reach = 0, 0
    for lo, hi in spans:
        read += max(hi - max(lo, reach), 0)
        reach = max(reach, hi)
    total = lanes + 8 * n_parts + 4 * read
    for c, t in zip(batch.columns, tiles):
        row = G._row_bytes(c.data) + 1 + (4 if c.lengths is not None else 0)
        out = G._row_bytes(t.data) + 1 + (4 if t.lengths is not None else 0)
        total += read * row + lanes * out
    return total
