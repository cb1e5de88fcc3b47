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

K25 (``bucket_split``) is the grace join's bucket split
(``spark_rapids_tpu/exec/joins.py:108 _bucket_side``): from K10's order
of a batch by key-hash bucket and the bucket counts read back once, one
launch writes every column of every non-empty bucket into a dense batch
of its own at ``bucket_rows(count)`` rows, the padding zero and invalid.
``split_by_bucket`` chains the two.

``ShuffleStats`` keeps ``deviceBytes``, ``collectiveTimeNs`` and the
cross-process counters of ``parallel/multiprocess.py`` (collectives,
bytes sent, host-staged bytes).  Not
ported, for later slices: the host-staged path and its CRC stamping
(``shuffle.mode=host`` needs the spill tier, ROADMAP A6, and raises),
fallbacks and checkpoint bytes.
"""
from __future__ import annotations

import ctypes
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..data.column import DeviceBatch, DeviceColumn, bucket_rows
from ..ops.kernels import _build as B
from ..ops.kernels import gather as G
from ..ops.kernels import segment as S
from .. import types as T

#: CUDA kernels launched by K10's build and slice
BUILD_LAUNCHES = B.LaunchCounter("packed_build")
SLICE_LAUNCHES = B.LaunchCounter("packed_slice")
#: CUDA kernels launched by K24
TILE_LAUNCHES = B.LaunchCounter("exchange_tiles")
#: CUDA kernels launched by K25
SPLIT_LAUNCHES = B.LaunchCounter("bucket_split")
#: int64 words of a column and of a bucket in K25's table
#: (csrc/bucket.cu COL_WORDS, BUCKET_WORDS); a bucket's count is its
#: third word
SPLIT_COL_WORDS = 4
SPLIT_BUCKET_WORDS = 4

#: the widest fan-out of the shared-memory build (one thread per bucket)
MAX_SHARED_FANOUT = 255
#: columns one slice launch copies (csrc/shuffle.cu MAX_SLICE_COLS)
MAX_SLICE_COLS = 32


class ShuffleStats:
    """Process-wide shuffle counters: ``deviceBytes``, the bytes of the
    packed blocks written on the card; ``collectiveTimeNs``, the wall of
    the distributed runner's collectives (a single-process transport's
    whole exchange; across processes, each ``torch.distributed`` call);
    ``processCollectives``, the ``torch.distributed`` calls this process
    made; ``processBytesSent``, the bytes it sent to other processes; and
    ``hostStagedBytes``, the bytes it copied between the card and host
    memory to take part in a collective whose backend works on host
    tensors (gloo).  Counters are added under a lock: a guarded
    collective runs on a thread of its own."""

    _KEYS = ("deviceBytes", "collectiveTimeNs", "processCollectives",
             "processBytesSent", "hostStagedBytes")

    def __init__(self):
        self._values: Dict[str, int] = {k: 0 for k in self._KEYS}
        self._lock = threading.Lock()

    def reset(self) -> None:
        with self._lock:
            for k in self._KEYS:
                self._values[k] = 0

    def add(self, name: str, v: int = 1) -> None:
        with self._lock:
            self._values[name] = self._values.get(name, 0) + v

    def counters(self) -> Dict[str, int]:
        with self._lock:
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
def collective_timer(bytes_sent: int = 0, process: bool = False):
    """Wall-clock one collective of the distributed runner into
    ``collectiveTimeNs``; with ``process``, a ``torch.distributed`` call
    that sends ``bytes_sent`` bytes to other processes."""
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        GLOBAL.add("collectiveTimeNs", time.perf_counter_ns() - t0)
        if process:
            GLOBAL.add("processCollectives", 1)
            GLOBAL.add("processBytesSent", bytes_sent)


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


# ---------------------------------------------------------------------------
# K25: the grace join's bucket split
# ---------------------------------------------------------------------------
def bucket_layout(counts: Sequence[int], min_bucket_rows: int = 128
                  ) -> List[Tuple[int, int, int, int]]:
    """``(bucket, start, count, capacity)`` of every non-empty bucket, from
    the host counts of K10's order: a bucket's rows start where the lower
    buckets' end, and its batch holds ``bucket_rows(count)`` rows (the
    reference's ``slice_device_batch`` of the compacted bucket)."""
    out, start = [], 0
    for b, cnt in enumerate(counts):
        if cnt:
            out.append((b, start, cnt, bucket_rows(cnt, min_bucket_rows)))
        start += cnt
    return out


def _take_rows(t: torch.Tensor, idx: torch.Tensor, cap: int) -> torch.Tensor:
    """``t``'s rows ``idx`` at the front of ``cap`` zeroed rows."""
    out = torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[:idx.shape[0]] = t.index_select(0, idx)
    return out


def bucket_split_plain(batch: DeviceBatch, order: torch.Tensor,
                       counts: Sequence[int], min_bucket_rows: int = 128
                       ) -> List[Optional[DeviceBatch]]:
    """Plain version of K25: each non-empty bucket built by
    ``index_select`` of the order's slice, zero and invalid past its
    count; None for an empty bucket."""
    out: List[Optional[DeviceBatch]] = [None] * len(counts)
    dev = order.device
    for b, start, cnt, cap in bucket_layout(counts, min_bucket_rows):
        idx = order[start:start + cnt].to(torch.int64)
        cols = [DeviceColumn(
            c.dtype, _take_rows(c.data, idx, cap),
            _take_rows(c.validity, idx, cap),
            None if c.lengths is None
            else _take_rows(c.lengths.to(torch.int32), idx, cap))
            for c in batch.columns]
        out[b] = DeviceBatch(batch.schema, cols, torch.tensor(
            cnt, dtype=torch.int32, device=dev))
    return out


def bucket_split(batch: DeviceBatch, order: torch.Tensor,
                 counts: Sequence[int], kernels: Optional[B.Kernels] = None,
                 min_bucket_rows: int = 128) -> List[Optional[DeviceBatch]]:
    """K25: every column of ``batch`` gathered into one dense batch per
    non-empty bucket, in one launch: bucket ``b``'s row ``j`` is the
    batch's row ``order[starts[b] + j]`` for ``j < counts[b]``, and zero
    and invalid past it, at ``bucket_rows(counts[b])`` rows.  ``order`` is
    K10's ``partition_order`` of the rows' bucket ids, ``counts`` its
    counts as host ints (at most 64 buckets).  None for an empty
    bucket."""
    kernels = B.kernels_for(order, kernels)
    if kernels is None:
        return bucket_split_plain(batch, order, counts, min_bucket_rows)
    layout = bucket_layout(counts, min_bucket_rows)
    out: List[Optional[DeviceBatch]] = [None] * len(counts)
    if not layout:
        return out
    dev = order.device
    srcs, words = [], []
    for c in batch.columns:
        data = c.data.contiguous()
        valid = c.validity.contiguous()
        lengths = None if c.lengths is None else \
            c.lengths.to(torch.int32).contiguous()
        srcs.append((data, valid, lengths))
        words += [B.ptr(data), B.ptr(valid), B.ptr(lengths) or 0,
                  G._row_bytes(data)]
    lane = 0
    for _b, start, cnt, cap in layout:
        words += [lane, start, cnt, cap]
        lane += cap
    bucket_cols = []
    for _b, _start, _cnt, cap in layout:
        cols = []
        for c, (data, _valid, lengths) in zip(batch.columns, srcs):
            o = DeviceColumn(
                c.dtype, torch.empty((cap,) + tuple(data.shape[1:]),
                                     dtype=data.dtype, device=dev),
                torch.empty(cap, dtype=torch.bool, device=dev),
                None if lengths is None else
                torch.empty(cap, dtype=torch.int32, device=dev))
            cols.append(o)
            words += [B.ptr(o.data), B.ptr(o.validity),
                      B.ptr(o.lengths) or 0]
        bucket_cols.append(cols)
    table = B.device_table(words, dev)
    # each bucket's row count: its count word of the table
    at = SPLIT_COL_WORDS * len(batch.columns) + 2
    num_rows = table[at:at + SPLIT_BUCKET_WORDS * len(layout):
                     SPLIT_BUCKET_WORDS].to(torch.int32)
    for i, ((b, _s, _c, _cap), cols) in enumerate(zip(layout, bucket_cols)):
        out[b] = DeviceBatch(batch.schema, cols, num_rows[i])
    order = order.to(torch.int32).contiguous()
    B.launch(SPLIT_LAUNCHES, kernels.library("bucket"), "k25_bucket_split",
             B.ptr(table), len(batch.columns), len(layout), lane,
             B.ptr(order), kernels.stream(order))
    return out


def split_by_bucket(batch: DeviceBatch, pids: torch.Tensor, m: int,
                    kernels: Optional[B.Kernels] = None,
                    min_bucket_rows: int = 128):
    """``batch``'s rows split by their bucket ids ``pids`` (in ``[0,
    m)``): K10's stable order by bucket, ONE host read of all ``m``
    counts, then K25.  Returns ``(buckets, counts)``: a batch or None per
    bucket, and the counts as host ints."""
    order, counts, _starts = partition_order(pids, batch.num_rows, m,
                                             kernels)
    counts = counts.cpu().tolist()
    return bucket_split(batch, order, counts, kernels,
                        min_bucket_rows), counts


def bucket_split_bytes(batch: DeviceBatch, counts: Sequence[int],
                       min_bucket_rows: int = 128) -> int:
    """Bytes K25 must move: each real row's data, validity and lengths
    read once and written once, its 4-byte order entry read, and every
    padding row of the outputs written once."""
    per_row = sum(G._row_bytes(c.data) + 1 +
                  (4 if c.lengths is not None else 0)
                  for c in batch.columns)
    total = 0
    for _b, _start, cnt, cap in bucket_layout(counts, min_bucket_rows):
        total += cnt * (2 * per_row + 4) + (cap - cnt) * per_row
    return total
