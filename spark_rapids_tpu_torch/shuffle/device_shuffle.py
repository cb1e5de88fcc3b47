"""K10 — the device exchange's partition build and split.

Counterpart of ``spark_rapids_tpu/shuffle/device_shuffle.py``: a shuffle
write groups the rows of each input batch by destination partition
(``partition_order``: a stable grouping by partition id, each
partition's ``counts``/``starts``), reads the counts back once a chunk of
batches (``fetch_counts``), then writes every non-empty partition of
the batch straight from it through that order, in one launch
(``partition_split``), at ``bucket_rows(count)`` rows, the padding zero
and invalid.  The reference's ``packed_build`` (the batch gathered into
one flat block) and ``packed_slice`` (one partition's range at the
block's padded size) stay as its counterparts for the tests against it;
the exchange calls neither.  ``resolve_mode`` is the
``spark.rapids.tpu.shuffle.mode`` choice.

K24 (``exchange_tiles``) is the distributed exchange's tiling
(``spark_rapids_tpu/parallel/exchange.py:bucket_rows`` and
``_gather_tiles``): from K10's build of a shard's rows it writes every
column's ``[n_parts * capacity]`` tile and the lane mask, which the
transport of ``parallel/`` swaps between shards.  ``collective_timer``
wall-clocks each collective into ``collectiveTimeNs``.

The wrappers launch ``csrc/shuffle.cu`` (the build, K24) and
``csrc/gather.cu`` (the split, ``k10_split``) for CUDA tensors and take
the plain PyTorch version only for CPU tensors, unless ``kernels=``
names the libraries to launch.

K25, the grace join's bucket split
(``spark_rapids_tpu/exec/joins.py:108 _bucket_side``), is K10's split
of a batch by key-hash bucket: ``split_by_bucket`` builds the order,
reads all the bucket counts back once and calls ``partition_split``,
whose launches it counts in ``SPLIT_LAUNCHES``.  K24 and K10's split
compute the same lane-to-row function.

``ShuffleStats`` keeps ``deviceBytes``, ``collectiveTimeNs`` and the
cross-process counters of ``parallel/multiprocess.py`` (collectives,
bytes sent, host-staged bytes).  Not
ported, for later slices: the host-staged path and its CRC stamping
(``shuffle.mode=host`` needs the spill tier, ROADMAP A6, and raises),
fallbacks and checkpoint bytes.
"""
from __future__ import annotations

import array
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

#: CUDA kernels launched by K10's build and by its split
BUILD_LAUNCHES = B.LaunchCounter("packed_build")
PARTITION_SPLIT_LAUNCHES = B.LaunchCounter("partition_split")
#: int64 words of a partition in K10's split table (csrc/gather.cu
#: SPLIT_WORDS): first block, first output lane, start, count
PARTITION_SPLIT_WORDS = 4
#: partitions whose table the split's kernel parameters carry
#: (csrc/gather.cu SPLIT_PARAM_PARTS); more go as a table on the card
SPLIT_PARAM_PARTS = 32
#: CUDA kernels launched by K24
TILE_LAUNCHES = B.LaunchCounter("exchange_tiles")
#: K10's split launches for the grace join's bucket split (K25)
SPLIT_LAUNCHES = B.LaunchCounter("bucket_split")

#: the widest fan-out of the shared-memory build (one thread per bucket)
MAX_SHARED_FANOUT = 255
#: int64 words of the build's two 256-bucket uint32 histograms
BUILD_HIST_WORDS = 256
#: columns one K24 launch copies (csrc/shuffle.cu MAX_TILE_COLS)
MAX_TILE_COLS = 32


class ShuffleStats:
    """Process-wide shuffle counters: ``deviceBytes``, the bytes of the
    exchange's partition batches that K10's split wrote on the card
    (data, validity and lengths of every lane, padding included); ``collectiveTimeNs``, the wall of
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
        # the two-buffer histogram (a call counts into one and zeroes the
        # other), then the look-back's status words, kept between calls
        scratch, epoch = S.LOOKBACK.take(
            BUILD_HIST_WORDS + n_out * B.tiles(n), dev, st, "k10_build")
        hist = scratch[:BUILD_HIST_WORDS].view(torch.int32)
        half = hist.shape[0] // 2
        cur, nxt = ((hist[half:], hist[:half]) if epoch & 1
                    else (hist[:half], hist[half:]))
        order = torch.empty(n, dtype=torch.int32, device=dev)
        status = scratch[BUILD_HIST_WORDS:-1]
        B.launch(BUILD_LAUNCHES, lib, "k10_build", B.ptr(pids),
                 B.ptr(num_rows), n, n_out, B.ptr(cur), B.ptr(nxt),
                 B.ptr(status), status.shape[0], epoch, B.ptr(counts),
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
    (the reference's ``packed_build``: K10's build, then K4's gather).
    The exchange splits from the build's order instead
    (``partition_split``)."""
    order, counts, starts = partition_order(pids, batch.num_rows, n_out,
                                            kernels)
    return G.gather_batch(batch, order, batch.num_rows), counts, starts


# ---------------------------------------------------------------------------
# slice (the reference's counterpart; the exchange splits instead)
# ---------------------------------------------------------------------------
def _slice_rows(block: DeviceBatch, start: int, count: int):
    lane = torch.arange(block.padded_rows, dtype=torch.int64,
                        device=block.device)
    idx = torch.clamp(start + lane, 0, max(block.padded_rows - 1, 0))
    return idx, lane < count


def packed_slice_plain(block: DeviceBatch, start: int,
                       count: int) -> DeviceBatch:
    idx, mask = _slice_rows(block, start, count)
    cols = [G.gather_column_plain(c, idx, mask) for c in block.columns]
    return DeviceBatch(block.schema, cols, torch.full(
        (), count, dtype=torch.int32, device=block.device))


def packed_slice(block: DeviceBatch, start: int, count: int,
                 kernels: Optional[B.Kernels] = None) -> DeviceBatch:
    """Partition rows ``[start, start + count)`` of a packed block, moved
    to the front of a batch of the block's padded size (the reference's
    clipped-index gather; validity AND lane < count), by K4's gather.
    ``start`` and ``count`` are host ints from ``fetch_counts``.  The
    exchange does not slice: ``partition_split`` writes each partition
    once, from the batch."""
    kernels = B.kernels_for(block.columns[0].validity, kernels)
    if kernels is None:
        return packed_slice_plain(block, start, count)
    idx, mask = _slice_rows(block, start, count)
    return DeviceBatch(block.schema, G.gather_columns(
        block.columns, idx.to(torch.int32), mask, kernels), torch.full(
            (), count, dtype=torch.int32, device=block.device))


# ---------------------------------------------------------------------------
# split: every non-empty partition of a batch, written once
# ---------------------------------------------------------------------------
def bucket_layout(counts: Sequence[int], min_bucket_rows: int = 128
                  ) -> List[Tuple[int, int, int, int]]:
    """``(partition, start, count, capacity)`` of every non-empty
    partition, from the host counts of K10's order: a partition's rows
    start where the lower partitions' end, and its batch holds
    ``bucket_rows(count)`` rows (the reference's ``slice_device_batch``
    of a compacted bucket)."""
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


def partition_split_plain(batch: DeviceBatch, order: torch.Tensor,
                          counts: Sequence[int], min_bucket_rows: int = 128
                          ) -> List[Optional[DeviceBatch]]:
    """Plain version of K10's split: each non-empty partition built by
    ``index_select`` of its slice of the order, zero and invalid past its
    count; None for an empty partition."""
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


def partition_split(batch: DeviceBatch, order: torch.Tensor,
                    counts: Sequence[int],
                    kernels: Optional[B.Kernels] = None,
                    min_bucket_rows: int = 128,
                    device_counts: Optional[torch.Tensor] = None,
                    launches: B.LaunchCounter = PARTITION_SPLIT_LAUNCHES
                    ) -> List[Optional[DeviceBatch]]:
    """K10's split: every column of ``batch`` written into one batch per
    non-empty partition, in one launch (up to ``gather.TABLE_COLUMNS``
    columns): partition ``p``'s row ``l`` is the batch's row
    ``order[starts[p] + l]`` for ``l < counts[p]``, and zero, invalid and
    of length 0 past it, at ``bucket_rows(counts[p])`` rows.  ``order`` is
    K10's ``partition_order`` of the batch, ``counts`` its counts as host
    ints (any fan-out), ``device_counts`` the same counts on the card
    (the build's; each partition's row count is a view of them).  The
    outputs are one block a (dtype, row shape) with every partition's
    rows end to end, cut into views.  None for an empty partition.
    ``launches`` counts the kernel's launches (the grace join's bucket
    split counts its own)."""
    kernels = B.kernels_for(order, kernels)
    if kernels is None:
        return partition_split_plain(batch, order, counts, min_bucket_rows)
    layout = bucket_layout(counts, min_bucket_rows)
    out: List[Optional[DeviceBatch]] = [None] * len(counts)
    if not layout:
        return out
    dev = order.device
    words, blocks, lanes = [], 0, 0
    for _p, start, cnt, cap in layout:
        words += [blocks, lanes, start, cnt]
        blocks += -(-cap // B.TILE)
        lanes += cap
    words += [blocks, lanes, 0, 0]
    if device_counts is None:
        device_counts = torch.tensor(list(counts), dtype=torch.int32).to(dev)
    # up to SPLIT_PARAM_PARTS partitions travel in the kernel's parameters,
    # more in a table on the card
    host = table = None
    if len(layout) <= SPLIT_PARAM_PARTS:
        host = array.array("q", words)
    else:
        table = B.device_table(words, dev)
    order = order.to(torch.int32).contiguous()
    cols = G.move(launches, kernels.library("gather"),
                  "k10_split", [batch.columns], lanes, dev,
                  (order.data_ptr(),
                   None if host is None else host.buffer_info()[0],
                   B.ptr(table), len(layout), blocks, kernels.stream(order)))
    for i, (p, _start, _cnt, cap) in enumerate(layout):
        lane = words[PARTITION_SPLIT_WORDS * i + 1]
        out[p] = DeviceBatch(batch.schema, [DeviceColumn(
            c.dtype, c.data[lane:lane + cap], c.validity[lane:lane + cap],
            None if c.lengths is None else c.lengths[lane:lane + cap])
            for c in cols], device_counts[p])
    return out


def split_bytes(batch: DeviceBatch, counts: Sequence[int],
                min_bucket_rows: int = 128) -> int:
    """Bytes K10's build and split must move for one batch: the real
    rows' 4-byte pids read twice (histogram, scatter), their order entry
    written and read, each real row's data, validity and lengths read
    once and written once, and every padding row of the outputs written
    once (``bucket_split_bytes``, which counts the order's read)."""
    rows = sum(counts)
    return 12 * rows + bucket_split_bytes(batch, counts, min_bucket_rows)


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
    for at in range(0, max(len(desc), 1), MAX_TILE_COLS):
        part = desc[at:at + MAX_TILE_COLS]
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
# K25: the grace join's bucket split (K10's split)
# ---------------------------------------------------------------------------
def split_by_bucket(batch: DeviceBatch, pids: torch.Tensor, m: int,
                    kernels: Optional[B.Kernels] = None,
                    min_bucket_rows: int = 128):
    """``batch``'s rows split by their bucket ids ``pids`` (in ``[0,
    m)``): K10's stable order by bucket, ONE host read of all ``m``
    counts, then K10's split (one launch, counted in ``SPLIT_LAUNCHES``).
    Returns ``(buckets, counts)``: a batch or None per bucket, and the
    counts as host ints."""
    order, dev_counts, _starts = partition_order(pids, batch.num_rows, m,
                                                 kernels)
    counts = dev_counts.cpu().tolist()
    return partition_split(batch, order, counts, kernels, min_bucket_rows,
                           device_counts=dev_counts,
                           launches=SPLIT_LAUNCHES), counts


def bucket_split_bytes(batch: DeviceBatch, counts: Sequence[int],
                       min_bucket_rows: int = 128) -> int:
    """Bytes K10's split must move: each real row's data, validity and
    lengths read once and written once, its 4-byte order entry read, and
    every padding row of the outputs written once."""
    per_row = sum(G._row_bytes(c.data) + 1 +
                  (4 if c.lengths is not None else 0)
                  for c in batch.columns)
    total = 0
    for _b, _start, cnt, cap in bucket_layout(counts, min_bucket_rows):
        total += cnt * (2 * per_row + 4) + (cap - cnt) * per_row
    return total
