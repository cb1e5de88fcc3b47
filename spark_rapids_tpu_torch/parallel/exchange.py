"""Collective repartition between the shards of a mesh.

Counterpart of ``spark_rapids_tpu/parallel/exchange.py``.  The reference
traces these functions per shard inside shard_map, where
``lax.all_to_all`` and ``lax.all_gather`` make every shard wait for the
others.  A Python loop over shards cannot stop halfway through a shard,
so here every collective takes the list of all the shards' batches (and
partition ids) at once and returns the list of their results:

    per shard:  K10's stable build of the rows by destination
                (``shuffle/device_shuffle.py:partition_order``), then K24's
                ``[P, C]`` tiles of every column and the lane mask
    all shards: the tile swap, destination ``d`` taking slice ``d`` of
                every source's tiles in source order (a device copy)
    per shard:  K4's stable compaction of the present lanes to the front

The capacity ``C`` is ``bucket_rows`` of the largest count any shard
sends any destination, read back once an exchange (the reference starts
from a static guess and re-runs the stage when it overflows; no row is
dropped here).  String tiles are written at the widest width of every
shard.  After the compaction each result is cut to the bucket of the rows
it received (known from the same counts, so no second read back): the
rows are the reference's, the padding lanes may differ.

Across processes (``process_exchange``, ``process_replicate``: the
reference's ``collective_exchange`` and ``gather_replicate`` on a mesh
whose shards belong to several processes, ``multiprocess.py``), each
process builds its own shards' K10 orders and K24 tiles as above; the
capacity, every shard's count to every destination and the string tile
widths come from one agreement (K27's max over the owned shards, then an
all-reduce MAX across the processes, read back once: ``comm.agree``), so
every process takes the same decisions.  A destination's slices from
shards of the same process are device views; the others arrive by one
``all_to_all_single`` a call (``comm.all_to_all``), each source's rows
for a destination sent at their exact count (the counts are replicated),
every column packed into one byte matrix a row.  The destination joins
every source's slice in global shard order and compacts with K4, so its
rows come out in the order of the single-process runner.

``device_partition_ids`` (K9), ``bucket_rows`` (the reference's formula,
for the tests), ``_gather_tiles`` (K24), ``_compact`` (K4),
``collective_exchange``, ``gather_replicate``, ``stack_partitions`` and
``unstack_partitions`` are ported.  ``squeeze_leading``,
``unsqueeze_leading``, ``exchange_step`` and ``stack_to_mesh`` exist only
for shard_map and are not.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.column import DeviceBatch, DeviceColumn, bucket_rows as \
    bucket_size
from ..ops.kernels.gather import compact
from ..shuffle import device_shuffle as DS
from ..utils import hashing


def to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Integer tensors as int64 numpy rows, with one copy (one sync) per
    device they lie on."""
    by_dev: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dev.setdefault(t.device, []).append(i)
    out: List[Optional[np.ndarray]] = [None] * len(tensors)
    for idx in by_dev.values():
        flat = torch.cat([tensors[i].to(torch.int64).reshape(-1)
                          for i in idx]).cpu().numpy()
        at = 0
        for i in idx:
            k = tensors[i].numel()
            out[i] = flat[at:at + k]
            at += k
    return out


def device_partition_ids(batch: DeviceBatch, key_indices,
                         num_parts: int) -> torch.Tensor:
    """Spark's Murmur3 pmod partition ids (K9); rows past ``num_rows``
    get the sentinel ``num_parts``."""
    cols = [batch.columns[i] for i in key_indices]
    pid = hashing.hash_pids(cols, num_parts)
    return torch.where(batch.row_mask(), pid,
                       torch.full((), num_parts, dtype=torch.int32,
                                  device=pid.device))


def bucket_rows(pids: torch.Tensor, num_parts: int, capacity: int):
    """The reference's formula: a stable argsort of ``pids`` (in ``[0,
    num_parts]``, ``num_parts`` dropped), each destination's start and
    count by ``searchsorted``; returns ``(rows int32[P, C], valid
    bool[P, C])``.  The exchange itself takes K10's build and K24."""
    n = pids.shape[0]
    order = torch.sort(pids.to(torch.int64), stable=True).indices
    bounds = torch.searchsorted(
        pids.to(torch.int64)[order],
        torch.arange(num_parts + 1, dtype=torch.int64, device=pids.device))
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    rows, valid = DS.tile_rows_plain(order, starts, counts, capacity)
    return rows.to(torch.int32), valid


def _gather_tiles(batch: DeviceBatch, order: torch.Tensor,
                  starts: torch.Tensor, counts: torch.Tensor, capacity: int,
                  widths: Optional[Sequence[Optional[int]]] = None):
    """Every column cut into flat ``[P * C]`` tiles, validity AND the lane
    mask (K24); returns ``(tiles, lane_valid)``."""
    return DS.exchange_tiles(batch, order, starts, counts, capacity, widths)


def _compact(cols: List[DeviceColumn], present: torch.Tensor,
             schema) -> DeviceBatch:
    """The present lanes moved to the front, stably (K4)."""
    n = present.shape[0]
    full = DeviceBatch(schema, cols, torch.full(
        (), n, dtype=torch.int32, device=present.device))
    return compact(full, present)


def _trim(batch: DeviceBatch, rows: int, min_bucket: int) -> DeviceBatch:
    """The front of a front-packed batch, cut to the bucket of its
    ``rows`` (views; no copy)."""
    keep = min(bucket_size(rows, min_bucket), batch.padded_rows)
    if keep == batch.padded_rows:
        return batch
    cols = [DeviceColumn(c.dtype, c.data[:keep], c.validity[:keep],
                         None if c.lengths is None else c.lengths[:keep])
            for c in batch.columns]
    return DeviceBatch(batch.schema, cols, batch.num_rows)


def string_widths(batches: Sequence[DeviceBatch]) -> List[Optional[int]]:
    """Each string column's widest byte matrix over ``batches`` (None for
    other columns)."""
    return [max(b.columns[i].data.shape[1] for b in batches)
            if c.data.dim() == 2 else None
            for i, c in enumerate(batches[0].columns)]


def _padded(c: DeviceColumn, width: Optional[int]) -> torch.Tensor:
    if width is None or c.data.shape[1] == width:
        return c.data
    return torch.nn.functional.pad(c.data, (0, width - c.data.shape[1]))


def concat_compact(pieces: Sequence[Sequence[DeviceColumn]],
                   masks: Sequence[torch.Tensor], schema, dev: torch.device,
                   rows: slice = slice(None)) -> DeviceBatch:
    """Rows ``rows`` of every piece's columns (string matrices padded to
    the widest) and of its mask, moved to ``dev`` and joined in order,
    then the masked-in rows compacted to the front (K4)."""
    cols = []
    for i, c0 in enumerate(pieces[0]):
        width = max(p[i].data.shape[1] for p in pieces) \
            if c0.data.dim() == 2 else None

        def cat(get):
            return torch.cat([get(p[i])[rows].to(dev, non_blocking=True)
                              for p in pieces])
        cols.append(DeviceColumn(
            c0.dtype, cat(lambda c: _padded(c, width)),
            cat(lambda c: c.validity),
            None if c0.lengths is None else cat(lambda c: c.lengths)))
    mask = torch.cat([m[rows].to(dev, non_blocking=True) for m in masks])
    return _compact(cols, mask, schema)


def _lane_bytes(cols: Sequence[DeviceColumn]) -> int:
    return sum(c.data[0].numel() * c.data.element_size() + 1
               + (4 if c.lengths is not None else 0) for c in cols) + 1


def collective_exchange(batches: List[DeviceBatch],
                        pids: List[torch.Tensor], num_parts: int,
                        devices: Optional[Sequence[torch.device]] = None,
                        capacity: int = 0, min_bucket: int = 128,
                        record: Optional[dict] = None) -> List[DeviceBatch]:
    """Repartition the shards' rows by ``pids`` (one int32 tensor a shard,
    padding rows ``num_parts``): shard ``d`` ends with the rows every
    shard sent it, in source order, each source's rows in their order.
    ``capacity`` 0 takes the largest count (no row dropped); a smaller one
    drops each destination's rows past it, as the reference's tiles do.
    ``record`` (a dict) receives the capacity, the rows each shard sent
    each destination, the rows each shard got and ``bytes_swapped``: the
    bytes of the tile slices that leave their shard, all shards together
    (``P * (P - 1)`` slices of ``capacity`` lanes)."""
    if len(batches) != num_parts:
        raise ValueError(f"{len(batches)} shards cannot exchange into "
                         f"{num_parts} destinations")
    devices = list(devices or [b.device for b in batches])
    builds = [DS.partition_order(p, b.num_rows, num_parts)
              for b, p in zip(batches, pids)]
    sent = [row.tolist() for row in to_host([c for _o, c, _s in builds])]
    cap = capacity or bucket_size(max(max(r) for r in sent), min_bucket)
    widths = string_widths(batches)
    tiled = [_gather_tiles(b, o, s, c, cap, widths)
             for b, (o, c, s) in zip(batches, builds)]
    got = [sum(min(r[d], cap) for r in sent) for d in range(num_parts)]
    out = [_trim(concat_compact([t for t, _m in tiled],
                                [m for _t, m in tiled], batches[0].schema,
                                devices[d], slice(d * cap, (d + 1) * cap)),
                 got[d], min_bucket)
           for d in range(num_parts)]
    if record is not None:
        record.update(capacity=cap, rows_sent=sent, partition_rows=got,
                      rows_written=sum(map(sum, sent)),
                      bytes_swapped=_lane_bytes(tiled[0][0]) * cap
                      * num_parts * (num_parts - 1))
    return out


def gather_replicate(batches: List[DeviceBatch],
                     devices: Optional[Sequence[torch.device]] = None,
                     min_bucket: int = 128,
                     record: Optional[dict] = None) -> List[DeviceBatch]:
    """Every shard's rows on every shard, in shard order (the broadcast
    exchange).  Shards on one device share one batch.  ``record``
    receives the rows and ``bytes_swapped``: the bytes of every shard's
    padded rows sent to each other shard, all shards together."""
    devices = list(devices or [b.device for b in batches])
    rows = [int(r[0]) for r in to_host([b.num_rows for b in batches])]
    total = sum(rows)
    by_dev: Dict[torch.device, DeviceBatch] = {}
    for dev in devices:
        if dev not in by_dev:
            by_dev[dev] = _trim(concat_compact(
                [b.columns for b in batches],
                [b.row_mask() for b in batches], batches[0].schema, dev),
                total, min_bucket)
    if record is not None:
        record.update(capacity=None, rows_sent=[[r] for r in rows],
                      partition_rows=[total] * len(devices),
                      rows_written=total,
                      bytes_swapped=_lane_bytes(by_dev[devices[0]].columns)
                      * sum(b.padded_rows for b in batches)
                      * (len(devices) - 1))
    return [by_dev[d] for d in devices]


def stack_partitions(batches: List[DeviceBatch]) -> DeviceBatch:
    """Per-shard batches of equal padded rows and string widths stacked
    into one ``[n, padded, ...]`` batch, ``num_rows`` int32[n]."""
    b0 = batches[0]
    cols = []
    for i, c0 in enumerate(b0.columns):
        cols.append(DeviceColumn(
            c0.dtype, torch.stack([b.columns[i].data for b in batches]),
            torch.stack([b.columns[i].validity for b in batches]),
            None if c0.lengths is None else
            torch.stack([b.columns[i].lengths for b in batches])))
    return DeviceBatch(b0.schema, cols, torch.stack(
        [b.num_rows.to(torch.int32) for b in batches]))


def unstack_partitions(stacked: DeviceBatch) -> List[DeviceBatch]:
    n = stacked.num_rows.shape[0]
    return [DeviceBatch(stacked.schema, [
        DeviceColumn(c.dtype, c.data[p], c.validity[p],
                     None if c.lengths is None else c.lengths[p])
        for c in stacked.columns], stacked.num_rows[p]) for p in range(n)]


# --------------------------------------------------------------------------
# across processes
# --------------------------------------------------------------------------
def _buffers(cols: Sequence[DeviceColumn]) -> List[torch.Tensor]:
    return [t for c in cols for t in (c.data, c.validity, c.lengths)
            if t is not None]


def _row_bytes(t: torch.Tensor) -> int:
    return int(np.prod(t.shape[1:], dtype=np.int64)) * t.element_size()


def pack_rows(cols: Sequence[DeviceColumn]) -> torch.Tensor:
    """Every buffer of ``cols`` (data, validity, lengths) side by side as
    one uint8 ``[rows, row bytes]`` matrix (a device copy)."""
    bufs = _buffers(cols)
    rows = bufs[0].shape[0]
    return torch.cat([t.contiguous().view(torch.uint8).reshape(
        rows, _row_bytes(t)) for t in bufs], dim=1)


def unpack_rows(packed: torch.Tensor,
                like: Sequence[DeviceColumn]) -> List[DeviceColumn]:
    """``pack_rows``'s inverse: columns shaped as ``like``'s (widths
    included) over ``packed``'s rows."""
    rows = packed.shape[0]
    out, at = [], 0

    def take(t):
        nonlocal at
        rb = _row_bytes(t)
        # a fresh dense copy (a slice of one row counts as contiguous, but
        # its stride and offset do not fit a wider element)
        part = torch.empty((rows, rb), dtype=torch.uint8,
                           device=packed.device).copy_(
            packed[:, at:at + rb]).view(t.dtype).reshape(
            (rows,) + tuple(t.shape[1:]))
        at += rb
        return part

    for c in like:
        data, valid = take(c.data), take(c.validity)
        out.append(DeviceColumn(c.dtype, data, valid,
                                None if c.lengths is None else
                                take(c.lengths)))
    return out


def _rows(cols: Sequence[DeviceColumn], lo: int,
          hi: int) -> List[DeviceColumn]:
    """Rows ``[lo, hi)`` of every column (views)."""
    return [DeviceColumn(c.dtype, c.data[lo:hi], c.validity[lo:hi],
                         None if c.lengths is None else c.lengths[lo:hi])
            for c in cols]


def _width_stats(batches: Sequence[DeviceBatch], first_slot: int):
    """The string columns' indices and, per column, its widest width over
    ``batches`` at slot ``first_slot + j``."""
    from ..ops.kernels.retile import Stat

    widths = string_widths(batches)
    idx = [i for i, w in enumerate(widths) if w is not None]
    return idx, [Stat(first_slot + j, int(widths[i]))
                 for j, i in enumerate(idx)]


def process_exchange(batches: List[DeviceBatch], pids: List[torch.Tensor],
                     num_parts: int, owners: Sequence[int], rank: int, comm,
                     capacity: int = 0, min_bucket: int = 128,
                     record: Optional[dict] = None) -> List[DeviceBatch]:
    """``collective_exchange`` over the shards of every process:
    ``batches``/``pids`` are this process's shards (``owners[s] == rank``,
    in global order); returns its shards' results.  ``comm`` is the
    transport (``agree``, ``all_to_all``).  ``record`` as
    ``collective_exchange``'s, over every shard of every process, with
    ``bytes_swapped`` the bytes that crossed between processes, all
    processes together, and ``process_bytes_sent`` this process's."""
    from ..ops.kernels.retile import Stat

    n = len(owners)
    if num_parts != n:
        raise ValueError(f"{n} shards cannot exchange into {num_parts} "
                         "destinations")
    mine = [s for s, o in enumerate(owners) if o == rank]
    if len(batches) != len(mine):
        raise ValueError(f"process {rank} holds shards {mine}, got "
                         f"{len(batches)} batches")
    builds = [DS.partition_order(p, b.num_rows, num_parts)
              for b, p in zip(batches, pids)]
    # one agreement: every shard's count to every destination at its own
    # slots (the capacity is the bucket of their max), then the widths
    stats = [Stat(s * num_parts, c) for s, (_o, c, _st) in zip(mine, builds)]
    str_idx, wstats = _width_stats(batches, n * num_parts)
    agreed = comm.agree(stats + wstats, n * num_parts + len(str_idx),
                        n * num_parts)
    sent = agreed[:n * num_parts].reshape(n, num_parts)
    cap = capacity or int(agreed[-1])
    widths: List[Optional[int]] = [None] * len(batches[0].columns)
    for j, i in enumerate(str_idx):
        widths[i] = int(agreed[n * num_parts + j])
    tiled = [_gather_tiles(b, o, st, c, cap, widths)
             for b, (o, c, st) in zip(batches, builds)]
    take = np.minimum(sent, cap)
    # the rows for other processes' destinations, grouped by process, each
    # destination's slices in source order; only those rows are packed
    send = [pack_rows(_rows(tiled[0][0], 0, 0))]
    send_rows, recv_rows = [], []
    for r in range(max(owners) + 1):
        theirs = [d for d, o in enumerate(owners) if o == r]
        if r == rank:
            send_rows.append(0)
            recv_rows.append(0)
            continue
        send_rows.append(int(sum(take[s, d] for d in theirs for s in mine)))
        recv_rows.append(int(sum(take[s, d] for d in mine for s in theirs)))
        send += [pack_rows(_rows(tiled[i][0], d * cap,
                                 d * cap + int(take[s, d])))
                 for d in theirs for i, s in enumerate(mine)]
    lb = send[0].shape[1]
    got_all = comm.all_to_all(torch.cat(send), send_rows, recv_rows)
    recv = unpack_rows(got_all, tiled[0][0])
    # where each (source, destination) piece sits in the received rows
    at, where = 0, {}
    for r in range(max(owners) + 1):
        if r == rank:
            continue
        for d in mine:
            for s in (s for s, o in enumerate(owners) if o == r):
                where[(s, d)] = (at, at + int(take[s, d]))
                at += int(take[s, d])
    got = [int(take[:, d].sum()) for d in range(n)]
    out = []
    for d in mine:
        pieces, masks = [], []
        for s in range(n):
            if owners[s] == rank:
                tiles, lane = tiled[mine.index(s)]
                pieces.append(_rows(tiles, d * cap, (d + 1) * cap))
                masks.append(lane[d * cap:(d + 1) * cap])
            else:
                lo, hi = where[(s, d)]
                pieces.append(_rows(recv, lo, hi))
                masks.append(torch.ones(hi - lo, dtype=torch.bool,
                                        device=batches[0].device))
        out.append(_trim(concat_compact(pieces, masks, batches[0].schema,
                                        batches[0].device), got[d],
                         min_bucket))
    if record is not None:
        cross = sum(int(take[s, d]) for s in range(n) for d in range(n)
                    if owners[s] != owners[d])
        record.update(capacity=cap, rows_sent=sent.tolist(),
                      partition_rows=got, rows_written=int(sent.sum()),
                      bytes_swapped=cross * lb,
                      process_bytes_sent=sum(send_rows) * lb)
    return out


def process_replicate(batches: List[DeviceBatch], owners: Sequence[int],
                      rank: int, comm, min_bucket: int = 128,
                      record: Optional[dict] = None) -> List[DeviceBatch]:
    """``gather_replicate`` over the shards of every process: every
    shard's rows, in global shard order, on every shard this process holds
    (one batch they share).  ``record`` as ``gather_replicate``'s, with
    ``bytes_swapped`` the bytes that crossed between processes."""
    from ..ops.kernels.retile import Stat

    n = len(owners)
    mine = [s for s, o in enumerate(owners) if o == rank]
    stats = [Stat(s, b.num_rows) for s, b in zip(mine, batches)]
    str_idx, wstats = _width_stats(batches, n)
    agreed = comm.agree(stats + wstats, n + len(str_idx), n)
    rows = [int(r) for r in agreed[:n]]
    width = {i: int(agreed[n + j]) for j, i in enumerate(str_idx)}
    schema, dev = batches[0].schema, batches[0].device

    def widened(b: DeviceBatch) -> List[DeviceColumn]:
        return [DeviceColumn(c.dtype, _padded(c, width.get(i)), c.validity,
                             c.lengths) for i, c in enumerate(b.columns)]

    local = [widened(b) for b in batches]
    # this process's rows, to every other process
    mine_packed = torch.cat([pack_rows(_rows(cols, 0, rows[s]))
                             for s, cols in zip(mine, local)])
    world = max(owners) + 1
    peers = [r for r in range(world) if r != rank]
    own_rows = sum(rows[s] for s in mine)
    send_rows = [0 if r == rank else own_rows for r in range(world)]
    recv_rows = [0 if r == rank else sum(rows[s] for s in range(n)
                                         if owners[s] == r)
                 for r in range(world)]
    got_all = comm.all_to_all(
        torch.cat([mine_packed] * len(peers)) if peers else mine_packed[:0],
        send_rows, recv_rows)
    recv = unpack_rows(got_all, local[0])
    pieces, masks, at = [], [], 0
    for s in range(n):
        if owners[s] == rank:
            i = mine.index(s)
            pieces.append(local[i])
            masks.append(batches[i].row_mask())
        else:
            pieces.append(_rows(recv, at, at + rows[s]))
            masks.append(torch.ones(rows[s], dtype=torch.bool, device=dev))
            at += rows[s]
    total = sum(rows)
    one = _trim(concat_compact(pieces, masks, schema, dev), total, min_bucket)
    if record is not None:
        lb = mine_packed.shape[1]
        record.update(capacity=None, rows_sent=[[r] for r in rows],
                      partition_rows=[total] * n, rows_written=total,
                      bytes_swapped=sum(
                          rows[s] * (world - 1) for s in range(n)) * lb,
                      process_bytes_sent=own_rows * len(peers) * lb)
    return [one] * len(batches)
