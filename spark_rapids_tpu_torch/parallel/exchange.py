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
