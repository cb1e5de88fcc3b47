"""Device batch coalescing.

Counterpart of ``spark_rapids_tpu/exec/coalesce.py``: concatenate small
batches toward a goal (TargetSize bytes, TargetRows, or
RequireSingleBatch: every batch of the partition in one).  The concat
reads every row count back to the host once (as the reference does) and
copies each column's live rows into a preallocated buffer of the new
row bucket — a plain data move, with no hand-written kernel.
"""
from __future__ import annotations

from typing import List

import torch

from ..config import (BATCH_SIZE_BYTES, BUCKET_MIN_ROWS,
                      SHUFFLE_TARGET_BATCH_ROWS)
from ..data.column import DeviceBatch, DeviceColumn, bucket_rows
from .base import (CoalesceGoal, DevicePartitionedData,
                   RequireSingleBatch, TargetRows, TargetSize, TpuExec)


def concat_device_batches(batches: List[DeviceBatch],
                          min_bucket: int = 128) -> DeviceBatch:
    """Concatenate device batches row-wise into one bucketed batch."""
    if not batches:
        raise ValueError("concat of zero batches")
    if len(batches) == 1:
        return batches[0]
    schema = batches[0].schema
    dev = batches[0].device
    counts = torch.stack([b.num_rows.to(torch.int32) for b in batches]
                         ).cpu().tolist()
    total = sum(counts)
    padded = bucket_rows(total, min_bucket)
    cols: List[DeviceColumn] = []
    for ci in range(len(schema)):
        parts = [b.columns[ci] for b in batches]
        first = parts[0]
        if first.dtype.is_string:
            w = max(p.data.shape[1] for p in parts)
            data = torch.zeros((padded, w), dtype=torch.uint8, device=dev)
            lengths = torch.zeros(padded, dtype=torch.int32, device=dev)
        else:
            data = torch.zeros(padded, dtype=first.data.dtype, device=dev)
            lengths = None
        validity = torch.zeros(padded, dtype=torch.bool, device=dev)
        at = 0
        for p, n in zip(parts, counts):
            if first.dtype.is_string:
                data[at:at + n, :p.data.shape[1]] = p.data[:n]
                lengths[at:at + n] = p.lengths[:n]
            else:
                data[at:at + n] = p.data[:n]
            validity[at:at + n] = p.validity[:n]
            at += n
        cols.append(DeviceColumn(first.dtype, data, validity, lengths))
    return DeviceBatch(schema, cols,
                       torch.tensor(total, dtype=torch.int32).to(dev))


class TpuCoalesceBatchesExec(TpuExec):
    def __init__(self, child, goal: CoalesceGoal):
        super().__init__([child])
        self.goal = goal

    @property
    def schema(self):
        return self.children[0].schema

    def execute_columnar(self, ctx):
        child = self.children[0].execute_columnar(ctx)
        min_bucket = ctx.conf.get(BUCKET_MIN_ROWS)
        goal = self.goal

        def batches_of(pid, limit, size_of):
            pending: List[DeviceBatch] = []
            acc = 0
            for db in child.iterator(pid):
                s = size_of(db)
                if pending and acc + s > limit:
                    yield concat_device_batches(pending, min_bucket)
                    pending, acc = [], 0
                pending.append(db)
                acc += s
            if pending:
                yield concat_device_batches(pending, min_bucket)

        def make(pid):
            def it():
                if isinstance(goal, RequireSingleBatch):
                    batches = list(child.iterator(pid))
                    if batches:
                        yield concat_device_batches(batches, min_bucket)
                    return
                if isinstance(goal, TargetRows):
                    rows = goal.rows if goal.rows is not None \
                        else ctx.conf.get(SHUFFLE_TARGET_BATCH_ROWS)
                    if rows <= 0:  # disabled: pass through
                        yield from child.iterator(pid)
                        return
                    # by padded rows: no row-count readback per batch
                    yield from batches_of(pid, rows,
                                          lambda b: b.padded_rows)
                    return
                target = goal.target if isinstance(goal, TargetSize) \
                    and goal.target is not None \
                    else ctx.conf.get(BATCH_SIZE_BYTES)
                yield from batches_of(pid, target, lambda b: b.device_bytes())
            return it

        return DevicePartitionedData(
            [make(i) for i in range(child.n_partitions)])

    def describe(self):
        return f"TpuCoalesceBatches[{self.goal!r}]"
