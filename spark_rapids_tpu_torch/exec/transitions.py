"""Host<->device transitions.

Counterpart of ``spark_rapids_tpu/exec/transitions.py``: HostToDeviceExec
slices oversize host batches to the reader size targets
(``_split_host_batch``) and uploads each piece; DeviceToHostExec
downloads result batches.  The reference's prefetch thread, upload
cache, semaphore and retry are not ported.
"""
from __future__ import annotations

from ..config import (BUCKET_MIN_ROWS, READER_BATCH_SIZE_BYTES,
                      READER_BATCH_SIZE_ROWS)
from ..data.column import device_to_host_many, host_to_device
from ..plan.physical import PartitionedData
from .base import DevicePartitionedData, TpuExec


def _split_host_batch(batch, max_rows: int, max_bytes: int):
    """Slice a host batch to at most ``max_rows`` rows and (by estimate)
    ``max_bytes`` bytes per piece."""
    n = batch.num_rows
    if n == 0:
        yield batch
        return
    rows_cap = max(1, max_rows)
    est = batch.estimate_bytes()
    if est > max_bytes:
        rows_cap = min(rows_cap, max(1, int(n * max_bytes / est)))
    if rows_cap >= n:
        yield batch
        return
    for start in range(0, n, rows_cap):
        yield batch.slice(start, min(start + rows_cap, n))


class HostToDeviceExec(TpuExec):
    def __init__(self, child):
        super().__init__([child])

    @property
    def schema(self):
        return self.children[0].schema

    def execute_columnar(self, ctx) -> DevicePartitionedData:
        child = self.children[0].execute(ctx)
        min_rows = ctx.conf.get(BUCKET_MIN_ROWS)
        max_rows = ctx.conf.get(READER_BATCH_SIZE_ROWS)
        max_bytes = ctx.conf.get(READER_BATCH_SIZE_BYTES)

        def make(pid):
            def it():
                for hb in child.iterator(pid):
                    for piece in _split_host_batch(hb, max_rows, max_bytes):
                        yield host_to_device(piece, min_rows, ctx.device)
            return it

        return DevicePartitionedData(
            [make(i) for i in range(child.n_partitions)])

    def describe(self):
        return "HostToDevice"


class DeviceToHostExec(TpuExec):
    def __init__(self, child):
        super().__init__([child])

    @property
    def schema(self):
        return self.children[0].schema

    def execute(self, ctx) -> PartitionedData:
        child = self.children[0].execute_columnar(ctx)

        def make(pid):
            def it():
                yield from device_to_host_many(list(child.iterator(pid)))
            return it

        return PartitionedData(
            [make(i) for i in range(child.n_partitions)])

    def execute_columnar(self, ctx):
        raise RuntimeError("DeviceToHostExec is a host boundary")

    def describe(self):
        return "DeviceToHost"
