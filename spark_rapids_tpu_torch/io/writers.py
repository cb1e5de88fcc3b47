"""File writer: one Parquet file from host batches, with its stats.

Counterpart of ``spark_rapids_tpu/io/writers.py``: ``WriteStatsTracker``
(``:24``, the reference's BasicColumnarWriteStatsTracker) and
``_write_one`` (``:48``), which encodes through ``io/parquet.py``
instead of pyarrow, with the same ``compression`` option and default
(snappy).  ORC has no encoder here.  The host engine's writers
(``write_partitions``, ``_write_dynamic``, ``:81``, ``:102``) wait for
the host engine; the device write is ``exec/write.py``.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import List

from .. import types as T
from ..data.column import HostBatch, HostColumn
from . import parquet


class Metric:
    """A counter that partitions may add to concurrently."""

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def add(self, v: int) -> None:
        with self._lock:
            self.value += v


class WriteStatsTracker:
    """Aggregate counters (``numFiles``, ``numOutputRows``,
    ``numOutputBytes``; and, beyond the reference's, ``encodeTimeNs`` and
    ``ioTimeNs``: the nanoseconds of ``_write_one`` spent encoding and in
    ``open``/``write``/``close``) and one ``{"path", "rows", "bytes"}``
    record a file (``files``)."""

    def __init__(self):
        self.metrics = defaultdict(Metric)
        self.files: List[dict] = []
        self._lock = threading.Lock()

    def new_file(self, path: str) -> None:
        self.metrics["numFiles"].add(1)

    def rows_written(self, n: int) -> None:
        self.metrics["numOutputRows"].add(n)

    def bytes_written(self, n: int) -> None:
        self.metrics["numOutputBytes"].add(n)

    def file_done(self, path: str, rows: int, nbytes: int) -> None:
        with self._lock:
            self.files.append({"path": path, "rows": rows, "bytes": nbytes})


def _write_one(batches: List[HostBatch], schema: T.Schema, fmt: str,
               path: str, options: dict, tracker: WriteStatsTracker) -> None:
    if fmt != "parquet":
        raise NotImplementedError(
            f"no {fmt} encoder in this engine (Parquet only)")
    if not batches:
        batches = [HostBatch(schema, [HostColumn.nulls(0, f.dtype)
                                      for f in schema])]
    batch = HostBatch.concat(batches) if len(batches) > 1 else batches[0]
    tracker.new_file(path)
    timings = {}
    t0 = time.perf_counter_ns()
    nbytes = parquet.write_file(path, batch,
                                options.get("compression", "snappy"),
                                timings=timings)
    tracker.metrics["ioTimeNs"].add(timings["io_ns"])
    tracker.metrics["encodeTimeNs"].add(time.perf_counter_ns() - t0
                                        - timings["io_ns"])
    tracker.rows_written(batch.num_rows)
    tracker.bytes_written(nbytes)
    tracker.file_done(path, batch.num_rows, nbytes)
