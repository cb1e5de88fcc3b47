"""Device write command.

Counterpart of ``spark_rapids_tpu/exec/write.py`` (``:36-219``).  The
write goes through the rewrite engine like any operator: tagged, shown
in explain (``*``/``!``) and converted to this exec.  A partition's
batches are concatenated (``exec/coalesce.py``); with ``partition_by``
they are sorted by the partition columns on the device
(``_sort_by_keys``: K1's stable lexsort with padding rows last, then a
K4 gather of the whole batch), downloaded in one ``device_to_host``
and split on the host where neighbouring sorted keys differ (NaN equal
to NaN, -0.0 in 0.0's group); each group is encoded by
``io/parquet.py`` into ``<k=v>/.../part-<pid:05d>.parquet``.  Without
``partition_by`` the batch is downloaded as it is and written to
``part-<pid:05d>.parquet``; no hand-written kernel runs.  ``_SUCCESS``
is written after every partition has finished.

The rules tag bucketed output, an unknown or unsupported partition
column and any format but Parquet (ORC: no encoder here) with ``!``;
the conversion of such a write raises ``NotImplementedError``, as every
node the device cannot run does until the host engine is ported.  The
reference's semaphore and trace ranges are not ported.  Beyond the
reference, ``ctx.metrics`` gets the nanoseconds a partition spent
draining its input (``inputTimeNs``: the child and the concat), in the
sort and the download (``sortDownloadTimeNs``) and in the split
(``splitTimeNs``); the tracker (``session.last_write_stats``) those of
the encode and the file IO.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np

from .. import types as T
from ..data import strings as dstrings
from ..data.column import DeviceBatch, HostBatch, device_to_host
from ..io import writers
from ..io.scans import partition_dir_name
from ..ops.kernels import gather as G
from ..ops.kernels import segment as seg
from .base import DevicePartitionedData, TpuExec
from .coalesce import concat_device_batches

_NAME = "TpuDataWritingCommandExec"
#: partition column types the writer can name directories by
_KEY_TYPES = (T.TypeId.BOOL, T.TypeId.INT8, T.TypeId.INT16, T.TypeId.INT32,
              T.TypeId.INT64, T.TypeId.FLOAT32, T.TypeId.FLOAT64,
              T.TypeId.DATE32, T.TypeId.TIMESTAMP, T.TypeId.STRING)


def group_starts(hb: HostBatch, key_idx) -> np.ndarray:
    """Row offsets where a group of equal keys starts in a batch sorted
    by those keys, with the row count last: neighbours differ where
    their validity differs or both are valid and their values differ
    (NaN equal to NaN, -0.0 equal to 0.0; strings by length and bytes)."""
    n = hb.num_rows
    neq = np.zeros(max(n - 1, 0), dtype=bool)
    for i in key_idx:
        c = hb.columns[i]
        valid = c.is_valid()
        both = valid[1:] & valid[:-1]
        if c.dtype.is_string:
            ln = c.lengths
            inside = np.arange(c.data.shape[1])[None, :] < ln[1:, None]
            dv = (ln[1:] != ln[:-1]) | \
                ((c.data[1:] != c.data[:-1]) & inside).any(axis=1)
        else:
            vals = c.data
            dv = np.not_equal(vals[1:], vals[:-1])
            if np.issubdtype(vals.dtype, np.floating):
                dv &= ~(np.isnan(vals[1:]) & np.isnan(vals[:-1]))
        neq |= (valid[1:] != valid[:-1]) | (both & dv)
    return np.concatenate([[0], np.flatnonzero(neq) + 1, [n]]) \
        .astype(np.int64)


def _key_value(c, row: int):
    """A host column's value at ``row`` as the directory name renders it
    (the reference's host value: strings as ``str``, others numpy)."""
    if c.validity is not None and not c.validity[row]:
        return None
    if c.dtype.is_string:
        return dstrings.decode_one(c.data[row], c.lengths[row])
    return c.data[row]


class TpuDataWritingCommandExec(TpuExec):
    """Consumes the device child and yields no rows: a partition's files
    are written while its (empty) output is drained."""

    def __init__(self, child, plan):
        super().__init__([child])
        self.plan = plan  # physical.DataWritingCommandExec

    @property
    def schema(self):
        return T.Schema([])

    def _key_idx(self):
        child_schema = self.children[0].schema
        return [child_schema.index_of(k) for k in self.plan.partition_by]

    def _sort_by_keys(self, b: DeviceBatch, kernels=None) -> DeviceBatch:
        """B.26: the batch in the stable order of its partition columns,
        padding rows last (K1 lexsort + K4 gather)."""
        cols = [b.columns[i] for i in self._key_idx()]
        order = seg.lexsort_device(cols, pad_valid=b.row_mask(),
                                   kernels=kernels)
        return G.gather_batch(b, order, b.num_rows, kernels=kernels)

    # ------------------------------------------------------------------
    def execute_columnar(self, ctx) -> DevicePartitionedData:
        child = self.children[0].execute_columnar(ctx)
        plan = self.plan
        tracker = writers.WriteStatsTracker()
        ctx.write_stats = tracker
        os.makedirs(plan.path, exist_ok=True)
        n_parts = child.n_partitions
        # _SUCCESS lands after every partition has written its files
        left = {"n": n_parts}
        lock = threading.Lock()

        def finish_one():
            with lock:
                left["n"] -= 1
                if left["n"] == 0:
                    with open(os.path.join(plan.path, "_SUCCESS"), "w"):
                        pass

        def make(pid):
            def it():
                t0 = time.perf_counter_ns()
                batches = list(child.iterator(pid))
                if batches:
                    b = concat_device_batches(batches)
                    ctx.add_metric(f"{_NAME}.inputTimeNs",
                                   time.perf_counter_ns() - t0)
                    if plan.partition_by:
                        self._write_dynamic(ctx, b, pid, tracker)
                    else:
                        t0 = time.perf_counter_ns()
                        hb = device_to_host(b)
                        ctx.add_metric(f"{_NAME}.sortDownloadTimeNs",
                                       time.perf_counter_ns() - t0)
                        name = f"part-{pid:05d}.parquet"
                        writers._write_one(
                            [hb], hb.schema, plan.fmt,
                            os.path.join(plan.path, name), plan.options,
                            tracker)
                        ctx.add_metric(f"{_NAME}.numOutputRows",
                                       hb.num_rows)
                finish_one()
                return
                yield  # a generator that yields no batch

            return it

        return DevicePartitionedData([make(i) for i in range(n_parts)])

    # ------------------------------------------------------------------
    def _write_dynamic(self, ctx, b: DeviceBatch, pid: int,
                       tracker: writers.WriteStatsTracker) -> None:
        """Device sort by the partition columns, one download, the split
        at group boundaries, one file a group."""
        plan = self.plan
        key_idx = self._key_idx()
        t0 = time.perf_counter_ns()
        hb = device_to_host(self._sort_by_keys(b))
        t1 = time.perf_counter_ns()
        ctx.add_metric(f"{_NAME}.sortDownloadTimeNs", t1 - t0)
        n = hb.num_rows
        if n == 0:
            return
        keep_idx = [i for i in range(len(hb.schema)) if i not in key_idx]
        out_schema = T.Schema([hb.schema.fields[i] for i in keep_idx])
        starts = group_starts(hb, key_idx)
        keys = [hb.columns[i] for i in key_idx]
        split_ns = time.perf_counter_ns() - t1
        for s, e in zip(starts[:-1].tolist(), starts[1:].tolist()):
            t0 = time.perf_counter_ns()
            parts = [partition_dir_name(k, _key_value(c, s))
                     for k, c in zip(plan.partition_by, keys)]
            out = HostBatch(out_schema,
                            [hb.columns[i].slice(s, e) for i in keep_idx])
            dirname = os.path.join(plan.path, *parts)
            t1 = time.perf_counter_ns()
            os.makedirs(dirname, exist_ok=True)
            t2 = time.perf_counter_ns()
            tracker.metrics["ioTimeNs"].add(t2 - t1)
            split_ns += t1 - t0
            writers._write_one(
                [out], out_schema, plan.fmt,
                os.path.join(dirname, f"part-{pid:05d}.parquet"),
                plan.options, tracker)
            ctx.add_metric(f"{_NAME}.numOutputRows", e - s)
        ctx.add_metric(f"{_NAME}.splitTimeNs", split_ns)

    def describe(self):
        part = f", partition_by={self.plan.partition_by}" \
            if self.plan.partition_by else ""
        return f"TpuDataWritingCommand[{self.plan.fmt}{part}]"


# ==========================================================================
# rule registration
# ==========================================================================
def register(register_exec):
    from ..plan import physical as P

    def tag(meta):
        plan = meta.plan
        if plan.fmt == "orc":
            meta.will_not_work_on_tpu(
                "ORC output has no encoder in this engine (Parquet only)")
        elif plan.fmt != "parquet":
            meta.will_not_work_on_tpu(
                f"output format {plan.fmt} is not supported (Parquet "
                "only; the reference takes parquet and orc)")
        if plan.bucket_by:
            meta.will_not_work_on_tpu(
                "bucketed output is not supported "
                "(reference: GpuOverrides.scala:260-314)")
        child_schema = plan.children[0].schema
        for k in plan.partition_by:
            if k not in child_schema:
                meta.will_not_work_on_tpu(
                    f"partition column {k} not found in input")
                continue
            dtype = child_schema[k].dtype
            if dtype.id not in _KEY_TYPES:
                meta.will_not_work_on_tpu(
                    f"partition column {k} has unsupported type {dtype}")

    register_exec(
        P.DataWritingCommandExec,
        convert=lambda meta, ch: TpuDataWritingCommandExec(
            ch[0], meta.plan),
        desc="device write command (parquet, dynamic partitions sorted "
             "on device)",
        tag=tag)
