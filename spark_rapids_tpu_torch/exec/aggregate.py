"""Device hash aggregate (sort-based).

Counterpart of ``spark_rapids_tpu/exec/aggregate.py:134-307``: sort rows
by key (K1), gather the keys (K4), derive segment ids (K2), take each
segment's first row (K3 over the row index) and reduce every buffer per
segment (K3) with a static segment count (the row bucket), then apply
the finalize expressions.  Modes partial and final, as the planner
emits them.

A partition that arrives as several batches is aggregated as the
reference's ``_agg_chunked`` (``:322-381``) does: each batch in buffer
form (a partial aggregate updates it, ``_compute(b, "update",
"buffers")``; a final one takes the exchange's buffers as they are),
the running buffers concatenated with each next batch's and merged
(``_compute(..., "merge", "buffers")``), and, in the final mode, one
merge that finalizes.  Its bodies run on K1-K4 like the one-batch path;
the running merge sums floats in another order than one pass over all
rows would (the batch boundaries are the reference's: the same coalesce
goals).  The reference's spill parking of the running buffers and its
split-and-retry around each step come with the memory tiers (ROADMAP
A6).  The number of input batches is recorded in the context's metrics
as ``TpuHashAggregateExec[<mode>].numInputBatches``.

Min and Max over a string column (the reference's
``_string_minmax_device``, ``:32-52``, ``:247-257``) reduce through
``segment.string_minmax``: the strings' ranks (K1 sort, K4 scatter),
each group's least or greatest rank (K3), the winning row gathered (K4);
the partial mode reduces the input strings, the final mode the partial
string buffers the exchange delivered, and a group with only null values
gives null.
"""
from __future__ import annotations

from typing import List

import torch

from .. import types as T
from ..data.column import DeviceBatch, DeviceColumn, host_to_device
from ..ops.expression import BoundReference, as_device_column
from ..ops.kernels import gather as G
from ..ops.kernels import segment as seg
from .base import DevicePartitionedData, TargetSize, TpuExec
from .coalesce import concat_device_batches


class TpuHashAggregateExec(TpuExec):
    def __init__(self, child, plan):
        super().__init__([child])
        self.plan = plan  # physical.HashAggregateExec (exprs bound)
        self.mode = plan.mode
        self.keys = plan.keys
        self.specs = plan.specs
        self._schema = plan.schema

    @property
    def schema(self):
        return self._schema

    @property
    def buffer_schema(self) -> T.Schema:
        """Group keys + aggregation buffers (the partial output form)."""
        from ..plan.physical import _buffer_fields

        if self.mode == "partial":
            return self._schema
        key_fields = list(self.children[0].schema.fields[:len(self.keys)])
        return T.Schema(key_fields + _buffer_fields(self.specs))

    @property
    def children_coalesce_goal(self):
        return [TargetSize()]

    def compute_batch(self, batch: DeviceBatch) -> DeviceBatch:
        phase = "merge" if self.mode == "final" else "update"
        emit = "buffers" if self.mode == "partial" else "final"
        return self._compute(batch, phase, emit)

    # ------------------------------------------------------------------
    def _compute(self, batch: DeviceBatch, phase: str,
                 emit: str) -> DeviceBatch:
        nkeys = len(self.keys)
        padded = batch.padded_rows
        dev = batch.device
        rm = batch.row_mask()

        if phase == "merge":
            key_cols = [batch.columns[i] for i in range(nkeys)]
        else:
            key_cols = [as_device_column(k.eval_tpu(batch), padded, dev)
                        for k in self.keys]
        key_cols = [DeviceColumn(c.dtype, c.data, c.validity & rm,
                                 c.lengths) for c in key_cols]

        lane = torch.arange(padded, dtype=torch.int32, device=dev)
        if nkeys:
            order = seg.lexsort_device(key_cols, pad_valid=rm)
            sorted_keys = [G.gather_column(c, order) for c in key_cols]
            pad_sorted = G.gather_array(rm, order)
            seg_ids = seg.segment_ids_device(sorted_keys,
                                             pad_valid=pad_sorted)
            total = rm.sum().to(torch.int32)
            last = torch.clamp(total - 1, 0, padded - 1).to(torch.int64)
            n_real = torch.where(total > 0, seg_ids[last] + 1,
                                 torch.zeros_like(total)).to(torch.int32)
        else:
            order = None  # identity: rows stay in place
            pad_sorted = rm
            seg_ids = torch.where(rm, torch.zeros_like(lane), lane + 1)
            sorted_keys = []
            n_real = torch.ones((), dtype=torch.int32, device=dev)

        out_valid_seg = lane < n_real
        # output key columns = first row of each segment
        seg_starts = seg.segment_min_index(seg_ids, padded)
        safe_starts = torch.clamp(seg_starts, 0, padded - 1
                                  ).to(torch.int32)
        out_keys = [G.gather_column(c, safe_starts, out_valid_seg)
                    for c in sorted_keys]

        if phase == "update":
            buffers = self._update_buffers(batch, rm, order, pad_sorted,
                                           seg_ids, padded, out_valid_seg)
        else:
            buffers = self._merge_buffers(batch, rm, order, pad_sorted,
                                          seg_ids, padded, out_valid_seg,
                                          nkeys)
        if emit == "buffers":
            return DeviceBatch(self.buffer_schema, out_keys + buffers,
                               n_real)
        return self._finalize(out_keys, buffers, n_real, padded,
                              out_valid_seg)

    @staticmethod
    def _sorted(x, order):
        return x if order is None else G.gather_array(x, order)

    @classmethod
    def _sorted_lengths(cls, c: DeviceColumn, order):
        if c.lengths is None:
            return None
        return cls._sorted(c.lengths.to(torch.int32), order)

    def _update_buffers(self, batch, rm, order, pad_sorted, seg_ids,
                        padded, out_valid_seg) -> List[DeviceColumn]:
        buffers = []
        dev = batch.device
        for sp in self.specs:
            func = sp.func
            if func.child is None:  # count(*)
                inputs = [(torch.ones(padded, dtype=torch.int64, device=dev),
                           pad_sorted, None)]
            else:
                c = as_device_column(func.child.eval_tpu(batch), padded,
                                     dev)
                inputs = [(self._sorted(c.data, order),
                           self._sorted(c.validity & rm, order),
                           self._sorted_lengths(c, order))]
            for (op, which), bt in zip(func.updates, func.buffer_dtypes()):
                vals, valid, lens = inputs[which]
                buffers.append(self._reduce_one(
                    vals, valid, seg_ids, padded, op, bt, out_valid_seg,
                    pad_sorted, lens))
        return buffers

    def _merge_buffers(self, batch, rm, order, pad_sorted, seg_ids, padded,
                       out_valid_seg, nkeys) -> List[DeviceColumn]:
        buffers = []
        col_idx = nkeys
        for sp in self.specs:
            for op, bt in zip(sp.func.merges, sp.func.buffer_dtypes()):
                c = batch.columns[col_idx]
                buffers.append(self._reduce_one(
                    self._sorted(c.data, order),
                    self._sorted(c.validity & rm, order), seg_ids, padded,
                    op, bt, out_valid_seg, pad_sorted,
                    self._sorted_lengths(c, order)))
                col_idx += 1
        return buffers

    def _reduce_one(self, vals, valid, seg_ids, padded, op,
                    buf_dtype: T.DType, out_valid_seg,
                    present, lengths=None) -> DeviceColumn:
        if buf_dtype.is_string:
            if op not in ("min", "max"):
                raise NotImplementedError(
                    f"{op} over a string column on the device")
            data, lens, counts = seg.string_minmax(vals, lengths, valid,
                                                   seg_ids, padded, op)
            return DeviceColumn(buf_dtype, data,
                                (counts > 0) & out_valid_seg, lens)
        data, ok = seg.segment_reduce_device(vals, valid, seg_ids, padded,
                                             op, present=present)
        ok = out_valid_seg if op == "count" else ok & out_valid_seg
        if data.dtype != buf_dtype.torch_dtype:
            data = data.to(buf_dtype.torch_dtype)
        return DeviceColumn(buf_dtype, data, ok)

    def _finalize(self, out_keys, buffers, n_real, padded,
                  out_valid_seg) -> DeviceBatch:
        from ..plan.physical import _buffer_fields

        buf_batch = DeviceBatch(T.Schema(_buffer_fields(self.specs)),
                                buffers, n_real)
        out_cols = list(out_keys)
        bi = 0
        nkeys = len(self.keys)
        for sp, f in zip(self.specs, self._schema.fields[nkeys:]):
            nbuf = len(sp.func.buffer_dtypes())
            refs = [BoundReference(bi + j, buffers[bi + j].dtype, True)
                    for j in range(nbuf)]
            c = as_device_column(sp.func.finalize(refs).eval_tpu(buf_batch),
                                 padded, buf_batch.device)
            data = c.data if c.dtype == f.dtype \
                else c.data.to(f.dtype.torch_dtype)
            out_cols.append(DeviceColumn(f.dtype, data,
                                         c.validity & out_valid_seg,
                                         c.lengths))
            bi += nbuf
        return DeviceBatch(self._schema, out_cols, n_real)

    def _agg_chunked(self, batches: List[DeviceBatch]) -> DeviceBatch:
        """Several input batches: each in buffer form, merged into the
        running buffers; the partial mode returns them, the final mode
        merges once more to finalize (re-merging the grouped result is
        the identity on every buffer)."""
        def to_buffers(b):
            if self.mode == "final":
                return b
            return self._compute(b, "update", "buffers")

        running = to_buffers(batches[0])
        for nxt in batches[1:]:
            running = self._compute(
                concat_device_batches([running, to_buffers(nxt)]), "merge",
                "buffers")
        if self.mode == "partial":
            return running
        return self._compute(running, "merge", "final")

    # ------------------------------------------------------------------
    def execute_columnar(self, ctx):
        child = self.children[0].execute_columnar(ctx)
        metric = f"TpuHashAggregateExec[{self.mode}].numInputBatches"

        def make(pid):
            def it():
                batches = list(child.iterator(pid))
                ctx.add_metric(metric, len(batches))
                if not batches:
                    if self.keys or self.mode == "partial":
                        return
                    # a global aggregate over no rows still yields one row
                    from ..plan.physical import _empty_batch

                    batches = [host_to_device(
                        _empty_batch(self.children[0].schema),
                        device=ctx.device)]
                if len(batches) == 1:
                    yield self.compute_batch(batches[0])
                else:
                    yield self._agg_chunked(batches)
            return it

        return DevicePartitionedData(
            [make(i) for i in range(child.n_partitions)])

    def describe(self):
        return (f"TpuHashAggregate[{self.mode}, keys={len(self.keys)}, "
                f"aggs={[sp.func.sql() for sp in self.specs]}]")


def tag(meta) -> None:
    """The reference's aggregate tag (``exec/aggregate.py:465-494``), with
    its reasons: a float aggregation input while
    ``variableFloatAgg.enabled`` is false, and a mode that
    ``hashAgg.replaceMode`` leaves out.  Until the host engine is ported,
    a tagged aggregate raises when the plan is converted."""
    from ..config import ALLOW_FLOAT_AGG, HASH_AGG_REPLACE_MODE

    if not meta.conf.get(ALLOW_FLOAT_AGG):
        for sp in meta.plan.specs:
            child = sp.func.child
            if child is not None and child.dtype.is_floating:
                meta.will_not_work_on_tpu(
                    f"aggregation over floating column "
                    f"({sp.func.sql()}) disabled; enable "
                    "spark.rapids.tpu.sql.variableFloatAgg.enabled")
                break
    allowed = str(meta.conf.get(HASH_AGG_REPLACE_MODE)).lower()
    if allowed != "all":
        modes = {m.strip() for m in allowed.split("|")}
        mode = meta.plan.mode
        if mode == "complete":
            mode = "partial"  # complete ~ single-phase partial+final
        if mode not in modes:
            meta.will_not_work_on_tpu(
                f"aggregation mode {meta.plan.mode} excluded by "
                f"hashAgg.replaceMode={allowed}")


def register(register_exec):
    from ..plan import physical as P

    def exprs_of(plan):
        return list(plan.keys) + [sp.func for sp in plan.specs]

    register_exec(
        P.HashAggregateExec,
        convert=lambda meta, ch: TpuHashAggregateExec(ch[0], meta.plan),
        desc="sort-based segmented-reduction group-by on the device",
        tag=tag,
        exprs_of=exprs_of)
