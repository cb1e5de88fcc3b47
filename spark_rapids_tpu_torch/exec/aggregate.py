"""Device hash aggregate (sort-based).

Counterpart of ``spark_rapids_tpu/exec/aggregate.py:134-307``: sort rows
by key (K1), gather the keys and every buffer's input in one launch
(K4), derive segment ids (K2), reduce every numeric buffer per segment
and take each segment's first row in one K3 call (two launches) with a
static segment count (the row bucket), gather the output keys (K4),
then apply the finalize expressions.  Modes partial and final, as the
planner emits them.

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

        inputs, jobs = self._buffer_inputs(batch, phase, nkeys, padded, dev,
                                           rm)
        lane = torch.arange(padded, dtype=torch.int32, device=dev)
        if nkeys:
            order = seg.lexsort_device(key_cols, pad_valid=rm)
            # one K4 launch: the keys and every buffer input in key order.
            # The sort puts the padding rows last, so the sorted row mask
            # is rm itself
            moved = [k for k, c in enumerate(inputs) if c is not None]
            gathered = G.gather_columns(
                key_cols + [inputs[k] for k in moved], order)
            sorted_keys = gathered[:nkeys]
            for k, c in zip(moved, gathered[nkeys:]):
                inputs[k] = c
            seg_ids = seg.segment_ids_device(sorted_keys, pad_valid=rm)
            total = rm.sum().to(torch.int32)
            last = torch.clamp(total - 1, 0, padded - 1).to(torch.int64)
            n_real = torch.where(total > 0, seg_ids[last] + 1,
                                 torch.zeros_like(total)).to(torch.int32)
        else:
            # rows stay in place: segment 0 the rows, 1 the padding (the
            # reference gives each padding row its own segment; only
            # segment 0 is an output row either way)
            seg_ids = torch.where(rm, torch.zeros_like(lane),
                                  torch.ones_like(lane))
            sorted_keys = []
            n_real = torch.ones((), dtype=torch.int32, device=dev)

        out_valid_seg = lane < n_real
        buffers, seg_starts = self._reduce_buffers(
            inputs, jobs, seg_ids, padded, out_valid_seg, rm, bool(nkeys))
        out_keys = []
        if nkeys:
            # output key columns = first row of each segment
            safe_starts = torch.clamp(seg_starts, 0, padded - 1
                                      ).to(torch.int32)
            out_keys = G.gather_columns(sorted_keys, safe_starts,
                                        out_valid_seg)
        if emit == "buffers":
            return DeviceBatch(self.buffer_schema, out_keys + buffers,
                               n_real)
        return self._finalize(out_keys, buffers, n_real, padded,
                              out_valid_seg)

    def _buffer_inputs(self, batch, phase, nkeys, padded, dev, rm):
        """The buffers' input columns, unsorted, validity ANDed with the
        row mask and lengths int32 (None: count(*), whose count reads the
        row mask alone), and the jobs: (input index, op, buffer dtype) a
        buffer, in the node's order.  An update's functions read their
        child once however many buffers they fill."""
        def masked(c):
            return DeviceColumn(
                c.dtype, c.data, c.validity & rm,
                None if c.lengths is None else c.lengths.to(torch.int32))

        inputs, jobs = [], []
        if phase == "update":
            for sp in self.specs:
                func = sp.func
                if func.child is None:
                    inputs.append(None)
                else:
                    inputs.append(masked(as_device_column(
                        func.child.eval_tpu(batch), padded, dev)))
                base = len(inputs) - 1
                for (op, which), bt in zip(func.updates,
                                           func.buffer_dtypes()):
                    jobs.append((base + which, op, bt))
        else:
            col_idx = nkeys
            for sp in self.specs:
                for op, bt in zip(sp.func.merges, sp.func.buffer_dtypes()):
                    inputs.append(masked(batch.columns[col_idx]))
                    jobs.append((len(inputs) - 1, op, bt))
                    col_idx += 1
        return inputs, jobs

    def _reduce_buffers(self, inputs, jobs, seg_ids, padded, out_valid_seg,
                        present, starts: bool):
        """Every buffer of the node from its sorted input: the numeric
        ones (and, with ``starts``, the segment starts) in one K3 call
        (``segment.segment_reduce_many``), string min/max through
        ``segment.string_minmax``.  Returns (buffers, starts or None)."""
        buffers = [None] * len(jobs)
        numeric = []
        for k, (i, op, bt) in enumerate(jobs):
            c = inputs[i]
            if not bt.is_string:
                # count(*) counts the rows: its validity is the row mask
                numeric.append((k, (None, present, op) if c is None
                                else (c.data, c.validity, op)))
                continue
            if op not in ("min", "max"):
                raise NotImplementedError(
                    f"{op} over a string column on the device")
            data, lens, counts = seg.string_minmax(c.data, c.lengths,
                                                   c.validity, seg_ids,
                                                   padded, op)
            buffers[k] = DeviceColumn(bt, data, (counts > 0) & out_valid_seg,
                                      lens)
        results, seg_starts = seg.segment_reduce_many(
            [sp for _k, sp in numeric], seg_ids, padded, present=present,
            starts=starts)
        for (k, (_v, _ok, op)), (data, ok) in zip(numeric, results):
            bt = jobs[k][2]
            ok = out_valid_seg if op == "count" else ok & out_valid_seg
            if data.dtype != bt.torch_dtype:
                data = data.to(bt.torch_dtype)
            buffers[k] = DeviceColumn(bt, data, ok)
        return buffers, seg_starts

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
