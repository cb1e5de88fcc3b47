"""Device window exec.

Counterpart of ``spark_rapids_tpu/exec/window.py:TpuWindowExec``, step by
step: for each window expression, one stable lexsort of the batch by
(partition keys, order keys) with K1 (padding sorts last), the sorted
partition keys gathered with K4 and their segment ids from K2 (without
partition keys every padding row is its own segment), then K14
(``ops/kernels/window.py``): each row's segment start and end,
row_number / rank / dense_rank (rank and dense_rank from K2's ids over
all keys), or the frame aggregate, written back to row order with
validity ANDed with the row mask.  Each expression sorts again, as in
the reference.  Output dtypes are ``WindowExpression.dtype``.

String frame aggregates, which the reference sends to its host engine,
are tagged off the device with the reference's reasons; the host engine
is not ported, so such a plan raises ``NotImplementedError`` naming
them.  Each partition's batches are concatenated into one (the
reference's ``execute_columnar``); the number of input batches is
recorded as ``TpuWindowExec.numInputBatches``.
"""
from __future__ import annotations

import torch

from .. import types as T
from ..data.column import DeviceBatch, DeviceColumn
from ..ops.aggregates import (AggregateFunction, Average, Count, First,
                              Last, Sum)
from ..ops.expression import as_device_column
from ..ops.kernels import gather as G
from ..ops.kernels import segment as seg
from ..ops.kernels import window as W
from ..ops.windowexprs import DenseRank, Rank, RowNumber, WindowExpression
from .base import DevicePartitionedData, RequireSingleBatch, TpuExec
from .coalesce import concat_device_batches

_BATCHES = "TpuWindowExec.numInputBatches"


def _supported_reason(wx: WindowExpression):
    """None if the expression runs on the device, else the reason (the
    reference's tagging, ``exec/window.py:41-60``)."""
    func = wx.func
    if isinstance(func, (RowNumber, Rank, DenseRank)):
        return None
    if not isinstance(func, AggregateFunction):
        return f"window function {type(func).__name__} not on device"
    if isinstance(func, (First, Last)):
        if func.child is not None and func.child.dtype.is_string:
            return "string window aggregates run on the host engine"
        return None
    name = getattr(func, "name", type(func).__name__.lower())
    if isinstance(func, (Count, Sum, Average)) or name in ("min", "max"):
        child = func.child
        if child is not None and child.dtype.id is T.TypeId.STRING \
                and name in ("min", "max", "sum", "average", "avg"):
            return "string window aggregates run on the host engine"
        return None
    return f"window aggregate {name} runs on the host engine"


def _frame_kind(func: AggregateFunction) -> str:
    if isinstance(func, Average):
        return "avg"
    return func.name


class TpuWindowExec(TpuExec):
    def __init__(self, child, plan):
        super().__init__([child])
        self.plan = plan  # window_cpu.WindowExec (expressions bound)
        self.window_exprs = plan.window_exprs
        self._schema = plan.schema

    @property
    def schema(self):
        return self._schema

    @property
    def children_coalesce_goal(self):
        return [RequireSingleBatch()]

    def _compute(self, batch: DeviceBatch) -> DeviceBatch:
        n = batch.padded_rows
        rm = batch.row_mask()
        out_cols = list(batch.columns)
        for wx in self.window_exprs:
            out_cols.append(self._one_window(batch, wx, n, rm))
        return DeviceBatch(self._schema, out_cols, batch.num_rows)

    def _one_window(self, batch, wx: WindowExpression, n: int,
                    rm: torch.Tensor) -> DeviceColumn:
        dev = batch.device
        spec = wx.spec
        part_cols = [as_device_column(e.eval_tpu(batch), n, dev)
                     for e in spec.partition_by]
        order_cols = [as_device_column(k.expr.eval_tpu(batch), n, dev)
                      for k in spec.order_by]
        desc = [False] * len(part_cols) + \
            [not k.ascending for k in spec.order_by]
        nf = [True] * len(part_cols) + [k.nulls_first for k in spec.order_by]
        all_cols = part_cols + order_cols
        lane = torch.arange(n, dtype=torch.int32, device=dev)
        if all_cols:
            order = seg.lexsort_device(all_cols, desc, nf, pad_valid=rm)
        else:
            order = lane
        # the sort puts the padding rows last, so rm is also the sorted
        # row mask
        func = wx.func
        ranked = isinstance(func, (Rank, DenseRank)) and bool(order_cols)
        # one K4 launch: the partition keys (and a rank's order keys)
        sorted_all = G.gather_columns(all_cols if ranked else part_cols,
                                      order)
        if part_cols:
            seg_ids = seg.segment_ids_device(sorted_all[:len(part_cols)],
                                             pad_valid=rm)
        else:
            # padding rows still need their own segments
            seg_ids = torch.where(rm, torch.zeros_like(lane), lane + 1)
        start, end = W.segment_bounds(seg_ids)

        if isinstance(func, (RowNumber, Rank, DenseRank)):
            ok_ids = ok_start = None
            if not isinstance(func, RowNumber):
                if order_cols:
                    ok_ids = seg.segment_ids_device(sorted_all,
                                                    pad_valid=rm)
                    if isinstance(func, Rank):
                        ok_start = W.segment_bounds(ok_ids)[0]
                else:  # no ordering: every row is its own tie group
                    ok_ids = ok_start = lane
            data, valid = W.rank_values(func.name, order, rm, start,
                                        ok_ids, ok_start)
        else:
            frame = spec.resolved_frame()
            values = valid = None
            if func.child is not None:
                c = as_device_column(func.child.eval_tpu(batch), n, dev)
                values, valid = c.data, c.validity
            data, valid = W.frame_aggregate(
                _frame_kind(func), frame.lower, frame.upper,
                bool(func.ignore_nulls), values, valid, order, rm, seg_ids,
                start, end)
        out_dtype = wx.dtype
        if data.dtype != out_dtype.torch_dtype:
            data = data.to(out_dtype.torch_dtype)
        return DeviceColumn(out_dtype, data, valid)

    def execute_columnar(self, ctx):
        child = self.children[0].execute_columnar(ctx)

        def make(pid):
            def it():
                batches = list(child.iterator(pid))
                ctx.add_metric(_BATCHES, len(batches))
                if not batches:
                    return
                yield self._compute(concat_device_batches(batches))

            return it

        return DevicePartitionedData(
            [make(i) for i in range(child.n_partitions)])

    def describe(self):
        return f"TpuWindow[{', '.join(w.sql() for w in self.window_exprs)}]"


def register(register_exec):
    from .window_cpu import WindowExec

    def tag(meta):
        for wx in meta.plan.window_exprs:
            reason = _supported_reason(wx)
            if reason:
                meta.will_not_work_on_tpu(reason)

    def exprs_of(plan):
        out = []
        for wx in plan.window_exprs:
            out.extend(wx.spec.partition_by)
            out.extend(k.expr for k in wx.spec.order_by)
            if isinstance(wx.func, AggregateFunction) \
                    and wx.func.child is not None:
                out.append(wx.func.child)
        return out

    register_exec(
        WindowExec,
        convert=lambda meta, ch: TpuWindowExec(ch[0], meta.plan),
        desc="scan-based window functions on the device",
        tag=tag,
        exprs_of=exprs_of)
