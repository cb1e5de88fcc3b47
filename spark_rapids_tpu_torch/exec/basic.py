"""Basic device operators: Project, Filter and the limits.

Counterpart of ``spark_rapids_tpu/exec/basic.py:22-121,141-190``.  The
filter compacts with K4 (``ops/kernels/gather.py:compact``).  A limit
reads each batch's row count on the host, as the reference does, and
turns the rows past the limit into padding through validity.  Union
and Expand come with later slices.
"""
from __future__ import annotations

from typing import List

import torch

from .. import types as T
from ..data.column import DeviceBatch, DeviceColumn
from ..ops.expression import (Expression, as_device_column,
                              bind_references, output_name)
from ..ops.kernels.gather import compact
from .base import DevicePartitionedData, TpuExec


class TpuProjectExec(TpuExec):
    def __init__(self, child, exprs: List[Expression],
                 schema: T.Schema = None):
        super().__init__([child])
        self.exprs = [bind_references(e, child.schema) for e in exprs]
        if schema is None:
            schema = T.Schema([
                T.Field(output_name(raw, i), b.dtype, b.nullable)
                for i, (raw, b) in enumerate(zip(exprs, self.exprs))])
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    def _compute(self, batch: DeviceBatch) -> DeviceBatch:
        n, dev = batch.padded_rows, batch.device
        mask = batch.row_mask()  # padding rows stay invalid
        cols = []
        for e in self.exprs:
            c = as_device_column(e.eval_tpu(batch), n, dev)
            cols.append(DeviceColumn(c.dtype, c.data, c.validity & mask,
                                     c.lengths))
        return DeviceBatch(self._schema, cols, batch.num_rows)

    def execute_columnar(self, ctx):
        child = self.children[0].execute_columnar(ctx)

        def make(pid):
            def it():
                for db in child.iterator(pid):
                    yield self._compute(db)
            return it

        return DevicePartitionedData(
            [make(i) for i in range(child.n_partitions)])

    def describe(self):
        return f"TpuProject[{', '.join(e.sql() for e in self.exprs)}]"


class TpuFilterExec(TpuExec):
    def __init__(self, child, condition: Expression):
        super().__init__([child])
        self.condition = bind_references(condition, child.schema)

    @property
    def schema(self):
        return self.children[0].schema

    @property
    def coalesce_after(self):
        return True

    def _keep(self, batch: DeviceBatch):
        """The keep mask of ``condition`` over ``batch`` — shared with
        the fused segment, which threads the mask through the segment
        instead of compacting per filter."""
        c = as_device_column(self.condition.eval_tpu(batch),
                             batch.padded_rows, batch.device)
        return c.data & c.validity

    def _compute(self, batch: DeviceBatch) -> DeviceBatch:
        return compact(batch, self._keep(batch))

    def execute_columnar(self, ctx):
        child = self.children[0].execute_columnar(ctx)

        def make(pid):
            def it():
                for db in child.iterator(pid):
                    yield self._compute(db)
            return it

        return DevicePartitionedData(
            [make(i) for i in range(child.n_partitions)])

    def describe(self):
        return f"TpuFilter[{self.condition.sql()}]"


class TpuLocalLimitExec(TpuExec):
    def __init__(self, child, n: int):
        super().__init__([child])
        self.n = n

    @property
    def schema(self):
        return self.children[0].schema

    def execute_columnar(self, ctx):
        child = self.children[0].execute_columnar(ctx)

        def make(pid):
            def it():
                remaining = self.n
                for db in child.iterator(pid):
                    if remaining <= 0:
                        break
                    n_rows = int(db.num_rows)  # host sync, as the reference
                    if n_rows <= remaining:
                        remaining -= n_rows
                        yield db
                        continue
                    # the padded arrays stay; rows past the limit become
                    # padding
                    mask = torch.arange(db.padded_rows, dtype=torch.int32,
                                        device=db.device) < remaining
                    cols = [DeviceColumn(c.dtype, c.data, c.validity & mask,
                                         c.lengths) for c in db.columns]
                    yield DeviceBatch(db.schema, cols, torch.full(
                        (), remaining, dtype=torch.int32, device=db.device))
                    remaining = 0
            return it

        return DevicePartitionedData(
            [make(i) for i in range(child.n_partitions)])

    def describe(self):
        return f"TpuLocalLimit[{self.n}]"


class TpuGlobalLimitExec(TpuLocalLimitExec):
    """Over a single partition (the planner puts the exchange below)."""

    def describe(self):
        return f"TpuGlobalLimit[{self.n}]"


def register(register_exec):
    from ..plan import physical as P

    register_exec(
        P.ProjectExec,
        convert=lambda meta, ch: TpuProjectExec(
            ch[0], meta.plan.exprs, meta.plan.schema),
        desc="columnar projection on the device",
        exprs_of=lambda plan: list(plan.exprs))
    register_exec(
        P.FilterExec,
        convert=lambda meta, ch: TpuFilterExec(ch[0], meta.plan.condition),
        desc="columnar filter with stream compaction on the device",
        exprs_of=lambda plan: [plan.condition])
    register_exec(
        P.GlobalLimitExec,
        convert=lambda meta, ch: TpuGlobalLimitExec(ch[0], meta.plan.n),
        desc="global limit on the device")
    register_exec(
        P.LocalLimitExec,
        convert=lambda meta, ch: TpuLocalLimitExec(ch[0], meta.plan.n),
        desc="per-partition limit on the device")
