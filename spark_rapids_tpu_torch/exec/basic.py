"""Basic device operators: Project, Filter, Union, the limits and Expand.

Counterpart of ``spark_rapids_tpu/exec/basic.py``.  The filter compacts
with K4 (``ops/kernels/gather.py:compact``).  A union hands on its
children's partitions one after another.  A limit reads each batch's row
count on the host, as the reference does, and turns the rows past the
limit into padding through validity.  An expand (grouping sets) yields
one batch per projection list per input batch, as the reference's
``TpuExpandExec`` (``:191-256``): K23 (``ops/kernels/generate.py:expand``)
writes all of them in one launch, after the torch ops evaluate the
entries that are neither column references nor literals.
"""
from __future__ import annotations

from typing import List

import torch

from .. import types as T
from ..data.column import DeviceBatch, DeviceColumn
from ..ops.expression import (BoundReference, Expression, Literal,
                              as_device_column, bind_references,
                              output_name, unalias)
from ..ops.kernels import generate as GK
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


class TpuUnionExec(TpuExec):
    def __init__(self, children):
        super().__init__(children)

    @property
    def schema(self):
        return self.children[0].schema

    def execute_columnar(self, ctx):
        parts = []
        for ch in self.children:
            parts.extend(ch.execute_columnar(ctx).parts)
        return DevicePartitionedData(parts)

    def describe(self):
        return "TpuUnion"


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


class TpuExpandExec(TpuExec):
    """One projected batch per projection list per input batch; each
    field takes the first projection's type and is nullable."""

    def __init__(self, child, projections: List[List[Expression]],
                 output_names: List[str]):
        super().__init__([child])
        self.projections = [[bind_references(e, child.schema) for e in ps]
                            for ps in projections]
        self._schema = T.Schema([T.Field(n, b.dtype, True) for n, b in
                                 zip(output_names, self.projections[0])])
        n_in = len(child.schema)
        #: entries evaluated by torch before K23, in order
        self.evaluated: List[Expression] = []
        self.ops: List[List[GK.ExpandOp]] = []
        for ps in self.projections:
            ops = []
            for f, e in zip(self._schema, ps):
                u = unalias(e)
                if isinstance(u, BoundReference):
                    ops.append(GK.ExpandOp("ref", f.dtype, u.ordinal))
                elif isinstance(u, Literal):
                    if u.value is None and u.dtype.id is not \
                            T.TypeId.NULL:
                        ops.append(GK.ExpandOp("null", f.dtype))
                    else:
                        ops.append(GK.ExpandOp("lit", f.dtype, value=u.value,
                                               lit_dtype=u.dtype))
                else:
                    ops.append(GK.ExpandOp("ref", f.dtype,
                                           n_in + len(self.evaluated)))
                    self.evaluated.append(e)
            self.ops.append(ops)
        self.spec = GK.ExpandSpec(self.ops)

    @property
    def schema(self):
        return self._schema

    @property
    def coalesce_after(self):
        return True

    def _compute(self, batch: DeviceBatch, plain: bool = False
                 ) -> List[DeviceBatch]:
        """The projected batches, on K23 (or, with ``plain``, on its
        plain version: a fused segment's plain composition)."""
        n, dev = batch.padded_rows, batch.device
        sources = list(batch.columns) + [
            as_device_column(e.eval_tpu(batch), n, dev)
            for e in self.evaluated]
        if plain:
            out = GK.expand_plain(sources, batch.row_mask(), self.ops)
        else:
            out = GK.expand(sources, batch.num_rows, self.spec)
        return [DeviceBatch(self._schema, cols, batch.num_rows)
                for cols in out]

    def execute_columnar(self, ctx):
        child = self.children[0].execute_columnar(ctx)

        def make(pid):
            def it():
                for db in child.iterator(pid):
                    yield from self._compute(db)
            return it

        return DevicePartitionedData(
            [make(i) for i in range(child.n_partitions)])

    def describe(self):
        return f"TpuExpand[{len(self.projections)} projections]"


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
        P.UnionExec,
        convert=lambda meta, ch: TpuUnionExec(ch),
        desc="columnar union")
    register_exec(
        P.ExpandExec,
        convert=lambda meta, ch: TpuExpandExec(
            ch[0], meta.plan.projections, meta.plan.schema.names),
        desc="grouping-sets expand on device",
        exprs_of=lambda plan: [e for ps in plan.projections for e in ps])
    register_exec(
        P.GlobalLimitExec,
        convert=lambda meta, ch: TpuGlobalLimitExec(ch[0], meta.plan.n),
        desc="global limit on the device")
    register_exec(
        P.LocalLimitExec,
        convert=lambda meta, ch: TpuLocalLimitExec(ch[0], meta.plan.n),
        desc="per-partition limit on the device")
