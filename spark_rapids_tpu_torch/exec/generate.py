"""Device Generate (explode) exec.

Counterpart of ``spark_rapids_tpu/exec/generate.py``: the reference's
statically shaped explode of per-row element expressions (outer=false):
every input row yields ``k`` output rows, so a batch of ``p`` padded rows
becomes one of ``p * k`` (not a power of two for k = 3: the consumers
take any row count, and the batch keeps the reference's shape, so the
coalesce above it sees the reference's batch sizes), with the logical
rows first (``num_rows * k``).  The elements are evaluated by the
engine's torch ops; K22 (``ops/kernels/generate.py:explode``) repeats
the pass-through columns, writes ``pos`` and interleaves the elements
row-major in one launch.  An element of type NULL (an untyped null
literal) takes the output type's null.  A nondeterministic element tags
the exec off the device, as in the reference.
"""
from __future__ import annotations

from typing import List

from .. import types as T
from ..data.column import DeviceBatch
from ..ops.expression import (Expression, Scalar, as_device_column,
                              bind_references)
from ..ops.kernels import generate as GK
from .base import DevicePartitionedData, TpuExec


class TpuGenerateExec(TpuExec):
    def __init__(self, child, plan):
        super().__init__([child])
        self.elements: List[Expression] = [
            bind_references(e, child.schema) for e in plan.elements]
        self.position = plan.position
        self._schema = plan.schema
        self._out_dtype = self._schema.fields[-1].dtype

    @property
    def schema(self):
        return self._schema

    @property
    def coalesce_after(self):
        return True

    def eval_elements(self, batch: DeviceBatch):
        n, dev = batch.padded_rows, batch.device
        out = []
        for e in self.elements:
            v = e.eval_tpu(batch)
            if e.dtype.id is T.TypeId.NULL:
                v = Scalar(self._out_dtype, None)
            out.append(as_device_column(v, n, dev))
        return out

    def _compute(self, batch: DeviceBatch, plain: bool = False
                 ) -> DeviceBatch:
        """The exploded batch, on K22 (or, with ``plain``, on its plain
        version: a fused segment's plain composition)."""
        elements = self.eval_elements(batch)
        if plain:
            cols = GK.explode_plain(batch.columns, batch.row_mask(),
                                    elements, self._out_dtype,
                                    self.position)
        else:
            cols = GK.explode(batch.columns, batch.num_rows, elements,
                              self._out_dtype, self.position)
        return DeviceBatch(self._schema, cols,
                           batch.num_rows * len(self.elements))

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
        return (f"TpuGenerate[{len(self.elements)} elements"
                f"{', pos' if self.position else ''}]")


def register(register_exec):
    from ..plan import physical as P

    def tag(meta):
        # the exploded row count must be static: every element evaluates
        # per input row (the reference's literal-array scope)
        for e in meta.plan.elements:
            if not e.deterministic:
                meta.will_not_work_on_tpu(
                    "nondeterministic explode elements")

    register_exec(
        P.GenerateExec,
        convert=lambda meta, ch: TpuGenerateExec(ch[0], meta.plan),
        desc="statically-shaped explode on device",
        tag=tag,
        exprs_of=lambda plan: list(plan.elements))
