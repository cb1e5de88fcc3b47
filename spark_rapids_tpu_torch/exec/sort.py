"""Device sort.

Counterpart of ``spark_rapids_tpu/exec/sort.py:TpuSortExec._order`` and
``_compute`` (75-91): the permutation of the sort keys from K1, padding
rows last, then a K4 gather of every column.  One batch per partition in
this slice; the external tile merge for larger partitions comes with the
SF10 slice.
"""
from __future__ import annotations

from ..ops.expression import as_device_column
from ..ops.kernels import gather as G
from ..ops.kernels import segment as seg
from ..data.column import DeviceColumn
from .base import DevicePartitionedData, TargetSize, TpuExec


class TpuSortExec(TpuExec):
    def __init__(self, child, keys):
        super().__init__([child])
        self.keys = keys  # List[functions.SortKey], exprs already bound

    @property
    def schema(self):
        return self.children[0].schema

    @property
    def children_coalesce_goal(self):
        return [TargetSize()]

    def _order(self, batch):
        padded, dev = batch.padded_rows, batch.device
        rm = batch.row_mask()
        key_cols = []
        for k in self.keys:
            c = as_device_column(k.expr.eval_tpu(batch), padded, dev)
            # padding rows must not influence the order
            key_cols.append(DeviceColumn(c.dtype, c.data, c.validity & rm,
                                         c.lengths))
        return seg.lexsort_device(
            key_cols,
            descending=[not k.ascending for k in self.keys],
            nulls_first=[k.nulls_first for k in self.keys],
            pad_valid=rm)

    def _compute(self, batch):
        return G.gather_batch(batch, self._order(batch), batch.num_rows)

    def execute_columnar(self, ctx):
        child = self.children[0].execute_columnar(ctx)

        def make(pid):
            def it():
                batches = list(child.iterator(pid))
                if len(batches) > 1:
                    raise NotImplementedError(
                        f"partition {pid} reached the sort as "
                        f"{len(batches)} batches; the external sort is not "
                        "ported yet")
                for b in batches:
                    yield self._compute(b)
            return it

        return DevicePartitionedData(
            [make(i) for i in range(child.n_partitions)])

    def describe(self):
        ks = ", ".join(
            f"{k.expr.sql()} {'ASC' if k.ascending else 'DESC'}"
            for k in self.keys)
        return f"TpuSort[{ks}]"


def register(register_exec):
    from ..plan import physical as P

    register_exec(
        P.SortExec,
        convert=lambda meta, ch: TpuSortExec(ch[0], meta.plan.keys),
        desc="device sort (stable LSD radix over key passes)",
        exprs_of=lambda plan: [k.expr for k in plan.keys])
