"""Device exchange, single output partition only.

Counterpart of ``spark_rapids_tpu/exec/exchange.py:TpuShuffleExchangeExec``
for ``n_out == 1``: every row goes to partition 0, so the exchange hands
the child's batches of every input partition through in order (the
reference's packed partition build + slice return the same rows at the
same padded size).  Murmur3 hash and range partitioning, and with them
``n_out > 1``, come with the multi-partition slice; such a plan raises.
"""
from __future__ import annotations

from .base import DevicePartitionedData, TargetRows, TpuExec


class TpuShuffleExchangeExec(TpuExec):
    def __init__(self, child, plan):
        super().__init__([child])
        self.plan = plan  # physical.ShuffleExchangeExec
        self.partitioning = plan.partitioning
        self.n_out = plan.n_out
        if self.n_out != 1:
            raise NotImplementedError(
                f"exchange to {self.n_out} partitions is not ported yet; "
                "only a single output partition is")

    @property
    def schema(self):
        return self.children[0].schema

    @property
    def children_coalesce_goal(self):
        return [TargetRows(None)]

    def execute_columnar(self, ctx):
        child = self.children[0].execute_columnar(ctx)

        def it():
            for pid in range(child.n_partitions):
                yield from child.iterator(pid)

        return DevicePartitionedData([it])

    def describe(self):
        return f"TpuShuffleExchange[{self.partitioning.describe()}]"


def register(register_exec):
    from ..plan import physical as P

    def tag(meta):
        if meta.plan.n_out != 1:
            meta.will_not_work_on_tpu(
                f"exchange to {meta.plan.n_out} partitions needs the "
                "hash/range exchange, which is not ported yet")

    register_exec(
        P.ShuffleExchangeExec,
        convert=lambda meta, ch: TpuShuffleExchangeExec(ch[0], meta.plan),
        desc="device exchange (single output partition)",
        tag=tag)
