"""Device joins: shuffled hash join and broadcast hash join.

Counterpart of ``spark_rapids_tpu/exec/joins.py``: ``TpuHashJoinExec``
(65-325: ``_keys_of``, ``_count``, ``_expand``, ``_semi_anti``,
``_join``), ``TpuShuffledHashJoinExec`` (326-377),
``TpuBroadcastHashJoinExec`` (394-492) and ``register`` (495-522).  The
device work is the sort-merge pipeline of ``ops/kernels/join.py``: K5
probe (with K1, K2, K4), K6 emit counts and expansion, K7 gathers, and
K4 compaction for semi/anti joins.  The output capacity is
``bucket_rows(total)`` after one host read of the total, the reference's
own sync.

Each join records in the context's metrics how many batch pairs it
joined and how many batches each side brought
(``TpuHashJoinExec.numJoinedPairs``, ``.numLeftBatches``,
``.numRightBatches``).

Left out, for later slices: grace bucketing of sides that arrive as more
than one batch (``_join_grace``, ``_bucket_side``; such a partition
raises ``NotImplementedError``), the retry/split wrappers and OOM
injection, the broadcast registry (``exec/broadcast.py``: the build side
is built once per execution and not cached across queries), the AQE
hooks, ``join_static``, residual join conditions, and casts between key
types that differ.
"""
from __future__ import annotations

from typing import List

import torch

from ..data.column import DeviceBatch, bucket_rows, host_to_device
from ..ops.expression import Expression, as_device_column
from ..ops.kernels import join as J
from ..ops.kernels.gather import compact
from .base import (DevicePartitionedData, RequireSingleBatch, TargetSize,
                   TpuExec)
from .coalesce import concat_device_batches

_PAIRS = "TpuHashJoinExec.numJoinedPairs"
_LEFT = "TpuHashJoinExec.numLeftBatches"
_RIGHT = "TpuHashJoinExec.numRightBatches"


class TpuHashJoinExec(TpuExec):
    """Shared device join core (the reference's GpuHashJoin analogue)."""

    def __init__(self, left, right, plan):
        super().__init__([left, right])
        self.plan = plan  # physical.HashJoinExec (exprs already bound)
        self.how = plan.how
        self.left_keys = plan.left_keys
        self.right_keys = plan.right_keys
        self._schema = plan.schema

    @property
    def schema(self):
        return self._schema

    # ------------------------------------------------------------------
    @staticmethod
    def _keys_of(batch: DeviceBatch, exprs: List[Expression]):
        return [as_device_column(k.eval_tpu(batch), batch.padded_rows,
                                 batch.device) for k in exprs]

    def _probe(self, lb: DeviceBatch, rb: DeviceBatch) -> J.Probe:
        return J.probe(self._keys_of(lb, self.left_keys),
                       self._keys_of(rb, self.right_keys),
                       lb.row_mask(), rb.row_mask(),
                       with_has_r=self.how in ("right", "full"))

    def _count(self, lb: DeviceBatch, rb: DeviceBatch):
        pr = self._probe(lb, rb)
        return pr, J.emit_counts(pr, self.how, lb.row_mask(),
                                 rb.row_mask())

    def _expand(self, c_out: int, total: int, lb: DeviceBatch,
                rb: DeviceBatch, pr: J.Probe, e: J.Emit) -> DeviceBatch:
        lidx, ridx, slot_valid = J.expand_pairs(pr, e, c_out)
        cols = (J.gather_side(lb.columns, lidx, slot_valid)
                + J.gather_side(rb.columns, ridx, slot_valid))
        return DeviceBatch(self._schema, cols, torch.full(
            (), total, dtype=torch.int32, device=lb.device))

    def _semi_anti(self, lb: DeviceBatch, rb: DeviceBatch) -> DeviceBatch:
        has = self._probe(lb, rb).cnt > 0
        return compact(lb, has if self.how == "semi" else ~has)

    def _join(self, lb: DeviceBatch, rb: DeviceBatch) -> DeviceBatch:
        if self.how in ("semi", "anti"):
            return self._semi_anti(lb, rb)
        pr, e = self._count(lb, rb)
        total = int(e.total)  # host sync: output sizing
        return self._expand(bucket_rows(total), total, lb, rb, pr, e)

    def _empty(self, side: int, ctx) -> DeviceBatch:
        from ..plan.physical import _empty_batch

        return host_to_device(_empty_batch(self.children[side].schema),
                              device=ctx.device)

    def _one_batch(self, batches: List[DeviceBatch], side: int, ctx,
                   pid: int) -> DeviceBatch:
        if not batches:
            return self._empty(side, ctx)
        if len(batches) > 1:
            raise NotImplementedError(
                f"partition {pid}: the {('left', 'right')[side]} side of "
                f"{self.describe()} arrived as {len(batches)} batches; "
                "grace (hash-bucketed) joins are not ported yet (raise "
                "spark.rapids.tpu.sql.batchSizeBytes)")
        return batches[0]


class TpuShuffledHashJoinExec(TpuHashJoinExec):
    """Both sides co-partitioned by the exchanges; joins one batch pair
    per partition."""

    @property
    def children_coalesce_goal(self):
        return [TargetSize(), TargetSize()]

    def execute_columnar(self, ctx):
        left = self.children[0].execute_columnar(ctx)
        right = self.children[1].execute_columnar(ctx)
        if left.n_partitions != right.n_partitions:
            raise ValueError("a shuffled join needs co-partitioned sides")

        def make(pid):
            def it():
                l_batches = list(left.iterator(pid))
                r_batches = list(right.iterator(pid))
                ctx.add_metric(_LEFT, len(l_batches))
                ctx.add_metric(_RIGHT, len(r_batches))
                lb = self._one_batch(l_batches, 0, ctx, pid)
                rb = self._one_batch(r_batches, 1, ctx, pid)
                ctx.add_metric(_PAIRS)
                yield self._join(lb, rb)
            return it

        return DevicePartitionedData(
            [make(i) for i in range(left.n_partitions)])

    def describe(self):
        return f"TpuShuffledHashJoin[{self.how}]"


class TpuBroadcastHashJoinExec(TpuHashJoinExec):
    """The build (right) side gathered from every partition into one
    batch, once per execution, and joined against each stream batch
    (every join type the planner broadcasts — inner, left, semi, anti —
    is row-local on the stream side)."""

    @property
    def children_coalesce_goal(self):
        return [TargetSize(), RequireSingleBatch()]

    def execute_columnar(self, ctx):
        left = self.children[0].execute_columnar(ctx)
        built: List[DeviceBatch] = []

        def build() -> DeviceBatch:
            if not built:
                right = self.children[1].execute_columnar(ctx)
                batches = [b for pid in range(right.n_partitions)
                           for b in right.iterator(pid)]
                ctx.add_metric(_RIGHT, len(batches))
                built.append(concat_device_batches(batches)
                             if batches else self._empty(1, ctx))
            return built[0]

        def make(pid):
            def it():
                streamed = False
                for lb in left.iterator(pid):
                    streamed = True
                    ctx.add_metric(_LEFT)
                    ctx.add_metric(_PAIRS)
                    yield self._join(lb, build())
                if not streamed:
                    ctx.add_metric(_PAIRS)
                    yield self._join(self._empty(0, ctx), build())
            return it

        return DevicePartitionedData(
            [make(i) for i in range(left.n_partitions)])

    def describe(self):
        return f"TpuBroadcastHashJoin[{self.how}]"


def register(register_exec):
    from ..plan import physical as P

    def tag(meta):
        plan = meta.plan
        if plan.condition is not None:
            meta.will_not_work_on_tpu(
                "join conditions are not ported to the device yet")
        for lk, rk in zip(plan.left_keys, plan.right_keys):
            if lk.dtype != rk.dtype:
                meta.will_not_work_on_tpu(
                    f"join keys of different types ({lk.dtype} vs "
                    f"{rk.dtype}) need a cast, which is not ported yet")

    def exprs_of(plan):
        out = list(plan.left_keys) + list(plan.right_keys)
        if plan.condition is not None:
            out.append(plan.condition)
        return out

    def convert(meta, ch):
        cls = TpuBroadcastHashJoinExec if meta.plan.broadcast \
            else TpuShuffledHashJoinExec
        return cls(ch[0], ch[1], meta.plan)

    register_exec(
        P.HashJoinExec,
        convert=convert,
        desc="sort-merge equi-join on the device",
        tag=tag,
        exprs_of=exprs_of)
