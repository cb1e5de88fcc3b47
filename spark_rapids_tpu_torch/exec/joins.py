"""Device joins: shuffled hash join and broadcast hash join.

Counterpart of ``spark_rapids_tpu/exec/joins.py``: ``TpuHashJoinExec``
(65-325: ``_keys_of``, ``_count``, ``_expand``, ``_semi_anti``,
``_join``), ``TpuShuffledHashJoinExec`` (326-377),
``TpuBroadcastHashJoinExec`` (394-492) and ``register`` (495-522).  The
device work is the sort-merge pipeline of ``ops/kernels/join.py``: K5
probe (with K1, K2, K4), K6 emit counts and expansion, K7's gather of
both sides in one launch, and K4 compaction for semi/anti joins.  The output capacity is
``bucket_rows(total)`` after one host read of the total, the reference's
own sync.

A shuffled join whose side reaches a partition as more than one batch
joins out of core by grace hash bucketing (reference ``_bucket_side``,
``_take_bucket``, ``_join_grace``, 108-237): both sides are split by
Murmur3 of their keys from a seed of the level
(``0x5D1E_995 + 1_000_003 * level``, never the exchange's 42), ``pmod
m``, with ``m`` doubling from 2 while ``m * batchSizeBytes`` is below the
pair's bytes, up to 64 (K9 seeded, K10's order, one read back of the m
counts, K25's split); equal keys share a bucket, so the buckets 0..m-1
join pairwise for every join type, and a bucket whose estimated bytes
pass twice the target is split again at the next level (at most 6, and
only while it is smaller than its parent pair).  The buckets, levels and
pair order are the reference's; the rows come out in bucket order.

Each join records in the context's metrics how many partition pairs it
joined and how many batches each side brought
(``TpuHashJoinExec.numJoinedPairs``, ``.numLeftBatches``,
``.numRightBatches``), and for the grace path the bucket pairs joined,
the buckets split and the deepest level (``.numGracePairs``,
``.numGraceBuckets``, ``.graceMaxLevel``); a shuffled join also appends
one record a partition to ``ctx.joins`` (its sides' batches and bytes
and those grace figures).

Differences from the reference's grace join: no spill catalog (buckets
stay device batches until the spill tier, ROADMAP A6; each source batch
is dropped once split, so a side is held about once plus its buckets),
and no ``pad_device_batch`` of each level's pairs to one shape (the
reference pads only so that XLA compiles once a level; eager PyTorch
compiles nothing per shape, and the rows are the same without it).

Left out, for later slices: the retry/split wrappers and OOM injection,
the broadcast registry (``exec/broadcast.py``: the build side is built
once per execution and not cached across queries), the AQE hooks,
``join_static``, residual join conditions, and casts between key types
that differ.
"""
from __future__ import annotations

from typing import List

import torch

from ..config import BATCH_SIZE_BYTES
from ..data.column import DeviceBatch, bucket_rows, host_to_device
from ..ops.expression import Expression, as_device_column
from ..ops.kernels import join as J
from ..ops.kernels.gather import compact
from ..shuffle import device_shuffle as DS
from ..utils import hashing
from .base import (DevicePartitionedData, RequireSingleBatch, TargetSize,
                   TpuExec)
from .coalesce import concat_device_batches

_PAIRS = "TpuHashJoinExec.numJoinedPairs"
_LEFT = "TpuHashJoinExec.numLeftBatches"
_RIGHT = "TpuHashJoinExec.numRightBatches"
_GRACE_PAIRS = "TpuHashJoinExec.numGracePairs"
_GRACE_BUCKETS = "TpuHashJoinExec.numGraceBuckets"
_GRACE_LEVEL = "TpuHashJoinExec.graceMaxLevel"

#: the grace buckets' seed at level 0 and its step a level (the
#: exchange's rows already share ``h42 % P``, so its seed would put them
#: all in one bucket whenever m and P share a factor)
GRACE_SEED = 0x5D1E_995
GRACE_SEED_STEP = 1_000_003
#: buckets a split takes at most, and the deepest recursion level
GRACE_MAX_BUCKETS = 64
GRACE_MAX_LEVEL = 6


class TpuHashJoinExec(TpuExec):
    """Shared device join core (the reference's GpuHashJoin analogue)."""

    def __init__(self, left, right, plan):
        super().__init__([left, right])
        self.plan = plan  # physical.HashJoinExec (exprs already bound)
        self.how = plan.how
        self.left_keys = plan.left_keys
        self.right_keys = plan.right_keys
        self._schema = plan.schema
        self._empties = {}

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
        cols = J.gather_pair(lb.columns, lidx, rb.columns, ridx,
                             slot_valid)
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
        """A batch of no rows for ``side``, made once (the grace path
        joins many buckets that are empty on one side)."""
        from ..plan.physical import _empty_batch

        key = (side, ctx.device)
        if key not in self._empties:
            self._empties[key] = host_to_device(
                _empty_batch(self.children[side].schema), device=ctx.device)
        return self._empties[key]

    # ------------------------------------------------------------------
    # out of core: grace hash bucketing
    # ------------------------------------------------------------------
    def _bucket_side(self, batches: List[DeviceBatch],
                     key_exprs: List[Expression], m: int, seed: int):
        """Split every batch of ``batches`` into ``m`` key-hash buckets
        (K9 from ``seed``, pmod ``m``; K10's order; one read back of the
        m counts; K10's split), taking each batch out of the list as it
        is split so that it is freed.  Returns the pieces of each bucket and each
        bucket's row total."""
        buckets: List[List[DeviceBatch]] = [[] for _ in range(m)]
        totals = [0] * m
        while batches:
            b = batches.pop(0)
            pids = hashing.hash_pids(self._keys_of(b, key_exprs), m,
                                     seed=seed)
            parts, counts = DS.split_by_bucket(b, pids, m)
            for i, (part, cnt) in enumerate(zip(parts, counts)):
                if cnt:
                    buckets[i].append(part)
                    totals[i] += cnt
        return buckets, totals

    def _take_bucket(self, parts: List[DeviceBatch], side: int,
                     ctx) -> DeviceBatch:
        """One batch of ``parts`` (a bucket's pieces, or a side of at
        most one batch): their concat, or an empty batch."""
        if not parts:
            return self._empty(side, ctx)
        return concat_device_batches(parts) if len(parts) > 1 else parts[0]

    def _join_grace(self, l_batches: List[DeviceBatch],
                    r_batches: List[DeviceBatch], total_bytes: int,
                    target: int, level: int, ctx, stats: dict):
        """Join sides too big for one batch pair bucket by bucket: both
        split into the same ``m`` buckets, each pair joined on its own, a
        bucket still over twice the target split again one level down
        (in place, before the next bucket).  Consumes both lists."""
        m = 2
        while m * target < total_bytes and m < GRACE_MAX_BUCKETS:
            m <<= 1
        seed = GRACE_SEED + GRACE_SEED_STEP * level
        l_bytes = sum(b.device_bytes() for b in l_batches)
        r_bytes = total_bytes - l_bytes
        l_buckets, l_counts = self._bucket_side(l_batches, self.left_keys,
                                                m, seed)
        r_buckets, r_counts = self._bucket_side(r_batches, self.right_keys,
                                                m, seed)
        ctx.add_metric(_GRACE_BUCKETS, m)
        ctx.metrics[_GRACE_LEVEL] = max(ctx.metrics.get(_GRACE_LEVEL, 0),
                                        level)
        stats["grace_buckets"] += m
        stats["grace_max_level"] = max(stats["grace_max_level"] or 0, level)
        l_bpr = l_bytes / max(sum(l_counts), 1)
        r_bpr = r_bytes / max(sum(r_counts), 1)
        for i in range(m):
            if not l_buckets[i] and not r_buckets[i]:
                continue
            lb = self._take_bucket(l_buckets[i], 0, ctx)
            rb = self._take_bucket(r_buckets[i], 1, ctx)
            l_buckets[i] = r_buckets[i] = None
            est = l_counts[i] * l_bpr + r_counts[i] * r_bpr
            if est > 2 * target and level < GRACE_MAX_LEVEL \
                    and est < total_bytes:
                # still too big but shrinking: split this pair again
                # (est == total_bytes means one dominant key, which no
                # hash splits: join it as it is)
                pair_bytes = lb.device_bytes() + rb.device_bytes()
                sides = [lb], [rb]
                del lb, rb
                yield from self._join_grace(*sides, pair_bytes, target,
                                            level + 1, ctx, stats)
            else:
                ctx.add_metric(_GRACE_PAIRS)
                stats["grace_pairs"] += 1
                yield self._join(lb, rb)


class TpuShuffledHashJoinExec(TpuHashJoinExec):
    """Both sides co-partitioned by the exchanges; joins each partition's
    batch pair, or its bucket pairs where a side brought several
    batches."""

    @property
    def children_coalesce_goal(self):
        return [TargetSize(), TargetSize()]

    def execute_columnar(self, ctx):
        left = self.children[0].execute_columnar(ctx)
        right = self.children[1].execute_columnar(ctx)
        if left.n_partitions != right.n_partitions:
            raise ValueError("a shuffled join needs co-partitioned sides")
        target = ctx.conf.get(BATCH_SIZE_BYTES)

        def make(pid):
            def it():
                l_batches = list(left.iterator(pid))
                r_batches = list(right.iterator(pid))
                ctx.add_metric(_LEFT, len(l_batches))
                ctx.add_metric(_RIGHT, len(r_batches))
                ctx.add_metric(_PAIRS)
                l_bytes = sum(b.device_bytes() for b in l_batches)
                r_bytes = sum(b.device_bytes() for b in r_batches)
                stats = {"join": self.describe(), "exec": id(self),
                         "partition": pid, "left_batches": len(l_batches),
                         "right_batches": len(r_batches),
                         "left_bytes": l_bytes, "right_bytes": r_bytes,
                         "grace_pairs": 0, "grace_buckets": 0,
                         "grace_max_level": None}
                ctx.joins.append(stats)
                if len(l_batches) <= 1 and len(r_batches) <= 1:
                    yield self._join(self._take_bucket(l_batches, 0, ctx),
                                     self._take_bucket(r_batches, 1, ctx))
                    return
                yield from self._join_grace(l_batches, r_batches,
                                            l_bytes + r_bytes, target, 0,
                                            ctx, stats)
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
