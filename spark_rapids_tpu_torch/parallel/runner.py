"""Distributed plan execution over the shards of a mesh.

Counterpart of ``spark_rapids_tpu/parallel/runner.py`` with one
controller.  The plan is cut at every exchange into stages, as Spark
cuts its DAG (``_split``, ``plan_stages``); the subtrees that do not
distribute (scans, host transitions) run locally and are dealt to the
shards (``_run_leaf``); then each stage runs over all the shards:

    exchange  = the transport's collective (``collective.py``): hash
                (K9), round robin, single and range partitioning (sampled
                bounds, K1 + K11), each through K10, K24 and K4
    broadcast = the build side replicated once a query
                (``_prepare_broadcasts``)
    join      = the exec's own join per shard, colocation checked first

The reference traces one stage per shard inside shard_map, where a
collective makes every shard wait for the others.  Here ``_lower``
returns the list of the n shards' batches: an ordinary exec runs its own
per-batch body (``_compute``, ``compute_batch``) on each shard in turn,
and an exchange, a replicate or a gather-to-one runs once over the whole
list.  PyTorch runs eagerly, so an exchange's capacity comes from the
partition counts it reads back, and a join is the exec's own ``_join``,
which sizes its output from the total it reads back (where the reference
calls ``join_static`` at a static capacity): there is no capacity retry
and no row is dropped.

Left out, each with its module: stage re-execution, the watchdog, the
host round-trip checksum and fault injection (``fault/``); stage
checkpoints and ``run_distributed(recovery=...)`` (``recovery/``); stage
statistics (``adaptive/``); spans, events and ``finish_query``
(``telemetry/``); cancellation (``scheduler/``); the collective deadline,
guarded calls and drain speculation (``elastic.py``); the task thread
pool (the leaves drain one partition at a time).  Aggregates run in the
partial and final modes the port's planner emits; a global (keyless)
final aggregate over rows gathered to shard 0 runs there alone, the
other shards yielding no rows, so that the runner returns the one row
``collect()`` returns (ROADMAP C.13: the reference's runner runs it on
every shard and returns a row of nulls for each empty one).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.column import (DeviceBatch, DeviceColumn, HostBatch,
                           bucket_rows, device_to_host_many, host_to_device)
from ..data import strings as dstrings
from ..ops.expression import as_device_column
from ..ops.kernels import segment as seg
from ..utils import hashing
from . import exchange as X
from .mesh import make_mesh

#: strided key samples a shard takes for the range bounds
RANGE_SAMPLES = 64


class DistributedUnsupported(Exception):
    """Raised when a plan node cannot run over the mesh."""


class _LeafRef:
    """A locally executed input, dealt to the shards."""

    def __init__(self, idx: int, node):
        self.idx = idx
        self.node = node


class _StageRef:
    """The output of an earlier stage, with the partitioning its exchange
    gave it (consumers check their distribution against it)."""

    def __init__(self, stage_id: int, partitioning=None):
        self.stage_id = stage_id
        self.partitioning = partitioning


class _Stage:
    def __init__(self, sid: int, root):
        self.sid = sid
        self.root = root  # exec tuples with _LeafRef/_StageRef leaves


def _where_rows(batch: DeviceBatch, pids: torch.Tensor,
                n: int) -> torch.Tensor:
    """``pids`` on the batch's rows, the sentinel ``n`` on its padding."""
    return torch.where(batch.row_mask(), pids.to(torch.int32),
                       torch.full((), n, dtype=torch.int32,
                                  device=pids.device))


class DistributedRunner:
    """Runs a device physical plan over ``mesh``; ``run(plan, ctx)``
    returns the rows of shards 0..n-1 concatenated, like ``collect``."""

    def __init__(self, mesh, min_bucket_rows: int = 128, transport=None):
        from .collective import DeviceCollectiveTransport

        self.mesh = mesh
        self.n = mesh.size
        self.min_bucket = min_bucket_rows
        self.transport = transport or DeviceCollectiveTransport(
            mesh, min_bucket_rows)

    # ---------------- stage splitting ---------------------------------
    def _split(self, node, stages: List[_Stage], leaves: List[_LeafRef]):
        from ..exec import basic as B
        from ..exec.aggregate import TpuHashAggregateExec
        from ..exec.coalesce import TpuCoalesceBatchesExec
        from ..exec.exchange import TpuShuffleExchangeExec
        from ..exec.fused import TpuFusedSegmentExec
        from ..exec.generate import TpuGenerateExec
        from ..exec.joins import TpuHashJoinExec
        from ..exec.sort import TpuSortExec
        from ..exec.window import TpuWindowExec

        distributable = (B.TpuProjectExec, B.TpuFilterExec,
                         B.TpuLocalLimitExec, B.TpuExpandExec,
                         B.TpuUnionExec, TpuHashAggregateExec,
                         TpuCoalesceBatchesExec, TpuSortExec,
                         TpuWindowExec, TpuGenerateExec, TpuHashJoinExec,
                         TpuFusedSegmentExec)

        if isinstance(node, TpuShuffleExchangeExec):
            # the exchange ends its producing stage
            body = self._split(node.children[0], stages, leaves)
            stage = _Stage(len(stages), (node, body))
            stages.append(stage)
            return _StageRef(stage.sid, node.partitioning)
        if isinstance(node, distributable):
            kids = [self._split(c, stages, leaves) for c in node.children]
            return (node, *kids)
        ref = _LeafRef(len(leaves), node)
        leaves.append(ref)
        return ref

    def plan_stages(self, root) -> Tuple[List[_Stage], List[_LeafRef]]:
        """Split ``root`` (any DeviceToHostExec root stripped) into
        stages; the last stage carries the plan's root."""
        from ..exec.transitions import DeviceToHostExec

        while isinstance(root, DeviceToHostExec):
            root = root.children[0]
        stages: List[_Stage] = []
        leaves: List[_LeafRef] = []
        top = self._split(root, stages, leaves)
        stages.append(_Stage(len(stages), top))
        return stages, leaves

    # ---------------- leaves ------------------------------------------
    def _run_leaf(self, node, ctx) -> List[DeviceBatch]:
        """Run a subtree that does not distribute and deal its partitions
        round robin to the shards (``pid % n``); when at most ``max(1, n //
        4)`` shards got rows, split the rows evenly instead.  The host
        batches under a HostToDeviceExec are taken as they are."""
        from ..exec.base import TpuExec
        from ..exec.transitions import HostToDeviceExec
        from ..plan.physical import _empty_batch

        if isinstance(node, HostToDeviceExec):
            data = node.children[0].execute(ctx)
            per_pid = [list(data.iterator(p))
                       for p in range(data.n_partitions)]
        elif isinstance(node, TpuExec):
            data = node.execute_columnar(ctx)
            per_pid = [device_to_host_many(list(data.iterator(p)))
                       for p in range(data.n_partitions)]
        else:
            data = node.execute(ctx)
            per_pid = [list(data.iterator(p))
                       for p in range(data.n_partitions)]

        shard_lists: List[List[HostBatch]] = [[] for _ in range(self.n)]
        for pid, bs in enumerate(per_pid):
            shard_lists[pid % self.n].extend(b for b in bs if b.num_rows)
        nonempty = sum(1 for bs in shard_lists if bs)
        def joined(bs: List[HostBatch]) -> HostBatch:
            # a shard's one batch is taken as it is, with no host copy
            if not bs:
                return _empty_batch(node.schema)
            return bs[0] if len(bs) == 1 else HostBatch.concat(bs)

        if nonempty <= max(1, self.n // 4):
            big = joined([b for bs in shard_lists for b in bs])
            n_rows = big.num_rows
            chunk = -(-n_rows // self.n) if n_rows else 0
            shards = [big.slice(min(p * chunk, n_rows),
                                min(p * chunk + chunk, n_rows))
                      for p in range(self.n)]
        else:
            shards = [joined(bs) for bs in shard_lists]
        return self._stack_host(shards)

    def _stack_host(self, shards: List[HostBatch]) -> List[DeviceBatch]:
        """One device batch a shard, on the shard's device, all at the
        bucket of the largest shard and with every string column at its
        widest width over the shards."""
        from ..data.column import HostColumn

        bucket = bucket_rows(max(max(b.num_rows for b in shards), 1),
                             self.min_bucket)
        widths = [max(b.columns[i].data.shape[1] for b in shards)
                  if f.dtype.is_string else None
                  for i, f in enumerate(shards[0].schema)]
        out = []
        for b, dev in zip(shards, self.mesh.devices):
            cols = [c if w is None else HostColumn(
                c.dtype, dstrings.pad_width(c.data, w), c.validity,
                c.lengths) for c, w in zip(b.columns, widths)]
            out.append(host_to_device(HostBatch(b.schema, cols), bucket,
                                      dev))
        return out

    # ---------------- partition ids -----------------------------------
    def _exchange_pids(self, exch, batches: List[DeviceBatch]):
        """Partition ids over the mesh size (the distributed partition
        count), padding rows the sentinel ``n``."""
        from ..shuffle.partitioning import (HashPartitioning,
                                            RangePartitioning,
                                            RoundRobinPartitioning,
                                            SinglePartitioning)

        part = exch.partitioning
        n = self.n
        if isinstance(part, RangePartitioning):
            return self._range_pids(batches, part._bound_keys)
        if isinstance(part, HashPartitioning):
            return self._hash_pids_by_exprs(batches, part.keys, exch.schema)
        out = []
        for b in batches:
            lane = torch.arange(b.padded_rows, dtype=torch.int32,
                                device=b.device)
            if isinstance(part, SinglePartitioning):
                pids = torch.zeros_like(lane)
            elif isinstance(part, RoundRobinPartitioning):
                pids = lane % n
            else:
                raise DistributedUnsupported(
                    f"partitioning {type(part).__name__}")
            out.append(_where_rows(b, pids, n))
        return out

    def _hash_pids_by_exprs(self, batches: List[DeviceBatch], exprs,
                            schema) -> List[torch.Tensor]:
        """Murmur3 pmod ``n`` of ``exprs`` bound to ``schema`` (K9)."""
        from ..ops.expression import bind_references

        bound = [bind_references(k, schema) for k in exprs]
        out = []
        for b in batches:
            cols = [as_device_column(k.eval_tpu(b), b.padded_rows, b.device)
                    for k in bound]
            out.append(_where_rows(b, hashing.hash_pids(cols, self.n),
                                   self.n))
        return out

    def _range_pids(self, batches: List[DeviceBatch],
                    sort_keys) -> List[torch.Tensor]:
        """Range partition ids by sampled bounds: K1's passes of every
        sort key per shard (string keys at their widest width over the
        shards); 64 strided samples a shard, read back together; the
        samples sorted with those of empty shards last; bounds at ``(V *
        i) // n`` of the V valid samples; pid = the number of bounds the
        row exceeds lexicographically (K11).  Any bounds keep the order;
        the samples set only the balance."""
        from ..exec.exchange import range_pids_from_bounds

        if self.n == 1:
            return [_where_rows(b, torch.zeros(b.padded_rows,
                                               dtype=torch.int32,
                                               device=b.device), 1)
                    for b in batches]
        keys = []
        for b in batches:
            rm = b.row_mask()
            keys.append([DeviceColumn(c.dtype, c.data, c.validity & rm,
                                      c.lengths)
                         for c in (as_device_column(k.expr.eval_tpu(b),
                                                    b.padded_rows, b.device)
                                   for k in sort_keys)])
        for j, c0 in enumerate(keys[0]):
            if c0.data.dim() == 2:
                w = max(ks[j].data.shape[1] for ks in keys)
                for ks in keys:
                    ks[j] = DeviceColumn(ks[j].dtype, X._padded(ks[j], w),
                                         ks[j].validity, ks[j].lengths)
        passes = [seg.key_passes_device(
            ks, descending=[not k.ascending for k in sort_keys],
            nulls_first=[k.nulls_first for k in sort_keys]) for ks in keys]
        lane = torch.arange(RANGE_SAMPLES, dtype=torch.int64)
        samples = []
        for p, b in zip(passes, batches):
            nr = b.num_rows.to(torch.int64).reshape(1)
            idx = lane.to(p.device) * torch.clamp(nr, min=1) // RANGE_SAMPLES
            samples.append(torch.cat([nr, p[:, idx].reshape(-1)]))
        host = X.to_host(samples)
        k = passes[0].shape[0]
        g = np.concatenate([h[1:].reshape(k, RANGE_SAMPLES) for h in host],
                           axis=1)
        gv = np.repeat([h[0] > 0 for h in host], RANGE_SAMPLES)
        # samples of empty shards last (the reference's 2**64 - 1 first
        # pass), then the passes, passes[0] dominating; stable
        order = np.lexsort(tuple(g[::-1]) + ((~gv).astype(np.int64),))
        v = int(gv.sum())
        bpos = np.clip((v * np.arange(1, self.n)) // self.n, 0,
                       g.shape[1] - 1)
        bounds = torch.from_numpy(np.ascontiguousarray(g[:, order[bpos]]))
        return [_where_rows(b, range_pids_from_bounds(
            p, bounds.to(p.device)), self.n)
            for p, b in zip(passes, batches)]

    # ---------------- collectives -------------------------------------
    def _gather_single(self, batches: List[DeviceBatch],
                       label: str = "gather to shard 0"
                       ) -> List[DeviceBatch]:
        """Every row to shard 0, the shards' rows in shard order."""
        pids = [_where_rows(b, torch.zeros(b.padded_rows, dtype=torch.int32,
                                           device=b.device), self.n)
                for b in batches]
        return self.transport.exchange(batches, pids, self.n, label=label)

    def _exchange_by_exprs(self, batches: List[DeviceBatch], exprs, schema,
                           label: str) -> List[DeviceBatch]:
        """Hash repartition on expression keys (colocates equal keys so
        that a per-shard group or window is globally right)."""
        return self.transport.exchange(
            batches, self._hash_pids_by_exprs(batches, exprs, schema),
            self.n, label=label)

    # ----- distribution requirements ----------------------------------
    @staticmethod
    def _source_partitioning(kid):
        """The partitioning a subtree's rows already satisfy, looking
        through coalesces."""
        from ..exec.coalesce import TpuCoalesceBatchesExec

        while isinstance(kid, tuple) and isinstance(
                kid[0], TpuCoalesceBatchesExec):
            kid = kid[1]
        return getattr(kid, "partitioning", None)

    @staticmethod
    def _is_single(part) -> bool:
        from ..shuffle.partitioning import SinglePartitioning

        return isinstance(part, SinglePartitioning)

    @staticmethod
    def _range_keys(part):
        """The bound SortKeys of a RangePartitioning, else None."""
        from ..shuffle.partitioning import RangePartitioning

        if not isinstance(part, RangePartitioning):
            return None
        return part._bound_keys or part.sort_keys

    def _range_matches_sort(self, part, sort_keys) -> bool:
        """True when the source range exchange partitions by exactly the
        sort's keys: its shards are then in global key order already."""
        ks = self._range_keys(part)
        if ks is None:
            return False
        return [(k.expr.sql(), k.ascending, k.nulls_first) for k in ks] == \
            [(k.expr.sql(), k.ascending, k.nulls_first) for k in sort_keys]

    def _sort_presorted(self, kid, op) -> bool:
        src = self._source_partitioning(kid)
        return self._is_single(src) or \
            self._range_matches_sort(src, op.keys)

    def _join_colocation(self, op, lkid, rkid) -> str:
        """'ok' when both sides of a shuffled join arrive hash-partitioned
        on the join keys (or both single), 'repair' when a side is range
        partitioned (hash re-exchange both), else 'unsupported'."""
        lpart = self._source_partitioning(lkid)
        rpart = self._source_partitioning(rkid)
        keys_ok = (self._hash_keys_match(lpart, op.plan.left_keys)
                   and self._hash_keys_match(rpart, op.plan.right_keys))
        if keys_ok or (self._is_single(lpart) and self._is_single(rpart)):
            return "ok"
        if self._range_keys(lpart) is not None or \
                self._range_keys(rpart) is not None:
            return "repair"
        return "unsupported"

    @staticmethod
    def _hash_keys_match(part, exprs) -> bool:
        from ..shuffle.partitioning import HashPartitioning

        if not isinstance(part, HashPartitioning):
            return False
        return [k.sql() for k in part.keys] == [e.sql() for e in exprs]

    # ---------------- lowering ----------------------------------------
    @staticmethod
    def _concat_compact(batches: List[DeviceBatch], schema) -> DeviceBatch:
        """One shard's batches joined row-wise and compacted (expand,
        union, fused segments)."""
        if len(batches) == 1:
            return batches[0]
        return X.concat_compact([b.columns for b in batches],
                                [b.row_mask() for b in batches], schema,
                                batches[0].device)

    def _lower(self, node, env: Dict) -> List[DeviceBatch]:
        """The n shards' output batches of ``node``, from the leaf, stage
        and broadcast inputs in ``env``."""
        from ..exec import basic as B
        from ..exec.aggregate import TpuHashAggregateExec
        from ..exec.coalesce import TpuCoalesceBatchesExec
        from ..exec.exchange import TpuShuffleExchangeExec
        from ..exec.fused import TpuFusedSegmentExec
        from ..exec.generate import TpuGenerateExec
        from ..exec.joins import TpuBroadcastHashJoinExec, TpuHashJoinExec
        from ..exec.sort import TpuSortExec
        from ..exec.window import TpuWindowExec

        if isinstance(node, (_LeafRef, _StageRef)):
            return env[self._env_key(node)]
        if not isinstance(node, tuple):
            raise DistributedUnsupported(f"cannot lower {node!r}")
        op, *kids = node
        if isinstance(op, TpuShuffleExchangeExec):
            body = self._lower(kids[0], env)
            return self.transport.exchange(
                body, self._exchange_pids(op, body), self.n,
                label=op.describe())
        if isinstance(op, TpuCoalesceBatchesExec):
            return self._lower(kids[0], env)
        if isinstance(op, TpuHashJoinExec):
            lb = self._lower(kids[0], env)
            if isinstance(op, TpuBroadcastHashJoinExec):
                rb = env[f"bcast{id(op)}"]
            else:
                rb = self._lower(kids[1], env)
                # colocation is a correctness invariant, not a planner
                # courtesy: both sides must arrive hash-partitioned on the
                # join keys (or single)
                verdict = self._join_colocation(op, kids[0], kids[1])
                if verdict == "repair":
                    lb = self._exchange_by_exprs(
                        lb, op.plan.left_keys, op.children[0].schema,
                        f"{op.describe()} left repair")
                    rb = self._exchange_by_exprs(
                        rb, op.plan.right_keys, op.children[1].schema,
                        f"{op.describe()} right repair")
                elif verdict == "unsupported":
                    raise DistributedUnsupported(
                        "shuffled join children are not colocated on the "
                        "join keys; the plan would produce wrong rows")
            return [op._join(l, r) for l, r in zip(lb, rb)]
        if isinstance(op, B.TpuExpandExec):
            return [self._concat_compact(op._compute(b), op.schema)
                    for b in self._lower(kids[0], env)]
        if isinstance(op, B.TpuUnionExec):
            pieces = [self._lower(k, env) for k in kids]
            return [self._concat_compact([p[i] for p in pieces], op.schema)
                    for i in range(self.n)]
        if isinstance(op, B.TpuLocalLimitExec):
            child = self._lower(kids[0], env)
            if isinstance(op, B.TpuGlobalLimitExec) and not self._is_single(
                    self._source_partitioning(kids[0])):
                child = self._gather_single(child, op.describe())
            out = []
            for b in child:
                keep = torch.clamp(b.num_rows.to(torch.int32), max=op.n)
                mask = torch.arange(b.padded_rows, dtype=torch.int32,
                                    device=b.device) < keep
                out.append(DeviceBatch(b.schema, [
                    DeviceColumn(c.dtype, c.data, c.validity & mask,
                                 c.lengths) for c in b.columns], keep))
            return out
        if isinstance(op, TpuSortExec):
            # range-exchange by sampled bounds, so that shard i's rows all
            # order before shard i+1's, then sort each shard
            child = self._lower(kids[0], env)
            if not self._sort_presorted(kids[0], op):
                child = self.transport.exchange(
                    child, self._range_pids(child, op.keys), self.n,
                    label=f"{op.describe()} range")
            return [op._compute(b) for b in child]
        if isinstance(op, TpuWindowExec):
            child = self._lower(kids[0], env)
            specs = [w.spec for w in op.window_exprs]
            keys = specs[0].partition_by if specs else []
            same = all([k.sql() for k in s.partition_by]
                       == [k.sql() for k in keys] for s in specs)
            part = self._source_partitioning(kids[0])
            if keys and same:
                if not self._hash_keys_match(part, keys) and \
                        not self._is_single(part):
                    child = self._exchange_by_exprs(
                        child, keys, op.children[0].schema,
                        f"{op.describe()} by partition keys")
            elif not self._is_single(part):
                child = self._gather_single(child, op.describe())
            return [op._compute(b) for b in child]
        if isinstance(op, TpuHashAggregateExec):
            child = self._lower(kids[0], env)
            if not op.keys and op.mode != "partial" and self._is_single(
                    self._source_partitioning(kids[0])):
                # a global aggregate over rows gathered to shard 0: one row
                # there, as collect() gives, and no row of nulls from each
                # empty shard (C.13; the reference runner returns n rows)
                return [op.compute_batch(child[0])] + [
                    self._empty_like(op.schema, b.device) for b in child[1:]]
            return [op.compute_batch(b) for b in child]
        if isinstance(op, (B.TpuProjectExec, B.TpuFilterExec,
                           TpuGenerateExec)):
            return [op._compute(b) for b in self._lower(kids[0], env)]
        if isinstance(op, TpuFusedSegmentExec):
            return [self._concat_compact(op._compute(b), op.schema)
                    for b in self._lower(kids[0], env)]
        raise DistributedUnsupported(f"cannot lower {op.describe()}")

    def _empty_like(self, schema, device) -> DeviceBatch:
        """A batch of no rows on ``device``, at the runner's bucket."""
        from ..plan.physical import _empty_batch

        return host_to_device(_empty_batch(schema), self.min_bucket, device)

    @staticmethod
    def _env_key(ref) -> str:
        if isinstance(ref, _LeafRef):
            return f"leaf{ref.idx}"
        return f"stage{ref.stage_id}"

    # ---------------- stages ------------------------------------------
    def _collect_broadcasts(self, node, out: List):
        """The stage's broadcast joins in post-order (inner build sides
        first, so that an outer build side finds an inner's input)."""
        from ..exec.joins import TpuBroadcastHashJoinExec

        if isinstance(node, tuple):
            for k in node[1:]:
                self._collect_broadcasts(k, out)
            if isinstance(node[0], TpuBroadcastHashJoinExec):
                out.append((node[0], node[2]))

    def _prepare_broadcasts(self, stage: _Stage, env: Dict) -> None:
        """Replicate each broadcast build side once a query (the
        reference's one broadcast relation an exchange)."""
        ops: List = []
        self._collect_broadcasts(stage.root, ops)
        for op, build_kid in ops:
            key = f"bcast{id(op)}"
            if key not in env:
                env[key] = self.transport.replicate(
                    self._lower(build_kid, env),
                    label=f"{op.describe()} build side")

    def _run_stage(self, stage: _Stage, env: Dict) -> List[DeviceBatch]:
        self._prepare_broadcasts(stage, env)
        return self._lower(stage.root, env)

    def run(self, root, ctx) -> HostBatch:
        """Run ``root`` over the mesh; the rows of shards 0..n-1, in
        order, as one HostBatch."""
        stages, leaves = self.plan_stages(root)
        env: Dict[str, List[DeviceBatch]] = {}
        for leaf in leaves:
            env[self._env_key(leaf)] = self._run_leaf(leaf.node, ctx)
        out = None
        for stage in stages:
            out = self._run_stage(stage, env)
            env[f"stage{stage.sid}"] = out
        return self._collect_output(out, stages)

    def _collect_output(self, out: List[DeviceBatch], stages) -> HostBatch:
        """The shards' rows downloaded (one read back of the row counts a
        device) and joined in shard order."""
        by_dev: Dict[torch.device, List[int]] = {}
        for i, b in enumerate(out):
            by_dev.setdefault(b.device, []).append(i)
        parts: List[Optional[HostBatch]] = [None] * len(out)
        for idx in by_dev.values():
            for i, h in zip(idx, device_to_host_many([out[i] for i in idx])):
                parts[i] = h
        host = [h for h in parts if h.num_rows]
        if not host:
            from ..plan.physical import _empty_batch

            return _empty_batch(self._schema_of(stages[-1].root))
        return HostBatch.concat(host)

    def _schema_of(self, node):
        if isinstance(node, tuple):
            return node[0].schema
        if isinstance(node, _LeafRef):
            return node.node.schema
        raise DistributedUnsupported("schema of a stage reference")


def run_distributed(session, df, mesh=None, n_devices: int = 8,
                    recovery=None) -> HostBatch:
    """Plan ``df`` through the session's planner and rewrites and run it
    over ``mesh`` (by default ``n_devices`` shards: CUDA devices for a
    session on ``cuda``, all on the CPU for one on ``cpu``).  Afterwards
    ``session.last_metrics`` holds the execution's metrics and the
    ``shuffle.*`` counters (``collectiveTimeNs``), and
    ``session.last_placements`` one record a collective."""
    from ..plan.physical import ExecContext
    from ..shuffle.device_shuffle import GLOBAL as shuffle_stats
    from .collective import DeviceCollectiveTransport

    if recovery is not None:
        raise NotImplementedError(
            "run_distributed(recovery=...) resumes stages from checkpoints, "
            "which needs the recovery subsystem (ROADMAP A10); it is not "
            "ported yet")
    if mesh is None:
        mesh = make_mesh(n_devices, device="cpu"
                         if session.device.type == "cpu" else None)
    wrong = [d for d in mesh.devices if d.type != session.device.type]
    if wrong:
        raise ValueError(f"a session on {session.device} cannot run over "
                         f"mesh devices {wrong}")
    phys = session.physical_plan(df.plan)
    ctx = ExecContext(session.conf, session.device)
    transport = DeviceCollectiveTransport(mesh)
    mark = shuffle_stats.counters()
    try:
        return DistributedRunner(mesh, transport=transport).run(phys, ctx)
    finally:
        session.last_metrics = dict(ctx.metrics)
        session.last_metrics.update(shuffle_stats.metrics_since(mark))
        session.last_placements = list(transport.records)
