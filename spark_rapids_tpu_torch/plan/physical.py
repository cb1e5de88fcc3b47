"""Physical plan nodes as the planner emits them.

Counterpart of ``spark_rapids_tpu/plan/physical.py``.  The planner lowers
a logical plan to these nodes and the rewrite engine (overrides.py) then
converts each supported node into its device exec.  In the reference the
nodes are also the host (numpy) engine; here only ``LocalScanExec``
executes on the host, as the source of host batches.  The other nodes
carry bound expressions and schemas and raise if executed: the host
engine and per-operator fallback come with a later slice.

Execution model: a plan executes to ``PartitionedData`` — N lazy
partition iterators of batches.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence

from .. import types as T
from ..data.column import HostBatch, HostColumn
from ..ops.aggregates import AggregateFunction
from ..ops.expression import Expression, bind_references, output_name
from . import functions as F


class ExecContext:
    """Per-query execution context: conf, target device, a flat dict of
    integer metrics (``<exec>.<metric>`` -> value) and the row placement
    of each multi-partition exchange (``placements``: one dict per
    exchange with its description, the rows written and the rows each
    output partition yielded), one record per shuffled join and
    partition (``joins``: the batches each side brought and the grace
    path's bucket pairs, buckets and deepest level), and a write's
    ``io.writers.WriteStatsTracker`` (``write_stats``)."""

    def __init__(self, conf, device):
        self.conf = conf
        self.device = device
        self.metrics: Dict[str, int] = {}
        self.placements: List[dict] = []
        self.joins: List[dict] = []
        self.write_stats = None

    def add_metric(self, key: str, value: int = 1) -> None:
        self.metrics[key] = self.metrics.get(key, 0) + value


class PartitionedData:
    def __init__(self, parts: List[Callable[[], Iterator]]):
        self.parts = parts

    @property
    def n_partitions(self):
        return len(self.parts)

    def iterator(self, pid: int) -> Iterator:
        return self.parts[pid]()


def _empty_batch(schema: T.Schema) -> HostBatch:
    return HostBatch(schema, [HostColumn.nulls(0, f.dtype) for f in schema])


def collect_batches(data: PartitionedData, schema: T.Schema) -> HostBatch:
    """Drain every partition, in order, into one host batch (the
    reference's task pool, retries and semaphore are not ported)."""
    batches: List[HostBatch] = []
    for pid in range(data.n_partitions):
        batches.extend(data.iterator(pid))
    if not batches:
        return _empty_batch(schema)
    return HostBatch.concat(batches)


class PhysicalPlan:
    def __init__(self, children: Sequence["PhysicalPlan"] = ()):
        self.children = list(children)

    @property
    def schema(self) -> T.Schema:
        raise NotImplementedError

    @property
    def name(self):
        return type(self).__name__

    def execute(self, ctx: ExecContext) -> PartitionedData:
        raise NotImplementedError(
            f"{self.name} runs only as a device exec here: the host engine "
            "is not ported yet")

    def with_new_children(self, children):
        node = copy.copy(self)
        node.children = list(children)
        return node

    def describe(self) -> str:
        return self.name

    def tree_string(self, indent: int = 0) -> str:
        s = "  " * indent + self.describe()
        for c in self.children:
            s += "\n" + c.tree_string(indent + 1)
        return s

    def __repr__(self):  # pragma: no cover
        return self.tree_string()


class LocalScanExec(PhysicalPlan):
    """Host source of in-memory batches, split over ``n_partitions``."""

    def __init__(self, batches: List[HostBatch], schema: T.Schema,
                 n_partitions: int = 1):
        super().__init__()
        self.batches = batches
        self._schema = schema
        self.n_partitions = max(1, n_partitions)

    @property
    def schema(self):
        return self._schema

    def execute(self, ctx):
        n = self.n_partitions
        buckets: List[List[HostBatch]] = [[] for _ in range(n)]
        if len(self.batches) >= n:
            for i, b in enumerate(self.batches):
                buckets[i % n].append(b)
        else:
            total = sum(b.num_rows for b in self.batches)
            if total:
                big = HostBatch.concat(self.batches) \
                    if len(self.batches) > 1 else self.batches[0]
                per = math.ceil(total / n)
                for i in range(n):
                    lo, hi = i * per, min((i + 1) * per, total)
                    if lo < hi:
                        buckets[i].append(big.slice(lo, hi))

        def make(pid):
            return lambda: iter(buckets[pid])

        return PartitionedData([make(i) for i in range(n)])

    def describe(self):
        return f"LocalScan[{self._schema.names}]"


class ProjectExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, exprs: List[Expression]):
        super().__init__([child])
        self.exprs = [bind_references(e, child.schema) for e in exprs]
        self._schema = T.Schema([
            T.Field(output_name(raw, i), b.dtype, b.nullable)
            for i, (raw, b) in enumerate(zip(exprs, self.exprs))])

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return f"Project[{', '.join(e.sql() for e in self.exprs)}]"


class FilterExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, condition: Expression):
        super().__init__([child])
        self.condition = bind_references(condition, child.schema)

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"Filter[{self.condition.sql()}]"


class LocalLimitExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, n: int):
        super().__init__([child])
        self.n = n

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"LocalLimit[{self.n}]"


class GlobalLimitExec(LocalLimitExec):
    """Expects a single-partition child (the planner inserts the
    exchange)."""

    def describe(self):
        return f"GlobalLimit[{self.n}]"


class UnionExec(PhysicalPlan):
    """The children's partitions one after another."""

    def __init__(self, children: List[PhysicalPlan]):
        super().__init__(children)

    @property
    def schema(self):
        return self.children[0].schema


class ExpandExec(PhysicalPlan):
    """One output batch per projection list per input batch; each field
    takes its type from the first projection and is nullable."""

    def __init__(self, child: PhysicalPlan,
                 projections: List[List[Expression]],
                 output_names: List[str]):
        super().__init__([child])
        self.projections = [[bind_references(e, child.schema) for e in ps]
                            for ps in projections]
        self._schema = T.Schema([T.Field(n, b.dtype, True) for n, b in
                                 zip(output_names, self.projections[0])])

    @property
    def schema(self):
        return self._schema


class GenerateExec(PhysicalPlan):
    """explode over per-row element expressions: the child's columns,
    ``pos`` (INT32, not null) when ``position`` is set, and the element
    (the first element's type, nullable)."""

    def __init__(self, child: PhysicalPlan, elements: List[Expression],
                 out_name: str, position: bool = False):
        super().__init__([child])
        self.elements = [bind_references(e, child.schema)
                         for e in elements]
        self.position = position
        fields = list(child.schema.fields)
        if position:
            fields.append(T.Field("pos", T.INT32, False))
        fields.append(T.Field(out_name, self.elements[0].dtype, True))
        self._schema = T.Schema(fields)

    @property
    def schema(self):
        return self._schema


class HashJoinExec(PhysicalPlan):
    """Equi-join, build = right side; inner/left/right/full/semi/anti with
    an optional residual condition (the device join takes none yet).
    ``broadcast`` selects the broadcast form over the shuffled one."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 left_keys, right_keys, how: str,
                 condition: Optional[Expression], broadcast: bool = False):
        super().__init__([left, right])
        self.left_keys = [bind_references(k, left.schema)
                          for k in left_keys]
        self.right_keys = [bind_references(k, right.schema)
                           for k in right_keys]
        self.how = how
        self.broadcast = broadcast
        lf = list(left.schema.fields)
        rf = list(right.schema.fields)
        if how in ("semi", "anti"):
            self._schema = T.Schema(lf)
        else:
            if how in ("left", "full"):
                rf = [T.Field(f.name, f.dtype, True) for f in rf]
            if how in ("right", "full"):
                lf = [T.Field(f.name, f.dtype, True) for f in lf]
            self._schema = T.Schema(lf + rf)
        self.condition = bind_references(condition, self._schema) \
            if condition is not None else None

    @property
    def schema(self):
        return self._schema

    def describe(self):
        kind = "broadcast" if self.broadcast else "shuffled"
        return f"HashJoin[{self.how}, {kind}]"


class SortExec(PhysicalPlan):
    """Per-partition sort."""

    def __init__(self, child: PhysicalPlan, keys: List[F.SortKey]):
        super().__init__([child])
        self.keys = [F.SortKey(bind_references(k.expr, child.schema),
                               k.ascending, k.nulls_first) for k in keys]

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        ks = ", ".join(
            f"{k.expr.sql()} {'ASC' if k.ascending else 'DESC'}"
            for k in self.keys)
        return f"Sort[{ks}]"


@dataclass
class AggSpec:
    func: AggregateFunction  # child already bound to the input schema
    name: str


def _buffer_fields(specs: List[AggSpec]) -> List[T.Field]:
    fields = []
    for i, sp in enumerate(specs):
        for j, bt in enumerate(sp.func.buffer_dtypes()):
            fields.append(T.Field(f"_buf{i}_{j}", bt, True))
    return fields


class HashAggregateExec(PhysicalPlan):
    """mode: 'partial' -> keys + partial buffers; 'final' -> merges
    keys + buffers and finalizes (the planner emits these two)."""

    def __init__(self, child: PhysicalPlan, mode: str,
                 key_exprs: List[Expression], specs: List[AggSpec],
                 out_names: Optional[List[str]] = None):
        super().__init__([child])
        self.mode = mode
        self.keys = [bind_references(k, child.schema) for k in key_exprs]
        self.specs = specs
        key_fields = [T.Field(output_name(k, i), self.keys[i].dtype,
                              self.keys[i].nullable)
                      for i, k in enumerate(key_exprs)]
        if mode == "partial":
            self._schema = T.Schema(key_fields + _buffer_fields(specs))
        else:
            names = out_names or [sp.name for sp in self.specs]
            self._schema = T.Schema(key_fields + [
                T.Field(n, sp.func.dtype, True)
                for n, sp in zip(names, specs)])

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return (f"HashAggregate[{self.mode}, keys={len(self.keys)}, "
                f"aggs={[sp.func.sql() for sp in self.specs]}]")


class ShuffleExchangeExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, partitioning):
        super().__init__([child])
        self.partitioning = partitioning

    @property
    def schema(self):
        return self.children[0].schema

    @property
    def n_out(self):
        return self.partitioning.num_partitions

    def describe(self):
        return f"ShuffleExchange[{self.partitioning.describe()}]"


# ==========================================================================
# Write
# ==========================================================================
class DataWritingCommandExec(PhysicalPlan):
    """The planner's write node (reference ``plan/physical.py:1111``);
    the rewrite engine converts it to ``TpuDataWritingCommandExec``
    (``exec/write.py``).  Its host ``execute`` raises, as every host
    node's does here."""

    def __init__(self, child: PhysicalPlan, fmt: str, path: str,
                 options: dict, partition_by: List[str],
                 bucket_by: Optional[List[str]] = None):
        super().__init__([child])
        self.fmt = fmt
        self.path = path
        self.options = options
        self.partition_by = partition_by
        self.bucket_by = bucket_by or []

    @property
    def schema(self):
        return T.Schema([])
