"""Planner: logical plan -> physical plan.

Counterpart of ``spark_rapids_tpu/plan/planner.py`` for the nodes
ported so far.  An aggregate becomes partial -> exchange -> final
(``planner.py:115-149``); a limit becomes local limit -> single-partition
exchange -> global limit (``:58``); a join becomes a broadcast hash join
when the build side's static size estimate is under
``broadcastSizeThreshold`` and the join type allows it, else a shuffled
hash join over hash exchanges on the keys (``:151-170``), decided from
the same estimate as the reference's (``:186-240``); a global sort over
more than one partition sorts each partition of a range exchange
(``:72-78``); a repartition is a hash exchange on its keys, or round
robin without keys (``:64-70``); a union, an expand and a generate map
one to one (``:55,80,84``); a window over more than one partition
hash-exchanges by its partition keys when every spec has the same ones,
else gathers into a single partition (``:93-112``); a write maps one to
one (``:88``).
"""
from __future__ import annotations

import copy
from typing import List, Optional

from .. import types as T
from ..config import SHUFFLE_PARTITIONS
from ..ops.aggregates import AggregateExpression
from ..ops.expression import Alias, bind_references, output_name
from ..shuffle.partitioning import (HashPartitioning, RangePartitioning,
                                    RoundRobinPartitioning,
                                    SinglePartitioning)
from . import functions as F
from . import logical as L
from . import physical as P


class Planner:
    def __init__(self, conf):
        self.conf = conf
        self.shuffle_partitions = conf.get(SHUFFLE_PARTITIONS)
        self.broadcast_threshold = conf.broadcast_threshold

    def plan(self, node: L.LogicalPlan) -> P.PhysicalPlan:
        fn = getattr(self, f"_plan_{type(node).__name__}", None)
        if fn is None:
            raise NotImplementedError(f"no strategy for {node.name}")
        return fn(node)

    def _plan_LocalRelation(self, node: L.LocalRelation):
        return P.LocalScanExec(node.batches, node.schema,
                               node.n_partitions)

    def _plan_Project(self, node: L.Project):
        return P.ProjectExec(self.plan(node.children[0]), node.exprs)

    def _plan_Filter(self, node: L.Filter):
        return P.FilterExec(self.plan(node.children[0]), node.condition)

    def _plan_Union(self, node: L.Union):
        return P.UnionExec([self.plan(c) for c in node.children])

    def _plan_Expand(self, node: L.Expand):
        return P.ExpandExec(self.plan(node.children[0]), node.projections,
                            node.output_names)

    def _plan_Generate(self, node: L.Generate):
        return P.GenerateExec(self.plan(node.children[0]), node.elements,
                              node.output_name, node.position)

    def _plan_Limit(self, node: L.Limit):
        child = self.plan(node.children[0])
        local = P.LocalLimitExec(child, node.n)
        exchange = P.ShuffleExchangeExec(local, SinglePartitioning())
        return P.GlobalLimitExec(exchange, node.n)

    def _plan_Join(self, node: L.Join):
        left = self.plan(node.children[0])
        right = self.plan(node.children[1])
        est = self._estimate_bytes(node.children[1])
        can_broadcast = (est is not None
                         and self.broadcast_threshold > 0
                         and est <= self.broadcast_threshold
                         and node.how in ("inner", "left", "semi", "anti"))
        if can_broadcast:
            return P.HashJoinExec(left, right, node.left_keys,
                                  node.right_keys, node.how,
                                  node.condition, broadcast=True)
        n = min(self.shuffle_partitions,
                max(self._n_partitions(left), self._n_partitions(right), 1))
        lex = P.ShuffleExchangeExec(
            left, HashPartitioning(node.left_keys, n).bind(left.schema))
        rex = P.ShuffleExchangeExec(
            right, HashPartitioning(node.right_keys, n).bind(right.schema))
        return P.HashJoinExec(lex, rex, node.left_keys, node.right_keys,
                              node.how, node.condition, broadcast=False)

    def _plan_Repartition(self, node: L.Repartition):
        child = self.plan(node.children[0])
        if node.keys:
            part = HashPartitioning(node.keys, node.n).bind(child.schema)
        else:
            part = RoundRobinPartitioning(node.n)
        return P.ShuffleExchangeExec(child, part)

    def _plan_Sort(self, node: L.Sort):
        child = self.plan(node.children[0])
        if node.global_sort and self._n_partitions(child) > 1:
            part = RangePartitioning(
                node.keys, self._n_partitions(child)).bind(child.schema)
            child = P.ShuffleExchangeExec(child, part)
        return P.SortExec(child, node.keys)

    def _plan_WriteFile(self, node: L.WriteFile):
        return P.DataWritingCommandExec(
            self.plan(node.children[0]), node.fmt, node.path, node.options,
            node.partition_by, node.bucket_by)

    def _plan_Window(self, node: L.Window):
        from ..exec.window_cpu import WindowExec

        child = self.plan(node.children[0])
        # co-partition by the window's partition keys so that each
        # partition computes whole windows
        specs = [w.spec for w in node.window_exprs]
        first_keys = specs[0].partition_by
        same = all([k.sql() for k in s.partition_by]
                   == [k.sql() for k in first_keys] for s in specs)
        if first_keys and same and self._n_partitions(child) > 1:
            child = P.ShuffleExchangeExec(
                child, HashPartitioning(
                    first_keys, min(self.shuffle_partitions,
                                    self._n_partitions(child))
                ).bind(child.schema))
        elif self._n_partitions(child) > 1:
            child = P.ShuffleExchangeExec(child, SinglePartitioning())
        return WindowExec(child, node.window_exprs, node.names)

    def _plan_Aggregate(self, node: L.Aggregate):
        child = self.plan(node.children[0])
        specs: List[P.AggSpec] = []
        out_names = []
        for j, a in enumerate(node.aggregates):
            name = output_name(a, len(node.keys) + j)
            inner = a.child if isinstance(a, Alias) else a
            if not isinstance(inner, AggregateExpression):
                raise ValueError(f"non-aggregate in agg list: {inner}")
            func = inner.func
            if func.child is not None:
                func = copy.copy(func)
                func.child = bind_references(func.child, child.schema)
            specs.append(P.AggSpec(func, name))
            out_names.append(name)

        partial = P.HashAggregateExec(child, "partial", node.keys, specs)
        if node.keys:
            part = HashPartitioning(
                [F.col(n).expr for n in
                 partial.schema.names[: len(node.keys)]],
                min(self.shuffle_partitions,
                    max(self._n_partitions(child), 1)))
        else:
            part = SinglePartitioning()
        exchange = P.ShuffleExchangeExec(partial,
                                         part.bind(partial.schema))
        final_keys = [F.col(n).expr
                      for n in partial.schema.names[: len(node.keys)]]
        return P.HashAggregateExec(exchange, "final", final_keys, specs,
                                   out_names)

    @staticmethod
    def _n_partitions(p: P.PhysicalPlan) -> int:
        if isinstance(p, P.LocalScanExec):
            return p.n_partitions
        if isinstance(p, P.ShuffleExchangeExec):
            return p.n_out
        if p.children:
            return max(Planner._n_partitions(c) for c in p.children)
        return getattr(p, "n_partitions", 1)

    @staticmethod
    def _estimate_bytes(node: L.LogicalPlan) -> Optional[int]:
        """Static size estimate for the broadcast decision: a local
        relation's ``estimate_bytes``, narrowed by projections in the
        ratio of nominal row widths, passed through filters and limits;
        None (no broadcast) for anything else."""
        if isinstance(node, L.LocalRelation):
            return sum(b.estimate_bytes() for b in node.batches)
        if isinstance(node, L.Project):
            est = Planner._estimate_bytes(node.children[0])
            if est is None:
                return None
            child_w = Planner._schema_row_width(node.children[0].schema)
            proj_w = Planner._schema_row_width(node.schema)
            return int(est * proj_w / child_w)
        if isinstance(node, (L.Filter, L.Limit)):
            return Planner._estimate_bytes(node.children[0])
        return None

    @staticmethod
    def _schema_row_width(schema: T.Schema) -> int:
        """Nominal bytes a row: the item size of fixed-width columns, 16
        for a string."""
        width = 0
        for f in schema:
            width += 16 if f.dtype.is_string else \
                int(getattr(f.dtype.np_dtype, "itemsize", 8))
        return max(width, 1)
