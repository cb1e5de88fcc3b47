"""Planner: logical plan -> physical plan.

Counterpart of ``spark_rapids_tpu/plan/planner.py`` for the slice's
nodes.  An aggregate becomes partial -> exchange -> final
(``planner.py:115-149``); a global sort over more than one partition
needs a range exchange, which comes with the multi-partition slice, so
it raises here.
"""
from __future__ import annotations

import copy
from typing import List

from ..config import SHUFFLE_PARTITIONS
from ..ops.aggregates import AggregateExpression
from ..ops.expression import Alias, bind_references, output_name
from ..shuffle.partitioning import HashPartitioning, SinglePartitioning
from . import functions as F
from . import logical as L
from . import physical as P


class Planner:
    def __init__(self, conf):
        self.conf = conf
        self.shuffle_partitions = conf.get(SHUFFLE_PARTITIONS)

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

    def _plan_Sort(self, node: L.Sort):
        child = self.plan(node.children[0])
        if node.global_sort and self._n_partitions(child) > 1:
            raise NotImplementedError(
                "a global sort over several partitions needs the range "
                "exchange, which is not ported yet")
        return P.SortExec(child, node.keys)

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
        return 1
