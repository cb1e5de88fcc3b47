"""Exchange partitioning descriptors.

Counterpart of ``spark_rapids_tpu/shuffle/partitioning.py:52-127``,
reduced to what the device exchange reads: the kind of partitioning, its
bound keys and its fan-out.  The rows are placed on the card by
``exec/exchange.py`` (Murmur3 hash, sampled range bounds, round robin);
the host ``partition_ids`` and the range partitioner's host sampling
(``prepare``) wait for the host engine.
"""
from __future__ import annotations

from typing import List, Optional

from .. import types as T
from ..ops.expression import Expression, bind_references


class Partitioning:
    def __init__(self, num_partitions: int):
        self.num_partitions = num_partitions

    def bind(self, schema: T.Schema) -> "Partitioning":
        return self

    def describe(self) -> str:
        return f"{type(self).__name__}({self.num_partitions})"


class SinglePartitioning(Partitioning):
    def __init__(self):
        super().__init__(1)


class RoundRobinPartitioning(Partitioning):
    """Row r of the exchange's input, counted over every input batch in
    write order, goes to partition ``r % num_partitions``."""


class HashPartitioning(Partitioning):
    def __init__(self, keys: List[Expression], num_partitions: int):
        super().__init__(num_partitions)
        self.keys = keys
        self._bound: Optional[List[Expression]] = None

    def bind(self, schema):
        self._bound = [bind_references(k, schema) for k in self.keys]
        return self

    def describe(self):
        return (f"HashPartitioning([{', '.join(k.sql() for k in self.keys)}]"
                f", {self.num_partitions})")


class RangePartitioning(Partitioning):
    """Split bounds picked from samples of the sort keys, rows placed by
    comparing their keys with the bounds (reference:
    GpuRangePartitioner.scala:33-104)."""

    def __init__(self, sort_keys, num_partitions: int, seed: int = 42):
        super().__init__(num_partitions)
        self.sort_keys = sort_keys  # List[functions.SortKey]
        self.seed = seed
        self._bound_keys = None

    def bind(self, schema):
        from ..plan import functions as F

        self._bound_keys = [
            F.SortKey(bind_references(k.expr, schema), k.ascending,
                      k.nulls_first)
            for k in self.sort_keys]
        return self
