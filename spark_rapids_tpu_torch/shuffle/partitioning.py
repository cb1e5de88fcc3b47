"""Exchange partitioning descriptors.

Counterpart of ``spark_rapids_tpu/shuffle/partitioning.py``, reduced to
what the planner records for the slice: the kind of partitioning, its
keys and its fan-out.  Placing rows (Murmur3 hash, sampled range
bounds, round robin) comes with the multi-partition exchange slice.
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
