"""Declarative aggregate functions.

Counterpart of ``spark_rapids_tpu/ops/aggregates.py`` (lines 75-186):
Count, Sum, Min, Max, Average, First and Last, each described by its
partial-buffer reductions (``updates``), how partial buffers merge
(``merges``), its buffer dtypes and a finalize expression.  The
aggregate exec drives them through the segmented-reduction kernel
(``ops/kernels/segment.py``); the window exec reads the same classes as
frame aggregates.  Over a string input only Min and Max run on the
device (through ``segment.string_minmax``); the reference also takes
Count, First and Last there, which the port does not yet.
"""
from __future__ import annotations

import copy
from typing import List, Optional, Tuple

from .. import types as T
from .arithmetic import Divide
from .expression import Expression


class AggregateFunction:
    """One aggregate call, e.g. sum(x)."""

    #: (op, which) pairs; op in {sum, min, max, count}; which = 0 selects
    #: the child column
    updates: List[Tuple[str, int]] = []
    #: ops merging each partial buffer (parallel to ``updates``)
    merges: List[str] = []

    def __init__(self, child: Optional[Expression],
                 ignore_nulls: bool = True):
        self.child = child
        #: read by First and Last only (Spark's ignoreNulls)
        self.ignore_nulls = ignore_nulls

    @property
    def children(self):
        return [] if self.child is None else [self.child]

    @property
    def dtype(self) -> T.DType:
        raise NotImplementedError

    @property
    def name(self):
        return type(self).__name__.lower()

    def buffer_dtypes(self) -> List[T.DType]:
        raise NotImplementedError

    def finalize(self, buffer_refs: List[Expression]) -> Expression:
        """Expression over the merged buffers giving the final value."""
        return buffer_refs[0]

    @property
    def tpu_supported(self) -> bool:
        if self.child is None:
            return True
        if not self.child.tpu_supported:
            return False
        # over strings: the min/max of the rank encoding only
        return not self.child.dtype.is_string or \
            isinstance(self, (Min, Max))

    def sql(self):
        c = self.child.sql() if self.child is not None else "*"
        return f"{self.name}({c})"

    def __repr__(self):  # pragma: no cover
        return self.sql()


class Count(AggregateFunction):
    updates = [("count", 0)]
    merges = ["sum"]

    @property
    def dtype(self):
        return T.INT64

    def buffer_dtypes(self):
        return [T.INT64]


class Sum(AggregateFunction):
    updates = [("sum", 0)]
    merges = ["sum"]

    @property
    def dtype(self):
        return T.FLOAT64 if self.child.dtype.is_floating else T.INT64

    def buffer_dtypes(self):
        return [self.dtype]


class Min(AggregateFunction):
    updates = [("min", 0)]
    merges = ["min"]

    @property
    def dtype(self):
        return self.child.dtype

    def buffer_dtypes(self):
        return [self.child.dtype]


class Max(AggregateFunction):
    updates = [("max", 0)]
    merges = ["max"]

    @property
    def dtype(self):
        return self.child.dtype

    def buffer_dtypes(self):
        return [self.child.dtype]


class Average(AggregateFunction):
    """sum + count composite."""

    updates = [("sum", 0), ("count", 0)]
    merges = ["sum", "sum"]

    @property
    def dtype(self):
        return T.FLOAT64

    def buffer_dtypes(self):
        return [T.FLOAT64 if self.child.dtype.is_floating else T.INT64,
                T.INT64]

    def finalize(self, buffer_refs):
        return Divide(buffer_refs[0], buffer_refs[1])


class First(AggregateFunction):
    """Spark semantics: ignoreNulls=false (the default of ``F.first``)
    returns the first row's value, null included; true returns the first
    non-null value."""

    @property
    def updates(self):
        return [("first" if self.ignore_nulls else "first_any", 0)]

    @property
    def merges(self):
        return ["first" if self.ignore_nulls else "first_any"]

    @property
    def dtype(self):
        return self.child.dtype

    def buffer_dtypes(self):
        return [self.child.dtype]


class Last(AggregateFunction):
    @property
    def updates(self):
        return [("last" if self.ignore_nulls else "last_any", 0)]

    @property
    def merges(self):
        return ["last" if self.ignore_nulls else "last_any"]

    @property
    def dtype(self):
        return self.child.dtype

    def buffer_dtypes(self):
        return [self.child.dtype]


class AggregateExpression(Expression):
    """Carries an aggregate function through planning; not evaluable —
    the aggregate exec interprets it."""

    def __init__(self, func: AggregateFunction, mode: str = "complete"):
        super().__init__(list(func.children))
        self.func = func
        self.mode = mode

    def with_children(self, children):
        # keep func.child in sync so bind_references reaches the function
        node = super().with_children(children)
        if node.func.child is not None:
            f = copy.copy(node.func)
            f.child = children[0]
            node.func = f
        return node

    @property
    def dtype(self):
        return self.func.dtype

    @property
    def nullable(self):
        return not isinstance(self.func, Count)

    def sql(self):
        return self.func.sql()
