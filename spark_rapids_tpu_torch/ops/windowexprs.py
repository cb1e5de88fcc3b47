"""Window expression IR.

Counterpart of ``spark_rapids_tpu/ops/windowexprs.py``: row frames
(``WindowFrame``), the window spec (partition-by + order-by + frame),
``RowNumber``/``Rank``/``DenseRank``, aggregates over a window
(``WindowExpression``) and the pyspark-like builders ``window()``,
``over``, ``row_number``, ``rank`` and ``dense_rank``.  Only row frames
exist, as in the reference; the window exec (``exec/window.py``)
evaluates them on the device.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import List, Optional, Union

from .. import types as T
from .aggregates import AggregateFunction
from .expression import Expression, bind_references

UNBOUNDED = None  # frame boundary sentinel
CURRENT_ROW = 0


@dataclass
class WindowFrame:
    """Row frame [lower, upper] relative to the current row; None =
    unbounded."""

    lower: Optional[int] = UNBOUNDED
    upper: Optional[int] = CURRENT_ROW

    @property
    def is_unbounded_to_current(self):
        return self.lower is UNBOUNDED and self.upper == 0

    @property
    def is_unbounded_both(self):
        return self.lower is UNBOUNDED and self.upper is UNBOUNDED


@dataclass
class WindowSpec:
    partition_by: List[Expression] = field(default_factory=list)
    order_by: List = field(default_factory=list)  # List[functions.SortKey]
    frame: Optional[WindowFrame] = None

    def resolved_frame(self) -> WindowFrame:
        """The frame in force: the given one, else Spark's default
        (unbounded preceding to the current row with an ordering, the
        whole partition without)."""
        if self.frame is not None:
            return self.frame
        if self.order_by:
            return WindowFrame(UNBOUNDED, CURRENT_ROW)
        return WindowFrame(UNBOUNDED, UNBOUNDED)


class WindowFunctionBase:
    pass


class RowNumber(WindowFunctionBase):
    dtype = T.INT32
    name = "row_number"


class Rank(WindowFunctionBase):
    dtype = T.INT32
    name = "rank"


class DenseRank(WindowFunctionBase):
    dtype = T.INT32
    name = "dense_rank"


@dataclass
class WindowExpression:
    """One windowed computation: function OVER spec."""

    func: Union[WindowFunctionBase, AggregateFunction]
    spec: WindowSpec

    @property
    def dtype(self) -> T.DType:
        return self.func.dtype

    def bind(self, schema: T.Schema) -> "WindowExpression":
        from ..plan import functions as F

        func = self.func
        if isinstance(func, AggregateFunction) and func.child is not None:
            func = copy.copy(func)
            func.child = bind_references(func.child, schema)
        spec = WindowSpec(
            [bind_references(e, schema) for e in self.spec.partition_by],
            [F.SortKey(bind_references(k.expr, schema), k.ascending,
                       k.nulls_first) for k in self.spec.order_by],
            self.spec.frame)
        return WindowExpression(func, spec)

    def sql(self) -> str:
        fname = self.func.name if isinstance(self.func, WindowFunctionBase) \
            else self.func.sql()
        return f"{fname} OVER (...)"


# --------------------------------------------------------------------------
# user-facing builders (pyspark-like)
# --------------------------------------------------------------------------
class WindowBuilder:
    def __init__(self):
        self._partition = []
        self._order = []
        self._frame = None

    def partition_by(self, *cols) -> "WindowBuilder":
        from ..plan.logical import _to_expr

        self._partition = [_to_expr(c) for c in cols]
        return self

    def order_by(self, *keys) -> "WindowBuilder":
        from ..plan import functions as F
        from ..plan.logical import _to_expr

        self._order = [k if isinstance(k, F.SortKey)
                       else F.SortKey(_to_expr(k)) for k in keys]
        return self

    def rows_between(self, lower, upper) -> "WindowBuilder":
        self._frame = WindowFrame(lower, upper)
        return self

    def spec(self) -> WindowSpec:
        return WindowSpec(self._partition, self._order, self._frame)


def window() -> WindowBuilder:
    return WindowBuilder()


def over(func_col, spec_builder: Union[WindowBuilder, WindowSpec]
         ) -> WindowExpression:
    """``over(F.sum("x"), window().partition_by("k").order_by("t"))``"""
    from ..plan import functions as F

    spec = spec_builder.spec() if isinstance(spec_builder, WindowBuilder) \
        else spec_builder
    if isinstance(func_col, WindowFunctionBase):
        return WindowExpression(func_col, spec)
    if isinstance(func_col, F.AggColumn):
        return WindowExpression(func_col.func, spec)
    raise TypeError(f"cannot window over {func_col!r}")


def row_number() -> RowNumber:
    return RowNumber()


def rank() -> Rank:
    return Rank()


def dense_rank() -> DenseRank:
    return DenseRank()
