"""User-facing column expression API.

Counterpart of ``spark_rapids_tpu/plan/functions.py`` for the slice:
``col``, ``lit``, ``if_``, ``when``/``otherwise``/``end``, ``coalesce``,
``nanvl``, ``abs``, ``pmod``, ``greatest``, ``least``, the aggregates
``sum``/``count``/``avg``/``min``/``max``/``first``/``last``, and
``Column`` with arithmetic (``%`` and unary ``-`` included),
comparison, boolean, alias, null-test and sort-order operators, ``cast``
(a type name or a DType), ``isin`` with literal members and the string
predicates ``contains``/``startswith``/``endswith``/``like``,
``substring``, ``concat``, ``year``, and the string transforms
``upper``, ``lower``, ``length``, ``trim``, ``ltrim``, ``rtrim``,
``substring_index``, ``locate`` and ``replace``.
``isin`` with column members, ``initcap`` and ``regexp_replace``
(host-engine only in the reference), the math functions beyond ``abs``
and ``pmod``, the shifts and the date functions come with later slices.
"""
from __future__ import annotations

from typing import Any, Optional, Union

from .. import types as T
from ..ops import aggregates as agg
from ..ops import arithmetic as ar
from ..ops import cast as cst
from ..ops import conditional as cond
from ..ops import datetimeexprs as dte
from ..ops import nullexprs as ne
from ..ops import predicates as pred
from ..ops import stringexprs as st
from ..ops.expression import (Alias, Expression, Literal,
                              UnresolvedAttribute)


class Column:
    """Wrapper over an Expression with pythonic operators."""

    def __init__(self, expr: Expression):
        self.expr = expr

    def __add__(self, other):
        return Column(ar.Add(self.expr, _e(other)))

    def __radd__(self, other):
        return Column(ar.Add(_e(other), self.expr))

    def __sub__(self, other):
        return Column(ar.Subtract(self.expr, _e(other)))

    def __rsub__(self, other):
        return Column(ar.Subtract(_e(other), self.expr))

    def __mul__(self, other):
        return Column(ar.Multiply(self.expr, _e(other)))

    def __rmul__(self, other):
        return Column(ar.Multiply(_e(other), self.expr))

    def __truediv__(self, other):
        return Column(ar.Divide(self.expr, _e(other)))

    def __rtruediv__(self, other):
        return Column(ar.Divide(_e(other), self.expr))

    def __mod__(self, other):
        return Column(ar.Remainder(self.expr, _e(other)))

    def __neg__(self):
        return Column(ar.UnaryMinus(self.expr))

    def __eq__(self, other):  # type: ignore[override]
        return Column(pred.EqualTo(self.expr, _e(other)))

    def __ne__(self, other):  # type: ignore[override]
        return Column(pred.Not(pred.EqualTo(self.expr, _e(other))))

    def __lt__(self, other):
        return Column(pred.LessThan(self.expr, _e(other)))

    def __le__(self, other):
        return Column(pred.LessThanOrEqual(self.expr, _e(other)))

    def __gt__(self, other):
        return Column(pred.GreaterThan(self.expr, _e(other)))

    def __ge__(self, other):
        return Column(pred.GreaterThanOrEqual(self.expr, _e(other)))

    def __and__(self, other):
        return Column(pred.And(self.expr, _e(other)))

    def __or__(self, other):
        return Column(pred.Or(self.expr, _e(other)))

    def __invert__(self):
        return Column(pred.Not(self.expr))

    def alias(self, name: str) -> "Column":
        return Column(Alias(self.expr, name))

    def cast(self, to: Union[str, T.DType]) -> "Column":
        to_t = T.from_name(to) if isinstance(to, str) else to
        return Column(cst.Cast(self.expr, to_t))

    def is_null(self) -> "Column":
        return Column(pred.IsNull(self.expr))

    def is_not_null(self) -> "Column":
        return Column(pred.IsNotNull(self.expr))

    def isin(self, *values) -> "Column":
        vals = list(values[0]) if len(values) == 1 and isinstance(
            values[0], (list, tuple, set)) else list(values)
        if any(isinstance(v, (Column, Expression)) for v in vals):
            raise NotImplementedError(
                "isin with column members (the reference's In) is not "
                "ported yet; pass literal members")
        return Column(pred.InSet(self.expr, vals))

    def startswith(self, prefix: str) -> "Column":
        return Column(st.StartsWith(self.expr, prefix))

    def endswith(self, suffix: str) -> "Column":
        return Column(st.EndsWith(self.expr, suffix))

    def contains(self, needle: str) -> "Column":
        return Column(st.Contains(self.expr, needle))

    def like(self, pattern: str) -> "Column":
        return Column(st.Like(self.expr, pattern))

    def asc(self) -> "SortKey":
        return SortKey(self.expr, ascending=True)

    def desc(self) -> "SortKey":
        return SortKey(self.expr, ascending=False)

    def __hash__(self):
        return id(self)

    def __repr__(self):  # pragma: no cover
        return f"Column({self.expr.sql()})"


class SortKey:
    def __init__(self, expr: Expression, ascending: bool = True,
                 nulls_first: Optional[bool] = None):
        self.expr = expr
        self.ascending = ascending
        # Spark default: nulls first for ASC, nulls last for DESC
        self.nulls_first = ascending if nulls_first is None else nulls_first


def _e(x) -> Expression:
    if isinstance(x, Column):
        return x.expr
    if isinstance(x, Expression):
        return x
    return Literal(x)


def _col_e(x) -> Expression:
    """Bare strings in a column position are column names (pyspark)."""
    if isinstance(x, str):
        return UnresolvedAttribute(x)
    return _e(x)


def col(name: str) -> Column:
    return Column(UnresolvedAttribute(name))


def lit(v: Any, dtype=None) -> Column:
    return Column(Literal(v, dtype))


class WhenBuilder:
    def __init__(self, branches):
        self._branches = branches

    def when(self, condition, value) -> "WhenBuilder":
        return WhenBuilder(self._branches + [(_e(condition), _e(value))])

    def otherwise(self, value) -> Column:
        return Column(cond.CaseWhen(self._branches, _e(value)))

    def end(self) -> Column:
        return Column(cond.CaseWhen(self._branches, None))


def when(condition, value) -> WhenBuilder:
    return WhenBuilder([(_e(condition), _e(value))])


def if_(c, t, f) -> Column:
    return Column(cond.If(_e(c), _e(t), _e(f)))


def coalesce(*cols) -> Column:
    return Column(ne.Coalesce([_col_e(c) for c in cols]))


def nanvl(a, b) -> Column:
    return Column(ne.NaNvl(_col_e(a), _col_e(b)))


class AggColumn(Column):
    def __init__(self, func: agg.AggregateFunction,
                 name: Optional[str] = None):
        super().__init__(agg.AggregateExpression(func))
        self.func = func
        self._name = name

    def alias(self, name: str) -> "AggColumn":
        return AggColumn(self.func, name)


def sum(c) -> AggColumn:  # noqa: A001 - mirrors pyspark naming
    return AggColumn(agg.Sum(_col_e(c)))


def count(c="*") -> AggColumn:
    child = None if (isinstance(c, str) and c == "*") else _col_e(c)
    return AggColumn(agg.Count(child))


def avg(c) -> AggColumn:
    return AggColumn(agg.Average(_col_e(c)))


def min(c) -> AggColumn:  # noqa: A001
    return AggColumn(agg.Min(_col_e(c)))


def max(c) -> AggColumn:  # noqa: A001
    return AggColumn(agg.Max(_col_e(c)))


def first(c, ignore_nulls: bool = False) -> AggColumn:
    return AggColumn(agg.First(_col_e(c), ignore_nulls))


def last(c, ignore_nulls: bool = False) -> AggColumn:
    return AggColumn(agg.Last(_col_e(c), ignore_nulls))


def substring(c, pos: int, length_: int) -> Column:
    return Column(st.Substring(_col_e(c), pos, length_))


def concat(*cols) -> Column:
    return Column(st.ConcatStrings([_col_e(c) for c in cols]))


def _u(cls):
    def fn(c):
        return Column(cls(_col_e(c)))

    return fn


abs = _u(ar.Abs)  # noqa: A001


def pmod(l, r) -> Column:
    return Column(ar.Pmod(_e(l), _e(r)))


def greatest(*cols) -> Column:
    e = _e(cols[0])
    for c in cols[1:]:
        e = ar.Greatest(e, _e(c))
    return Column(e)


def least(*cols) -> Column:
    e = _e(cols[0])
    for c in cols[1:]:
        e = ar.Least(e, _e(c))
    return Column(e)


upper = _u(st.Upper)
lower = _u(st.Lower)
length = _u(st.Length)
trim = _u(st.StringTrim)
ltrim = _u(st.StringTrimLeft)
rtrim = _u(st.StringTrimRight)


def substring_index(c, delim: str, count_: int) -> Column:
    return Column(st.SubstringIndex(_col_e(c), delim, count_))


def locate(substr: str, c, pos: int = 1) -> Column:
    return Column(st.StringLocate(substr, _col_e(c), pos))


def replace(c, search: str, replacement: str) -> Column:
    return Column(st.StringReplace(_col_e(c), search, replacement))


def year(c) -> Column:
    return Column(dte.Year(_col_e(c)))
