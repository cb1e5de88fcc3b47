"""Logical plan and DataFrame API.

Counterpart of ``spark_rapids_tpu/plan/logical.py`` for the slices
ported so far: ``LocalRelation``, ``Filter``, ``Project``,
``Aggregate``, ``Join``, ``Sort``, ``Limit``, ``Union``, ``Repartition``,
``Expand``, ``Generate``, ``Window`` and ``WriteFile``, and a
``DataFrame`` with ``filter``, ``with_column``, ``with_column_renamed``,
``select``, ``drop``, ``group_by().agg``, ``agg``, ``join``, ``sort``,
``limit``, ``union``/``unionAll``, ``repartition``, ``distinct``,
``explode``, ``with_window``, ``collect``, ``explain``,
``write_parquet`` and ``write_orc`` (planned and tagged; ORC has no
encoder, so its conversion raises).  Grouping sets are an ``Expand``
node built by the caller (the reference's DataFrame has no ``rollup``
either); ``sort_within_partitions`` and file scans come with later
slices.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from .. import types as T
from ..data.column import HostBatch
from ..ops.expression import (Alias, Expression, UnresolvedAttribute,
                              bind_references, output_name)
from . import functions as F


class LogicalPlan:
    def __init__(self, children: Sequence["LogicalPlan"] = ()):
        self.children = list(children)

    @property
    def schema(self) -> T.Schema:
        raise NotImplementedError

    @property
    def name(self):
        return type(self).__name__

    def tree_string(self, indent: int = 0) -> str:
        s = "  " * indent + self.describe()
        for c in self.children:
            s += "\n" + c.tree_string(indent + 1)
        return s

    def describe(self) -> str:
        return self.name

    def __repr__(self):  # pragma: no cover
        return self.tree_string()


class LocalRelation(LogicalPlan):
    def __init__(self, batches: List[HostBatch], schema: T.Schema,
                 n_partitions: int = 1):
        super().__init__()
        self.batches = batches
        self._schema = schema
        self.n_partitions = n_partitions

    @property
    def schema(self):
        return self._schema


class Project(LogicalPlan):
    def __init__(self, child: LogicalPlan, exprs: List[Expression]):
        super().__init__([child])
        self.exprs = exprs

    @property
    def schema(self):
        child_schema = self.children[0].schema
        fields = []
        for i, e in enumerate(self.exprs):
            bound = bind_references(e, child_schema)
            fields.append(T.Field(output_name(e, i), bound.dtype,
                                  bound.nullable))
        return T.Schema(fields)

    def describe(self):
        return f"Project[{', '.join(e.sql() for e in self.exprs)}]"


class Filter(LogicalPlan):
    def __init__(self, child: LogicalPlan, condition: Expression):
        super().__init__([child])
        self.condition = condition

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"Filter[{self.condition.sql()}]"


class Aggregate(LogicalPlan):
    def __init__(self, child: LogicalPlan, keys: List[Expression],
                 aggregates: List[Expression]):
        super().__init__([child])
        self.keys = keys
        self.aggregates = aggregates  # AggregateExpression or Alias thereof

    @property
    def schema(self):
        child_schema = self.children[0].schema
        fields = []
        for i, k in enumerate(self.keys):
            b = bind_references(k, child_schema)
            fields.append(T.Field(output_name(k, i), b.dtype, b.nullable))
        for j, a in enumerate(self.aggregates):
            b = bind_references(a, child_schema)
            fields.append(T.Field(
                output_name(a, len(self.keys) + j), b.dtype, b.nullable))
        return T.Schema(fields)

    def describe(self):
        return (f"Aggregate[keys={[k.sql() for k in self.keys]}, "
                f"aggs={[a.sql() for a in self.aggregates]}]")


class Join(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_keys: List[Expression], right_keys: List[Expression],
                 how: str = "inner", condition: Optional[Expression] = None):
        super().__init__([left, right])
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.how = how
        self.condition = condition

    @property
    def schema(self):
        l, r = self.children[0].schema, self.children[1].schema
        if self.how in ("semi", "anti"):
            return l
        lf = list(l.fields)
        rf = list(r.fields)
        if self.how in ("left", "full"):
            rf = [T.Field(f.name, f.dtype, True) for f in rf]
        if self.how in ("right", "full"):
            lf = [T.Field(f.name, f.dtype, True) for f in lf]
        return T.Schema(lf + rf)

    def describe(self):
        return f"Join[{self.how}]"


class Sort(LogicalPlan):
    def __init__(self, child: LogicalPlan, keys: List[F.SortKey],
                 global_sort: bool = True):
        super().__init__([child])
        self.keys = keys
        self.global_sort = global_sort

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"Sort[global={self.global_sort}]"


class Limit(LogicalPlan):
    def __init__(self, child: LogicalPlan, n: int):
        super().__init__([child])
        self.n = n

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"Limit[{self.n}]"


class Union(LogicalPlan):
    """The children's partitions one after another (Spark's UNION ALL);
    the schema is the first child's."""

    def __init__(self, children: List[LogicalPlan]):
        super().__init__(children)

    @property
    def schema(self):
        return self.children[0].schema


class Repartition(LogicalPlan):
    """Hash partitioning on ``keys``, or round robin without keys."""

    def __init__(self, child: LogicalPlan, n: int,
                 keys: Optional[List[Expression]] = None):
        super().__init__([child])
        self.n = n
        self.keys = keys

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"Repartition[{self.n}]"


class Expand(LogicalPlan):
    """Grouping-sets style row expansion: every input row once per
    projection list.  Each field takes its type from the first
    projection and is nullable."""

    def __init__(self, child: LogicalPlan,
                 projections: List[List[Expression]],
                 output_names: List[str]):
        super().__init__([child])
        self.projections = projections
        self.output_names = output_names

    @property
    def schema(self):
        child_schema = self.children[0].schema
        first = [bind_references(e, child_schema)
                 for e in self.projections[0]]
        return T.Schema([T.Field(n, b.dtype, True)
                         for n, b in zip(self.output_names, first)])

    def describe(self):
        return f"Expand[{len(self.projections)} projections]"


class Generate(LogicalPlan):
    """explode over per-row element expressions: every input row once per
    element, the child's columns, then ``pos`` (INT32, not null) when
    ``position`` is set, then the element as ``output_name`` (the first
    element's type, nullable)."""

    def __init__(self, child: LogicalPlan, elements: List[Expression],
                 output_name_: str, position: bool = False):
        super().__init__([child])
        self.elements = elements
        self.output_name = output_name_
        self.position = position

    @property
    def schema(self):
        child_schema = self.children[0].schema
        b = bind_references(self.elements[0], child_schema)
        fields = list(child_schema.fields)
        if self.position:
            fields.append(T.Field("pos", T.INT32, False))
        fields.append(T.Field(self.output_name, b.dtype, True))
        return T.Schema(fields)

    def describe(self):
        return f"Generate[{len(self.elements)} elements]"


class Window(LogicalPlan):
    """The child's columns plus one column per window expression
    (``ops.windowexprs.WindowExpression``), named by ``names``."""

    def __init__(self, child: LogicalPlan, window_exprs, names: List[str]):
        super().__init__([child])
        self.window_exprs = window_exprs
        self.names = names

    @property
    def schema(self):
        child_schema = self.children[0].schema
        fields = list(child_schema.fields)
        for n, w in zip(self.names, self.window_exprs):
            fields.append(T.Field(n, w.bind(child_schema).dtype, True))
        return T.Schema(fields)

    def describe(self):
        return f"Window[{', '.join(w.sql() for w in self.window_exprs)}]"


class WriteFile(LogicalPlan):
    def __init__(self, child: LogicalPlan, fmt: str, path: str,
                 options: Optional[dict] = None,
                 partition_by: Optional[List[str]] = None,
                 bucket_by: Optional[List[str]] = None):
        super().__init__([child])
        self.fmt = fmt
        self.path = path
        self.options = options or {}
        self.partition_by = partition_by or []
        self.bucket_by = bucket_by or []

    @property
    def schema(self):
        return T.Schema([])


_JOIN_ALIASES = {"left_outer": "left", "right_outer": "right",
                 "full_outer": "full", "leftsemi": "semi",
                 "left_semi": "semi", "leftanti": "anti",
                 "left_anti": "anti"}


def _to_expr(c) -> Expression:
    if isinstance(c, str):
        return UnresolvedAttribute(c)
    if isinstance(c, F.Column):
        return c.expr
    if isinstance(c, Expression):
        return c
    raise TypeError(f"not a column: {c!r}")


class GroupedData:
    def __init__(self, df: "DataFrame", keys):
        self._df = df
        self._keys = [_to_expr(k) for k in keys]

    def agg(self, *aggs) -> "DataFrame":
        exprs = []
        for a in aggs:
            if isinstance(a, F.AggColumn):
                e = a.expr if a._name is None else Alias(a.expr, a._name)
            elif isinstance(a, F.Column):
                e = a.expr
            else:
                raise TypeError(f"not an aggregate: {a!r}")
            exprs.append(e)
        return DataFrame(self._df.session,
                         Aggregate(self._df.plan, self._keys, exprs))


class DataFrame:
    def __init__(self, session, plan: LogicalPlan):
        self.session = session
        self.plan = plan

    @property
    def schema(self) -> T.Schema:
        return self.plan.schema

    @property
    def columns(self) -> List[str]:
        return self.schema.names

    def select(self, *cols) -> "DataFrame":
        return DataFrame(self.session,
                         Project(self.plan, [_to_expr(c) for c in cols]))

    def with_column(self, name: str, c) -> "DataFrame":
        exprs = [UnresolvedAttribute(n) for n in self.columns if n != name]
        exprs.append(Alias(_to_expr(c), name))
        return DataFrame(self.session, Project(self.plan, exprs))

    def filter(self, condition) -> "DataFrame":
        return DataFrame(self.session,
                         Filter(self.plan, _to_expr(condition)))

    def group_by(self, *keys) -> GroupedData:
        return GroupedData(self, keys)

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def sort(self, *keys) -> "DataFrame":
        sort_keys = [k if isinstance(k, F.SortKey)
                     else F.SortKey(_to_expr(k)) for k in keys]
        return DataFrame(self.session, Sort(self.plan, sort_keys, True))

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             condition=None) -> "DataFrame":
        """Equi-join on ``on``: a column name, a list of names present on
        both sides, or ``([left keys], [right keys])``.  ``how``: inner,
        left, right, full, semi or anti (and their Spark aliases)."""
        how = _JOIN_ALIASES.get(how, how)
        if on is None:
            raise ValueError("join requires 'on'")
        if isinstance(on, str):
            on = [on]
        if isinstance(on, (list, tuple)) and on and isinstance(on[0], str):
            lk = [UnresolvedAttribute(k) for k in on]
            rk = [UnresolvedAttribute(k) for k in on]
        else:
            lk, rk = on
            lk = [_to_expr(k) for k in lk]
            rk = [_to_expr(k) for k in rk]
        cond = _to_expr(condition) if condition is not None else None
        return DataFrame(self.session,
                         Join(self.plan, other.plan, lk, rk, how, cond))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, Limit(self.plan, n))

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL: this frame's rows, then ``other``'s."""
        return DataFrame(self.session, Union([self.plan, other.plan]))

    unionAll = union

    def distinct(self) -> "DataFrame":
        """The distinct rows: a group-by on every column with no
        aggregate."""
        keys = [UnresolvedAttribute(n) for n in self.columns]
        return DataFrame(self.session, Aggregate(self.plan, keys, []))

    def drop(self, *names) -> "DataFrame":
        """Every column but ``names`` (all columns of a name go)."""
        keep = [n for n in self.columns if n not in names]
        return self.select(*keep)

    def with_column_renamed(self, old: str, new: str) -> "DataFrame":
        exprs = [Alias(UnresolvedAttribute(n), new) if n == old
                 else UnresolvedAttribute(n) for n in self.columns]
        return DataFrame(self.session, Project(self.plan, exprs))

    def explode(self, elements, name: str = "col") -> "DataFrame":
        """Every row once per element expression, the element in column
        ``name`` (row-major: a row's elements are consecutive)."""
        return DataFrame(self.session, Generate(
            self.plan, [_to_expr(e) for e in elements], name))

    def with_window(self, name: str, window_expr) -> "DataFrame":
        """Add column ``name`` = ``window_expr`` (``over(...)``); each
        call is its own Window node, as in the reference."""
        return DataFrame(self.session,
                         Window(self.plan, [window_expr], [name]))

    def repartition(self, n: int, *cols) -> "DataFrame":
        """``n`` partitions, by the Murmur3 hash of ``cols``, or round
        robin when no column is named."""
        keys = [_to_expr(c) for c in cols] or None
        return DataFrame(self.session, Repartition(self.plan, n, keys))

    def _result_batch(self) -> HostBatch:
        return self.session.execute(self.plan)

    def collect(self) -> List[tuple]:
        return self._result_batch().to_rows()

    def explain(self, mode: str = "ALL") -> str:
        return self.session.explain(self.plan, mode)

    def write_parquet(self, path: str, partition_by=None,
                      bucket_by=None, **options):
        """Write every partition as Parquet under ``path`` (Hive
        ``k=v`` directories by ``partition_by``; ``compression``
        ``snappy`` by default, ``gzip`` or ``none``), then ``_SUCCESS``;
        ``session.last_write_stats`` holds the files written."""
        self.session.execute(WriteFile(self.plan, "parquet", path,
                                       options, partition_by, bucket_by))

    def write_orc(self, path: str, partition_by=None,
                  bucket_by=None, **options):
        self.session.execute(WriteFile(self.plan, "orc", path,
                                       options, partition_by, bucket_by))

    def __repr__(self):  # pragma: no cover
        return f"DataFrame[{', '.join(map(repr, self.schema.fields))}]"
