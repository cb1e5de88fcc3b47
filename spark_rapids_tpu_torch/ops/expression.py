"""Expression IR evaluated on device batches.

Counterpart of ``spark_rapids_tpu/ops/expression.py``.  Every expression
implements ``eval_tpu(DeviceBatch)`` — the reference's name for the
accelerator engine's evaluation — as plain torch ops on the batch's
tensors; the host engine (``eval_cpu``) is not ported yet.

Null semantics are Spark's: an output row is null when any input row is
null; AND/OR use Kleene logic.  Invalid lanes still compute (branch-free,
mask-carried), and padding rows flow through with validity False.
"""
from __future__ import annotations

import copy
import datetime as _dt
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..data.column import DeviceBatch, DeviceColumn


class Scalar:
    """A typed scalar result; value None = null."""

    __slots__ = ("dtype", "value")

    def __init__(self, dtype: T.DType, value: Any):
        self.dtype = dtype
        self.value = value

    @property
    def is_null(self) -> bool:
        return self.value is None

    def __repr__(self):  # pragma: no cover
        return f"Scalar({self.dtype}, {self.value})"


def as_device_column(x, n_padded: int, device) -> DeviceColumn:
    """A column as is; a scalar broadcast to ``n_padded`` rows."""
    if isinstance(x, DeviceColumn):
        return x
    if x.dtype.is_string:
        # one encoded row broadcast (stride 0) to n_padded rows: the
        # string kernels read it once; a consumer that writes it copies
        from ..data import strings as dstrings

        bm, ln = dstrings.encode([x.value])
        data = torch.from_numpy(bm).to(device).expand(n_padded, -1)
        lengths = torch.from_numpy(ln).to(device).expand(n_padded)
        validity = torch.full((n_padded,), not x.is_null, dtype=torch.bool,
                              device=device)
        return DeviceColumn(x.dtype, data, validity, lengths)
    val = 0 if x.is_null else x.value
    data = torch.full((n_padded,), val, dtype=x.dtype.torch_dtype,
                      device=device)
    validity = torch.full((n_padded,), not x.is_null, dtype=torch.bool,
                          device=device)
    return DeviceColumn(x.dtype, data, validity)


class Expression:
    """Base expression node."""

    def __init__(self, children: Sequence["Expression"] = ()):
        self.children: List[Expression] = list(children)

    @property
    def dtype(self) -> T.DType:
        raise NotImplementedError

    @property
    def nullable(self) -> bool:
        return any(c.nullable for c in self.children) if self.children \
            else True

    @property
    def name(self) -> str:
        return type(self).__name__

    @property
    def deterministic(self) -> bool:
        """False for an expression whose value depends on more than its
        row (the fusion pass stops at it)."""
        return all(c.deterministic for c in self.children)

    def with_children(self, children: List["Expression"]) -> "Expression":
        node = copy.copy(self)
        node.children = list(children)
        return node

    def transform(self, fn) -> "Expression":
        node = self.with_children([c.transform(fn) for c in self.children])
        replaced = fn(node)
        return node if replaced is None else replaced

    def eval_tpu(self, batch: DeviceBatch):
        """Device evaluation; expressions without one are tagged off the
        device by the plan-rewrite engine."""
        raise NotImplementedError(f"{self.name}.eval_tpu")

    @property
    def tpu_supported(self) -> bool:
        return type(self).eval_tpu is not Expression.eval_tpu

    def sql(self) -> str:
        return f"{self.name}({', '.join(c.sql() for c in self.children)})"

    def __repr__(self):  # pragma: no cover
        return self.sql()


# --------------------------------------------------------------------------
# Leaves
# --------------------------------------------------------------------------
class Literal(Expression):
    def __init__(self, value: Any, dtype: Optional[T.DType] = None):
        super().__init__()
        if dtype is None:
            dtype = _infer_literal_type(value)
        if dtype.id is T.TypeId.DATE32:
            if isinstance(value, _dt.datetime):
                value = value.date()
            if isinstance(value, _dt.date):
                value = (value - _dt.date(1970, 1, 1)).days
        self._dtype = dtype
        self.value = value

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self.value is None

    def eval_tpu(self, batch):
        return Scalar(self._dtype, self.value)

    def sql(self):
        return repr(self.value)


def _infer_literal_type(v) -> T.DType:
    if v is None:
        return T.NULL
    if isinstance(v, bool):
        return T.BOOL
    if isinstance(v, _dt.date) and not isinstance(v, _dt.datetime):
        return T.DATE32
    if isinstance(v, (int, np.integer)):
        return T.INT32 if -(2 ** 31) <= int(v) < 2 ** 31 else T.INT64
    if isinstance(v, (float, np.floating)):
        return T.FLOAT64
    if isinstance(v, str):
        return T.STRING
    raise TypeError(f"cannot infer literal type for {v!r}")


class UnresolvedAttribute(Expression):
    def __init__(self, attr_name: str):
        super().__init__()
        self.attr_name = attr_name

    @property
    def dtype(self):
        raise ValueError(f"unresolved attribute '{self.attr_name}'")

    def sql(self):
        return self.attr_name


class BoundReference(Expression):
    def __init__(self, ordinal: int, dtype: T.DType, nullable: bool = True,
                 attr_name: str = ""):
        super().__init__()
        self.ordinal = ordinal
        self._dtype = dtype
        self._nullable = nullable
        self.attr_name = attr_name

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self._nullable

    def eval_tpu(self, batch: DeviceBatch):
        return batch.columns[self.ordinal]

    def sql(self):
        return self.attr_name or f"input[{self.ordinal}]"


class Alias(Expression):
    def __init__(self, child: Expression, alias: str):
        super().__init__([child])
        self.alias = alias

    @property
    def child(self):
        return self.children[0]

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def nullable(self):
        return self.child.nullable

    def eval_tpu(self, batch):
        return self.child.eval_tpu(batch)

    def sql(self):
        return f"{self.child.sql()} AS {self.alias}"


def unalias(e: Expression) -> Expression:
    """``e`` without the aliases around it."""
    while isinstance(e, Alias):
        e = e.child
    return e


def output_name(expr: Expression, i: int) -> str:
    if isinstance(expr, Alias):
        return expr.alias
    if isinstance(expr, UnresolvedAttribute):
        return expr.attr_name
    if isinstance(expr, BoundReference) and expr.attr_name:
        return expr.attr_name
    return f"col{i}"


def bind_references(expr: Expression, schema: T.Schema) -> Expression:
    def replace(node):
        if isinstance(node, UnresolvedAttribute):
            idx = schema.index_of(node.attr_name)
            f = schema[idx]
            return BoundReference(idx, f.dtype, f.nullable, node.attr_name)
        return None

    return expr.transform(replace)


# --------------------------------------------------------------------------
# Generic unary/binary machinery
# --------------------------------------------------------------------------
def and_validity(n: int, device, *cols) -> torch.Tensor:
    v = None
    for c in cols:
        if isinstance(c, DeviceColumn):
            cv = c.validity
        else:
            cv = None if not c.is_null else torch.zeros(
                n, dtype=torch.bool, device=device)
        if cv is not None:
            v = cv if v is None else (v & cv)
    if v is None:
        v = torch.ones(n, dtype=torch.bool, device=device)
    return v


class UnaryExpression(Expression):
    """Null-intolerant unary op: override ``do_tpu(data)``."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def child(self):
        return self.children[0]

    @property
    def dtype(self):
        return self.result_dtype(self.child.dtype)

    def result_dtype(self, child_dtype: T.DType) -> T.DType:
        return child_dtype

    def do_tpu(self, data):
        raise NotImplementedError

    def eval_tpu(self, batch):
        c = as_device_column(self.child.eval_tpu(batch), batch.padded_rows,
                             batch.device)
        return DeviceColumn(self.dtype, self.do_tpu(c.data), c.validity)


class BinaryExpression(Expression):
    """Null-intolerant binary op: override ``do_tpu(l, r)``."""

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    @property
    def dtype(self):
        return self.result_dtype(self.left.dtype, self.right.dtype)

    def result_dtype(self, lt: T.DType, rt: T.DType) -> T.DType:
        return T.promote(lt, rt)

    def do_tpu(self, l, r):
        raise NotImplementedError

    def extra_null_tpu(self, l, r):
        """Validity beyond AND-of-inputs (e.g. division by zero)."""
        return None

    def cast_inputs(self, l, r):
        out = self.dtype
        if out.is_numeric:
            return l.to(out.torch_dtype), r.to(out.torch_dtype)
        lt, rt = self.left.dtype, self.right.dtype
        if lt.is_numeric and rt.is_numeric:
            p = T.promote(lt, rt).torch_dtype
            return l.to(p), r.to(p)
        return l, r

    def eval_tpu(self, batch):
        n, dev = batch.padded_rows, batch.device
        lc = self.left.eval_tpu(batch)
        rc = self.right.eval_tpu(batch)
        validity = and_validity(n, dev, lc, rc)
        l, r = self.cast_inputs(as_device_column(lc, n, dev).data,
                                as_device_column(rc, n, dev).data)
        data = self.do_tpu(l, r)
        extra = self.extra_null_tpu(l, r)
        if extra is not None:
            validity = validity & ~extra
        return DeviceColumn(self.dtype, data, validity)
