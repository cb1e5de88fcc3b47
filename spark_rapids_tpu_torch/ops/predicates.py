"""Predicate expressions.

Counterpart of ``spark_rapids_tpu/ops/predicates.py`` for the slice:
the five comparisons (numbers, dates, and strings through K8,
``ops/kernels/stringkernels.py``), And/Or with Kleene logic, Not, IsNull,
IsNotNull and InSet (literal members; strings through K8).
EqualNullSafe, IsNaN and In (non-literal members) come with a later
slice.
"""
from __future__ import annotations

import datetime as _dt
from typing import List

import numpy as np
import torch

from .. import types as T
from ..data.column import DeviceColumn
from ..data import strings as dstrings
from .expression import (BinaryExpression, Expression, UnaryExpression,
                         and_validity, as_device_column)
from .kernels import stringkernels as sk


class _Comparison(BinaryExpression):
    op = ""  # "<", "<=", ">", ">=", "=="

    def result_dtype(self, lt, rt):
        return T.BOOL

    def cast_inputs(self, l, r):
        lt, rt = self.left.dtype, self.right.dtype
        if lt.is_numeric and rt.is_numeric and lt != rt:
            p = T.promote(lt, rt).torch_dtype
            return l.to(p), r.to(p)
        return l, r

    def eval_tpu(self, batch):
        if not (self.left.dtype.is_string or self.right.dtype.is_string):
            return super().eval_tpu(batch)
        n, dev = batch.padded_rows, batch.device
        lc = self.left.eval_tpu(batch)
        rc = self.right.eval_tpu(batch)
        lcol = as_device_column(lc, n, dev)
        rcol = as_device_column(rc, n, dev)
        validity = and_validity(n, dev, lc, rc)
        if self.op == "==":
            data = sk.equals(lcol.data, lcol.lengths, rcol.data,
                             rcol.lengths)
        else:
            c = sk.compare(lcol.data, lcol.lengths, rcol.data, rcol.lengths)
            data = {"<": c < 0, "<=": c <= 0, ">": c > 0,
                    ">=": c >= 0}[self.op]
        return DeviceColumn(T.BOOL, data, validity)

    def do_tpu(self, l, r):
        return _CMP[self.op](l, r)

    def sql(self):
        return f"({self.left.sql()} {self.op} {self.right.sql()})"


_CMP = {
    "==": torch.eq,
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
}


class EqualTo(_Comparison):
    op = "=="


class LessThan(_Comparison):
    op = "<"


class LessThanOrEqual(_Comparison):
    op = "<="


class GreaterThan(_Comparison):
    op = ">"


class GreaterThanOrEqual(_Comparison):
    op = ">="


class Not(UnaryExpression):
    def result_dtype(self, ct):
        return T.BOOL

    def do_tpu(self, data):
        return ~data

    def sql(self):
        return f"(NOT {self.child.sql()})"


def _bool_pair(expr, batch):
    n, dev = batch.padded_rows, batch.device
    lc = as_device_column(expr.children[0].eval_tpu(batch), n, dev)
    rc = as_device_column(expr.children[1].eval_tpu(batch), n, dev)
    return lc.validity, rc.validity, lc.data & lc.validity, \
        rc.data & rc.validity


class And(Expression):
    def __init__(self, left, right):
        super().__init__([left, right])

    @property
    def dtype(self):
        return T.BOOL

    def eval_tpu(self, batch):
        lv, rv, ld, rd = _bool_pair(self, batch)
        lf = lv & ~ld
        rf = rv & ~rd
        return DeviceColumn(T.BOOL, ld & rd, lf | rf | (lv & rv))

    def sql(self):
        return f"({self.children[0].sql()} AND {self.children[1].sql()})"


class Or(Expression):
    def __init__(self, left, right):
        super().__init__([left, right])

    @property
    def dtype(self):
        return T.BOOL

    def eval_tpu(self, batch):
        lv, rv, ld, rd = _bool_pair(self, batch)
        return DeviceColumn(T.BOOL, ld | rd, ld | rd | (lv & rv))

    def sql(self):
        return f"({self.children[0].sql()} OR {self.children[1].sql()})"


class IsNull(Expression):
    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return T.BOOL

    @property
    def nullable(self):
        return False

    def eval_tpu(self, batch):
        n, dev = batch.padded_rows, batch.device
        c = as_device_column(self.children[0].eval_tpu(batch), n, dev)
        # padding rows report "null"; they are masked out downstream
        return DeviceColumn(T.BOOL, ~c.validity,
                            torch.ones(n, dtype=torch.bool, device=dev))

    def sql(self):
        return f"({self.children[0].sql()} IS NULL)"


class IsNotNull(Expression):
    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return T.BOOL

    @property
    def nullable(self):
        return False

    def eval_tpu(self, batch):
        n, dev = batch.padded_rows, batch.device
        c = as_device_column(self.children[0].eval_tpu(batch), n, dev)
        return DeviceColumn(T.BOOL, c.validity.clone(),
                            torch.ones(n, dtype=torch.bool, device=dev))

    def sql(self):
        return f"({self.children[0].sql()} IS NOT NULL)"


class InSet(Expression):
    """``child IN (v1, v2, ...)`` with literal members, Spark's
    three-valued result: null when the child is null, and a miss becomes
    null when a member is null (``predicates.py:468``)."""

    def __init__(self, child: Expression, values: List):
        super().__init__([child])
        self.values = [v for v in values if v is not None]
        self.has_null_value = any(v is None for v in values)

    @property
    def dtype(self):
        return T.BOOL

    def member_array(self) -> np.ndarray:
        """The non-null members in the child's numpy type (dates as
        days since the epoch)."""
        dt = self.children[0].dtype
        vals = [(v - _dt.date(1970, 1, 1)).days
                if isinstance(v, _dt.date) else v for v in self.values]
        return np.asarray(vals, dtype=dt.np_dtype)

    def eval_tpu(self, batch):
        n, dev = batch.padded_rows, batch.device
        c = as_device_column(self.children[0].eval_tpu(batch), n, dev)
        data = torch.zeros(n, dtype=torch.bool, device=dev)
        if c.dtype.is_string:
            for v in self.values:
                bm, ln = dstrings.encode([v])
                data = data | sk.equals(c.data, c.lengths,
                                        torch.from_numpy(bm).to(dev),
                                        torch.from_numpy(ln).to(dev))
        elif self.values:
            vals = torch.from_numpy(self.member_array()).to(dev)
            data = (c.data[:, None] == vals[None, :]).any(dim=1)
        validity = c.validity
        if self.has_null_value:
            validity = validity & data
        return DeviceColumn(T.BOOL, data, validity)
