"""Predicate expressions.

Counterpart of ``spark_rapids_tpu/ops/predicates.py`` for the slice:
the five comparisons (numbers, dates, and strings through K8,
``ops/kernels/stringkernels.py``), And/Or with Kleene logic, Not, IsNull
and IsNotNull.  EqualNullSafe, IsNaN and In/InSet come with a later
slice.
"""
from __future__ import annotations

import torch

from .. import types as T
from ..data.column import DeviceColumn
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
