"""Arithmetic expressions.

Counterpart of ``spark_rapids_tpu/ops/arithmetic.py``: Add, Subtract,
Multiply, Divide, IntegralDivide, Remainder, Pmod, UnaryMinus,
UnaryPositive, Abs, Least and Greatest, as torch bodies (the host
engine's ``do_cpu`` bodies are not ported).  Spark semantics (non-ANSI):
integer overflow wraps (Java), division by zero yields NULL, integral
division truncates toward zero, ``%`` takes the sign of the dividend.
An integer divisor of -1 negates instead of dividing, so the minimum of
a type divided by -1 wraps as in the reference rather than trapping the
host's divide instruction.  Inside a fused segment each runs as a K12
rule (``ops/kernels/fused.py``) with the same semantics.
"""
from __future__ import annotations

import torch

from .. import types as T
from ..data.column import DeviceColumn
from .cast import numeric_cast
from .expression import (BinaryExpression, UnaryExpression,
                         as_device_column)


def _trunc_div(l, r):
    """Java's truncating division of integers (``r`` has no zero), -1
    as a negation."""
    neg = r == -1
    q = torch.div(l, torch.where(neg, torch.ones_like(r), r),
                  rounding_mode="trunc")
    return torch.where(neg, -l, q)


def _java_mod(l, r):
    """``l`` modulo ``r`` with the dividend's sign (a zero divisor taken
    as 1; a float NaN as the canonical NaN)."""
    safe = torch.where(r == 0, torch.ones_like(r), r)
    if l.dtype.is_floating_point:
        # a NaN result as the canonical NaN: the bits torch's fmod leaves
        # differ between its CPU and CUDA bodies
        m = torch.fmod(l, safe)
        return torch.where(torch.isnan(m), torch.full_like(m, float("nan")),
                           m)
    return l - _trunc_div(l, safe) * safe


class Add(BinaryExpression):
    def do_tpu(self, l, r):
        return l + r

    def sql(self):
        return f"({self.left.sql()} + {self.right.sql()})"


class Subtract(BinaryExpression):
    def do_tpu(self, l, r):
        return l - r

    def sql(self):
        return f"({self.left.sql()} - {self.right.sql()})"


class Multiply(BinaryExpression):
    def do_tpu(self, l, r):
        return l * r

    def sql(self):
        return f"({self.left.sql()} * {self.right.sql()})"


class Divide(BinaryExpression):
    """Fractional division; Spark returns double and NULL on a zero
    divisor."""

    def result_dtype(self, lt, rt):
        return T.FLOAT64

    def do_tpu(self, l, r):
        return l / torch.where(r == 0, torch.ones_like(r), r)

    def extra_null_tpu(self, l, r):
        return r == 0

    def sql(self):
        return f"({self.left.sql()} / {self.right.sql()})"


class IntegralDivide(BinaryExpression):
    """``div``: both sides as bigint, truncated toward zero."""

    def result_dtype(self, lt, rt):
        return T.INT64

    def cast_inputs(self, l, r):
        """Both sides as bigint, as the reference's ``astype`` converts (a
        float toward zero, NaN to 0, saturating)."""
        return (numeric_cast(l, self.left.dtype, T.INT64),
                numeric_cast(r, self.right.dtype, T.INT64))

    def do_tpu(self, l, r):
        return _trunc_div(l, torch.where(r == 0, torch.ones_like(r), r))

    def extra_null_tpu(self, l, r):
        return r == 0


class Remainder(BinaryExpression):
    def do_tpu(self, l, r):
        return _java_mod(l, r)

    def extra_null_tpu(self, l, r):
        return r == 0

    def sql(self):
        return f"({self.left.sql()} % {self.right.sql()})"


class Pmod(BinaryExpression):
    """The non-negative modulus of a positive divisor (the divisor's
    sign in general)."""

    def do_tpu(self, l, r):
        safe = torch.where(r == 0, torch.ones_like(r), r)
        m = _java_mod(l, safe)
        return torch.where((m != 0) & ((m < 0) != (safe < 0)), m + safe, m)

    def extra_null_tpu(self, l, r):
        return r == 0


class UnaryMinus(UnaryExpression):
    def do_tpu(self, data):
        return -data

    def sql(self):
        return f"(- {self.child.sql()})"


class UnaryPositive(UnaryExpression):
    def do_tpu(self, data):
        return data


class Abs(UnaryExpression):
    def do_tpu(self, data):
        return torch.abs(data)


def greatest_values(a, b):
    """XLA's ``maximum`` of two tensors of one type: a NaN wins, and +0.0
    beats -0.0 in either order."""
    if not a.dtype.is_floating_point:
        return torch.maximum(a, b)
    out = torch.where(a > b, a, torch.where(
        b > a, b, torch.where(torch.signbit(a), b, a)))
    return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b,
                                                      out))


def least_values(a, b):
    """The reference's ``fmin``: ``a`` where ``b`` is NaN or ``a < b``,
    else ``b`` (a NaN loses unless both are; of two equal values, ``b``)."""
    if not a.dtype.is_floating_point:
        return torch.minimum(a, b)
    return torch.where(torch.isnan(b) | (a < b), a, b)


class _NullSkippingExtremum(BinaryExpression):
    """Spark's greatest/least: a null input is skipped, and the result is
    null only when every input is.  NaN ranks above every value, so
    greatest propagates NaN and least ignores it."""

    values = None

    def eval_tpu(self, batch):
        n, dev = batch.padded_rows, batch.device
        lc = as_device_column(self.left.eval_tpu(batch), n, dev)
        rc = as_device_column(self.right.eval_tpu(batch), n, dev)
        out_t = self.dtype
        ld = lc.data.to(out_t.torch_dtype)
        rd = rc.data.to(out_t.torch_dtype)
        lv, rv = lc.validity, rc.validity
        both = type(self).values(ld, rd)
        data = torch.where(lv & rv, both, torch.where(lv, ld, rd))
        return DeviceColumn(out_t, data, lv | rv)


class Least(_NullSkippingExtremum):
    values = staticmethod(least_values)


class Greatest(_NullSkippingExtremum):
    values = staticmethod(greatest_values)
