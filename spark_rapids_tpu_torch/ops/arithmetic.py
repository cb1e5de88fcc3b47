"""Arithmetic expressions.

Counterpart of ``spark_rapids_tpu/ops/arithmetic.py`` for the four
operations the slice runs (Add, Subtract, Multiply, Divide).  Spark
semantics (non-ANSI): integer overflow wraps, and division by zero
yields NULL.  IntegralDivide, Remainder, Pmod, the unary ops and
Least/Greatest come with a later slice.
"""
from __future__ import annotations

import torch

from .. import types as T
from .expression import BinaryExpression


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
