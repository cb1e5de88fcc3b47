"""Conditional expressions.

Counterpart of ``spark_rapids_tpu/ops/conditional.py:If`` (42) and
``CaseWhen`` (95): both branches compute and a ``where`` selects,
branch-free; a null condition takes the false branch, and the result has
the branches' promoted type (string branches are padded to the wider
matrix).  A ``CaseWhen`` is the chain of ``If``s it desugars to, strings
included, on the device and in K12 (``ops/kernels/fused.py`` generates
the chain's code).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import types as T
from ..data.column import DeviceColumn
from .expression import Expression, Literal, Scalar, as_device_column


def common_type(dtypes) -> T.DType:
    """The promoted type of non-null branch types (NULL if all are)."""
    out = None
    for dt in dtypes:
        if dt.id is T.TypeId.NULL:
            continue
        if out is None:
            out = dt
        elif out != dt:
            out = T.promote(out, dt)
    return out or T.NULL


def _pad_width(bm: torch.Tensor, w: int) -> torch.Tensor:
    if bm.shape[1] >= w:
        return bm
    return torch.nn.functional.pad(bm, (0, w - bm.shape[1]))


class If(Expression):
    def __init__(self, pred, if_true, if_false):
        super().__init__([pred, if_true, if_false])

    @property
    def dtype(self):
        return common_type([self.children[1].dtype,
                            self.children[2].dtype])

    def _branch(self, e: Expression, batch, out: T.DType):
        v = e.eval_tpu(batch)
        if e.dtype.id is T.TypeId.NULL:  # an untyped null takes out's type
            v = Scalar(out, None)
        return as_device_column(v, batch.padded_rows, batch.device)

    def eval_tpu(self, batch):
        n, dev = batch.padded_rows, batch.device
        out = self.dtype
        p = as_device_column(self.children[0].eval_tpu(batch), n, dev)
        t = self._branch(self.children[1], batch, out)
        f = self._branch(self.children[2], batch, out)
        cond = p.data & p.validity
        validity = torch.where(cond, t.validity, f.validity)
        if out.is_string:
            w = max(t.data.shape[1], f.data.shape[1])
            data = torch.where(cond[:, None], _pad_width(t.data, w),
                               _pad_width(f.data, w))
            lengths = torch.where(cond, t.lengths, f.lengths)
            return DeviceColumn(out, data, validity, lengths)
        data = torch.where(cond, t.data.to(out.torch_dtype),
                           f.data.to(out.torch_dtype))
        return DeviceColumn(out, data, validity)

    def sql(self):
        c = self.children
        return f"IF({c[0].sql()}, {c[1].sql()}, {c[2].sql()})"


class CaseWhen(Expression):
    """CASE WHEN p1 THEN v1 ... [ELSE e] END, desugared to an If chain
    (no ELSE: a null of the values' type)."""

    def __init__(self, branches: List[Tuple[Expression, Expression]],
                 else_value: Optional[Expression] = None):
        flat = []
        for p, v in branches:
            flat.extend([p, v])
        if else_value is not None:
            flat.append(else_value)
        super().__init__(flat)
        self.n_branches = len(branches)
        self.has_else = else_value is not None

    def _branches(self):
        return [(self.children[2 * i], self.children[2 * i + 1])
                for i in range(self.n_branches)]

    def _else(self):
        return self.children[-1] if self.has_else else None

    def chain(self) -> Expression:
        """The ``If`` chain this CASE stands for."""
        node: Expression = self._else() if self.has_else else Literal(
            None, self.dtype)
        for p, v in reversed(self._branches()):
            node = If(p, v, node)
        return node

    @property
    def dtype(self):
        ts = [v.dtype for _, v in self._branches()]
        if self.has_else:
            ts.append(self._else().dtype)
        return common_type(ts)

    def eval_tpu(self, batch):
        return self.chain().eval_tpu(batch)

    def sql(self):
        parts = " ".join(f"WHEN {p.sql()} THEN {v.sql()}"
                         for p, v in self._branches())
        e = f" ELSE {self._else().sql()}" if self.has_else else ""
        return f"CASE {parts}{e} END"
