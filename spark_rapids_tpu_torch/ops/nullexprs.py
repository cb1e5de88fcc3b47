"""Null-handling expressions: ``Coalesce`` and ``NaNvl``.

Counterpart of ``spark_rapids_tpu/ops/nullexprs.py:17 Coalesce`` and
``:76 NaNvl`` (the reference's device bodies): both are branch-free
selects over their children, evaluated in full.  A coalesce takes, row
by row, the first valid child, converted to the children's promoted type
(string children padded to the widest matrix, at least one byte); a
``nanvl(a, b)`` takes ``b`` where ``a`` is a valid NaN, else ``a``.
Inside a fused segment both run as K12 rules
(``ops/kernels/fused.py``).  The reference's ``NullIf`` and ``Nvl``
(``nullexprs.py:120-160``) come with a later slice; a child of type NULL
(an untyped null literal) is never valid, so a coalesce skips it.
"""
from __future__ import annotations

from typing import List

import torch

from .. import types as T
from ..data.column import DeviceColumn
from .conditional import _pad_width, common_type
from .expression import Expression, as_device_column


class Coalesce(Expression):
    def __init__(self, exprs: List[Expression]):
        super().__init__(exprs)

    @property
    def dtype(self):
        return common_type([c.dtype for c in self.children])

    def eval_tpu(self, batch):
        n, dev = batch.padded_rows, batch.device
        out = self.dtype
        cols = [as_device_column(e.eval_tpu(batch), n, dev)
                for e in self.children if e.dtype.id is not T.TypeId.NULL]
        validity = torch.zeros(n, dtype=torch.bool, device=dev)
        if out.is_string:
            w = max([1] + [c.data.shape[1] for c in cols])
            data = torch.zeros((n, w), dtype=torch.uint8, device=dev)
            lengths = torch.zeros(n, dtype=torch.int32, device=dev)
            for c in cols:
                fill = ~validity & c.validity
                data = torch.where(fill[:, None], _pad_width(c.data, w),
                                   data)
                lengths = torch.where(fill, c.lengths.to(torch.int32),
                                      lengths)
                validity = validity | fill
            return DeviceColumn(out, data, validity, lengths)
        data = torch.zeros(n, dtype=out.torch_dtype, device=dev)
        for c in cols:
            fill = ~validity & c.validity
            data = torch.where(fill, c.data.to(out.torch_dtype), data)
            validity = validity | fill
        return DeviceColumn(out, data, validity)


class NaNvl(Expression):
    """nanvl(a, b): b where a is NaN, else a."""

    def __init__(self, left, right):
        super().__init__([left, right])

    @property
    def dtype(self):
        return common_type([c.dtype for c in self.children])

    def eval_tpu(self, batch):
        n, dev = batch.padded_rows, batch.device
        out = self.dtype
        a = as_device_column(self.children[0].eval_tpu(batch), n, dev)
        b = as_device_column(self.children[1].eval_tpu(batch), n, dev)
        ad = a.data.to(out.torch_dtype)
        bd = b.data.to(out.torch_dtype)
        use_b = a.validity & torch.isnan(ad)
        return DeviceColumn(out, torch.where(use_b, bd, ad),
                            torch.where(use_b, b.validity, a.validity))
