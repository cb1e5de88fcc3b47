"""Cast — the primitive cast matrix — and the float normalizers.

Counterpart of ``spark_rapids_tpu/ops/cast.py``: ``Cast`` with the
reference's device matrix (``:41-120,318-398``), ``NormalizeNaNAndZero``
(``:401``) and ``KnownFloatingPointNormalized`` (``:435``).  The string
directions run on K16 (parse) and K17 (format) through
``ops/kernels/castkernels.py``; the numeric directions are torch ops with
the reference's (Spark non-ANSI) semantics:

  * int -> narrower int wraps (Java narrowing);
  * float -> integral maps NaN to 0 and saturates at
    ``_float_int_bounds``; float -> date or timestamp converts as XLA
    does (toward zero, NaN to 0, saturating);
  * numeric -> boolean is ``!= 0``; boolean -> numeric is 0/1;
  * date <-> timestamp at midnight UTC; timestamp -> date, and timestamp
    -> integral seconds, floor;
  * string -> number / boolean / date / timestamp trims and parses;
    malformed input gives NULL, and exponent forms ('1e2') are NULL for
    integral targets (the device's answer, where the reference's host
    parses them); narrower integral targets are range-checked, then
    converted;
  * integer / boolean / date / timestamp -> string formats.

float -> string has no device implementation (the reference keeps it on
the host), so such a Cast is tagged off the device; the host engine is
not ported yet, so planning it raises.  A scalar child (a literal) is
cast through the same column path on one CPU row.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import types as T
from ..data import strings as dstrings
from ..data.column import DeviceColumn
from .expression import Expression, Scalar, as_device_column
from .kernels import castkernels as K

_INT_RANGE = {
    T.TypeId.INT8: (-128, 127),
    T.TypeId.INT16: (-(2 ** 15), 2 ** 15 - 1),
    T.TypeId.INT32: (-(2 ** 31), 2 ** 31 - 1),
    T.TypeId.INT64: (-(2 ** 63), 2 ** 63 - 1),
}

MICROS_PER_SEC = 1_000_000
MICROS_PER_DAY = 86_400 * MICROS_PER_SEC

#: string-source targets with an exact (or gated) device parse
_STRING_PARSE_TARGETS = {
    T.TypeId.BOOL, T.TypeId.INT8, T.TypeId.INT16, T.TypeId.INT32,
    T.TypeId.INT64, T.TypeId.DATE32, T.TypeId.TIMESTAMP,
}


class Cast(Expression):
    def __init__(self, child: Expression, to: T.DType, ansi: bool = False):
        super().__init__([child])
        self.to = to
        self.ansi = ansi

    @property
    def child(self):
        return self.children[0]

    @property
    def dtype(self):
        return self.to

    @property
    def nullable(self):
        # string parses can produce nulls
        return self.child.nullable or self.child.dtype.is_string

    def sql(self):
        return f"CAST({self.child.sql()} AS {self.to.sql_name})"

    @property
    def tpu_supported(self):
        """Every direction but float -> string (reference:
        ``ops/cast.py:Cast.tpu_supported``); the divergent string
        directions are further gated by confs in the Cast rule's tag."""
        src, dst = self.child.dtype, self.to
        if not (src.is_string or dst.is_string):
            return True
        if src.is_string:
            return dst.is_string or dst.id in _STRING_PARSE_TARGETS \
                or dst.is_floating
        return not src.is_floating

    def eval_tpu(self, batch):
        c = self.child.eval_tpu(batch)
        if isinstance(c, Scalar):
            return cast_scalar(c, self.to)
        return cast_column(c, self.to)


def cast_column(c: DeviceColumn, dst: T.DType) -> DeviceColumn:
    src = c.dtype
    if src == dst:
        return c
    if src.id is T.TypeId.NULL:
        return _nulls(c.padded_rows, dst, c.validity.device)
    if src.is_string:
        return _cast_from_string(c, dst)
    if dst.is_string:
        return _cast_to_string(c)
    return DeviceColumn(dst, numeric_cast(c.data, src, dst), c.validity)


def cast_scalar(s: Scalar, dst: T.DType) -> Scalar:
    """A literal through the column path, on one CPU row."""
    if s.is_null or s.dtype.id is T.TypeId.NULL:
        return Scalar(dst, None)
    out = cast_column(as_device_column(s, 1, "cpu"), dst)
    if not bool(out.validity[0]):
        return Scalar(dst, None)
    if dst.is_string:
        return Scalar(dst, dstrings.decode_one(out.data[0].numpy(),
                                               int(out.lengths[0])))
    return Scalar(dst, out.data[0].item())


def _nulls(n: int, dst: T.DType, device) -> DeviceColumn:
    validity = torch.zeros(n, dtype=torch.bool, device=device)
    if dst.is_string:
        return DeviceColumn(dst, torch.zeros((n, 1), dtype=torch.uint8,
                                             device=device), validity,
                            torch.zeros(n, dtype=torch.int32, device=device))
    return DeviceColumn(dst, torch.zeros(n, dtype=dst.torch_dtype,
                                         device=device), validity)


def _cast_from_string(c: DeviceColumn, dst: T.DType) -> DeviceColumn:
    """K16: parse; invalid input -> NULL."""
    did = dst.id
    if did is T.TypeId.BOOL:
        data, ok = K.parse_bool(c.data, c.lengths, c.validity)
    elif did is T.TypeId.DATE32:
        data, ok = K.parse_date(c.data, c.lengths, c.validity)
    elif did is T.TypeId.TIMESTAMP:
        data, ok = K.parse_timestamp(c.data, c.lengths, c.validity)
    elif dst.is_floating:
        data, ok = K.parse_float(c.data, c.lengths, c.validity)
        data = data.to(dst.torch_dtype)
    else:  # integral: narrower targets are range-checked, then converted
        data, ok = K.parse_int(c.data, c.lengths, c.validity)
        if did is not T.TypeId.INT64:
            lo, hi = _INT_RANGE[did]
            ok = ok & (data >= lo) & (data <= hi)
            data = data.to(dst.torch_dtype)
    return DeviceColumn(dst, data, ok)


def _cast_to_string(c: DeviceColumn) -> DeviceColumn:
    """K17: format (float -> string is tagged off the device)."""
    sid = c.dtype.id
    if sid is T.TypeId.BOOL:
        bm, lengths = K.format_bool(c.data, c.validity)
    elif sid is T.TypeId.DATE32:
        bm, lengths = K.format_date(c.data, c.validity)
    elif sid is T.TypeId.TIMESTAMP:
        bm, lengths = K.format_timestamp(c.data, c.validity)
    elif c.dtype.is_integral:
        bm, lengths = K.format_int(c.data, c.validity)
    else:
        raise NotImplementedError(
            f"CAST({c.dtype.sql_name} AS string) has no device "
            "implementation")
    return DeviceColumn(T.STRING, bm, c.validity, lengths)


def _float_int_bounds(dst: T.DType):
    """Float-representable clamp bounds: float(2**63-1) rounds UP to 2**63
    which would overflow the int cast, so step down to the largest float
    strictly below the bound."""
    lo, hi = _INT_RANGE[dst.id]
    lo_f, hi_f = float(lo), float(hi)
    if hi_f > hi:
        hi_f = float(np.nextafter(hi_f, 0.0))
    return lo_f, hi_f


def float_to_int(x: torch.Tensor, dst: T.DType) -> torch.Tensor:
    """A float to an integer type as XLA converts: toward zero, NaN to
    0, saturating at the type's range."""
    lo, hi = _INT_RANGE[dst.id]
    x = torch.trunc(x.to(torch.float64))
    x = torch.where(torch.isnan(x), 0.0, x)
    below = x < float(lo)
    above = x >= float(hi + 1)
    safe = torch.where(below | above, 0.0, x).to(dst.torch_dtype)
    return torch.where(below, lo, torch.where(above, hi, safe)).to(
        dst.torch_dtype)


def numeric_cast(data: torch.Tensor, src: T.DType, dst: T.DType
                 ) -> torch.Tensor:
    """The non-string directions (reference: ``_device_cast``)."""
    sid, did = src.id, dst.id
    out = dst.torch_dtype
    if sid is T.TypeId.BOOL:
        return data.to(out)
    if did is T.TypeId.BOOL:
        return data != 0
    if sid is T.TypeId.DATE32:
        if did is T.TypeId.TIMESTAMP:
            return data.to(torch.int64) * MICROS_PER_DAY
        return data.to(out)
    if sid is T.TypeId.TIMESTAMP:
        if did is T.TypeId.DATE32:
            return torch.div(data, MICROS_PER_DAY,
                             rounding_mode="floor").to(torch.int32)
        if dst.is_floating:
            return (data.to(torch.float64) / MICROS_PER_SEC).to(out)
        return torch.div(data, MICROS_PER_SEC, rounding_mode="floor").to(out)
    if did is T.TypeId.TIMESTAMP:
        if src.is_floating:
            return float_to_int(data.to(torch.float64) * MICROS_PER_SEC,
                                T.INT64)
        return data.to(torch.int64) * MICROS_PER_SEC
    if did is T.TypeId.DATE32:
        if src.is_floating:
            return float_to_int(data, T.INT32)
        return data.to(torch.int32)
    if src.is_floating and dst.is_integral:
        # NaN -> 0, clipped in the source's own type (the bounds round
        # there), then converted
        lo_f, hi_f = _float_int_bounds(dst)
        d = torch.where(torch.isnan(data), torch.zeros_like(data), data)
        lo_t = torch.tensor(lo_f, dtype=data.dtype, device=data.device)
        hi_t = torch.tensor(hi_f, dtype=data.dtype, device=data.device)
        return float_to_int(torch.minimum(torch.maximum(d, lo_t), hi_t), dst)
    return data.to(out)


class NormalizeNaNAndZero(Expression):
    """-0.0 becomes 0.0 and every NaN the one canonical NaN, so grouping
    and join keys compare (reference: ``ops/cast.py:401``)."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def child(self):
        return self.children[0]

    @property
    def dtype(self):
        return self.child.dtype

    def eval_tpu(self, batch):
        c = as_device_column(self.child.eval_tpu(batch), batch.padded_rows,
                             batch.device)
        d = c.data
        d = torch.where(d == 0.0, torch.zeros_like(d), d)
        if d.is_floating_point():
            d = torch.where(torch.isnan(d), torch.full_like(d, float("nan")),
                            d)
        return DeviceColumn(c.dtype, d, c.validity)


class KnownFloatingPointNormalized(Expression):
    """A pass-through marker (reference: ``ops/cast.py:435``)."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return self.children[0].dtype

    def eval_tpu(self, batch):
        return self.children[0].eval_tpu(batch)
