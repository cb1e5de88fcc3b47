"""Date parts.

Counterpart of ``spark_rapids_tpu/ops/datetimeexprs.py`` cut to ``Year``
(``:76``), the one date function TPC-H reads (Q7, Q8, Q9).  The calendar
math is the reference's ``_civil_from_days`` (``:23-42``, Hinnant's
branch-free civil-from-days) with ``_to_days`` (``:46-49``), as torch
integer ops: every division floors (``torch.div(...,
rounding_mode="floor")``), as the reference's ``floor_divide`` does, so
dates before 1970 (negative day counts) and timestamps before the epoch
land in the right year.  The result is INT32; a null input gives null.
K12's code generator (``ops/kernels/fused.py``) emits the same integer
steps with a flooring division helper.

Left out, for later slices (ROADMAP A3): Month, DayOfMonth, the time
parts, date arithmetic and the unix-time conversions.
"""
from __future__ import annotations

import torch

from .. import types as T
from .expression import UnaryExpression

#: microseconds in a day (the reference's ``ops/cast.py:MICROS_PER_DAY``)
MICROS_PER_DAY = 86_400_000_000


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z: torch.Tensor):
    """Days since 1970-01-01 (any integer tensor) -> (year, month, day)
    as int64 tensors."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def to_days(data: torch.Tensor, dtype: T.DType) -> torch.Tensor:
    """DATE32 as it is; TIMESTAMP microseconds floored to days."""
    if dtype.id is T.TypeId.TIMESTAMP:
        return _fdiv(data, MICROS_PER_DAY)
    return data


class Year(UnaryExpression):
    """The calendar year of a date or timestamp (UTC), as INT32."""

    def result_dtype(self, ct):
        return T.INT32

    def do_tpu(self, data):
        y, _m, _d = civil_from_days(to_days(data, self.child.dtype))
        return y.to(torch.int32)
