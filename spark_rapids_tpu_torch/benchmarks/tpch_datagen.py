"""Seeded TPC-H-like lineitem generator for the Q1/Q6 slice.

Counterpart of ``spark_rapids_tpu/benchmarks/tpch_datagen.py:283-330``,
cut to the seven columns Q1 reads (``l_quantity``, ``l_extendedprice``,
``l_discount``, ``l_tax``, ``l_returnflag``, ``l_linestatus``,
``l_shipdate``) with the reference's value distributions.  String
columns are built straight into byte matrices, so SF1 (6,000,000 rows)
takes seconds.  The draws are this module's own: the rows are not the
reference generator's rows.
"""
from __future__ import annotations

import datetime as dt
from typing import Optional

import numpy as np

from .. import types as T
from ..data.column import HostBatch, HostColumn

EPOCH = dt.date(1970, 1, 1)

LINEITEM_Q1_SCHEMA = T.Schema([
    T.Field("l_quantity", T.FLOAT64),
    T.Field("l_extendedprice", T.FLOAT64),
    T.Field("l_discount", T.FLOAT64),
    T.Field("l_tax", T.FLOAT64),
    T.Field("l_returnflag", T.STRING),
    T.Field("l_linestatus", T.STRING),
    T.Field("l_shipdate", T.DATE32),
])


def days(y: int, m: int, d: int) -> int:
    return (dt.date(y, m, d) - EPOCH).days


def _char_column(codes: np.ndarray) -> HostColumn:
    """One-byte strings from their byte codes."""
    n = codes.shape[0]
    return HostColumn(T.STRING, codes.astype(np.uint8).reshape(n, 1), None,
                      np.ones(n, dtype=np.int32))


def lineitem(sf: float = 1.0, seed: int = 42,
             n_rows: Optional[int] = None) -> HostBatch:
    """Q1's lineitem columns at ``sf`` (4 lines per order, 1,500,000
    orders per unit of scale: 6,000,000 rows at SF1), or exactly
    ``n_rows`` rows."""
    rng = np.random.default_rng(seed)
    if n_rows is None:
        n_ord = max(10, int(1_500_000 * sf))
        n_line = n_ord * 4
    else:
        n_line = int(n_rows)
        n_ord = max(1, n_line // 4)
    o_date = rng.integers(days(1992, 1, 1), days(1998, 8, 3), n_ord)
    l_odate = o_date[np.sort(rng.integers(0, n_ord, n_line))]
    l_ship = (l_odate + rng.integers(1, 122, n_line)).astype(np.int32)
    shipped = l_ship <= days(1995, 6, 17)
    returned = rng.random(n_line) < 0.5
    rf = np.where(shipped, np.where(returned, ord("R"), ord("A")), ord("N"))
    ls = np.where(shipped, ord("F"), ord("O"))
    cols = [
        HostColumn(T.FLOAT64, rng.integers(1, 51, n_line).astype(np.float64)),
        HostColumn(T.FLOAT64,
                   np.round(rng.uniform(900.0, 105_000.0, n_line), 2)),
        HostColumn(T.FLOAT64,
                   np.round(rng.integers(0, 11, n_line) * 0.01, 2)),
        HostColumn(T.FLOAT64, np.round(rng.integers(0, 9, n_line) * 0.01, 2)),
        _char_column(rf),
        _char_column(ls),
        HostColumn(T.DATE32, l_ship),
    ]
    return HostBatch(LINEITEM_Q1_SCHEMA, cols)


def dataframes(session, sf: float = 1.0, seed: int = 42,
               n_rows: Optional[int] = None):
    """``{"lineitem": DataFrame}`` on ``session``, one partition."""
    return {"lineitem": session.create_dataframe(
        lineitem(sf, seed, n_rows), n_partitions=1)}
