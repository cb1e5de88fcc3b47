"""Seeded TPC-H-like tables for the Q1, Q3, Q4 and Q6 slices.

Counterpart of ``spark_rapids_tpu/benchmarks/tpch_datagen.py``, cut to
the columns those queries read, with the reference's value
distributions:

  * customer (``:225-247``): ``c_custkey`` 1..n, ``c_mktsegment`` one of
    five segments;
  * orders (``:249-281``): sparse ``o_orderkey`` = 4i - 3, ``o_custkey``
    drawn from the lower ~85% of customer keys (the top ~15% place no
    orders), ``o_orderdate``, ``o_orderpriority``, ``o_shippriority``;
  * lineitem (``:283-330``): each line picks its order through the
    reference's ``li_ord_idx`` scheme (sorted uniform draws, so lines per
    order vary), with ``l_orderkey`` and the ship, commit and receipt
    dates derived from the order's date, and Q1's seven columns.

String columns are built straight into byte matrices, so SF1 (150,000
customers, 1,500,000 orders, 6,000,000 lines) takes seconds.  The draws
are this module's own: the rows are not the reference generator's rows.
Q1's lineitem rows are drawn first, so they stay what they were before
the join columns existed.  ``dataframes(..., query=q)`` hands a query
only the columns it reads, at the reference's default of two partitions
unless told otherwise.
"""
from __future__ import annotations

import datetime as dt
from typing import Dict, List, Optional

import numpy as np

from .. import types as T
from ..data import strings as dstrings
from ..data.column import HostBatch, HostColumn

EPOCH = dt.date(1970, 1, 1)

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]

LINEITEM_Q1_SCHEMA = T.Schema([
    T.Field("l_quantity", T.FLOAT64),
    T.Field("l_extendedprice", T.FLOAT64),
    T.Field("l_discount", T.FLOAT64),
    T.Field("l_tax", T.FLOAT64),
    T.Field("l_returnflag", T.STRING),
    T.Field("l_linestatus", T.STRING),
    T.Field("l_shipdate", T.DATE32),
])

#: the columns each query reads, by table, in the reference's order
QUERY_COLUMNS: Dict[int, Dict[str, List[str]]] = {
    1: {"lineitem": LINEITEM_Q1_SCHEMA.names},
    6: {"lineitem": LINEITEM_Q1_SCHEMA.names},
    3: {"customer": ["c_custkey", "c_mktsegment"],
        "orders": ["o_orderkey", "o_custkey", "o_orderdate",
                   "o_shippriority"],
        "lineitem": ["l_orderkey", "l_extendedprice", "l_discount",
                     "l_shipdate"]},
    4: {"orders": ["o_orderkey", "o_orderdate", "o_orderpriority"],
        "lineitem": ["l_orderkey", "l_commitdate", "l_receiptdate"]},
}


def days(y: int, m: int, d: int) -> int:
    return (dt.date(y, m, d) - EPOCH).days


def _char_column(codes: np.ndarray) -> HostColumn:
    """One-byte strings from their byte codes."""
    n = codes.shape[0]
    return HostColumn(T.STRING, codes.astype(np.uint8).reshape(n, 1), None,
                      np.ones(n, dtype=np.int32))


def _choice_column(codes: np.ndarray, choices: List[str]) -> HostColumn:
    """Strings ``choices[codes]`` as a byte matrix of the widest choice."""
    bm, ln = dstrings.encode(choices)
    return HostColumn(T.STRING, bm[codes], None, ln[codes])


def _sizes(sf: float, n_rows: Optional[int]):
    """(orders, lines): 1,500,000 orders and 4 lines an order per unit of
    scale, or exactly ``n_rows`` lines."""
    if n_rows is None:
        n_ord = max(10, int(1_500_000 * sf))
        return n_ord, n_ord * 4
    return max(1, int(n_rows) // 4), int(n_rows)


def _draw(sf: float, seed: int, n_rows: Optional[int], joins: bool):
    """Every column, by name; the join tables' columns only if
    ``joins``."""
    rng = np.random.default_rng(seed)
    n_ord, n_line = _sizes(sf, n_rows)
    o_date = rng.integers(days(1992, 1, 1), days(1998, 8, 3), n_ord)
    li_ord_idx = np.sort(rng.integers(0, n_ord, n_line))
    l_odate = o_date[li_ord_idx]
    l_ship = (l_odate + rng.integers(1, 122, n_line)).astype(np.int32)
    shipped = l_ship <= days(1995, 6, 17)
    returned = rng.random(n_line) < 0.5
    rf = np.where(shipped, np.where(returned, ord("R"), ord("A")), ord("N"))
    ls = np.where(shipped, ord("F"), ord("O"))
    c = {
        "l_quantity": HostColumn(
            T.FLOAT64, rng.integers(1, 51, n_line).astype(np.float64)),
        "l_extendedprice": HostColumn(
            T.FLOAT64, np.round(rng.uniform(900.0, 105_000.0, n_line), 2)),
        "l_discount": HostColumn(
            T.FLOAT64, np.round(rng.integers(0, 11, n_line) * 0.01, 2)),
        "l_tax": HostColumn(
            T.FLOAT64, np.round(rng.integers(0, 9, n_line) * 0.01, 2)),
        "l_returnflag": _char_column(rf),
        "l_linestatus": _char_column(ls),
        "l_shipdate": HostColumn(T.DATE32, l_ship),
    }
    if not joins:
        return c
    n_cust = max(5, int(150_000 * sf)) if n_rows is None \
        else max(5, n_ord // 10)
    o_key = np.arange(1, n_ord + 1, dtype=np.int64) * 4 - 3
    c.update({
        "l_orderkey": HostColumn(T.INT64, o_key[li_ord_idx]),
        "l_commitdate": HostColumn(T.DATE32, (
            l_odate + rng.integers(30, 91, n_line)).astype(np.int32)),
        "l_receiptdate": HostColumn(T.DATE32, (
            l_ship + rng.integers(1, 31, n_line)).astype(np.int32)),
        "c_custkey": HostColumn(
            T.INT64, np.arange(1, n_cust + 1, dtype=np.int64)),
        "c_mktsegment": _choice_column(rng.integers(0, 5, n_cust),
                                       SEGMENTS),
        "o_orderkey": HostColumn(T.INT64, o_key),
        "o_custkey": HostColumn(T.INT64, rng.integers(
            1, max(2, int(n_cust * 0.85)) + 1, n_ord).astype(np.int64)),
        "o_orderdate": HostColumn(T.DATE32, o_date.astype(np.int32)),
        "o_orderpriority": _choice_column(rng.integers(0, 5, n_ord),
                                          PRIORITIES),
        "o_shippriority": HostColumn(T.INT32,
                                     np.zeros(n_ord, dtype=np.int32)),
    })
    return c


def _batch(cols: Dict[str, HostColumn], names: List[str]) -> HostBatch:
    return HostBatch(T.Schema([T.Field(n, cols[n].dtype) for n in names]),
                     [cols[n] for n in names])


def lineitem(sf: float = 1.0, seed: int = 42,
             n_rows: Optional[int] = None) -> HostBatch:
    """Q1's lineitem columns at ``sf`` (6,000,000 rows at SF1), or
    exactly ``n_rows`` rows."""
    return _batch(_draw(sf, seed, n_rows, joins=False),
                  LINEITEM_Q1_SCHEMA.names)


def tables(query: int, sf: float = 1.0, seed: int = 42,
           n_rows: Optional[int] = None) -> Dict[str, HostBatch]:
    """The tables ``query`` reads, each with only the columns it reads."""
    if query not in QUERY_COLUMNS:
        raise ValueError(f"no table layout for TPC-H Q{query}")
    cols = _draw(sf, seed, n_rows, joins=query not in (1, 6))
    return {t: _batch(cols, names)
            for t, names in QUERY_COLUMNS[query].items()}


def dataframes(session, sf: float = 1.0, seed: int = 42,
               n_rows: Optional[int] = None, query: int = 1,
               n_partitions: int = 2):
    """The tables of ``query`` as DataFrames on ``session`` (Q1's
    lineitem when no query is named), each split over ``n_partitions``:
    two by default, the reference's ``create_dataframe`` default, as the
    reference's own ``tpch_datagen.dataframes`` builds its tables."""
    return {t: session.create_dataframe(b, n_partitions=n_partitions)
            for t, b in tables(query, sf, seed, n_rows).items()}
