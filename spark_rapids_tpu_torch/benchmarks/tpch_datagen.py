"""Seeded TPC-H-like tables for the Q1, Q3, Q4, Q6, Q12, Q13 and Q14
slices.

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
    dates derived from the order's date, and Q1's seven columns;
  * for Q12–Q14 (``:153-206,249-330``): ``o_comment`` (four comment
    words, ~5% with `` special handle requests`` appended),
    ``l_partkey`` (uniform over the parts), ``l_shipmode`` (one of seven
    modes) and part (``p_partkey`` 1..n, 200,000 at SF1; ``p_type`` from
    TYPE_S1–S3, every 29th ``ECONOMY ANODIZED STEEL``).

String columns are built straight into byte matrices, so SF1 (150,000
customers, 1,500,000 orders, 6,000,000 lines) takes seconds.  The draws
are this module's own: the rows are not the reference generator's rows.
Q1's lineitem rows are drawn first and the Q12–Q14 columns last, so
each query's rows stay what they were before the later columns
existed.  ``dataframes(..., query=q)`` hands a query
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
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
COMMENT_WORDS = ["carefully", "quickly", "furiously", "slyly", "blithely",
                 "express", "regular", "final", "ironic", "pending",
                 "bold", "even", "silent", "unusual", "special",
                 "requests", "deposits", "packages", "accounts", "ideas"]
#: appended to ~5% of order comments (Q13's needles)
Q13_SUFFIX = " special handle requests"

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
    12: {"lineitem": ["l_orderkey", "l_shipdate", "l_commitdate",
                      "l_receiptdate", "l_shipmode"],
         "orders": ["o_orderkey", "o_orderpriority"]},
    13: {"customer": ["c_custkey"],
         "orders": ["o_orderkey", "o_custkey", "o_comment"]},
    14: {"lineitem": ["l_partkey", "l_extendedprice", "l_discount",
                      "l_shipdate"],
         "part": ["p_partkey", "p_type"]},
}
#: the queries that read the columns drawn last
_LATE_QUERIES = (12, 13, 14)


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


def _comments(rng, n: int) -> HostColumn:
    """Four words of COMMENT_WORDS joined by spaces, ~5% followed by
    ``Q13_SUFFIX``, built straight into a byte matrix."""
    words, wlen = dstrings.encode(COMMENT_WORDS)
    idx = rng.integers(0, len(COMMENT_WORDS), (n, 4))
    tagged = rng.random(n) < 0.05
    suffix = np.frombuffer(Q13_SUFFIX.encode(), dtype=np.uint8)
    lengths = (wlen[idx].sum(axis=1) + 3
               + np.where(tagged, len(suffix), 0)).astype(np.int32)
    out = np.zeros((n, int(lengths.max()) if n else 1), dtype=np.uint8)
    rows = np.arange(n)
    pos = np.zeros(n, dtype=np.int64)
    for j in range(4):
        if j:
            out[rows, pos] = ord(" ")
            pos += 1
        wl = wlen[idx[:, j]]
        for c in range(words.shape[1]):
            put = c < wl
            out[rows[put], pos[put] + c] = words[idx[put, j], c]
        pos += wl
    for c, byte in enumerate(suffix):
        out[rows[tagged], pos[tagged] + c] = byte
    return HostColumn(T.STRING, out, None, lengths)


def _draw_late(rng, c: Dict[str, HostColumn], n_ord: int, n_line: int,
               n_part: int) -> None:
    """Q12–Q14's columns, drawn after every other column."""
    types = [f"{a} {b} {t}" for a in TYPE_S1 for b in TYPE_S2
             for t in TYPE_S3]
    p_type = (rng.integers(0, 6, n_part) * 25 + rng.integers(0, 5, n_part)
              * 5 + rng.integers(0, 5, n_part))
    p_type[::29] = types.index("ECONOMY ANODIZED STEEL")
    c.update({
        "o_comment": _comments(rng, n_ord),
        "l_partkey": HostColumn(T.INT64, rng.integers(
            1, n_part + 1, n_line).astype(np.int64)),
        "l_shipmode": _choice_column(rng.integers(0, 7, n_line), SHIPMODES),
        "p_partkey": HostColumn(
            T.INT64, np.arange(1, n_part + 1, dtype=np.int64)),
        "p_type": _choice_column(p_type, types),
    })


def _draw(sf: float, seed: int, n_rows: Optional[int], joins: bool,
          late: bool = False):
    """Every column, by name; the join tables' columns only if
    ``joins``, Q12–Q14's only if ``late``."""
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
    if late:
        n_part = max(8, int(200_000 * sf)) if n_rows is None \
            else max(8, n_ord * 2 // 15)
        _draw_late(rng, c, n_ord, n_line, n_part)
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
    cols = _draw(sf, seed, n_rows, joins=query not in (1, 6),
                 late=query in _LATE_QUERIES)
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
