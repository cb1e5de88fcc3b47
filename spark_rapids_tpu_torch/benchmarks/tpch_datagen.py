"""Seeded TPC-H-like tables, at SF1 for the chip and bit for bit as the
reference generates them for the tests.

Counterpart of ``spark_rapids_tpu/benchmarks/tpch_datagen.py``, in two
forms.

``generate(sf, seed)`` is the reference's ``generate`` (``:96-336``),
drawing every table in the same order from one
``numpy.random.default_rng(seed)``, so it returns the reference's arrays
bit for bit (strings as object arrays of ``str``); ``reference_tables``
turns them into this engine's host batches.  It builds strings one row
at a time, so it serves the tests' small scales.

``tables(query, sf, seed)`` is a fast generator for SF1 (150,000
customers, 1,500,000 orders, 6,000,000 lines, 200,000 parts, 800,000
partsupp rows, 10,000 suppliers, the 25 nations and 5 regions), with the
reference's value distributions and needles, each table cut to the
columns its query reads:

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
    TYPE_S1–S3, every 29th ``ECONOMY ANODIZED STEEL``);
  * for Q2, Q5, Q7–Q11 and Q15–Q22 (``:29-44,74,108-247,267-326``):
    region and nation (the 25 standard nations), supplier (``s_name``
    ``Supplier#%09d``, two-word addresses, nations biased toward the
    workloads' nations with the first eight ``_FOCUS_NATIONS``, phones
    ``cc-ddd-ddd-dddd`` with country codes 10–34, ~10% of comments with
    `` Customer Complaints``), the rest of part (``p_name`` three
    distinct colours, ~8% starting ``forest ``; ``p_mfgr``, ``p_brand``
    correlated with ``p_container`` for about half the parts, ``p_size``
    1–50), partsupp (four suppliers a part by the reference's formula,
    ``ps_availqty`` INT32), the rest of customer (names, addresses,
    nations, phones, balances, comments), ``o_orderstatus`` (O, F or P),
    ``o_totalprice``, ``l_suppkey`` (one of the part's four partsupp
    suppliers) and ``l_shipinstruct``.

String columns are built straight into byte matrices, so SF1 takes
seconds.  The draws are this module's own: the rows are not the
reference generator's rows.  Q1's lineitem rows are drawn first, the
Q12–Q14 columns next and the columns of the other queries last, so each
query's rows stay what they were before the later columns existed.
``dataframes(..., query=q)`` hands a query only the columns it reads, at
the reference's default of two partitions unless told otherwise;
``draw_all`` draws every column once for many queries.

``lineitem_text`` prints lineitem's Q1/Q6 columns and ``l_orderkey`` as
dbgen's ``lineitem.tbl`` does (keys and quantities as integers, money
``%.2f``, dates ``YYYY-MM-DD``), every field a string column, beside the
typed columns it was printed from; ``export_lines`` gives the bytes of
the text export's line (dbgen's line without ``l_linenumber``, the three
money fields and ``l_comment``).  Both work on whole columns in numpy,
never through Python strings.

``write_parquet(session, path, sf, seed)`` writes ``generate``'s eight
tables as Parquet directories ``path/<table>/`` through the session's
write path, as the reference's ``write_parquet`` (``:345``) does.
"""
from __future__ import annotations

import datetime as dt
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .. import types as T
from ..data import strings as dstrings
from ..data.column import HostBatch, HostColumn
from ..interop import from_reference_arrays
from ._util import pick, schema_of

EPOCH = dt.date(1970, 1, 1)
MICROS_PER_DAY = 86_400_000_000

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [  # (name, regionkey) — the 25 standard TPC-H nations
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
          "cream", "cyan", "dark", "deep", "dim", "dodger", "drab",
          "firebrick", "floral", "forest", "frosted", "gainsboro",
          "ghost", "goldenrod", "green", "grey", "honeydew", "hot",
          "indian", "ivory", "khaki", "lace", "lavender"]
COMMENT_WORDS = ["carefully", "quickly", "furiously", "slyly", "blithely",
                 "express", "regular", "final", "ironic", "pending",
                 "bold", "even", "silent", "unusual", "special",
                 "requests", "deposits", "packages", "accounts", "ideas"]
#: appended to ~5% of order comments (Q13's needles)
Q13_SUFFIX = " special handle requests"
#: appended to ~10% of supplier comments (Q16's needle)
Q16_SUFFIX = " Customer Complaints"

# The nation draw is biased toward the nations the queries name (FRANCE
# and GERMANY for Q7, ASIA's nations for Q5, SAUDI ARABIA for Q21,
# CANADA for Q20, BRAZIL for Q8), and the first rows of a table take the
# eight focus nations, as in the reference (``:61-83``).
_NATION_WEIGHTS = np.ones(25)
for _k in (2, 3, 6, 7, 8, 9, 12, 18, 20, 21):
    _NATION_WEIGHTS[_k] = 4.0
_NATION_WEIGHTS = _NATION_WEIGHTS / _NATION_WEIGHTS.sum()
_FOCUS_NATIONS = np.array([20, 3, 6, 7, 2, 8, 9, 12], dtype=np.int64)

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
QUERY_COLUMNS: Dict[Union[int, str], Dict[str, List[str]]] = {
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
    2: {"part": ["p_partkey", "p_mfgr", "p_type", "p_size"],
        "region": ["r_regionkey", "r_name"],
        "nation": ["n_nationkey", "n_name", "n_regionkey"],
        "supplier": ["s_suppkey", "s_name", "s_address", "s_nationkey",
                     "s_phone", "s_acctbal", "s_comment"],
        "partsupp": ["ps_partkey", "ps_suppkey", "ps_supplycost"]},
    5: {"region": ["r_regionkey", "r_name"],
        "nation": ["n_nationkey", "n_name", "n_regionkey"],
        "customer": ["c_custkey", "c_nationkey"],
        "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
        "lineitem": ["l_orderkey", "l_suppkey", "l_extendedprice",
                     "l_discount"],
        "supplier": ["s_suppkey", "s_nationkey"]},
    7: {"nation": ["n_nationkey", "n_name"],
        "supplier": ["s_suppkey", "s_nationkey"],
        "lineitem": ["l_orderkey", "l_suppkey", "l_extendedprice",
                     "l_discount", "l_shipdate"],
        "orders": ["o_orderkey", "o_custkey"],
        "customer": ["c_custkey", "c_nationkey"]},
    8: {"region": ["r_regionkey", "r_name"],
        "nation": ["n_nationkey", "n_name", "n_regionkey"],
        "part": ["p_partkey", "p_type"],
        "lineitem": ["l_orderkey", "l_partkey", "l_suppkey",
                     "l_extendedprice", "l_discount"],
        "supplier": ["s_suppkey", "s_nationkey"],
        "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
        "customer": ["c_custkey", "c_nationkey"]},
    9: {"part": ["p_partkey", "p_name"],
        "lineitem": ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                     "l_extendedprice", "l_discount"],
        "supplier": ["s_suppkey", "s_nationkey"],
        "partsupp": ["ps_partkey", "ps_suppkey", "ps_supplycost"],
        "orders": ["o_orderkey", "o_orderdate"],
        "nation": ["n_nationkey", "n_name"]},
    10: {"customer": ["c_custkey", "c_name", "c_address", "c_nationkey",
                      "c_phone", "c_acctbal", "c_comment"],
         "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
         "lineitem": ["l_orderkey", "l_extendedprice", "l_discount",
                      "l_returnflag"],
         "nation": ["n_nationkey", "n_name"]},
    11: {"partsupp": ["ps_partkey", "ps_suppkey", "ps_availqty",
                      "ps_supplycost"],
         "supplier": ["s_suppkey", "s_nationkey"],
         "nation": ["n_nationkey", "n_name"]},
    15: {"lineitem": ["l_suppkey", "l_extendedprice", "l_discount",
                      "l_shipdate"],
         "supplier": ["s_suppkey", "s_name", "s_address", "s_phone"]},
    16: {"part": ["p_partkey", "p_brand", "p_type", "p_size"],
         "supplier": ["s_suppkey", "s_comment"],
         "partsupp": ["ps_partkey", "ps_suppkey"]},
    17: {"part": ["p_partkey", "p_brand", "p_container"],
         "lineitem": ["l_partkey", "l_quantity", "l_extendedprice"]},
    18: {"lineitem": ["l_orderkey", "l_quantity"],
         "orders": ["o_orderkey", "o_custkey", "o_totalprice",
                    "o_orderdate"],
         "customer": ["c_custkey", "c_name"]},
    19: {"lineitem": ["l_partkey", "l_quantity", "l_extendedprice",
                      "l_discount", "l_shipinstruct", "l_shipmode"],
         "part": ["p_partkey", "p_brand", "p_size", "p_container"]},
    20: {"part": ["p_partkey", "p_name"],
         "lineitem": ["l_partkey", "l_suppkey", "l_quantity",
                      "l_shipdate"],
         "partsupp": ["ps_partkey", "ps_suppkey", "ps_availqty"],
         "nation": ["n_nationkey", "n_name"],
         "supplier": ["s_suppkey", "s_name", "s_address", "s_nationkey"]},
    21: {"lineitem": ["l_orderkey", "l_suppkey", "l_commitdate",
                      "l_receiptdate"],
         "orders": ["o_orderkey", "o_orderstatus"],
         "supplier": ["s_suppkey", "s_name", "s_nationkey"],
         "nation": ["n_nationkey", "n_name"]},
    22: {"customer": ["c_custkey", "c_phone", "c_acctbal"],
         "orders": ["o_custkey"]},
    # benchmarks/tpch_clean.py
    "orders_profile": {"orders": ["o_orderpriority", "o_comment"]},
    "customer_clean": {"customer": ["c_name", "c_phone", "c_address",
                                    "c_mktsegment", "c_comment"]},
}
#: the queries that read the Q12–Q14 columns, and the columns drawn last
_LATE_QUERIES = (12, 13, 14)
_REST_QUERIES = (2, 5, 7, 8, 9, 10, 11, 15, 16, 17, 18, 19, 20, 21, 22,
                 "orders_profile", "customer_clean")


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


def _join_words(words: np.ndarray, wlen: np.ndarray, idx: np.ndarray,
                tagged: np.ndarray, suffix: bytes) -> HostColumn:
    """Rows of the words ``idx[i]`` (indices into the byte matrix
    ``words``) joined by spaces, each ``tagged`` row followed by
    ``suffix``, built straight into a byte matrix."""
    n, k = idx.shape
    tail = np.frombuffer(suffix, dtype=np.uint8)
    lengths = (wlen[idx].sum(axis=1) + (k - 1)
               + np.where(tagged, len(tail), 0)).astype(np.int32)
    out = np.zeros((n, int(lengths.max()) if n else 1), dtype=np.uint8)
    rows = np.arange(n)
    pos = np.zeros(n, dtype=np.int64)
    for j in range(k):
        if j:
            out[rows, pos] = ord(" ")
            pos += 1
        wl = wlen[idx[:, j]]
        for c in range(words.shape[1]):
            put = c < wl
            out[rows[put], pos[put] + c] = words[idx[put, j], c]
        pos += wl
    for c, byte in enumerate(tail):
        out[rows[tagged], pos[tagged] + c] = byte
    return HostColumn(T.STRING, out, None, lengths)


def _comments(rng, n: int, k: int = 4, suffix: str = Q13_SUFFIX,
              share: float = 0.05) -> HostColumn:
    """``k`` words of COMMENT_WORDS joined by spaces, ~``share`` of the
    rows followed by ``suffix`` (none drawn without a suffix)."""
    words, wlen = dstrings.encode(COMMENT_WORDS)
    idx = rng.integers(0, len(COMMENT_WORDS), (n, k))
    tagged = rng.random(n) < share if suffix else np.zeros(n, bool)
    return _join_words(words, wlen, idx, tagged, suffix.encode())


def _digits(values: np.ndarray, k: int) -> np.ndarray:
    """uint8[n, k]: the ASCII digits of non-negative ``values``, zero
    padded to ``k`` places."""
    scale = 10 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    return (values.astype(np.int64)[:, None] // scale % 10 + 48) \
        .astype(np.uint8)


def _concat(*parts) -> HostColumn:
    """Fixed-width strings side by side: each part a ``bytes`` literal or
    a uint8[n, k] matrix."""
    n = next(p.shape[0] for p in parts if isinstance(p, np.ndarray))
    mats = [np.broadcast_to(np.frombuffer(p, dtype=np.uint8), (n, len(p)))
            if isinstance(p, bytes) else p for p in parts]
    out = np.ascontiguousarray(np.concatenate(mats, axis=1))
    return HostColumn(T.STRING, out, None,
                      np.full(n, out.shape[1], dtype=np.int32))


def _phones(rng, n: int) -> HostColumn:
    """``cc-ddd-ddd-dddd`` with a country code of 10–34 (``:240-242``)."""
    cc = rng.integers(10, 35, n)
    a = rng.integers(100, 1000, n)
    b = rng.integers(100, 1000, n)
    d = rng.integers(1000, 10000, n)
    return _concat(_digits(cc, 2), b"-", _digits(a, 3), b"-",
                   _digits(b, 3), b"-", _digits(d, 4))


def _nations(rng, n: int) -> np.ndarray:
    """Nation keys drawn with the reference's weights, the first rows
    the focus nations (``:77-83``)."""
    out = rng.choice(25, size=n, p=_NATION_WEIGHTS).astype(np.int64)
    k = min(n, len(_FOCUS_NATIONS))
    out[:k] = _FOCUS_NATIONS[:k]
    return out


def _money(rng, lo: float, hi: float, n: int) -> HostColumn:
    return HostColumn(T.FLOAT64, np.round(rng.uniform(lo, hi, n), 2))


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


def _draw_rest(rng, c: Dict[str, HostColumn], n_ord: int, n_line: int,
               n_part: int, n_cust: int, n_supp: int) -> None:
    """The columns of Q2, Q5, Q7–Q11 and Q15–Q22, drawn after every
    other column, with the reference's distributions (``:108-326``)."""
    region, reg_len = dstrings.encode(REGIONS)
    nation, nat_len = dstrings.encode([name for name, _r in NATIONS])
    c.update({
        "r_regionkey": HostColumn(T.INT64, np.arange(5, dtype=np.int64)),
        "r_name": HostColumn(T.STRING, region, None, reg_len),
        "n_nationkey": HostColumn(T.INT64, np.arange(25, dtype=np.int64)),
        "n_name": HostColumn(T.STRING, nation, None, nat_len),
        "n_regionkey": HostColumn(T.INT64, np.array(
            [r for _n, r in NATIONS], dtype=np.int64)),
    })
    # supplier (:116-141)
    sk = np.arange(1, n_supp + 1, dtype=np.int64)
    c.update({
        "s_suppkey": HostColumn(T.INT64, sk),
        "s_name": _concat(b"Supplier#", _digits(sk, 9)),
        "s_comment": _comments(rng, n_supp, suffix=Q16_SUFFIX, share=0.1),
        "s_address": _comments(rng, n_supp, 2, suffix=""),
        "s_nationkey": HostColumn(T.INT64, _nations(rng, n_supp)),
        "s_phone": _phones(rng, n_supp),
        "s_acctbal": _money(rng, -999.99, 9999.99, n_supp),
    })
    # the rest of part (:143-206): three distinct colours, ~8% of the
    # names starting "forest"; brand digits correlated with the
    # container's size for about half the parts
    colors, clen = dstrings.encode(COLORS)
    pick = np.argsort(rng.random((n_part, len(COLORS))), axis=1)[:, :3]
    forest = rng.random(n_part) < 0.08
    pick[forest] = np.column_stack([
        np.full(int(forest.sum()), COLORS.index("forest")),
        pick[forest, :2]])
    brand_m = rng.integers(1, 6, n_part)
    brand_n = rng.integers(1, 6, n_part)
    cont_a = rng.integers(0, 5, n_part)
    cont_b = rng.integers(0, 8, n_part)
    corr = rng.random(n_part) < 0.5
    brand_m[corr & (cont_a == 0)] = 1   # SM * -> Brand#1n
    brand_m[corr & (cont_a == 2)] = 2   # MED * -> Brand#2n
    brand_m[corr & (cont_a == 1)] = 3   # LG * -> Brand#3n
    containers = [f"{a} {b}" for a in CONTAINER_1 for b in CONTAINER_2]
    c.update({
        "p_name": _join_words(colors, clen, pick, np.zeros(n_part, bool),
                              b""),
        "p_mfgr": _concat(b"Manufacturer#",
                          _digits(rng.integers(1, 6, n_part), 1)),
        "p_brand": _concat(b"Brand#", _digits(brand_m, 1),
                           _digits(brand_n, 1)),
        "p_size": HostColumn(T.INT32, rng.integers(1, 51, n_part)
                             .astype(np.int32)),
        "p_container": _choice_column(cont_a * 8 + cont_b, containers),
    })
    # partsupp (:208-223): four suppliers a part
    ps_part = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
    ps_supp = ((ps_part + np.tile(np.arange(4, dtype=np.int64), n_part)
                * (n_supp // 4 + 1)) % n_supp) + 1
    c.update({
        "ps_partkey": HostColumn(T.INT64, ps_part),
        "ps_suppkey": HostColumn(T.INT64, ps_supp),
        "ps_availqty": HostColumn(T.INT32, rng.integers(
            1, 10_000, 4 * n_part).astype(np.int32)),
        "ps_supplycost": _money(rng, 1.0, 1000.0, 4 * n_part),
    })
    # the rest of customer (:225-247) and orders (:249-281)
    ck = c["c_custkey"].data
    c.update({
        "c_name": _concat(b"Customer#", _digits(ck, 9)),
        "c_address": _comments(rng, n_cust, 2, suffix=""),
        "c_nationkey": HostColumn(T.INT64, _nations(rng, n_cust)),
        "c_phone": _phones(rng, n_cust),
        "c_acctbal": _money(rng, -999.99, 9999.99, n_cust),
        "c_comment": _comments(rng, n_cust, suffix=""),
        "o_orderstatus": _choice_column(rng.integers(0, 3, n_ord),
                                        ["O", "F", "P"]),
        "o_totalprice": _money(rng, 850.0, 560_000.0, n_ord),
    })
    # the rest of lineitem (:283-326): (l_partkey, l_suppkey) from
    # partsupp, as in TPC-H
    l_part = c["l_partkey"].data
    c.update({
        "l_suppkey": HostColumn(T.INT64, ps_supp[
            (l_part - 1) * 4 + rng.integers(0, 4, n_line)]),
        "l_shipinstruct": _choice_column(rng.integers(0, 4, n_line),
                                         INSTRUCTS),
    })


def _draw(sf: float, seed: int, n_rows: Optional[int], joins: bool,
          late: bool = False, rest: bool = False):
    """Every column, by name; the join tables' columns only if
    ``joins``, Q12–Q14's only if ``late``, the other queries' only if
    ``rest`` (which implies both)."""
    late = late or rest
    joins = joins or late
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
    if rest:
        n_supp = max(3, int(10_000 * sf)) if n_rows is None \
            else max(3, n_ord // 150)
        _draw_rest(rng, c, n_ord, n_line, n_part, n_cust, n_supp)
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


def draw_all(sf: float = 1.0, seed: int = 42,
             n_rows: Optional[int] = None) -> Dict[str, HostColumn]:
    """Every column of every table, once, for ``tables(..., cols=)``:
    each query's rows equal those of its own draw."""
    return _draw(sf, seed, n_rows, joins=True, rest=True)


def tables(query: Union[int, str], sf: float = 1.0, seed: int = 42,
           n_rows: Optional[int] = None,
           cols: Optional[Dict[str, HostColumn]] = None
           ) -> Dict[str, HostBatch]:
    """The tables ``query`` reads, each with only the columns it reads
    (cut from ``cols``, a ``draw_all`` of the same arguments, when
    given)."""
    if query not in QUERY_COLUMNS:
        raise ValueError(f"no table layout for TPC-H query {query!r}")
    if cols is None:
        cols = _draw(sf, seed, n_rows, joins=query not in (1, 6),
                     late=query in _LATE_QUERIES,
                     rest=query in _REST_QUERIES)
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


# ---------------------------------------------------------------------------
# the reference's generator, draw for draw
# ---------------------------------------------------------------------------
def _comment(rng, n, k=4):
    words = np.array(COMMENT_WORDS, dtype=object)
    idx = rng.integers(0, len(words), (n, k))
    return np.array([" ".join(words[r]) for r in idx], dtype=object)


def generate(sf: float = 0.001, seed: int = 42):
    """Return {table: (Schema, {col: np.ndarray})} at ~sf × TPC-H scale,
    the reference's arrays bit for bit."""
    rng = np.random.default_rng(seed)
    n_supp = max(3, int(10_000 * sf))
    n_part = max(8, int(200_000 * sf))
    n_psupp = n_part * 4
    n_cust = max(5, int(150_000 * sf))
    n_ord = max(10, int(1_500_000 * sf))
    n_line = int(n_ord * 4)

    out = {}

    # region / nation -------------------------------------------------------
    out["region"] = (schema_of([("r_regionkey", T.INT64),
                              ("r_name", T.STRING),
                              ("r_comment", T.STRING)]),
                     {"r_regionkey": np.arange(5, dtype=np.int64),
                      "r_name": np.array(REGIONS, dtype=object),
                      "r_comment": _comment(rng, 5)})
    out["nation"] = (schema_of([("n_nationkey", T.INT64),
                              ("n_name", T.STRING),
                              ("n_regionkey", T.INT64),
                              ("n_comment", T.STRING)]),
                     {"n_nationkey": np.arange(25, dtype=np.int64),
                      "n_name": np.array([n for n, _ in NATIONS],
                                         dtype=object),
                      "n_regionkey": np.array([r for _, r in NATIONS],
                                              dtype=np.int64),
                      "n_comment": _comment(rng, 25)})

    # supplier ---------------------------------------------------------------
    sk = np.arange(1, n_supp + 1, dtype=np.int64)
    s_comment = _comment(rng, n_supp)
    # Q16 needle: some suppliers have complaints
    mask = rng.random(n_supp) < 0.1
    s_comment[mask] = np.char.add(
        s_comment[mask].astype(str), " Customer Complaints").astype(object)
    out["supplier"] = (schema_of([("s_suppkey", T.INT64),
                                ("s_name", T.STRING),
                                ("s_address", T.STRING),
                                ("s_nationkey", T.INT64),
                                ("s_phone", T.STRING),
                                ("s_acctbal", T.FLOAT64),
                                ("s_comment", T.STRING)]),
                       {"s_suppkey": sk,
                        "s_name": np.array([f"Supplier#{i:09d}" for i in sk],
                                           dtype=object),
                        "s_address": _comment(rng, n_supp, 2),
                        "s_nationkey": _nations(rng, n_supp),
                        "s_phone": np.array(
                            [f"{rng.integers(10, 35)}-{rng.integers(100, 1000)}"
                             f"-{rng.integers(100, 1000)}-{rng.integers(1000, 10000)}"
                             for _ in sk], dtype=object),
                        "s_acctbal": np.round(
                            rng.uniform(-999.99, 9999.99, n_supp), 2),
                        "s_comment": s_comment})

    # part -------------------------------------------------------------------
    pk = np.arange(1, n_part + 1, dtype=np.int64)
    p_name = np.array(
        [" ".join(rng.choice(COLORS, size=3, replace=False))
         for _ in pk], dtype=object)
    # Q20 needle: ~8% of part names start with "forest"
    fmask = rng.random(n_part) < 0.08
    p_name[fmask] = np.array(
        ["forest " + " ".join(rng.choice(COLORS, size=2, replace=False))
         for _ in range(int(fmask.sum()))], dtype=object)
    p_type = np.array(
        [f"{TYPE_S1[a]} {TYPE_S2[b]} {TYPE_S3[c]}"
         for a, b, c in zip(rng.integers(0, 6, n_part),
                            rng.integers(0, 5, n_part),
                            rng.integers(0, 5, n_part))], dtype=object)
    p_type[::29] = "ECONOMY ANODIZED STEEL"  # Q8's exact-match needle
    # brand digits and container sizes correlated for ~half the parts so
    # the Q17/Q19 (brand, container) conjunctions select non-empty sets
    brand_m = rng.integers(1, 6, n_part)
    brand_n = rng.integers(1, 6, n_part)
    cont_a = rng.integers(0, 5, n_part)
    cont_b = rng.integers(0, 8, n_part)
    corr = rng.random(n_part) < 0.5
    brand_m[corr & (cont_a == 0)] = 1   # SM * -> Brand#1n
    brand_m[corr & (cont_a == 2)] = 2   # MED * -> Brand#2n
    brand_m[corr & (cont_a == 1)] = 3   # LG * -> Brand#3n
    # (MED BOX & Brand#23 for Q17 happens naturally via the correlation)
    out["part"] = (schema_of([("p_partkey", T.INT64),
                            ("p_name", T.STRING),
                            ("p_mfgr", T.STRING),
                            ("p_brand", T.STRING),
                            ("p_type", T.STRING),
                            ("p_size", T.INT32),
                            ("p_container", T.STRING),
                            ("p_retailprice", T.FLOAT64),
                            ("p_comment", T.STRING)]),
                   {"p_partkey": pk,
                    "p_name": p_name,
                    "p_mfgr": np.array(
                        [f"Manufacturer#{m}" for m in
                         rng.integers(1, 6, n_part)], dtype=object),
                    "p_brand": np.array(
                        [f"Brand#{m}{n}" for m, n in
                         zip(brand_m, brand_n)], dtype=object),
                    "p_type": p_type,
                    "p_size": rng.integers(1, 51, n_part).astype(np.int32),
                    "p_container": np.array(
                        [f"{CONTAINER_1[a]} {CONTAINER_2[b]}"
                         for a, b in zip(cont_a, cont_b)],
                        dtype=object),
                    "p_retailprice": np.round(
                        900 + (pk % 1000) * 0.1 + (pk % 100), 2)
                    .astype(np.float64),
                    "p_comment": _comment(rng, n_part, 2)})

    # partsupp ---------------------------------------------------------------
    ps_part = np.repeat(pk, 4)
    ps_supp = ((ps_part + np.tile(np.arange(4, dtype=np.int64), n_part)
                * (n_supp // 4 + 1)) % n_supp) + 1
    out["partsupp"] = (schema_of([("ps_partkey", T.INT64),
                                ("ps_suppkey", T.INT64),
                                ("ps_availqty", T.INT32),
                                ("ps_supplycost", T.FLOAT64),
                                ("ps_comment", T.STRING)]),
                       {"ps_partkey": ps_part,
                        "ps_suppkey": ps_supp,
                        "ps_availqty": rng.integers(1, 10_000, n_psupp)
                        .astype(np.int32),
                        "ps_supplycost": np.round(
                            rng.uniform(1.0, 1000.0, n_psupp), 2),
                        "ps_comment": _comment(rng, n_psupp, 2)})

    # customer ---------------------------------------------------------------
    ck = np.arange(1, n_cust + 1, dtype=np.int64)
    out["customer"] = (schema_of([("c_custkey", T.INT64),
                                ("c_name", T.STRING),
                                ("c_address", T.STRING),
                                ("c_nationkey", T.INT64),
                                ("c_phone", T.STRING),
                                ("c_acctbal", T.FLOAT64),
                                ("c_mktsegment", T.STRING),
                                ("c_comment", T.STRING)]),
                       {"c_custkey": ck,
                        "c_name": np.array(
                            [f"Customer#{i:09d}" for i in ck], dtype=object),
                        "c_address": _comment(rng, n_cust, 2),
                        "c_nationkey": _nations(rng, n_cust),
                        "c_phone": np.array(
                            [f"{rng.integers(10, 35)}-{rng.integers(100, 1000)}"
                             f"-{rng.integers(100, 1000)}-{rng.integers(1000, 10000)}"
                             for _ in ck], dtype=object),
                        "c_acctbal": np.round(
                            rng.uniform(-999.99, 9999.99, n_cust), 2),
                        "c_mktsegment": pick(rng, n_cust, SEGMENTS),
                        "c_comment": _comment(rng, n_cust)})

    # orders -----------------------------------------------------------------
    ok = np.arange(1, n_ord + 1, dtype=np.int64) * 4 - 3  # sparse keys
    o_date = rng.integers(days(1992, 1, 1), days(1998, 8, 3), n_ord) \
        .astype(np.int32)
    o_comment = _comment(rng, n_ord)
    mask = rng.random(n_ord) < 0.05  # Q13 needle
    o_comment[mask] = np.char.add(
        o_comment[mask].astype(str), " special handle requests").astype(object)
    out["orders"] = (schema_of([("o_orderkey", T.INT64),
                              ("o_custkey", T.INT64),
                              ("o_orderstatus", T.STRING),
                              ("o_totalprice", T.FLOAT64),
                              ("o_orderdate", T.DATE32),
                              ("o_orderpriority", T.STRING),
                              ("o_clerk", T.STRING),
                              ("o_shippriority", T.INT32),
                              ("o_comment", T.STRING)]),
                     {"o_orderkey": ok,
                      # top ~15% of custkeys place no orders (Q22 anti join)
                      "o_custkey": rng.integers(
                          1, max(2, int(n_cust * 0.85)) + 1, n_ord)
                      .astype(np.int64),
                      "o_orderstatus": pick(rng, n_ord, ["O", "F", "P"]),
                      "o_totalprice": np.round(
                          rng.uniform(850.0, 560_000.0, n_ord), 2),
                      "o_orderdate": o_date,
                      "o_orderpriority": pick(rng, n_ord, PRIORITIES),
                      "o_clerk": np.array(
                          [f"Clerk#{c:09d}" for c in
                           rng.integers(1, max(2, n_ord // 100), n_ord)],
                          dtype=object),
                      "o_shippriority": np.zeros(n_ord, dtype=np.int32),
                      "o_comment": o_comment})

    # lineitem ---------------------------------------------------------------
    li_ord_idx = np.sort(rng.integers(0, n_ord, n_line))
    l_ok = ok[li_ord_idx]
    l_part = rng.integers(1, n_part + 1, n_line).astype(np.int64)
    l_supp = ps_supp[(l_part - 1) * 4 + rng.integers(0, 4, n_line)]
    l_odate = o_date[li_ord_idx]
    l_ship = (l_odate + rng.integers(1, 122, n_line)).astype(np.int32)
    l_commit = (l_odate + rng.integers(30, 91, n_line)).astype(np.int32)
    l_receipt = (l_ship + rng.integers(1, 31, n_line)).astype(np.int32)
    shipped = l_ship <= days(1995, 6, 17)
    rf = np.where(shipped,
                  np.where(rng.random(n_line) < 0.5, "R", "A"), "N") \
        .astype(object)
    out["lineitem"] = (schema_of([("l_orderkey", T.INT64),
                                ("l_partkey", T.INT64),
                                ("l_suppkey", T.INT64),
                                ("l_linenumber", T.INT32),
                                ("l_quantity", T.FLOAT64),
                                ("l_extendedprice", T.FLOAT64),
                                ("l_discount", T.FLOAT64),
                                ("l_tax", T.FLOAT64),
                                ("l_returnflag", T.STRING),
                                ("l_linestatus", T.STRING),
                                ("l_shipdate", T.DATE32),
                                ("l_commitdate", T.DATE32),
                                ("l_receiptdate", T.DATE32),
                                ("l_shipinstruct", T.STRING),
                                ("l_shipmode", T.STRING),
                                ("l_comment", T.STRING)]),
                       {"l_orderkey": l_ok,
                        # (l_partkey, l_suppkey) drawn FROM partsupp, as in
                        # real TPC-H (lineitem references partsupp)
                        "l_partkey": l_part,
                        "l_suppkey": l_supp,
                        "l_linenumber": (np.arange(n_line) % 7 + 1)
                        .astype(np.int32),
                        "l_quantity": rng.integers(1, 51, n_line)
                        .astype(np.float64),
                        "l_extendedprice": np.round(
                            rng.uniform(900.0, 105_000.0, n_line), 2),
                        "l_discount": np.round(
                            rng.integers(0, 11, n_line) * 0.01, 2),
                        "l_tax": np.round(
                            rng.integers(0, 9, n_line) * 0.01, 2),
                        "l_returnflag": rf,
                        "l_linestatus": np.where(shipped, "F", "O")
                        .astype(object),
                        "l_shipdate": l_ship,
                        "l_commitdate": l_commit,
                        "l_receiptdate": l_receipt,
                        "l_shipinstruct": pick(rng, n_line, INSTRUCTS),
                        "l_shipmode": pick(rng, n_line, SHIPMODES),
                        "l_comment": _comment(rng, n_line, 2)})
    return out


def reference_tables(sf: float = 0.001, seed: int = 42
                     ) -> Dict[str, HostBatch]:
    """``generate``'s eight tables as this engine's host batches."""
    out = {}
    for name, (schema, cols) in generate(sf, seed).items():
        out[name] = from_reference_arrays(
            [(f.name, f.dtype.sql_name) for f in schema],
            [cols[f.name] for f in schema])
    return out


def write_parquet(session, path: str, sf: float = 0.001, seed: int = 42):
    """``generate``'s eight tables as Parquet directories under ``path``
    (``path/<table>/part-0000p.parquet``, two partitions a table)."""
    for name, batch in reference_tables(sf, seed).items():
        session.create_dataframe(batch).write_parquet(
            os.path.join(path, name))


# ---------------------------------------------------------------------------
# dbgen's text of lineitem
# ---------------------------------------------------------------------------
#: lineitem's columns as the text ingest reads them (every one a string)
TEXT_COLUMNS = ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount",
                "l_tax", "l_returnflag", "l_linestatus", "l_shipdate"]
#: the TPC-H type each text column is cast to (the flags stay strings)
TEXT_TYPES = {"l_orderkey": "bigint", "l_quantity": "double",
              "l_extendedprice": "double", "l_discount": "double",
              "l_tax": "double", "l_shipdate": "date"}
#: the typed columns the text export formats, in the line's order
EXPORT_COLUMNS = ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                  "l_returnflag", "l_linestatus", "l_shipdate",
                  "l_commitdate", "l_receiptdate", "l_shipinstruct",
                  "l_shipmode"]

_Text = Tuple[np.ndarray, np.ndarray]  # (uint8[n, w] bytes, int32 lengths)


def int_text(values: np.ndarray) -> _Text:
    """Non-negative integers as left-aligned decimal text."""
    v = values.astype(np.int64)
    if len(v) and int(v.min()) < 0:
        raise ValueError("int_text takes non-negative values")
    k = len(str(int(v.max()))) if len(v) else 1
    ndig = np.ones(len(v), dtype=np.int32)
    for p in range(1, k):
        ndig += (v >= 10 ** p).astype(np.int32)
    digits = _digits(v, k)
    col = np.arange(k)[None, :]
    src = np.minimum(col + (k - ndig)[:, None], k - 1)
    out = np.take_along_axis(digits, src, axis=1)
    out[col >= ndig[:, None]] = 0
    return out, ndig


def join_text(*parts) -> _Text:
    """Variable-width texts side by side: each part a ``bytes`` literal
    or (bytes, lengths)."""
    n = next(p[0].shape[0] for p in parts if isinstance(p, tuple))
    mats = []
    for p in parts:
        if isinstance(p, bytes):
            lit = np.frombuffer(p, dtype=np.uint8)
            mats.append((np.broadcast_to(lit, (n, len(p))),
                         np.full(n, len(p), dtype=np.int32)))
        else:
            mats.append(p)
    lengths = np.sum([ln.astype(np.int64) for _bm, ln in mats], axis=0)
    out = np.zeros((n, max(1, int(lengths.max()) if n else 1)),
                   dtype=np.uint8)
    rows = np.arange(n)
    pos = np.zeros(n, dtype=np.int64)
    for bm, ln in mats:
        for c in range(bm.shape[1]):
            put = c < ln
            out[rows[put], pos[put] + c] = bm[put, c]
        pos += ln
    return out, lengths.astype(np.int32)


def cents_text(values: np.ndarray) -> _Text:
    """Non-negative money as C's ``%.2f`` prints it."""
    cents = np.rint(values * 100.0).astype(np.int64)
    return join_text(int_text(cents // 100), b".",
                     (_digits(cents % 100, 2),
                      np.full(len(cents), 2, dtype=np.int32)))


def date_text(days: np.ndarray) -> _Text:
    """int32 days since 1970-01-01 as 'YYYY-MM-DD' (years 0..9999)."""
    d = days.astype("datetime64[D]")
    month = d.astype("datetime64[M]")
    y = month.astype("datetime64[Y]").astype(np.int64) + 1970
    m = month.astype(np.int64) % 12 + 1
    dd = (d - month).astype(np.int64) + 1
    c = _concat(_digits(y, 4), b"-", _digits(m, 2), b"-", _digits(dd, 2))
    return c.data, c.lengths


def timestamp_text(us: np.ndarray) -> _Text:
    """int64 microseconds since the epoch as 'YYYY-MM-DD HH:MM:SS.ffffff'
    (years 0..9999)."""
    us = us.astype(np.int64)
    days = us // MICROS_PER_DAY
    rem = us - days * MICROS_PER_DAY
    date, _ln = date_text(days.astype(np.int32))
    c = _concat(date, b" ", _digits(rem // 3_600_000_000, 2), b":",
                _digits(rem // 60_000_000 % 60, 2), b":",
                _digits(rem // 1_000_000 % 60, 2), b".",
                _digits(rem % 1_000_000, 6))
    return c.data, c.lengths


def _text_column(text: _Text) -> HostColumn:
    return HostColumn(T.STRING, text[0], None, text[1])


def lineitem_text(sf: float = 1.0, seed: int = 42,
                  n_rows: Optional[int] = None,
                  cols: Optional[Dict[str, HostColumn]] = None
                  ) -> Tuple[HostBatch, HostBatch]:
    """(text, typed): ``TEXT_COLUMNS`` as dbgen prints them, every field a
    string, and the typed columns they were printed from (cut from
    ``cols``, a ``draw_all`` of the same arguments, when given)."""
    if cols is None:
        cols = _draw(sf, seed, n_rows, joins=True)
    typed = _batch(cols, TEXT_COLUMNS)
    c = {f.name: col for f, col in zip(typed.schema, typed.columns)}
    text = {
        "l_orderkey": int_text(c["l_orderkey"].data),
        "l_quantity": int_text(c["l_quantity"].data.astype(np.int64)),
        "l_extendedprice": cents_text(c["l_extendedprice"].data),
        "l_discount": cents_text(c["l_discount"].data),
        "l_tax": cents_text(c["l_tax"].data),
        "l_returnflag": (c["l_returnflag"].data, c["l_returnflag"].lengths),
        "l_linestatus": (c["l_linestatus"].data, c["l_linestatus"].lengths),
        "l_shipdate": date_text(c["l_shipdate"].data),
    }
    batch = HostBatch(T.Schema([T.Field(n, T.STRING) for n in TEXT_COLUMNS]),
                      [_text_column(text[n]) for n in TEXT_COLUMNS])
    return batch, typed


def export_table(sf: float = 1.0, seed: int = 42,
                 n_rows: Optional[int] = None,
                 cols: Optional[Dict[str, HostColumn]] = None) -> HostBatch:
    """The typed columns of the text export (``EXPORT_COLUMNS``)."""
    if cols is None:
        cols = _draw(sf, seed, n_rows, joins=True, rest=True)
    return _batch(cols, EXPORT_COLUMNS)


def export_lines(batch: HostBatch) -> _Text:
    """The export's line of each row of ``batch`` (``EXPORT_COLUMNS``):
    every field followed by ``|``, as dbgen ends its fields."""
    c = {f.name: col for f, col in zip(batch.schema, batch.columns)}
    fields = [
        int_text(c["l_orderkey"].data), int_text(c["l_partkey"].data),
        int_text(c["l_suppkey"].data),
        int_text(c["l_quantity"].data.astype(np.int64)),
        (c["l_returnflag"].data, c["l_returnflag"].lengths),
        (c["l_linestatus"].data, c["l_linestatus"].lengths),
        date_text(c["l_shipdate"].data), date_text(c["l_commitdate"].data),
        date_text(c["l_receiptdate"].data),
        (c["l_shipinstruct"].data, c["l_shipinstruct"].lengths),
        (c["l_shipmode"].data, c["l_shipmode"].lengths)]
    parts = []
    for f in fields:
        parts += [f, b"|"]
    return join_text(*parts)
