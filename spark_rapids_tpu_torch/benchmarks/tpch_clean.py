"""TPC-H orders and customer cleaned as text: the string transforms and
string min/max.

``orders_profile`` reads orders' ``o_orderpriority`` and ``o_comment``,
splits the priority's code from its name (``substring_index``, a cast,
``lower``), measures and searches the comment (``length``, ``locate``),
cuts a trimmed preview of it (``substring``, ``trim``) and a key with
every space replaced and the case raised (``replace``, ``upper``), then
groups by the priority and keeps the count, the average length, the
number of comments that name ``special``, and the first preview and the
last key of each group (string ``min`` and ``max``).

``customer_clean`` keeps the customers whose comment is longer than 30
bytes and cleans five fields: the number after ``#`` in ``c_name``, the
country code before the first ``-`` of ``c_phone``, the phone without
its dashes, the segment in lower case, an upper-case key of the
address's first 12 bytes without trailing spaces (``rtrim``), and the
comment's last two words without leading spaces (``ltrim``), sorted by
the customer number.

Both run under ``CLEAN_CONF``: ``CAST_CONF`` (the string parses on the
device) and ``incompatibleOps.enabled`` with the enable keys of Upper and
Lower, whose rules are incompatible (ASCII-only case maps) and whose
keys default to off, as in the reference.

Each query takes the functions module ``F`` of the package it runs in
(this package's by default), so the same query runs in the JAX package
for the tests.  ``oracle_orders_profile`` and ``oracle_customer_clean``
compute the same rows from the host table alone, with Python's bytes
methods (``split``, ``find``, ``strip``, ``replace``, ``upper``,
``lower``) and ``min``/``max``, nothing of the engine; ``check_rows``
holds an engine's rows against them, strings byte for byte.
"""
from __future__ import annotations

from typing import Dict, List

from ..plan import functions as f
from .tpch_text import CAST_CONF

CLEAN_CONF = {**CAST_CONF,
              "spark.rapids.tpu.sql.incompatibleOps.enabled": True,
              "spark.rapids.tpu.sql.expr.Upper": True,
              "spark.rapids.tpu.sql.expr.Lower": True}


def orders_profile(orders, F=f):
    c = F.col
    o = orders.select(
        F.substring_index(c("o_orderpriority"), "-", 1).cast("int")
        .alias("prio"),
        F.lower(F.substring_index(c("o_orderpriority"), "-", -1))
        .alias("prio_name"),
        F.length(c("o_comment")).alias("comment_len"),
        F.locate("special", c("o_comment")).alias("special_at"),
        F.trim(F.substring(c("o_comment"), 1, 24)).alias("preview"),
        F.upper(F.replace(c("o_comment"), " ", "_")).alias("comment_key"))
    return (o.group_by("prio", "prio_name")
            .agg(F.count("*").alias("orders"),
                 F.avg("comment_len").alias("avg_len"),
                 F.sum(F.if_(c("special_at") > F.lit(0), F.lit(1),
                             F.lit(0))).alias("special"),
                 F.min("preview").alias("first_preview"),
                 F.max("comment_key").alias("last_key"))
            .sort("prio"))


def customer_clean(customer, F=f):
    c = F.col
    return (customer.filter(F.length(c("c_comment")) > F.lit(30))
            .select(F.substring_index(c("c_name"), "#", -1).cast("bigint")
                    .alias("cust_no"),
                    F.substring_index(c("c_phone"), "-", 1).cast("int")
                    .alias("country"),
                    F.replace(c("c_phone"), "-", "").alias("phone"),
                    F.lower(c("c_mktsegment")).alias("segment"),
                    F.upper(F.rtrim(F.substring(c("c_address"), 1, 12)))
                    .alias("addr_key"),
                    F.ltrim(F.substring_index(c("c_comment"), " ", -2))
                    .alias("comment_tail"))
            .sort("cust_no"))


#: name -> (query, the table it reads)
QUERIES = {"orders_profile": (orders_profile, "orders"),
           "customer_clean": (customer_clean, "customer")}


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------
def _bytes_rows(batch, name: str) -> List[bytes]:
    """A string column of a host batch as one ``bytes`` a row (no
    nulls: the generator draws none)."""
    col = batch.columns[batch.schema.names.index(name)]
    data, lengths = col.data, col.lengths
    return [data[i, :lengths[i]].tobytes() for i in range(data.shape[0])]


def _chars(b: bytes) -> int:
    return len(b.decode("utf-8"))


def oracle_orders_profile(orders) -> List[tuple]:
    """``orders_profile``'s rows from orders' host batch."""
    groups: Dict[tuple, list] = {}
    for prio, comment in zip(_bytes_rows(orders, "o_orderpriority"),
                             _bytes_rows(orders, "o_comment")):
        key = (int(prio.split(b"-")[0]), prio.split(b"-")[-1].lower())
        g = groups.setdefault(key, [0, 0, 0, [], []])
        g[0] += 1
        g[1] += _chars(comment)
        g[2] += comment.find(b"special") >= 0
        g[3].append(comment[:24].strip(b" "))
        g[4].append(comment.replace(b" ", b"_").upper())
    return [(prio, name.decode(), n, total / n, special,
             min(previews).decode(), max(keys).decode())
            for (prio, name), (n, total, special, previews, keys)
            in sorted(groups.items())]


def oracle_customer_clean(customer) -> List[tuple]:
    """``customer_clean``'s rows from customer's host batch."""
    rows = []
    for name, phone, address, segment, comment in zip(
            *(_bytes_rows(customer, c) for c in
              ("c_name", "c_phone", "c_address", "c_mktsegment",
               "c_comment"))):
        if _chars(comment) <= 30:
            continue
        rows.append((int(name.split(b"#")[-1]), int(phone.split(b"-")[0]),
                     phone.replace(b"-", b"").decode(),
                     segment.lower().decode(),
                     address[:12].rstrip(b" ").upper().decode(),
                     b" ".join(comment.split(b" ")[-2:]).lstrip(b" ")
                     .decode()))
    return sorted(rows)


ORACLES = {"orders_profile": oracle_orders_profile,
           "customer_clean": oracle_customer_clean}


def check_rows(got, want, what: str) -> None:
    """Raise unless ``got`` equals ``want`` in order: strings byte for
    byte (their UTF-8 bytes, lengths included), integers exactly, floats
    within relative 1e-9."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows, want {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if len(g) != len(w):
            raise AssertionError(f"{what}: row {i} width")
        for a, b in zip(g, w):
            if isinstance(b, float):
                ok = isinstance(a, float) and abs(a - b) <= 1e-9 * abs(b)
            elif isinstance(b, str):
                ok = isinstance(a, str) and a.encode() == b.encode()
            else:
                ok = type(a) is type(b) and a == b
            if not ok:
                raise AssertionError(f"{what}: row {i}: {a!r} vs the "
                                     f"oracle's {b!r}")
