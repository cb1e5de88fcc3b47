"""TPC-H Q1, Q3, Q4, Q6, Q12, Q13 and Q14 as DataFrame code.

Counterpart of ``spark_rapids_tpu/benchmarks/tpch.py:q1`` (45), ``q3``
(90), ``q4`` (105), ``q6`` (141), ``q12`` (283), ``q13`` (303) and
``q14`` (317), written against this engine's DataFrame API.  The other
fifteen queries need more joins, other string functions, distinct,
unions or subquery forms, which come with later slices.
"""
from __future__ import annotations

import datetime as dt

from ..plan import functions as F

col = F.col
lit = F.lit


def _d(y, m, d):
    return lit(dt.date(y, m, d))


def q1(t):
    li = t["lineitem"].filter(col("l_shipdate") <= _d(1998, 9, 2))
    disc_price = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    charge = disc_price * (lit(1.0) + col("l_tax"))
    return (li.group_by("l_returnflag", "l_linestatus")
            .agg(F.sum("l_quantity").alias("sum_qty"),
                 F.sum("l_extendedprice").alias("sum_base_price"),
                 F.sum(disc_price).alias("sum_disc_price"),
                 F.sum(charge).alias("sum_charge"),
                 F.avg("l_quantity").alias("avg_qty"),
                 F.avg("l_extendedprice").alias("avg_price"),
                 F.avg("l_discount").alias("avg_disc"),
                 F.count("l_quantity").alias("count_order"))
            .sort("l_returnflag", "l_linestatus"))


def q3(t):
    cust = t["customer"].filter(col("c_mktsegment") == lit("BUILDING"))
    orders = t["orders"].filter(col("o_orderdate") < _d(1995, 3, 15))
    li = t["lineitem"].filter(col("l_shipdate") > _d(1995, 3, 15))
    j = (cust.select("c_custkey")
         .join(orders, on=(["c_custkey"], ["o_custkey"]), how="inner")
         .join(li, on=(["o_orderkey"], ["l_orderkey"]), how="inner"))
    rev = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (j.group_by("o_orderkey", "o_orderdate", "o_shippriority")
            .agg(F.sum(rev).alias("revenue"))
            .select("o_orderkey", "revenue", "o_orderdate", "o_shippriority")
            .sort(col("revenue").desc(), col("o_orderdate").asc())
            .limit(10))


def q4(t):
    orders = t["orders"].filter(
        (col("o_orderdate") >= _d(1993, 7, 1))
        & (col("o_orderdate") < _d(1993, 10, 1)))
    late = t["lineitem"].filter(col("l_commitdate") < col("l_receiptdate"))
    return (orders.join(late, on=(["o_orderkey"], ["l_orderkey"]),
                        how="semi")
            .group_by("o_orderpriority")
            .agg(F.count("*").alias("order_count"))
            .sort("o_orderpriority"))


def q6(t):
    li = t["lineitem"].filter(
        (col("l_shipdate") >= _d(1994, 1, 1))
        & (col("l_shipdate") < _d(1995, 1, 1))
        & (col("l_discount") >= lit(0.05)) & (col("l_discount") <= lit(0.07))
        & (col("l_quantity") < lit(24.0)))
    return li.agg(F.sum(col("l_extendedprice") * col("l_discount"))
                  .alias("revenue"))


def q12(t):
    li = t["lineitem"].filter(
        col("l_shipmode").isin("MAIL", "SHIP")
        & (col("l_commitdate") < col("l_receiptdate"))
        & (col("l_shipdate") < col("l_commitdate"))
        & (col("l_receiptdate") >= _d(1994, 1, 1))
        & (col("l_receiptdate") < _d(1995, 1, 1)))
    j = li.select("l_orderkey", "l_shipmode").join(
        t["orders"].select("o_orderkey", "o_orderpriority"),
        on=(["l_orderkey"], ["o_orderkey"]), how="inner")
    high = F.if_(col("o_orderpriority").isin("1-URGENT", "2-HIGH"),
                 lit(1), lit(0))
    low = F.if_(col("o_orderpriority").isin("1-URGENT", "2-HIGH"),
                lit(0), lit(1))
    return (j.group_by("l_shipmode")
            .agg(F.sum(high).alias("high_line_count"),
                 F.sum(low).alias("low_line_count"))
            .sort("l_shipmode"))


def q13(t):
    orders = t["orders"].filter(
        ~(col("o_comment").contains("special")
          & col("o_comment").contains("requests")))
    j = t["customer"].select("c_custkey").join(
        orders.select("o_orderkey", "o_custkey"),
        on=(["c_custkey"], ["o_custkey"]), how="left")
    per_cust = (j.group_by("c_custkey")
                .agg(F.count("o_orderkey").alias("c_count")))
    return (per_cust.group_by("c_count")
            .agg(F.count("*").alias("custdist"))
            .sort(col("custdist").desc(), col("c_count").desc()))


def q14(t):
    li = t["lineitem"].filter(
        (col("l_shipdate") >= _d(1995, 9, 1))
        & (col("l_shipdate") < _d(1995, 10, 1)))
    j = li.select("l_partkey", "l_extendedprice", "l_discount").join(
        t["part"].select("p_partkey", "p_type"),
        on=(["l_partkey"], ["p_partkey"]), how="inner")
    rev = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    promo = F.if_(col("p_type").like("PROMO%"), rev, lit(0.0))
    return (j.agg(F.sum(promo).alias("num"), F.sum(rev).alias("den"))
            .select((lit(100.0) * col("num") / col("den"))
                    .alias("promo_revenue")))


QUERIES = {1: q1, 3: q3, 4: q4, 6: q6, 12: q12, 13: q13, 14: q14}
