"""TPCx-BB-like queries as DataFrame code.

Counterpart of ``spark_rapids_tpu/benchmarks/tpcxbb.py`` for the queries
this engine runs: ``q24`` (``:449-461``), the quantity sold of cheap and
of pricey items (a semi and an anti join with the cheap items, two
global sums, a union), and ``q30`` (``:541-562``), the windowed top-N of
category affinity.  The other 28 need functions of later slices (math,
``CaseWhen``, more string and date functions).  ``oracle_q24`` computes
q24's rows with numpy alone.

``clickstream_windows`` is no reference query: it is shaped like the
clickstream sessionization of TPCx-BB's Q2, Q3, Q4 and Q8 (every click
in its user's history, ordered by click date and time) and runs the
window exec over the whole ``web_clickstreams`` table.

Usage::

    tables = tpcxbb_datagen.dataframes(session, sf=1.0, seed=99,
                                       names=["web_clickstreams", "item"])
    rows = QUERIES[30](tables).collect()
"""
from __future__ import annotations

import numpy as np

from ..ops.windowexprs import over, row_number, window
from ..plan import functions as F

col = F.col
lit = F.lit


def q24(t):
    """Sales before/after an item price threshold (elasticity shape)."""
    cheap = t["item"].filter(col("i_current_price") < lit(50.0)) \
        .select(col("i_item_sk").alias("ci"))
    j = t["store_sales"].join(cheap, on=(["ss_item_sk"], ["ci"]),
                              how="semi")
    k = t["store_sales"].join(cheap, on=(["ss_item_sk"], ["ci"]),
                              how="anti")
    a = j.agg(F.sum("ss_quantity").alias("q")).select(
        lit("cheap").alias("bucket"), col("q"))
    b = k.agg(F.sum("ss_quantity").alias("q")).select(
        lit("pricey").alias("bucket"), col("q"))
    return a.union(b).sort("bucket")


def oracle_q24(tables):
    """q24's two rows with numpy: the quantity of the store sales whose
    item costs under 50, and of the others."""
    from ..interop import to_reference_arrays

    c = {}
    for b in tables.values():
        c.update(to_reference_arrays(b)[1])
    cheap = np.unique(c["i_item_sk"][c["i_current_price"] < 50.0])
    hit = np.isin(c["ss_item_sk"], cheap)
    q = c["ss_quantity"].astype(np.int64)
    return [("cheap", int(q[hit].sum())), ("pricey", int(q[~hit].sum()))]


def q30(t):
    """Category pairs viewed in the same session, ranked per category by
    affinity (windowed top-N)."""
    v = (t["web_clickstreams"]
         .join(t["item"].select("i_item_sk", "i_category_id"),
               on=(["wcs_item_sk"], ["i_item_sk"]), how="inner")
         .select(col("wcs_user_sk").alias("u"),
                 col("wcs_click_date_sk").alias("d"),
                 col("i_category_id").alias("cat_a"))
         .distinct())
    v2 = v.select(col("u").alias("u2"), col("d").alias("d2"),
                  col("cat_a").alias("cat_b"))
    pairs = (v.join(v2, on=(["u", "d"], ["u2", "d2"]), how="inner")
             .filter(col("cat_a") != col("cat_b"))
             .group_by("cat_a", "cat_b")
             .agg(F.count("*").alias("cnt")))
    ranked = pairs.with_window(
        "rn", over(row_number(),
                   window().partition_by("cat_a")
                   .order_by(col("cnt").desc(), col("cat_b").asc())))
    return (ranked.filter(col("rn") <= lit(3))
            .select("cat_a", "cat_b", "cnt", "rn")
            .sort("cat_a", "rn"))


QUERIES = {24: q24, 30: q30}


def clickstream_windows(t):
    """Per user, in click order: the click's number, the sales keys of
    the last five clicks summed, and the earliest click time of the five
    clicks around it."""
    def session():
        return window().partition_by("wcs_user_sk").order_by(
            "wcs_click_date_sk", "wcs_click_time_sk")

    return (t["web_clickstreams"]
            .with_window("click_no", over(row_number(), session()))
            .with_window("sales_last5", over(
                F.sum("wcs_sales_sk"), session().rows_between(-4, 0)))
            .with_window("min_time_5", over(
                F.min("wcs_click_time_sk"), session().rows_between(-2, 2))))
