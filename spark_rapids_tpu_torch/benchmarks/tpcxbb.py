"""TPCx-BB-like queries as DataFrame code.

Counterpart of ``spark_rapids_tpu/benchmarks/tpcxbb.py``, the reference's
code of the queries the port's tests and ``chip_smoke.py`` run: ``q24``
(``:449-461``), the quantity sold of cheap and of pricey items (a semi
and an anti join with the cheap items, two global sums, a union),
``q30`` (``:541-562``), the windowed top-N of category affinity, and the
feature sets of TPCx-BB's machine-learning queries (``ML_PREP``): ``q5``
(``:103``, logistic regression: per-user clicks against education),
``q20`` (``:374``, return-behaviour segmentation, with ``greatest``),
``q25`` (``:464``, RFM), ``q26`` (``:480``, category-spend vectors) and
``q28`` (``:507``, sentiment buckets, with ``CASE WHEN``).  Of the
reference's other bodies, all but q14, q23 (``sqrt``) and q20's and
q28's functions ran through the port's functions at sf 0.002 when last
probed (ROADMAP A3); they are not copied here yet.  ``oracle_q24`` and
``ORACLES`` compute the rows with numpy alone, from the tables cut to
each query's columns (``QUERY_COLUMNS``, ``query_tables``).

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
from .tpch_oracle import _index
from .tpcxbb_datagen import columns_of

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


def q5(t):
    """Per-user category-click features vs college education (the
    logistic-regression prep)."""
    clicks = (t["web_clickstreams"]
              .join(t["item"].select("i_item_sk", "i_category_id"),
                    on=(["wcs_item_sk"], ["i_item_sk"]), how="inner"))
    feat = (clicks.group_by(col("wcs_user_sk").alias("u"))
            .agg(F.count("*").alias("total_clicks"),
                 F.sum(F.if_(col("i_category_id") == lit(0),
                             lit(1), lit(0))).alias("cat0_clicks")))
    demo = (t["customer"]
            .join(t["customer_demographics"],
                  on=(["c_current_cdemo_sk"], ["cd_demo_sk"]), how="inner")
            .select(col("c_customer_sk").alias("ck"),
                    col("cd_education_status").alias("edu")))
    return (feat.join(demo, on=(["u"], ["ck"]), how="inner")
            .with_column("college",
                         F.if_(col("edu").isin("College",
                                               "Advanced Degree"),
                               lit(1), lit(0)))
            .group_by("college")
            .agg(F.count("*").alias("users"),
                 F.avg("total_clicks").alias("avg_clicks"),
                 F.avg("cat0_clicks").alias("avg_cat0"))
            .sort("college"))


def q20(t):
    """Customer return-behavior features (segmentation prep)."""
    sales = (t["store_sales"].group_by(col("ss_customer_sk").alias("c"))
             .agg(F.count("*").alias("orders"),
                  F.sum("ss_net_paid").alias("spend")))
    rets = (t["store_returns"].group_by(col("sr_customer_sk").alias("rc"))
            .agg(F.count("*").alias("returns")))
    j = sales.join(rets, on=(["c"], ["rc"]), how="left")
    return (j.with_column("returns", F.coalesce(col("returns"), lit(0)))
            .with_column("return_ratio",
                         col("returns") * lit(1.0)
                         / F.greatest(col("orders"), lit(1)))
            .filter(col("return_ratio") > lit(0.2))
            .select("c", "orders", "returns", "return_ratio")
            .sort(col("return_ratio").desc(), col("c").asc())
            .limit(100))


def q25(t):
    """Customer RFM features (recency / frequency / monetary)."""
    per = (t["store_sales"]
           .group_by(col("ss_customer_sk").alias("c"))
           .agg(F.max("ss_sold_date_sk").alias("last_day"),
                F.count("*").alias("frequency"),
                F.sum("ss_net_paid").alias("monetary")))
    return (per.with_column("recent",
                            F.if_(col("last_day") >= lit(1460),
                                  lit(1), lit(0)))
            .filter(col("frequency") >= lit(2))
            .select("c", "recent", "frequency", "monetary")
            .sort(col("monetary").desc(), col("c").asc())
            .limit(100))


def q26(t):
    """Per-customer category-spend vector (clustering prep)."""
    j = (t["store_sales"]
         .join(t["item"].select("i_item_sk", "i_category_id"),
               on=(["ss_item_sk"], ["i_item_sk"]), how="inner"))
    catcol = [F.sum(F.if_(col("i_category_id") == lit(c),
                          col("ss_net_paid"), lit(0.0))).alias(f"cat{c}")
              for c in range(5)]
    return (j.group_by(col("ss_customer_sk").alias("c"))
            .agg(F.count("*").alias("n"), *catcol)
            .filter(col("n") >= lit(3))
            .sort(col("n").desc(), col("c").asc())
            .limit(100))


def q28(t):
    """Rating-bucket counts per category (naive-bayes prep)."""
    j = (t["product_reviews"]
         .join(t["item"].select("i_item_sk", "i_category_id"),
               on=(["pr_item_sk"], ["i_item_sk"]), how="inner"))
    return (j.with_column("sentiment",
                          F.when(col("pr_review_rating") >= lit(4),
                                 lit("pos"))
                          .when(col("pr_review_rating") == lit(3),
                                lit("neutral"))
                          .otherwise(lit("neg")))
            .group_by("i_category_id", "sentiment")
            .agg(F.count("*").alias("cnt"))
            .sort("i_category_id", "sentiment"))


QUERIES = {5: q5, 20: q20, 24: q24, 25: q25, 26: q26, 28: q28, 30: q30}
#: the feature sets of TPCx-BB's machine-learning queries
ML_PREP = (5, 20, 25, 26, 28)
#: the columns each ML-prep query reads, by table
QUERY_COLUMNS = {
    5: {"web_clickstreams": ["wcs_user_sk", "wcs_item_sk"],
        "item": ["i_item_sk", "i_category_id"],
        "customer": ["c_customer_sk", "c_current_cdemo_sk"],
        "customer_demographics": ["cd_demo_sk", "cd_education_status"]},
    20: {"store_sales": ["ss_customer_sk", "ss_net_paid"],
         "store_returns": ["sr_customer_sk"]},
    25: {"store_sales": ["ss_sold_date_sk", "ss_customer_sk",
                         "ss_net_paid"]},
    26: {"store_sales": ["ss_item_sk", "ss_customer_sk", "ss_net_paid"],
         "item": ["i_item_sk", "i_category_id"]},
    28: {"product_reviews": ["pr_item_sk", "pr_review_rating"],
         "item": ["i_item_sk", "i_category_id"]},
}


def query_tables(generated, q: int):
    """``tpcxbb_datagen.generate``'s output cut to query ``q``'s columns,
    as host batches."""
    return columns_of(generated, QUERY_COLUMNS[q])


# --------------------------------------------------------------------------
# numpy oracles of the ML-prep queries (every key column of the generator
# is non-null, and every dimension key unique, as the oracles check)
# --------------------------------------------------------------------------
def _columns(tables):
    from ..interop import to_reference_arrays

    c = {}
    for b in tables.values():
        c.update(to_reference_arrays(b)[1])
    return c


def _lookup(keys, unique_keys):
    """For each of ``keys``, its row in ``unique_keys`` (a dimension's
    primary key) and whether it is there."""
    if len(np.unique(unique_keys)) != len(unique_keys):
        raise AssertionError("oracle: a dimension key repeats")
    return _index(keys, unique_keys)


def _group(keys):
    """(unique keys, each row's group, group sizes) by one stable sort."""
    order = np.argsort(keys, kind="stable")
    s = keys[order]
    first = np.ones(len(s), dtype=bool)
    first[1:] = s[1:] != s[:-1]
    gid = np.empty(len(s), dtype=np.int64)
    gid[order] = np.cumsum(first) - 1
    starts = np.flatnonzero(first)
    return s[starts], gid, np.diff(np.append(starts, len(s)))


def _sums(gid, n, values):
    """Per group sums of ``values`` in row order (float64)."""
    out = np.zeros(n)
    np.add.at(out, gid, values)
    return out


def _top(rows, key, limit=None):
    rows = sorted(rows, key=key)
    return rows if limit is None else rows[:limit]


def oracle_q5(tables):
    c = _columns(tables)
    at, hit = _lookup(c["wcs_item_sk"], c["i_item_sk"])
    users, gid, total = _group(c["wcs_user_sk"][hit])
    cat0 = np.bincount(gid, weights=(c["i_category_id"][at[hit]] == 0),
                       minlength=len(users)).astype(np.int64)
    dat, dhit = _lookup(c["c_current_cdemo_sk"], c["cd_demo_sk"])
    ck = c["c_customer_sk"][dhit]
    edu = c["cd_education_status"][dat[dhit]]
    cat_, chit = _lookup(users, ck)   # the customers are unique
    college = np.array([e in ("College", "Advanced Degree")
                        for e in edu], dtype=bool)[cat_[chit]]
    tot, c0 = total[chit], cat0[chit]
    out = []
    for v in (0, 1):
        m = college == bool(v)
        if m.any():
            out.append((v, int(m.sum()), float(tot[m].sum() / m.sum()),
                        float(c0[m].sum() / m.sum())))
    return out


def oracle_q20(tables):
    c = _columns(tables)
    cust, gid, orders = _group(c["ss_customer_sk"])
    rcust, _rg, returns = _group(c["sr_customer_sk"])
    at, hit = _lookup(cust, rcust)
    ret = np.where(hit, returns[at], 0).astype(np.int64)
    ratio = ret * 1.0 / np.maximum(orders, 1)
    keep = ratio > 0.2
    rows = [(int(k), int(o), int(r), float(x)) for k, o, r, x in
            zip(cust[keep], orders[keep], ret[keep], ratio[keep])]
    return _top(rows, lambda r: (-r[3], r[0]), 100)


def oracle_q25(tables):
    c = _columns(tables)
    cust, gid, freq = _group(c["ss_customer_sk"])
    last = np.full(len(cust), np.iinfo(np.int64).min)
    np.maximum.at(last, gid, c["ss_sold_date_sk"])
    money = _sums(gid, len(cust), c["ss_net_paid"])
    keep = freq >= 2
    rows = [(int(k), int(d >= 1460), int(f), float(m)) for k, d, f, m in
            zip(cust[keep], last[keep], freq[keep], money[keep])]
    return _top(rows, lambda r: (-r[3], r[0]), 100)


def oracle_q26(tables):
    c = _columns(tables)
    at, hit = _lookup(c["ss_item_sk"], c["i_item_sk"])
    cust, gid, n = _group(c["ss_customer_sk"][hit])
    cat = c["i_category_id"][at[hit]]
    paid = c["ss_net_paid"][hit]
    sums = [_sums(gid, len(cust), np.where(cat == k, paid, 0.0))
            for k in range(5)]
    keep = n >= 3
    rows = [(int(k), int(m), *(float(s[i]) for s in sums))
            for i, (k, m) in enumerate(zip(cust, n)) if keep[i]]
    return _top(rows, lambda r: (-r[1], r[0]), 100)


def oracle_q28(tables):
    c = _columns(tables)
    at, hit = _lookup(c["pr_item_sk"], c["i_item_sk"])
    cat = c["i_category_id"][at[hit]].astype(np.int64)
    rating = c["pr_review_rating"][hit]
    senti = np.where(rating >= 4, 2, np.where(rating == 3, 1, 0))
    names = ("neg", "neutral", "pos")   # their byte order
    counts = np.bincount(cat * 3 + senti)
    return [(int(k // 3), names[k % 3], int(counts[k]))
            for k in range(len(counts)) if counts[k]]


ORACLES = {5: oracle_q5, 20: oracle_q20, 24: oracle_q24, 25: oracle_q25,
           26: oracle_q26, 28: oracle_q28}


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
