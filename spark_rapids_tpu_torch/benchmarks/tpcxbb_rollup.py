"""Row-multiplying queries on the TPCx-BB tables: a rollup, an unpivot.

``q67`` is TPC-DS v3 query 67 on TPCx-BB's store_sales, date_dim, store
and item (``tpcxbb_datagen``): the sales ``coalesce(ss_sales_price *
ss_quantity, 0)`` summed over ``ROLLUP`` of the keys, ranked within
``i_category`` by the sum (``rank() over (partition by i_category order
by sumsales desc)``), the top 100 of each category kept, ordered by every
key, the sum and the rank, and cut to 100 rows.  The rollup is one
``Expand`` between the Project that follows the joins and the aggregate,
as Spark plans it: with K keys, K + 1 projection lists, list g keeping
the first K - g keys, a typed null in place of each other key and the
grouping id g as a literal; the aggregate groups by the keys and the id.

The generator lacks some of q67's columns; the cuts:

==================================  =====================  ==============
q67 reads                           this query reads       why
==================================  =====================  ==============
``i_brand``                         ``i_brand_id``         no brand string
``i_product_name``                  ``i_item_id``          no product name
``s_store_id``                      ``s_store_name``       no store id
``d_qoy``                           dropped: 7 keys,       no quarter in
                                    8 grouping sets        date_dim, and
                                                           ``quarter()``
                                                           is not ported
``d_month_seq between 1200          ``d_year = 2002``      one year of the
and 1211``                                                 generator's five
==================================  =====================  ==============

At SF1 the year holds ~800,000 of store_sales's 4,000,000 rows, so the
Expand emits ~6,400,000.

``store_unpivot`` turns store_sales's three money columns
(``ss_sales_price``, ``ss_net_paid``, ``ss_net_profit``) into long form,
as Spark SQL's ``stack()``/``UNPIVOT`` does: one ``Generate`` with
``position`` (``pos`` in 0..2, ``amount``) over the four selected
columns, then per ``(ss_store_sk, pos)`` the count, the sum and the
maximum of the amount, sorted: 4,000,000 rows in, 12,000,000 out at SF1.

Each query takes the namespace of the package it runs in: its functions
module ``F``, its ``plan.logical`` module ``L`` (for the ``Expand`` and
``Generate`` nodes, which neither package's DataFrame builds for a
rollup or an unpivot) and its ``ops.windowexprs`` module ``W``; this
package's by default, so the tests run the same plans in the JAX
package.  ``QUERY_COLUMNS`` names the columns each query reads
(``query_tables`` cuts the generated tables to them); ``oracle_q67``,
``oracle_store_unpivot`` and ``tpcxbb.oracle_q24`` compute the rows
with numpy alone, nothing of the engine.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..ops import windowexprs
from ..plan import functions as f
from ..plan import logical
from .tpcxbb_datagen import columns_of

#: q67's rollup keys, in rollup order
KEYS = ["i_category", "i_class", "i_brand_id", "i_item_id", "d_year",
        "d_moy", "s_store_name"]
YEAR = 2002
TOP = 100
MONEY = ["ss_sales_price", "ss_net_paid", "ss_net_profit"]

QUERY_COLUMNS = {
    "q67": {"store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                            "ss_quantity", "ss_sales_price"],
            "date_dim": ["d_date_sk", "d_year", "d_moy"],
            "store": ["s_store_sk", "s_store_name"],
            "item": ["i_item_sk", "i_item_id", "i_category", "i_class",
                     "i_brand_id"]},
    "store_unpivot": {"store_sales": ["ss_store_sk"] + MONEY},
    "q24": {"store_sales": ["ss_item_sk", "ss_quantity"],
            "item": ["i_item_sk", "i_current_price"]},
}


def query_tables(generated, query: str) -> Dict[str, object]:
    """``tpcxbb_datagen.generate``'s output cut to ``query``'s columns, as
    host batches."""
    return columns_of(generated, QUERY_COLUMNS[query])


def _frame(like, plan):
    """A DataFrame of ``like``'s class and session over ``plan``."""
    return type(like)(like.session, plan)


def q67(t, F=f, L=logical, W=windowexprs):
    c = F.col
    dates = t["date_dim"].filter(c("d_year") == F.lit(YEAR)) \
        .select("d_date_sk", "d_year", "d_moy")
    stores = t["store"].select("s_store_sk", "s_store_name")
    items = t["item"].select("i_item_sk", "i_category", "i_class",
                             "i_brand_id", "i_item_id")
    joined = (t["store_sales"]
              .join(dates, on=(["ss_sold_date_sk"], ["d_date_sk"]))
              .join(stores, on=(["ss_store_sk"], ["s_store_sk"]))
              .join(items, on=(["ss_item_sk"], ["i_item_sk"])))
    base = joined.select(*KEYS, F.coalesce(
        c("ss_sales_price") * c("ss_quantity"), F.lit(0.0)).alias("sales"))
    types = {n: base.schema.fields[i].dtype for i, n in enumerate(KEYS)}
    projections = []
    for g in range(len(KEYS) + 1):
        kept = len(KEYS) - g
        projections.append(
            [c(k).expr if i < kept else F.lit(None, types[k]).expr
             for i, k in enumerate(KEYS)]
            + [c("sales").expr, F.lit(g).expr])
    rolled = _frame(base, L.Expand(base.plan, projections,
                                   KEYS + ["sales", "gid"]))
    sums = rolled.group_by(*KEYS, "gid").agg(
        F.sum("sales").alias("sumsales"))
    ranked = sums.with_window("rk", W.over(
        W.rank(), W.window().partition_by("i_category")
        .order_by(c("sumsales").desc())))
    return (ranked.filter(c("rk") <= F.lit(TOP))
            .select(*KEYS, "sumsales", "rk")
            .sort(*KEYS, "sumsales", "rk")
            .limit(TOP))


def store_unpivot(t, F=f, L=logical, W=windowexprs):
    c = F.col
    ss = t["store_sales"].select("ss_store_sk", *MONEY)
    long = _frame(ss, L.Generate(ss.plan, [c(m).expr for m in MONEY],
                                 "amount", position=True))
    return (long.group_by("ss_store_sk", "pos")
            .agg(F.count("*").alias("n"), F.sum("amount").alias("total"),
                 F.max("amount").alias("top"))
            .sort("ss_store_sk", "pos"))


QUERIES = {"q67": q67, "store_unpivot": store_unpivot}


# ---------------------------------------------------------------------------
# numpy oracles
# ---------------------------------------------------------------------------
def _cols(tables) -> Dict[str, np.ndarray]:
    """name -> numpy array (strings as object arrays of str)."""
    from ..interop import to_reference_arrays

    out = {}
    for b in tables.values():
        out.update(to_reference_arrays(b)[1])
    return out


def _by_key(keys: np.ndarray, column: np.ndarray, sk: np.ndarray):
    """``column`` at the rows whose ``keys`` equal ``sk`` (keys unique)."""
    order = np.argsort(keys, kind="stable")
    at = np.searchsorted(keys[order], sk)
    at = np.clip(at, 0, len(keys) - 1)
    hit = keys[order][at] == sk
    return column[order][at], hit


def _null_first(v):
    return (v is not None, v)


def oracle_q67(tables) -> List[tuple]:
    """q67's rows from the host tables with numpy: one grouped sum per
    grouping set, the rank within each category, the top 100 per
    category, sorted with nulls first, cut to 100."""
    c = _cols(tables)
    year, hit_d = _by_key(c["d_date_sk"], c["d_year"], c["ss_sold_date_sk"])
    moy, _h = _by_key(c["d_date_sk"], c["d_moy"], c["ss_sold_date_sk"])
    store, hit_s = _by_key(c["s_store_sk"], c["s_store_name"],
                           c["ss_store_sk"])
    rows = hit_d & (year == YEAR) & hit_s
    item_cols = {}
    hit_i = np.ones(len(rows), bool)
    for k in ("i_category", "i_class", "i_brand_id", "i_item_id"):
        item_cols[k], h = _by_key(c["i_item_sk"], c[k], c["ss_item_sk"])
        hit_i &= h
    rows &= hit_i
    vals = {**{k: v[rows] for k, v in item_cols.items()},
            "d_year": year[rows], "d_moy": moy[rows],
            "s_store_name": store[rows]}
    sales = (c["ss_sales_price"][rows]
             * c["ss_quantity"][rows].astype(np.float64))
    codes, uniq = [], []
    for k in KEYS:
        u, inv = np.unique(vals[k], return_inverse=True)
        uniq.append(u)
        codes.append(inv.astype(np.int64))
    parts = []  # (key codes with -1 for null, sums) per grouping set
    for g in range(len(KEYS) + 1):
        kept = len(KEYS) - g
        if kept:
            combo = np.stack(codes[:kept], axis=1)
            groups, inv = np.unique(combo, axis=0, return_inverse=True)
            inv = inv.reshape(-1)
        else:
            groups = np.zeros((1, 0), np.int64)
            inv = np.zeros(len(sales), np.int64)
        sums = np.bincount(inv, weights=sales, minlength=len(groups))
        full = np.full((len(groups), len(KEYS)), -1, np.int64)
        full[:, :kept] = groups
        parts.append((full, sums))
    keys = np.concatenate([p[0] for p in parts])
    sums = np.concatenate([p[1] for p in parts])
    cat = keys[:, 0]
    order = np.lexsort((-sums, cat))
    cs, ss = cat[order], sums[order]
    i = np.arange(len(order))
    new_part = np.ones(len(order), bool)
    new_part[1:] = cs[1:] != cs[:-1]
    part_start = np.maximum.accumulate(np.where(new_part, i, 0))
    new_val = new_part.copy()
    new_val[1:] |= ss[1:] != ss[:-1]
    tie_start = np.maximum.accumulate(np.where(new_val, i, 0))
    rank = np.empty(len(order), np.int64)
    rank[order] = tie_start - part_start + 1
    out = []
    for r in np.nonzero(rank <= TOP)[0]:
        key = tuple(None if keys[r, j] < 0 else uniq[j][keys[r, j]]
                    for j in range(len(KEYS)))
        key = tuple(v.item() if hasattr(v, "item") else v for v in key)
        out.append(key + (float(sums[r]), int(rank[r])))
    out.sort(key=lambda row: tuple(_null_first(v) for v in row))
    return out[:TOP]


def oracle_store_unpivot(tables) -> List[tuple]:
    """The unpivot's rows with numpy: per (store, position) the count,
    the sum and the maximum of that money column."""
    c = _cols(tables)
    store = c["ss_store_sk"]
    stores = np.unique(store)
    inv = np.searchsorted(stores, store)
    out = []
    per = []
    for m in MONEY:
        v = c[m]
        n = np.bincount(inv, minlength=len(stores))
        total = np.bincount(inv, weights=v, minlength=len(stores))
        top = np.full(len(stores), -np.inf)
        np.maximum.at(top, inv, v)
        per.append((n, total, top))
    for si, s in enumerate(stores.tolist()):
        for pos, (n, total, top) in enumerate(per):
            out.append((int(s), pos, int(n[si]), float(total[si]),
                        float(top[si])))
    return out


ORACLES = {"q67": oracle_q67, "store_unpivot": oracle_store_unpivot}
