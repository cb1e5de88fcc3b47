"""Seeded TPCx-BB-like retail tables.

Counterpart of ``spark_rapids_tpu/benchmarks/tpcxbb_datagen.py``: the same
generator, drawing every table in the same order from one
``numpy.random.default_rng(seed)``, so ``generate(sf, seed)`` gives the
reference's arrays bit for bit (strings as object arrays of ``str``,
dates as int64 day numbers from 2001-01-01).  At SF1: 8,000,000
web_clickstreams rows, 100,000 items, 200,000 customers.  ``tables``
turns the chosen tables into this engine's host batches and
``dataframes`` into DataFrames, at the reference's default of two
partitions unless told otherwise, and ``write_parquet`` writes them as
Parquet directories, one a table (as ``tpch_datagen.write_parquet``).
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import numpy as np

from .. import types as T
from ..data.column import HostBatch
from ..interop import from_reference_arrays
from ._util import pick, schema_of


CATEGORIES = ["Books", "Electronics", "Home", "Clothing", "Sports",
              "Music", "Toys", "Garden", "Jewelry", "Shoes"]
CLASSES = ["premium", "economy", "standard", "deluxe", "basic"]
# includes every state set the reference queries predicate on
# (Q9Like's KY/GA/NM, MT/OR/IN, WI/MO/WV bands)
STATES = ["CA", "NY", "TX", "WA", "IL", "FL", "GA", "OH", "MI", "NC",
          "KY", "NM", "MT", "OR", "IN", "WI", "MO", "WV"]
# includes the education levels the reference predicates on
# (Q5Like/Q9Like's '4 yr Degree' / '2 yr Degree')
EDUCATION = ["Primary", "Secondary", "College", "4 yr Degree",
             "2 yr Degree", "Advanced Degree", "Unknown"]
COUNTRIES = ["United States", "Canada"]
MARITAL = ["M", "S", "D", "W", "U"]
GENDER = ["M", "F"]
REVIEW_WORDS = ["great", "terrible", "excellent", "poor", "love",
                "hate", "quality", "broken", "perfect", "awful",
                "recommend", "refund", "fast", "slow", "shiny"]

#: day-number range covered by date_dim: 5 years from 2001-01-01
N_DAYS = 5 * 365


def generate(sf: float = 0.001, seed: int = 99):
    """Return {table: (Schema, {col: np.ndarray})} at ~sf scale."""
    rng = np.random.default_rng(seed)
    n_item = max(12, int(100_000 * sf))
    n_cust = max(10, int(200_000 * sf))
    n_store = max(5, int(100 * sf * 10))
    n_wh = max(2, int(20 * sf * 10))
    n_ss = max(40, int(4_000_000 * sf))
    n_ws = max(30, int(2_000_000 * sf))
    n_wcs = max(60, int(8_000_000 * sf))
    n_pr = max(15, int(300_000 * sf))
    n_inv = n_item * 4

    out = {}

    # date_dim --------------------------------------------------------------
    dsk = np.arange(N_DAYS, dtype=np.int64)
    out["date_dim"] = (schema_of([("d_date_sk", T.INT64),
                                ("d_year", T.INT32),
                                ("d_moy", T.INT32),
                                ("d_dom", T.INT32)]),
                       {"d_date_sk": dsk,
                        "d_year": (2001 + dsk // 365).astype(np.int32),
                        "d_moy": ((dsk % 365) // 31 + 1).clip(1, 12)
                        .astype(np.int32),
                        "d_dom": ((dsk % 365) % 31 + 1).astype(np.int32)})

    # item ------------------------------------------------------------------
    isk = np.arange(1, n_item + 1, dtype=np.int64)
    cat_id = rng.integers(0, len(CATEGORIES), n_item)
    out["item"] = (schema_of([("i_item_sk", T.INT64),
                            ("i_item_id", T.STRING),
                            ("i_category", T.STRING),
                            ("i_category_id", T.INT32),
                            ("i_class", T.STRING),
                            ("i_class_id", T.INT32),
                            ("i_current_price", T.FLOAT64),
                            ("i_brand_id", T.INT32)]),
                   {"i_item_sk": isk,
                    "i_item_id": np.array(
                        [f"ITEM{i:08d}" for i in isk], dtype=object),
                    "i_category": np.array(CATEGORIES, dtype=object)[cat_id],
                    "i_category_id": cat_id.astype(np.int32),
                    "i_class": pick(rng, n_item, CLASSES),
                    # 1..15 — the class-id space Q26Like pivots over
                    "i_class_id": rng.integers(1, 16, n_item)
                    .astype(np.int32),
                    "i_current_price": np.round(
                        rng.uniform(0.5, 300.0, n_item), 2),
                    "i_brand_id": rng.integers(1, 50, n_item)
                    .astype(np.int32)})

    # customer + address + demographics ------------------------------------
    csk = np.arange(1, n_cust + 1, dtype=np.int64)
    out["customer"] = (schema_of([("c_customer_sk", T.INT64),
                                ("c_first_name", T.STRING),
                                ("c_last_name", T.STRING),
                                ("c_birth_year", T.INT32),
                                ("c_current_addr_sk", T.INT64),
                                ("c_current_cdemo_sk", T.INT64)]),
                       {"c_customer_sk": csk,
                        "c_first_name": np.array(
                            [f"First{i % 97}" for i in csk], dtype=object),
                        "c_last_name": np.array(
                            [f"Last{i % 89}" for i in csk], dtype=object),
                        "c_birth_year": rng.integers(1930, 2000, n_cust)
                        .astype(np.int32),
                        "c_current_addr_sk": rng.integers(
                            1, n_cust + 1, n_cust).astype(np.int64),
                        "c_current_cdemo_sk": rng.integers(
                            1, n_cust + 1, n_cust).astype(np.int64)})
    out["customer_address"] = (schema_of([("ca_address_sk", T.INT64),
                                        ("ca_state", T.STRING),
                                        ("ca_city", T.STRING),
                                        ("ca_country", T.STRING)]),
                               {"ca_address_sk": csk,
                                "ca_state": pick(rng, n_cust, STATES),
                                "ca_city": np.array(
                                    [f"City{i % 53}" for i in csk],
                                    dtype=object),
                                "ca_country": np.where(
                                    rng.random(n_cust) < 0.9,
                                    COUNTRIES[0], COUNTRIES[1])
                                .astype(object)})
    out["customer_demographics"] = (
        schema_of([("cd_demo_sk", T.INT64),
                 ("cd_gender", T.STRING),
                 ("cd_marital_status", T.STRING),
                 ("cd_education_status", T.STRING)]),
        {"cd_demo_sk": csk,
         "cd_gender": pick(rng, n_cust, GENDER),
         "cd_marital_status": pick(rng, n_cust, MARITAL),
         "cd_education_status": pick(rng, n_cust, EDUCATION)})

    # store / warehouse -----------------------------------------------------
    ssk = np.arange(1, n_store + 1, dtype=np.int64)
    out["store"] = (schema_of([("s_store_sk", T.INT64),
                             ("s_store_name", T.STRING)]),
                    {"s_store_sk": ssk,
                     "s_store_name": np.array(
                         [f"Store{i}" for i in ssk], dtype=object)})
    wsk = np.arange(1, n_wh + 1, dtype=np.int64)
    out["warehouse"] = (schema_of([("w_warehouse_sk", T.INT64),
                                 ("w_warehouse_name", T.STRING),
                                 ("w_state", T.STRING)]),
                        {"w_warehouse_sk": wsk,
                         "w_warehouse_name": np.array(
                             [f"Warehouse{i}" for i in wsk], dtype=object),
                         "w_state": pick(rng, n_wh, STATES)})

    # store_sales -----------------------------------------------------------
    ss_item = rng.integers(1, n_item + 1, n_ss).astype(np.int64)
    ss_price = np.round(rng.uniform(1.0, 300.0, n_ss), 2)
    ss_qty = rng.integers(1, 20, n_ss).astype(np.int32)
    out["store_sales"] = (schema_of([("ss_sold_date_sk", T.INT64),
                                   ("ss_item_sk", T.INT64),
                                   ("ss_customer_sk", T.INT64),
                                   ("ss_cdemo_sk", T.INT64),
                                   ("ss_addr_sk", T.INT64),
                                   ("ss_store_sk", T.INT64),
                                   ("ss_ticket_number", T.INT64),
                                   ("ss_quantity", T.INT32),
                                   ("ss_sales_price", T.FLOAT64),
                                   ("ss_net_paid", T.FLOAT64),
                                   ("ss_net_profit", T.FLOAT64)]),
                          {"ss_sold_date_sk": rng.integers(0, N_DAYS, n_ss)
                           .astype(np.int64),
                           "ss_item_sk": ss_item,
                           "ss_customer_sk": rng.integers(
                               1, n_cust + 1, n_ss).astype(np.int64),
                           "ss_cdemo_sk": rng.integers(
                               1, n_cust + 1, n_ss).astype(np.int64),
                           "ss_addr_sk": rng.integers(
                               1, n_cust + 1, n_ss).astype(np.int64),
                           "ss_store_sk": rng.integers(
                               1, n_store + 1, n_ss).astype(np.int64),
                           # ~4 line items per ticket (basket analyses)
                           "ss_ticket_number": np.sort(rng.integers(
                               1, max(2, n_ss // 4), n_ss)).astype(np.int64),
                           "ss_quantity": ss_qty,
                           "ss_sales_price": ss_price,
                           "ss_net_paid": np.round(ss_price * ss_qty, 2),
                           # spans Q9Like's profit bands (0-2000,
                           # 150-3000, 50-25000) with negatives mixed in
                           "ss_net_profit": np.round(
                               rng.uniform(-500.0, 26_000.0, n_ss), 2)})

    # web_sales -------------------------------------------------------------
    ws_price = np.round(rng.uniform(1.0, 300.0, n_ws), 2)
    ws_qty = rng.integers(1, 20, n_ws).astype(np.int32)
    out["web_sales"] = (schema_of([("ws_sold_date_sk", T.INT64),
                                 ("ws_item_sk", T.INT64),
                                 ("ws_bill_customer_sk", T.INT64),
                                 ("ws_order_number", T.INT64),
                                 ("ws_warehouse_sk", T.INT64),
                                 ("ws_quantity", T.INT32),
                                 ("ws_sales_price", T.FLOAT64),
                                 ("ws_net_paid", T.FLOAT64)]),
                        {"ws_sold_date_sk": rng.integers(0, N_DAYS, n_ws)
                         .astype(np.int64),
                         "ws_item_sk": rng.integers(1, n_item + 1, n_ws)
                         .astype(np.int64),
                         "ws_bill_customer_sk": rng.integers(
                             1, n_cust + 1, n_ws).astype(np.int64),
                         "ws_order_number": np.sort(rng.integers(
                             1, max(2, n_ws // 3), n_ws)).astype(np.int64),
                         "ws_warehouse_sk": rng.integers(
                             1, n_wh + 1, n_ws).astype(np.int64),
                         "ws_quantity": ws_qty,
                         "ws_sales_price": ws_price,
                         "ws_net_paid": np.round(ws_price * ws_qty, 2)})

    # returns (subset of sales rows) ----------------------------------------
    n_sr = max(8, n_ss // 10)
    sr_idx = rng.choice(n_ss, n_sr, replace=False)
    out["store_returns"] = (
        schema_of([("sr_returned_date_sk", T.INT64),
                 ("sr_item_sk", T.INT64),
                 ("sr_customer_sk", T.INT64),
                 ("sr_ticket_number", T.INT64),
                 ("sr_return_quantity", T.INT32)]),
        {"sr_returned_date_sk": (
            out["store_sales"][1]["ss_sold_date_sk"][sr_idx]
            + rng.integers(1, 90, n_sr)).astype(np.int64),
         "sr_item_sk": out["store_sales"][1]["ss_item_sk"][sr_idx],
         "sr_customer_sk":
             out["store_sales"][1]["ss_customer_sk"][sr_idx],
         "sr_ticket_number":
             out["store_sales"][1]["ss_ticket_number"][sr_idx],
         "sr_return_quantity": rng.integers(1, 5, n_sr).astype(np.int32)})
    n_wr = max(6, n_ws // 10)
    wr_idx = rng.choice(n_ws, n_wr, replace=False)
    out["web_returns"] = (
        schema_of([("wr_returned_date_sk", T.INT64),
                 ("wr_item_sk", T.INT64),
                 ("wr_refunded_customer_sk", T.INT64),
                 ("wr_order_number", T.INT64),
                 ("wr_return_quantity", T.INT32),
                 ("wr_refunded_cash", T.FLOAT64)]),
        {"wr_returned_date_sk": (
            out["web_sales"][1]["ws_sold_date_sk"][wr_idx]
            + rng.integers(1, 90, n_wr)).astype(np.int64),
         "wr_item_sk": out["web_sales"][1]["ws_item_sk"][wr_idx],
         "wr_refunded_customer_sk":
             out["web_sales"][1]["ws_bill_customer_sk"][wr_idx],
         "wr_order_number": out["web_sales"][1]["ws_order_number"][wr_idx],
         "wr_return_quantity": rng.integers(1, 5, n_wr).astype(np.int32),
         "wr_refunded_cash": np.round(
             out["web_sales"][1]["ws_sales_price"][wr_idx]
             * rng.uniform(0.1, 1.0, n_wr), 2)})

    # web_clickstreams ------------------------------------------------------
    out["web_clickstreams"] = (
        schema_of([("wcs_click_date_sk", T.INT64),
                 ("wcs_click_time_sk", T.INT64),
                 ("wcs_user_sk", T.INT64),
                 ("wcs_item_sk", T.INT64),
                 ("wcs_sales_sk", T.INT64)]),
        # clicks concentrate on fewer users/days so user+day "sessions"
        # regularly contain several clicks (basket/affinity queries)
        {"wcs_click_date_sk": rng.integers(0, min(N_DAYS, 300), n_wcs)
         .astype(np.int64),
         "wcs_click_time_sk": rng.integers(0, 86400, n_wcs)
         .astype(np.int64),
         "wcs_user_sk": rng.integers(1, max(3, n_cust // 4), n_wcs)
         .astype(np.int64),
         "wcs_item_sk": rng.integers(1, n_item + 1, n_wcs)
         .astype(np.int64),
         # ~20% of clicks convert to a sale
         "wcs_sales_sk": np.where(rng.random(n_wcs) < 0.2,
                                  rng.integers(1, max(2, n_ws), n_wcs),
                                  0).astype(np.int64)})

    # product_reviews -------------------------------------------------------
    words = np.array(REVIEW_WORDS, dtype=object)
    ridx = rng.integers(0, len(words), (n_pr, 6))
    out["product_reviews"] = (
        schema_of([("pr_review_sk", T.INT64),
                 ("pr_item_sk", T.INT64),
                 ("pr_user_sk", T.INT64),
                 ("pr_review_date_sk", T.INT64),
                 ("pr_review_rating", T.INT32),
                 ("pr_review_content", T.STRING)]),
        {"pr_review_sk": np.arange(1, n_pr + 1, dtype=np.int64),
         "pr_item_sk": rng.integers(1, n_item + 1, n_pr).astype(np.int64),
         "pr_user_sk": rng.integers(1, n_cust + 1, n_pr).astype(np.int64),
         "pr_review_date_sk": rng.integers(0, N_DAYS, n_pr)
         .astype(np.int64),
         "pr_review_rating": rng.integers(1, 6, n_pr).astype(np.int32),
         "pr_review_content": np.array(
             [" ".join(words[r]) for r in ridx], dtype=object)})

    # inventory -------------------------------------------------------------
    inv_item = np.repeat(isk, 4)
    out["inventory"] = (
        schema_of([("inv_date_sk", T.INT64),
                 ("inv_item_sk", T.INT64),
                 ("inv_warehouse_sk", T.INT64),
                 ("inv_quantity_on_hand", T.INT32)]),
        {"inv_date_sk": rng.integers(0, N_DAYS, n_inv).astype(np.int64),
         "inv_item_sk": inv_item,
         "inv_warehouse_sk": ((inv_item % n_wh) + 1).astype(np.int64),
         "inv_quantity_on_hand": rng.integers(0, 1000, n_inv)
         .astype(np.int32)})

    return out


def tables(sf: float = 0.001, seed: int = 99,
           names: Optional[Iterable[str]] = None) -> Dict[str, HostBatch]:
    """The generated tables (all, or ``names``) as host batches."""
    return tables_of(generate(sf, seed), names)


def tables_of(generated, names: Optional[Iterable[str]] = None
              ) -> Dict[str, HostBatch]:
    """``generate``'s output (all tables, or ``names``) as host batches."""
    out = {}
    for name, (schema, cols) in generated.items():
        if names is None or name in names:
            out[name] = from_reference_arrays(
                [(f.name, f.dtype.sql_name) for f in schema],
                [cols[f.name] for f in schema])
    return out


def columns_of(generated, columns: Dict[str, Iterable[str]]
               ) -> Dict[str, HostBatch]:
    """``generate``'s output cut to ``columns`` (table -> the column
    names to keep; they keep the table's order), as host batches."""
    out = {}
    for table, names in columns.items():
        schema, cols = generated[table]
        fields = [(fl.name, fl.dtype.sql_name) for fl in schema
                  if fl.name in names]
        out[table] = from_reference_arrays(fields,
                                           [cols[n] for n, _ in fields])
    return out


def dataframes(session, sf: float = 0.001, seed: int = 99,
               names: Optional[Iterable[str]] = None,
               n_partitions: int = 2):
    return {name: session.create_dataframe(b, n_partitions=n_partitions)
            for name, b in tables(sf, seed, names).items()}


def write_parquet(session, path: str, sf: float = 0.001, seed: int = 99):
    """The generated tables as Parquet directories under ``path``
    (``path/<table>/part-0000p.parquet``, two partitions a table)."""
    for name, df in dataframes(session, sf, seed).items():
        df.write_parquet(os.path.join(path, name))
