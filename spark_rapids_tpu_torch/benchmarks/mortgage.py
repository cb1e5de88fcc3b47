"""Mortgage ETL benchmark.

Counterpart of ``spark_rapids_tpu/benchmarks/mortgage.py`` (the
reference's port of spark-rapids' ``MortgageSpark.scala``): clean the
monthly loan-performance records, aggregate them per loan, join the
result onto the acquisitions and emit the ML-ready feature frame.
``generate``, ``dataframes``, ``etl`` and ``summary`` are the reference's
code.  ``tables`` makes the same draws as ``generate`` but encodes the
two string columns by indexing the six seller names, encoded once, with
the drawn codes (``generate``'s object arrays of 60,000,000 strings at
sf 50 would take minutes to encode); ``oracle_etl``, ``oracle_summary``
and ``oracle_features`` compute the answers with numpy alone.

Two tables:
  perf(loan_id, period, servicer, interest_rate, current_upb,
       loan_age, delinquency_status)   12 monthly records a loan
  acq(loan_id, orig_rate, orig_upb, orig_date_sk, seller, credit_score)
At sf 1: 100,000 loans and 1,200,000 records.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .. import types as T
from ..data import strings as dstrings
from ..data.column import HostBatch, HostColumn
from ..plan import functions as F
from ._util import pick, schema_of

col = F.col
lit = F.lit

SELLERS = ["BANK OF AMERICA", "WELLS FARGO", "JPMORGAN", "CITI",
           "QUICKEN", "OTHER"]

PERF_SCHEMA = schema_of([("loan_id", T.INT64), ("period", T.INT32),
                       ("servicer", T.STRING),
                       ("interest_rate", T.FLOAT64),
                       ("current_upb", T.FLOAT64),
                       ("loan_age", T.INT32),
                       ("delinquency_status", T.INT32)])
ACQ_SCHEMA = schema_of([("loan_id", T.INT64), ("orig_rate", T.FLOAT64),
                      ("orig_upb", T.FLOAT64),
                      ("orig_date_sk", T.INT64),
                      ("seller", T.STRING),
                      ("credit_score", T.INT32)])
#: the feature frame's numeric columns (every ETL column but ``seller``),
#: in its column order
FEATURES = ["loan_id", "credit_score", "orig_upb", "rate_spread",
            "worst_dlq", "months_delinquent", "first_dlq_period",
            "avg_upb", "ever_90"]


def _draw(sf: float, seed: int, pick):
    """The reference's draws, in its order; ``pick`` makes the string
    columns from the same draws."""
    rng = np.random.default_rng(seed)
    n_loan = max(20, int(100_000 * sf))
    n_perf = n_loan * 12  # a year of monthly records per loan

    loan = np.repeat(np.arange(1, n_loan + 1, dtype=np.int64), 12)
    period = np.tile(np.arange(12, dtype=np.int32), n_loan)
    # delinquency: mostly current, occasional 30/60/90+ day states
    dlq = rng.choice([0, 0, 0, 0, 0, 0, 1, 2, 3], size=n_perf) \
        .astype(np.int32)
    upb0 = rng.uniform(50_000, 800_000, n_loan)
    upb = (np.repeat(upb0, 12) * (1.0 - 0.002 * period)).round(2)
    perf = {"loan_id": loan,
            "period": period,
            "servicer": pick(rng, n_perf, SELLERS),
            "interest_rate": np.round(
                np.repeat(rng.uniform(2.5, 7.5, n_loan), 12), 3),
            "current_upb": upb,
            "loan_age": period,
            "delinquency_status": dlq}
    acq = {"loan_id": np.arange(1, n_loan + 1, dtype=np.int64),
           "orig_rate": np.round(rng.uniform(2.5, 7.5, n_loan), 3),
           "orig_upb": upb0.round(2),
           "orig_date_sk": rng.integers(0, 1825, n_loan).astype(np.int64),
           "seller": pick(rng, n_loan, SELLERS),
           "credit_score": rng.integers(450, 850, n_loan)
           .astype(np.int32)}
    return {"perf": (PERF_SCHEMA, perf), "acq": (ACQ_SCHEMA, acq)}


def generate(sf: float = 0.01, seed: int = 31):
    """{table: (Schema, {column: array})}, the reference's arrays bit for
    bit (strings as object arrays of ``str``)."""
    return _draw(sf, seed, pick)


def _encoded_pick(rng, n, choices) -> HostColumn:
    """``pick``'s draw as a string column: the choices encoded once, their
    rows indexed by the drawn codes."""
    bm, ln = dstrings.encode(list(choices))
    codes = rng.integers(0, len(choices), n)
    return HostColumn(T.STRING, bm[codes], None, ln[codes])


def tables(sf: float = 0.01, seed: int = 31) -> Dict[str, HostBatch]:
    """``generate``'s tables as host batches."""
    out = {}
    for name, (schema, cols) in _draw(sf, seed, _encoded_pick).items():
        out[name] = HostBatch(schema, [
            cols[f.name] if f.dtype.is_string else
            HostColumn(f.dtype, cols[f.name]) for f in schema])
    return out


def dataframes(session, sf: float = 0.01, seed: int = 31,
               n_partitions: int = 2):
    return {name: session.create_dataframe(b, n_partitions=n_partitions)
            for name, b in tables(sf, seed).items()}


def etl(t):
    """The ETL: per-loan delinquency aggregates joined back onto the
    acquisition records, emitting the feature frame (reference:
    MortgageSpark's createDelinquency + join with acquisition)."""
    perf = t["perf"]
    dlq = (perf.group_by(col("loan_id").alias("dl"))
           .agg(F.max("delinquency_status").alias("worst_dlq"),
                F.sum(F.if_(col("delinquency_status") >= lit(1),
                            lit(1), lit(0))).alias("months_delinquent"),
                F.min(F.if_(col("delinquency_status") >= lit(1),
                            col("period"), lit(999)))
                .alias("first_dlq_period"),
                F.avg("current_upb").alias("avg_upb"),
                F.count("*").alias("n_records")))
    j = (t["acq"].join(dlq, on=(["loan_id"], ["dl"]), how="left")
         .with_column("worst_dlq", F.coalesce(col("worst_dlq"), lit(0)))
         .with_column("months_delinquent",
                      F.coalesce(col("months_delinquent"), lit(0)))
         .with_column("ever_90",
                      F.if_(col("worst_dlq") >= lit(3), lit(1), lit(0)))
         .with_column("rate_spread",
                      col("orig_rate") - lit(4.0)))
    return (j.select("loan_id", "seller", "credit_score", "orig_upb",
                     "rate_spread", "worst_dlq", "months_delinquent",
                     "first_dlq_period", "avg_upb", "ever_90")
            .sort("loan_id"))


def summary(t):
    """Per-seller portfolio summary over the ETL output."""
    return (etl(t).group_by("seller")
            .agg(F.count("*").alias("loans"),
                 F.avg("credit_score").alias("avg_score"),
                 F.sum("ever_90").alias("ever_90_loans"),
                 F.sum("orig_upb").alias("portfolio_upb"))
            .sort("seller"))


# --------------------------------------------------------------------------
# numpy oracles
# --------------------------------------------------------------------------
def _arrays(batch: HostBatch):
    return {f.name: c for f, c in zip(batch.schema, batch.columns)}


def oracle_etl(tabs: Dict[str, HostBatch]):
    """``etl``'s result with numpy: {column: (data, valid)} in loan_id
    order; ``seller`` as (bytes matrix, lengths) rows of the encoding."""
    p, a = _arrays(tabs["perf"]), _arrays(tabs["acq"])
    loan = p["loan_id"].data
    order = None
    if len(loan) > 1 and not bool((loan[1:] >= loan[:-1]).all()):
        order = np.argsort(loan, kind="stable")

    def by_loan(x):
        return x if order is None else x[order]
    lk = by_loan(loan)
    first = np.ones(len(lk), dtype=bool)
    first[1:] = lk[1:] != lk[:-1]
    starts = np.flatnonzero(first)
    keys = lk[starts]
    counts = np.diff(np.append(starts, len(lk)))
    dlq = by_loan(p["delinquency_status"].data)
    late = dlq >= 1
    worst = np.maximum.reduceat(dlq, starts)
    months = np.add.reduceat(late.astype(np.int64), starts)
    first_p = np.minimum.reduceat(
        np.where(late, by_loan(p["period"].data), 999).astype(np.int32),
        starts)
    avg = np.add.reduceat(by_loan(p["current_upb"].data), starts) / counts
    # the left join of the acquisitions with the per-loan aggregates
    aid = a["loan_id"].data
    pos = np.clip(np.searchsorted(keys, aid), 0, max(len(keys) - 1, 0))
    hit = keys[pos] == aid if len(keys) else np.zeros(len(aid), bool)
    rows = np.argsort(aid, kind="stable")

    def take(x, fill, dtype):
        return np.where(hit, x[pos], fill).astype(dtype)[rows]

    worst_j = take(worst, 0, np.int32)
    s = a["seller"]
    return {
        "loan_id": (aid[rows], None),
        "seller": ((s.data[rows], s.lengths[rows]), None),
        "credit_score": (a["credit_score"].data[rows], None),
        "orig_upb": (a["orig_upb"].data[rows], None),
        "rate_spread": ((a["orig_rate"].data - 4.0)[rows], None),
        "worst_dlq": (worst_j, None),
        "months_delinquent": (take(months, 0, np.int64), None),
        "first_dlq_period": (take(first_p, 0, np.int32), hit[rows]),
        "avg_upb": (take(avg, 0.0, np.float64), hit[rows]),
        "ever_90": ((worst_j >= 3).astype(np.int32), None),
    }


def oracle_features(want) -> np.ndarray:
    """``oracle_etl``'s numeric columns as the float64 ``[rows, 9]``
    matrix of ``FEATURES``, the rows with a null dropped."""
    keep = np.ones(len(want["loan_id"][0]), dtype=bool)
    for name in FEATURES:
        if want[name][1] is not None:
            keep &= want[name][1]
    return np.stack([want[n][0][keep].astype(np.float64)
                     for n in FEATURES], axis=1)


def check_etl(got: HostBatch, want) -> None:
    """Raise unless ``got`` (``etl``'s result batch) equals ``want``
    (``oracle_etl``): integers, strings and nulls exact, floats to rel
    1e-9, in loan_id order."""
    g = _arrays(got)
    n = len(want["loan_id"][0])
    if got.num_rows != n:
        raise AssertionError(f"etl: {got.num_rows} rows, want {n}")
    for name, (data, valid) in want.items():
        c = g[name]
        v = c.is_valid()
        if not np.array_equal(v, np.ones(n, bool) if valid is None
                              else valid):
            raise AssertionError(f"etl: {name}'s nulls differ")
        if name == "seller":
            bm, ln = data
            w = max(bm.shape[1], c.data.shape[1])
            if not (np.array_equal(c.lengths, ln) and np.array_equal(
                    dstrings.pad_width(c.data, w),
                    dstrings.pad_width(bm, w))):
                raise AssertionError("etl: seller differs")
            continue
        x = c.data[v]
        y = data[v]
        if np.issubdtype(y.dtype, np.floating):
            bad = ~(np.abs(x - y) <= 1e-9 * np.abs(y))
        else:
            bad = x != y
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise AssertionError(f"etl: {name} differs at {int(bad.sum())} "
                                 f"rows, first {x[i]!r} vs {y[i]!r}")


def oracle_summary(want):
    """``summary``'s rows from ``oracle_etl``'s columns: per seller, the
    loans, average credit score, loans ever 90 days late and the
    original balances, by seller."""
    bm, ln = want["seller"][0]
    codes = {s: i for i, s in enumerate(SELLERS)}
    enc_bm, enc_ln = dstrings.encode(list(SELLERS))
    w = max(bm.shape[1], enc_bm.shape[1])
    enc = dstrings.pad_width(enc_bm, w)
    rows_bm = dstrings.pad_width(bm, w)
    code = np.full(len(ln), -1, dtype=np.int64)
    for s, i in codes.items():
        code[(rows_bm == enc[i]).all(axis=1) & (ln == enc_ln[i])] = i
    if (code < 0).any():
        raise AssertionError("summary oracle: a seller outside SELLERS")
    out = []
    for s in sorted(SELLERS):
        m = code == codes[s]
        if not m.any():
            continue
        out.append((s, int(m.sum()),
                    float(want["credit_score"][0][m].astype(np.int64).sum()
                          / m.sum()),
                    int(want["ever_90"][0][m].astype(np.int64).sum()),
                    float(want["orig_upb"][0][m].sum())))
    return out
