"""``substring`` and ``year`` in spark_rapids_tpu_torch (CPU tensors: K15
and K12 take their plain versions) against the JAX package's device
session, value by value by ``repr``:

* ``Substring`` for pos in {-20, -3, -1, 0, 1, 2, 14, 15, 40} x length in
  {None, -1, 0, 1, 2, 100}, over null rows, empty strings, multi-byte
  UTF-8 rows (cut between bytes, as the reference's device path cuts
  them) and a 15-byte phone number, as projections over a filter: fused
  into one K12 segment (the default) and unfused;
* ``Year`` on dates from 0001-01-01 to 9999-12-31 (negative day numbers,
  leap days, the turn of each century; Python's calendar agrees) and on
  three day numbers before year 1, and on timestamps before and after
  the epoch, fused and unfused;
* Q22's shape: a substring filtered with ``isin`` inside one segment;
* ``substring_plain`` (the CPU path of K15) against the reference's
  ``take_along_axis`` kernel on random byte matrices."""
import datetime as dt

import numpy as np
import pytest
import torch

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import f as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.ops import stringexprs as jst
from spark_rapids_tpu.ops.kernels import stringkernels as jsk
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import f as PF
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.ops import stringexprs as pst
from spark_rapids_tpu_torch.ops.kernels import stringkernels as SK

NO_FUSION = {"spark.rapids.tpu.sql.fusion.enabled": False}
POS = [-20, -3, -1, 0, 1, 2, 14, 15, 40]
LENGTHS = [None, -1, 0, 1, 2, 100]
STRINGS = ["hello world", "", None, "ab", "héllo", "日本語",
           "a", "13-345-678-9012", "x" * 30, None, "é", "tail end"]
EPOCH = dt.date(1970, 1, 1)


def _days(d: dt.date) -> int:
    return (d - EPOCH).days


def _dates():
    fixed = [dt.date(1, 1, 1), dt.date(9999, 12, 31), dt.date(1969, 12, 31),
             dt.date(1970, 1, 1), dt.date(2000, 2, 29), dt.date(2000, 3, 1),
             dt.date(1900, 2, 28), dt.date(1900, 3, 1), dt.date(1600, 2, 29),
             dt.date(4, 2, 29), dt.date(100, 12, 31), dt.date(101, 1, 1),
             dt.date(1582, 10, 15), dt.date(2024, 12, 31)]
    rng = np.random.default_rng(9)
    lo, hi = _days(dt.date(1, 1, 1)), _days(dt.date(9999, 12, 31))
    return [_days(d) for d in fixed] + rng.integers(lo, hi + 1, 300).tolist()


#: day numbers before 0001-01-01 (proleptic years 0 and below), where
#: the civil-from-days offset leaves a negative count to floor
BEFORE_YEAR_1 = [-719163, -719469, -1_000_000]


def _frames(data, jfields, pfields, conf=None):
    jdf = jsrt.Session(conf).create_dataframe(
        data, JT.Schema([JT.Field(n, t) for n, t in jfields]),
        n_partitions=1)
    pdf = Session(conf, device="cpu").create_dataframe(
        data, PT.Schema([PT.Field(n, t) for n, t in pfields]),
        n_partitions=1)
    return jdf, pdf


def _substrings(F, st, df):
    cols = []
    for i, pos in enumerate(POS):
        for j, ln in enumerate(LENGTHS):
            e = st.Substring(F.col("s").expr, pos, ln)
            cols.append(F.Column(e).alias(f"c{i}_{j}"))
    return df.filter(F.col("k") >= F.lit(0)).select("k", *cols)


@pytest.mark.parametrize("fusion", ["on", "off"])
def test_substring_matches_reference(fusion):
    conf = None if fusion == "on" else NO_FUSION
    data = {"k": list(range(len(STRINGS))), "s": STRINGS}
    jdf, pdf = _frames(data, [("k", JT.INT64), ("s", JT.STRING)],
                       [("k", PT.INT64), ("s", PT.STRING)], conf)
    want = _substrings(JF, jst, jdf).collect()
    pq = _substrings(PF, pst, pdf)
    got = pq.collect()
    assert [tuple(map(repr, r)) for r in got] == \
        [tuple(map(repr, r)) for r in want]
    plan = str(pdf.session.physical_plan(pq.plan))
    assert ("TpuFusedSegment[2:" in plan) == (fusion == "on")
    # spot checks of the semantics: 1-based, 0 acts as 1, negative from
    # the end, None to the end, null stays null
    row = {r[0]: r for r in got}[7]  # "13-345-678-9012"
    at = {(p, ln): row[1 + i * len(LENGTHS) + j]
          for i, p in enumerate(POS) for j, ln in enumerate(LENGTHS)}
    assert at[(1, 2)] == "13" and at[(0, 2)] == "13"
    assert at[(-3, None)] == "012" and at[(-20, 2)] == "13"
    assert at[(15, 100)] == "2" and at[(40, 1)] == "" and at[(2, -1)] == ""
    assert all(v is None for v in {r[0]: r for r in got}[2][1:])


def _years(F, df):
    return df.filter(F.col("k") >= F.lit(0)).select(
        "k", F.year(F.col("d")).alias("y"), F.year(F.col("t")).alias("yt"))


@pytest.mark.parametrize("fusion", ["on", "off"])
def test_year_matches_reference_and_calendar(fusion):
    conf = None if fusion == "on" else NO_FUSION
    days = _dates() + BEFORE_YEAR_1
    rng = np.random.default_rng(4)
    micros = (np.array(days, dtype=np.int64) * 86_400_000_000
              + rng.integers(0, 86_400_000_000, len(days))).tolist()
    micros[3] = -1  # one microsecond before the epoch: 1969
    data = {"k": list(range(len(days))), "d": days, "t": micros}
    jdf, pdf = _frames(
        data, [("k", JT.INT64), ("d", JT.DATE32), ("t", JT.TIMESTAMP)],
        [("k", PT.INT64), ("d", PT.DATE32), ("t", PT.TIMESTAMP)], conf)
    want = _years(JF, jdf).collect()
    pq = _years(PF, pdf)
    got = pq.collect()
    assert [tuple(map(repr, r)) for r in got] == \
        [tuple(map(repr, r)) for r in want]
    assert [r[1] for r in got[-3:]] == [0, 0, -768]
    for k, y, yt in got[:-3]:
        assert y == (EPOCH + dt.timedelta(days=days[k])).year
        assert yt == (EPOCH + dt.timedelta(microseconds=micros[k])).year
    plan = str(pdf.session.physical_plan(pq.plan))
    assert ("TpuFusedSegment[2:" in plan) == (fusion == "on")


def _q22_shape(F, df):
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    return (df.with_column("cntrycode", F.substring(F.col("s"), 1, 2))
            .filter(F.col("cntrycode").isin(*codes))
            .select("k", "cntrycode"))


@pytest.mark.parametrize("fusion", ["on", "off"])
def test_substring_isin_segment_matches_reference(fusion):
    conf = None if fusion == "on" else NO_FUSION
    rng = np.random.default_rng(12)
    phones = [f"{a}-{b}" for a, b in zip(rng.integers(10, 35, 200),
                                         rng.integers(100, 1000, 200))]
    phones[5] = None
    phones[6] = "1"
    data = {"k": list(range(200)), "s": phones}
    jdf, pdf = _frames(data, [("k", JT.INT64), ("s", JT.STRING)],
                       [("k", PT.INT64), ("s", PT.STRING)], conf)
    got = _q22_shape(PF, pdf).collect()
    assert got == _q22_shape(JF, jdf).collect() and 0 < len(got) < 200
    plan = str(pdf.session.physical_plan(_q22_shape(PF, pdf).plan))
    assert ("TpuFusedSegment[3: TpuProject[k, s, Substring(s) AS "
            "cntrycode] -> TpuFilter[InSet(cntrycode)]" in plan) == \
        (fusion == "on")


@pytest.mark.parametrize("w", [1, 3, 15])
def test_substring_plain_matches_reference_kernel(w):
    rng = np.random.default_rng(w)
    n = 257
    bm = rng.integers(0, 256, (n, w)).astype(np.uint8)
    ln = rng.integers(0, w + 1, n).astype(np.int32)
    pos = np.arange(w)[None, :]
    bm = np.where(pos < ln[:, None], bm, 0).astype(np.uint8)
    for start in (-w - 5, -w, -2, -1, 0, 1, w - 1, w, w + 3):
        for sub_len in (-1, 0, 1, 2, w, w + 7):
            out_w = min(max(sub_len, 1), w)
            jb, jl = jsk.substring(bm, ln, start, sub_len, out_w)
            pb, pl = SK.substring(torch.from_numpy(bm), torch.from_numpy(ln),
                                  start, sub_len, out_w)
            assert pb.dtype == torch.uint8 and pl.dtype == torch.int32
            assert np.array_equal(pb.numpy(), np.asarray(jb))
            assert np.array_equal(pl.numpy(), np.asarray(jl))
