"""Window functions through spark_rapids_tpu_torch (on CPU tensors, where
K1, K2, K4 and K14 take their plain versions) against the JAX package's
device window exec (``TpuWindowExec`` on JAX-CPU), on the same data.

Every case of ``tests/test_window.py`` runs here, plus first/last with
and without ``ignore_nulls`` over every frame kind, nulls first and last
in the order keys, no partition keys, no order keys, NaN and -0.0 in
float min/max (compared by ``repr``: the sign of a zero counts), int64
sums that wrap, and a long float segment.  Keys, counts, ranks and
integer results are equal; a float window sum is a difference of two
prefix sums, so its error scales with the prefix, not with the frame:
float results agree to rel 1e-9 of max(|result|, S), where S, the sum of
|v| over the column, bounds every prefix sum |P[hi]|.  The explain marks
equal the reference's, and a string frame aggregate, which the reference
sends to its host engine, raises naming the reference's reason."""
import math
import re

import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import f as JF
from spark_rapids_tpu.ops import windowexprs as JW
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import f as PF
from spark_rapids_tpu_torch.ops import windowexprs as PW

DATA = {
    "k": [1, 1, 1, 2, 2, None, 1, 2, 2, 1],
    "t": [3, 1, 2, 5, 4, 1, 1, 4, None, 9],
    "v": [1.0, 2.0, None, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0],
}
RANK_DATA = {"k": [1, 1, 1, 1, 2, 2, 2],
             "t": [1, 1, 2, 3, 5, 5, 5],
             "v": [1.0] * 7}


def _marks(report):
    return [tuple(re.match(r"\s*([*!@]) (\w+)", line).groups())
            for line in report.splitlines()]


def _scale(data):
    vals = [abs(v) for v in data.get("v", []) if isinstance(v, float)
            and math.isfinite(v)]
    return sum(vals)


def _same_rows(got, want, scale):
    got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float) and \
                    math.isfinite(b):
                assert abs(a - b) <= 1e-9 * max(abs(b), scale), (g, w)
            else:
                assert repr(a) == repr(b), (g, w)


def _run_both(build, data=DATA, n_partitions=2, exact=False):
    """``build(F, W)`` makes the window expression from one package's
    functions and windowexprs modules."""
    jdf = jsrt.Session().create_dataframe(data, n_partitions=n_partitions)
    jq = jdf.with_window("w", build(JF, JW))
    pdf = Session(device="cpu").create_dataframe(data,
                                                 n_partitions=n_partitions)
    pq = pdf.with_window("w", build(PF, PW))
    assert _marks(pq.explain()) == _marks(jq.explain())
    assert "* WindowExec -> will run on the device" in pq.explain()
    got, want = pq.collect(), jq.collect()
    if exact:
        assert sorted(map(repr, got)) == sorted(map(repr, want))
    else:
        _same_rows(got, want, _scale(data))
    return got


def _w(W, part=("k",), order=("t",), frame=None):
    b = W.window()
    if part:
        b = b.partition_by(*part)
    if order:
        b = b.order_by(*order)
    if frame is not None:
        b = b.rows_between(*frame)
    return b


# --------------------------------------------------------------------------
# the cases of tests/test_window.py
# --------------------------------------------------------------------------
def test_row_number():
    _run_both(lambda F, W: W.over(W.row_number(), _w(W)), exact=True)


@pytest.mark.parametrize("fn", ["rank", "dense_rank"])
def test_rank_dense_rank(fn):
    _run_both(lambda F, W: W.over(getattr(W, fn)(), _w(W)), data=RANK_DATA,
              exact=True)


@pytest.mark.parametrize("agg", ["sum", "count", "avg", "min", "max"])
def test_unbounded_window_aggs(agg):
    _run_both(lambda F, W: W.over(getattr(F, agg)("v"), _w(W, order=())))


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max"])
def test_running_window_aggs(agg):
    _run_both(lambda F, W: W.over(getattr(F, agg)("v"),
                                  _w(W, frame=(None, 0))))


@pytest.mark.parametrize("agg", ["sum", "min", "max", "count"])
def test_bounded_window_aggs(agg):
    _run_both(lambda F, W: W.over(getattr(F, agg)("v"),
                                  _w(W, frame=(-1, 1))))


def test_window_reverse_running():
    _run_both(lambda F, W: W.over(F.max("v"), _w(W, frame=(0, None))))


def test_window_desc_order_and_large():
    rng = np.random.RandomState(17)
    data = {"k": rng.randint(0, 10, 400).tolist(),
            "t": rng.randint(0, 1000, 400).tolist(),
            "v": rng.rand(400).tolist()}
    _run_both(lambda F, W: W.over(
        F.sum("v"), W.window().partition_by("k")
        .order_by(F.col("t").desc()).rows_between(None, 0)), data=data)


@pytest.mark.parametrize("which", ["first", "last"])
@pytest.mark.parametrize("ignore_nulls", [False, True],
                         ids=["keep_nulls", "ignore_nulls"])
@pytest.mark.parametrize("frame", ["running", "unbounded", "bounded",
                                   "reverse"])
def test_first_last_window(which, ignore_nulls, frame):
    frames = {"running": None, "unbounded": (None, None),
              "bounded": (-1, 1), "reverse": (0, None)}
    _run_both(lambda F, W: W.over(
        getattr(F, which)("v", ignore_nulls=ignore_nulls),
        _w(W, frame=frames[frame])), exact=True)


@pytest.mark.parametrize("agg", ["min", "max"])
def test_wide_bounded_minmax(agg):
    rng = np.random.RandomState(4)
    n = 3000
    data = {"k": rng.randint(0, 3, n).tolist(),
            "t": list(range(n)),
            "v": [float(x) if x > 5 else None
                  for x in rng.randint(0, 100, n)]}
    for lo, hi in [(-700, 0), (-400, 400), (3, 900)]:
        _run_both(lambda F, W: W.over(getattr(F, agg)("v"),
                                      _w(W, frame=(lo, hi))),
                  data=data, exact=True)


@pytest.mark.parametrize("case", ["min", "first"])
def test_string_window_aggregate_raises_with_reference_reason(case):
    data = {"k": [1, 1, 2], "t": [1, 2, 3], "s": ["a", None, "c"]}

    def build(F, W):
        if case == "min":
            return W.over(F.min("s"), W.window().partition_by("k"))
        return W.over(F.first("s"), _w(W))

    jq = jsrt.Session().create_dataframe(data).with_window(
        "w", build(JF, JW))
    pq = Session(device="cpu").create_dataframe(data).with_window(
        "w", build(PF, PW))
    assert "string window aggregates run on the host engine" in \
        jq.explain()
    assert _marks(pq.explain()) == _marks(jq.explain())
    with pytest.raises(NotImplementedError,
                       match="string window aggregates run on the host "
                       "engine"):
        pq.collect()


# --------------------------------------------------------------------------
# further cases
# --------------------------------------------------------------------------
@pytest.mark.parametrize("nulls_first", [True, False],
                         ids=["nulls_first", "nulls_last"])
@pytest.mark.parametrize("ascending", [True, False], ids=["asc", "desc"])
def test_order_nulls_first_and_last(nulls_first, ascending):
    def build(F, W):
        key = F.SortKey(F.col("t").expr, ascending, nulls_first)
        return W.over(F.sum("v"), W.window().partition_by("k")
                      .order_by(key).rows_between(-2, 0))

    _run_both(build)
    _run_both(lambda F, W: W.over(W.row_number(), W.window().partition_by(
        "k").order_by(F.SortKey(F.col("t").expr, ascending, nulls_first))),
        exact=True)


@pytest.mark.parametrize("fn", ["row_number", "rank", "sum", "max"])
def test_no_partition_keys(fn):
    def build(F, W):
        func = getattr(W, fn)() if fn in ("row_number", "rank") \
            else getattr(F, fn)("v")
        return W.over(func, _w(W, part=(), order=("t",),
                               frame=None if fn != "max" else (-1, 2)))

    _run_both(build, n_partitions=1)
    _run_both(build, n_partitions=2)


@pytest.mark.parametrize("fn", ["row_number", "rank", "dense_rank",
                                "first"])
def test_no_order_keys(fn):
    def build(F, W):
        func = F.first("v") if fn == "first" else getattr(W, fn)()
        return W.over(func, _w(W, order=()))

    # every row is its own tie group and rows keep their input order
    _run_both(build, n_partitions=1, exact=True)


@pytest.mark.parametrize("frame", [(None, None), (None, 0), (0, None),
                                   (-1, 1)], ids=["unbounded", "running",
                                                  "reverse", "bounded"])
@pytest.mark.parametrize("agg", ["min", "max"])
def test_nan_and_signed_zero_minmax(agg, frame):
    rng = np.random.default_rng(5)
    n = 300
    pool = [0.0, -0.0, float("nan"), 1.5, -2.5, float("inf"), None]
    data = {"k": rng.integers(0, 4, n).tolist(),
            "t": rng.integers(0, 50, n).tolist(),
            "v": [pool[i] for i in rng.integers(0, len(pool), n)]}
    got = _run_both(lambda F, W: W.over(getattr(F, agg)("v"),
                                        _w(W, frame=frame)),
                    data=data, exact=True)
    # the reference's choice between -0.0 and 0.0: min takes -0.0
    zeros = {repr(r[3]) for r in got
             if isinstance(r[3], float) and r[3] == 0.0}
    if zeros and frame == (None, None):
        assert zeros == {"-0.0" if agg == "min" else "0.0"}


@pytest.mark.parametrize("frame", [(None, 0), (-2, 1)],
                         ids=["running", "bounded"])
def test_int64_sums_wrap(frame):
    big = 2 ** 62
    data = {"k": [1, 1, 1, 1, 2, 2, 2],
            "t": [1, 2, 3, 4, 1, 2, 3],
            "v": [big, big, big, -big, -big, -big, -big]}
    got = _run_both(lambda F, W: W.over(F.sum("v"), _w(W, frame=frame)),
                    data=data, exact=True)
    assert any(r[3] < 0 for r in got if r[0] == 1)  # wrapped past 2**63


def test_long_float_segment_sum():
    """One 20,000-row segment of values ~1e6 with short frames late in
    it: the prefix sums reach ~1e10 while a frame sums ~4e6."""
    rng = np.random.default_rng(11)
    n = 20_000
    data = {"k": [1] * n, "t": list(range(n)),
            "v": (rng.random(n) * 1e6).tolist()}
    _run_both(lambda F, W: W.over(F.sum("v"), _w(W, frame=(-3, 0))),
              data=data, n_partitions=1)
    _run_both(lambda F, W: W.over(F.avg("v"), _w(W, frame=(-3, 0))),
              data=data, n_partitions=1)


def test_group_by_first_last_match_reference_oracle():
    """Group-by First/Last (K3's first/last picks) against the reference's
    host engine, its oracle: with ignore_nulls the JAX package's device
    aggregate returns the first row's null where Spark, the host engine
    and the port return the first non-null value."""
    data = {"k": [1, 1, 2, 2, 2, 3], "v": [None, 2.0, 3.0, None, 5.0, None]}
    for ignore in (False, True):
        for n_partitions in (1, 2):
            jdf = jsrt.Session(tpu_enabled=False).create_dataframe(
                data, n_partitions=n_partitions)
            pdf = Session(device="cpu").create_dataframe(
                data, n_partitions=n_partitions)
            want = jdf.group_by("k").agg(
                JF.first("v", ignore_nulls=ignore).alias("f"),
                JF.last("v", ignore_nulls=ignore).alias("l")).collect()
            got = pdf.group_by("k").agg(
                PF.first("v", ignore_nulls=ignore).alias("f"),
                PF.last("v", ignore_nulls=ignore).alias("l")).collect()
            assert sorted(got, key=repr) == sorted(want, key=repr)
            assert (1, 2.0 if ignore else None, 2.0) in got
