"""Cast in spark_rapids_tpu_torch (on CPU tensors, where K16 and K17 take
their plain versions) against the JAX package's device session on
JAX-CPU, on the same seeded inputs.

* Every case of the reference's ``tests/test_cast.py`` (string -> four
  integer widths, boolean, date, timestamp, double; integer, boolean,
  date and timestamp -> string; the strict pipeline; the seeded round
  trips), through both packages under the same conf: the same rows, by
  ``repr`` (floats bit for bit).
* The numeric matrix: every primitive source type to every target the
  device takes, with NaN, +-inf, -0.0, out-of-range floats to every
  integer width, wrapping narrowing, and dates and timestamps on both
  sides of 1970: the same rows by ``repr``.
* The plain versions of ``castkernels`` against the reference's
  functions called directly (exact; format bytes on valid rows, since
  the port zeroes null rows where the reference leaves digits).  The
  float parse is bit for bit where the mantissa has at most 15 digits
  and ``|e| <= 22``; elsewhere within 2 ULP, except where ``e < -307``:
  there the reference's XLA ``pow`` flushes 10^e to zero (from 1e-308,
  a subnormal, down) and the port's table keeps the correctly rounded
  power, so the port's value is the nearer one.
* With each cast gate off, the reference's explain names the key and the
  port's planning raises naming it; float -> string stays off the device
  in both.
* ``csrc/pow10.cuh`` is ``castkernels.pow10_header()``, and every
  expression the planner registers has a K12 rule."""
import math
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import f as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.ops.kernels import castkernels as JK
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import f as PF
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.ops.kernels import _build as B
from spark_rapids_tpu_torch.ops.kernels import castkernels as CK
from test_torch_kernels_emulated_cast import _inputs, _values

ALL_ON = {"spark.rapids.tpu.sql.castStringToInteger.enabled": True,
          "spark.rapids.tpu.sql.castStringToFloat.enabled": True,
          "spark.rapids.tpu.sql.castStringToTimestamp.enabled": True}
DEVICE_CAST_CONF = {  # the reference test's conf
    "spark.rapids.tpu.sql.castStringToInteger.enabled": True,
    "spark.rapids.tpu.sql.castStringToTimestamp.enabled": True,
}


def _both(data, conf=None, schema=None):
    """(port DataFrame, reference DataFrame) of the same columns."""
    names = list(data)
    if schema is None:
        pdf = Session(conf, device="cpu").create_dataframe(data)
        jdf = jsrt.Session(conf).create_dataframe(data)
    else:
        pdf = Session(conf, device="cpu").create_dataframe(data, PT.Schema(
            [PT.Field(n, PT.from_name(t)) for n, t in schema]))
        jdf = jsrt.Session(conf).create_dataframe(data, JT.Schema(
            [JT.Field(n, JT.from_name(t)) for n, t in schema]))
    assert pdf.columns == jdf.columns == names
    return pdf, jdf


def _rows(rows):
    return sorted((tuple(repr(v) for v in r) for r in rows),
                  key=lambda r: r[-1])


def _same_rows(query, data, conf=None, schema=None):
    pdf, jdf = _both(data, conf, schema)
    got = query(pdf, PF).collect()
    want = query(jdf, JF).collect()
    assert _rows(got) == _rows(want)
    return got


@pytest.fixture(scope="module", autouse=True)
def quick_reference_compiles():
    """The reference's kernels compiled without most XLA optimizations,
    for this module only (the flag is restored for the next module)."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


# --------------------------------------------------------------------------
# every case of tests/test_cast.py
# --------------------------------------------------------------------------
INTS = ["0", "42", "-7", "+15", " 99 ", "3.7", "-3.7", ".5", "-", "",
        "abc", "9223372036854775807", "-9223372036854775808",
        "9223372036854775808", "-9223372036854775809", "00123", "1.999",
        "127", "128", "-128", "-129", None, "  -42  ", "4 2", "++1",
        "1.", "1.2.3", "12345678901234567890"]


def _cast_query(to, col="s"):
    return lambda df, F: df.select(F.col(col).cast(to).alias("x"),
                                   F.col("i"))


@pytest.mark.parametrize("to", ["bigint", "int", "smallint", "tinyint"])
def test_string_to_integral(to):
    got = _same_rows(_cast_query(to), {"s": INTS,
                                       "i": list(range(len(INTS)))},
                     DEVICE_CAST_CONF)
    assert any(r[0] is None for r in got) and any(r[0] for r in got)


def test_string_to_bool():
    vals = ["t", "TRUE", "Yes", "y", "1", "f", "False", "no", "N", "0",
            "x", "", " true ", None, "truthy"]
    _same_rows(_cast_query("boolean"), {"s": vals,
                                        "i": list(range(len(vals)))})


def test_string_to_date():
    vals = ["2021-01-15", "1970-01-01", "2100-12-31", "2021-02-29",
            "2020-02-29", "2021-13-01", "2021-00-10", "2021-1-5",
            "2021", "2021-06", "junk", " 2021-03-04 ", "", None,
            "2021-04-31", "0001-01-01", "9999-12-31"]
    _same_rows(_cast_query("date"), {"s": vals,
                                     "i": list(range(len(vals)))},
               DEVICE_CAST_CONF)


def test_string_to_timestamp():
    vals = ["2021-01-15 10:30:00", "2021-01-15T10:30:00",
            "2021-01-15 10:30:00.123456", "2021-01-15 10:30:00.5",
            "2021-01-15 10:30", "2021-01-15 10", "2021-01-15",
            "1969-12-31 23:59:59.999999", "2021-01-15 24:00:00",
            "2021-01-15 10:61:00", "2021-01-15x10:30:00", "", None,
            "2021", "2021-06", "2021-01-15 10:30:61"]
    _same_rows(_cast_query("timestamp"), {"s": vals,
                                          "i": list(range(len(vals)))},
               DEVICE_CAST_CONF)


def test_int_bool_to_string():
    iv = [0, 1, -1, 42, -999999, 2 ** 62, -(2 ** 63), 2 ** 63 - 1,
          None, 123456789]
    got = _same_rows(_cast_query("string", "v"),
                     {"v": iv, "i": list(range(len(iv)))})
    assert ("-9223372036854775808", 6) in got
    bv = [True, False, None, True]
    _same_rows(_cast_query("string", "v"),
               {"v": bv, "i": list(range(len(bv)))})


def test_date_timestamp_to_string():
    dv = [0, 18642, -3650, None, 2932896]
    _same_rows(_cast_query("string", "v"),
               {"v": dv, "i": list(range(len(dv)))},
               schema=[("v", "date"), ("i", "bigint")])
    tv = [0, 1611700200123456, -1, -86400000001, None, 1234567890000000]
    got = _same_rows(_cast_query("string", "v"),
                     {"v": tv, "i": list(range(len(tv)))},
                     schema=[("v", "timestamp"), ("i", "bigint")])
    assert ("1969-12-31 23:59:59.999999", 2) in got


def test_string_to_float_gated():
    vals = ["1.5", "-2.25", "1e3", "2.5E-2", "inf", "-Infinity", "NaN",
            "3", ".5", "1e", "x", "", None, "+0.125"]
    conf = {"spark.rapids.tpu.sql.castStringToFloat.enabled": True}
    _same_rows(_cast_query("double"), {"s": vals,
                                       "i": list(range(len(vals)))}, conf)
    # default off: the reference tags the expression to its host engine,
    # and the port (no host engine yet) raises at planning naming the key
    pdf, jdf = _both({"s": ["1.5"]})
    assert "castStringToFloat" in jdf.select(
        JF.col("s").cast("double").alias("x")).explain()
    with pytest.raises(NotImplementedError, match="castStringToFloat"):
        pdf.select(PF.col("s").cast("double").alias("x")).collect()


def test_cast_pipeline_stays_on_device_strict():
    conf = {"spark.rapids.tpu.sql.test.enabled": True,
            "spark.rapids.tpu.sql.test.allowedNonTpu": "ShuffleExchangeExec",
            **DEVICE_CAST_CONF}
    data = {"s": ["10", "20", "30", "bad", "40"], "g": [1, 1, 2, 2, 2]}

    def query(df, F):
        return (df.select(F.col("s").cast("bigint").alias("v"), F.col("g"))
                .filter(F.col("v") > 15)
                .group_by("g").agg(F.sum("v").alias("sv")))

    pdf, jdf = _both(data, conf)
    assert sorted(query(pdf, PF).collect()) == \
        sorted(query(jdf, JF).collect()) == [(1, 20), (2, 70)]


@pytest.mark.parametrize("seed", [5, 17])
def test_fuzz_cast_round_trips(seed):
    import random

    rng = random.Random(seed)
    n = 300
    ints = [None if rng.random() < 0.1 else
            rng.randrange(-(2 ** 63), 2 ** 63) for _ in range(n)]
    _same_rows(lambda df, F: df.select(
        F.col("v").cast("string").cast("bigint").alias("x"), F.col("i")),
        {"v": ints, "i": list(range(n))}, DEVICE_CAST_CONF)

    def rand_numeric_string():
        r = rng.random()
        if r < 0.1:
            return None
        if r < 0.2:
            return "".join(rng.choice("0123456789abc .-+")
                           for _ in range(rng.randrange(0, 8)))
        s = rng.choice(["", "-", "+"])
        s += "".join(rng.choice("0123456789")
                     for _ in range(rng.randrange(1, 21)))
        if rng.random() < 0.3:
            s += "." + "".join(rng.choice("0123456789")
                               for _ in range(rng.randrange(0, 4)))
        return s

    strs = [rand_numeric_string() for _ in range(n)]
    _same_rows(_cast_query("bigint"), {"s": strs, "i": list(range(n))},
               DEVICE_CAST_CONF)
    days = [None if rng.random() < 0.1 else rng.randrange(-30000, 80000)
            for _ in range(n)]
    _same_rows(lambda df, F: df.select(
        F.col("v").cast("string").cast("date").alias("x"), F.col("i")),
        {"v": days, "i": list(range(n))}, DEVICE_CAST_CONF,
        schema=[("v", "date"), ("i", "bigint")])


# --------------------------------------------------------------------------
# the numeric matrix
# --------------------------------------------------------------------------
MATRIX = {
    "boolean": [True, False, None, True],
    "tinyint": [0, 1, -1, 127, -128, None, 42],
    "smallint": [0, -1, 32767, -32768, 300, None, -129],
    "int": [0, -1, 2 ** 31 - 1, -2 ** 31, 300, -129, 65541, None],
    "bigint": [0, -1, 2 ** 63 - 1, -2 ** 63, 2 ** 40 + 3, -2 ** 35,
               259_200_000_005, None],
    "float": [0.0, -0.0, math.nan, math.inf, -math.inf, 1.5, -2.5, 3e9,
              -3e9, 1e30, 2147483648.0, 127.9, -128.9, None],
    "double": [0.0, -0.0, math.nan, math.inf, -math.inf, 1.5, -2.5, 3e9,
               -3e9, 9.3e18, -9.3e18, 1e30, 0.1, 255.9, -128.7, 1e300,
               -86400.5, None],
    "date": [0, -1, 18642, -3650, 2932896, -719528, -800000, 70000, None],
    "timestamp": [0, -1, 1611700200123456, -86400000001, 2 ** 62, -2 ** 62,
                  1234567890000000, -1_000_001, None],
    "string": ["1", "-1", " 2 ", "3.5", "abc", "", "t", "false",
               "2021-01-15", "1969-12-31 23:59:59.999999", "1e2", "inf",
               "127", "-129", "1970-01-01", "0", "-0.0", "NaN", None],
}
TARGETS = list(MATRIX)


@pytest.mark.parametrize("src", TARGETS)
def test_numeric_matrix_matches_reference(src):
    """``src`` to every target the device takes (float -> string is the
    one it does not), in one projection."""
    vals = MATRIX[src]
    dsts = [t for t in TARGETS
            if not (src in ("float", "double") and t == "string")]
    got = _same_rows(
        lambda df, F: df.select(*[F.col("v").cast(t).alias(t) for t in dsts],
                                F.col("i")),
        {"v": vals, "i": list(range(len(vals)))}, ALL_ON,
        schema=[("v", src), ("i", "bigint")])
    assert len(got) == len(vals)


def test_float_to_string_stays_off_the_device():
    pdf, jdf = _both({"v": [1.5]}, schema=[("v", "double")])
    want = jdf.select(JF.col("v").cast("string").alias("x")).explain()
    assert "no device implementation" in want
    with pytest.raises(NotImplementedError,
                       match="no device implementation"):
        pdf.select(PF.col("v").cast("string").alias("x")).collect()


# --------------------------------------------------------------------------
# the plain versions against the reference's functions
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("kind", ["int", "bool", "date", "timestamp"])
def test_parse_plain_matches_reference(inputs, kind):
    bm, ln, valid = inputs[kind]
    got = getattr(CK, f"parse_{kind}_plain")(bm, ln, valid)
    want = getattr(JK, f"parse_{kind}")(jnp.asarray(bm.numpy()),
                                        jnp.asarray(ln.numpy()),
                                        jnp.asarray(valid.numpy()))
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
    assert 0 < int(got[1].sum()) < bm.shape[0]


def test_trim_plain_matches_reference(inputs):
    bm, ln, _v = inputs["int"]
    got = CK.trim_aligned_plain(bm, ln)
    want = JK.trim_aligned(jnp.asarray(bm.numpy()), jnp.asarray(ln.numpy()))
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))


_FLOAT_TOKEN = re.compile(r"^[+-]?(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?$")


def _float_class(text) -> str:
    """"exact": at most 15 mantissa digits and |e| <= 22, or inf / nan /
    malformed; "flushed": 10^e below 1e-307 (XLA's pow gives 0 there);
    "ulp": the rest."""
    t = (text or "").strip(" \t\n\r\x0b\x0c")
    m = _FLOAT_TOKEN.match(t)
    if m is None:
        return "exact"
    whole, frac, exp = m.group(1), m.group(2) or "", m.group(3) or "0"
    e = int(exp) - len(frac)
    if e < -307:
        return "flushed"
    return "exact" if len((whole + frac).lstrip("0")) <= 15 and \
        abs(e) <= 22 else "ulp"


def _ulps(a: float, b: float) -> int:
    ia = struct.unpack("<q", struct.pack("<d", a))[0]
    ib = struct.unpack("<q", struct.pack("<d", b))[0]
    return abs(ia - ib)


def test_parse_float_plain_matches_reference(inputs):
    from spark_rapids_tpu_torch.data import strings as dstrings

    bm, ln, valid = inputs["float"]
    got_v, got_ok = CK.parse_float_plain(bm, ln, valid)
    want_v, want_ok = JK.parse_float(jnp.asarray(bm.numpy()),
                                     jnp.asarray(ln.numpy()),
                                     jnp.asarray(valid.numpy()))
    np.testing.assert_array_equal(got_ok.numpy(), _np(want_ok))
    texts = dstrings.decode(bm.numpy(), ln.numpy(), valid.numpy())
    g, w = got_v.numpy(), _np(want_v)
    counts = {"exact": 0, "ulp": 0, "flushed": 0}
    for i, t in enumerate(texts):
        if not got_ok[i]:
            continue
        kind = _float_class(t)
        counts[kind] += 1
        if kind == "exact":
            assert g[i].tobytes() == w[i].tobytes(), t
        elif kind == "ulp":
            assert _ulps(float(g[i]), float(w[i])) <= 2, t
    assert counts["exact"] > 500 and counts["ulp"] > 100, counts


@pytest.mark.parametrize("kind", ["int", "bool", "date", "timestamp"])
def test_format_plain_matches_reference(kind):
    vals = _values(np.random.default_rng(17))
    v, valid = vals[kind], vals["valid"]
    got_b, got_l = getattr(CK, f"format_{kind}_plain")(v, valid)
    want_b, want_l = getattr(JK, f"format_{kind}")(jnp.asarray(v.numpy()),
                                                   jnp.asarray(valid.numpy()))
    np.testing.assert_array_equal(got_l.numpy(), _np(want_l))
    ok = valid.numpy()
    np.testing.assert_array_equal(got_b.numpy()[ok], _np(want_b)[ok])
    assert not got_b.numpy()[~ok].any()


def test_civil_helpers_match_reference():
    rng = np.random.default_rng(3)
    z = np.concatenate([rng.integers(-3_000_000, 3_000_000, 4000),
                        [-719_528, -719_469, -719_468, -1, 0]])
    gy, gm, gd = CK.civil_from_days_plain(torch.from_numpy(z))
    wy, wm, wd = JK._civil_from_days(jnp.asarray(z))
    for g, w in ((gy, wy), (gm, wm), (gd, wd)):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    y = rng.integers(0, 10000, 4000)
    m = rng.integers(0, 14, 4000)
    d = rng.integers(0, 33, 4000)
    y[:3], m[:3], d[:3] = [0, 0, 0], [2, 1, 3], [29, 1, 1]
    np.testing.assert_array_equal(
        CK.days_from_civil_plain(torch.from_numpy(y), torch.from_numpy(m),
                                 torch.from_numpy(d)).numpy(),
        _np(JK._days_from_civil(jnp.asarray(y), jnp.asarray(m),
                                jnp.asarray(d))))


def test_ymd_helpers_match_reference(inputs):
    bm, ln, _v = inputs["date"]
    b, L = CK.trim_aligned_plain(bm, ln)
    jb, jL = jnp.asarray(b.numpy()), jnp.asarray(L.numpy())
    for start, count in ((0, 4), (5, 2), (8, 2), (9, 3)):
        got = CK.read_digits_plain(b, start, count)
        want = JK._read_digits(jb, jL, start, count)
        np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    got_days, got_ok = CK.parse_ymd_plain(b, L)
    want_days, _dlen, want_ok = JK._parse_ymd(jb, jL)
    np.testing.assert_array_equal(got_ok.numpy(), _np(want_ok))
    np.testing.assert_array_equal(got_days.numpy(), _np(want_days))


# --------------------------------------------------------------------------
# the gates, the table, the code generator's coverage
# --------------------------------------------------------------------------
GATES = {"castStringToInteger": "bigint", "castStringToFloat": "double",
         "castStringToTimestamp": "date"}


def _marks(report):
    return [tuple(re.match(r"\s*([*!@]) (\w+)", line).groups())
            for line in report.splitlines()]


@pytest.mark.parametrize("gate", sorted(GATES))
def test_gate_off_names_the_key(gate):
    key = f"spark.rapids.tpu.sql.{gate}.enabled"
    others = {k: True for k in ALL_ON if k != key}
    pdf, jdf = _both({"s": ["1", "2"]}, others)
    to = GATES[gate]
    jq = jdf.select(JF.col("s").cast(to).alias("x"))
    pq = pdf.select(PF.col("s").cast(to).alias("x"))
    assert key in jq.explain()
    assert _marks(pq.explain()) == _marks(jq.explain())
    assert key in pq.explain()
    with pytest.raises(NotImplementedError, match=re.escape(key)):
        pq.collect()
    # with the gate on, both run the cast on the device
    pdf, jdf = _both({"s": ["1", "2"]}, ALL_ON)
    assert "!" not in "".join(m for m, _n in _marks(
        pdf.select(PF.col("s").cast(to).alias("x")).explain())
        if _n != "LocalScanExec")


def test_pow10_header_is_the_table():
    assert (B.CSRC / "pow10.cuh").read_text() == CK.pow10_header()
    assert CK.POW10[-CK.POW10_MIN_EXP] == 1.0


def test_every_registered_expression_has_a_k12_rule():
    """``fused.py`` raises for no expression the planner registers: the
    fused segments of the fusion test, the Substring/Year segment, the
    cast segment, the string transform segment, the Coalesce/NaNvl
    segment and the two segments of the arithmetic and CaseWhen rules
    cover every registered class (UnresolvedAttribute is bound before
    fusion)."""
    from spark_rapids_tpu_torch.exec.fused import TpuFusedSegmentExec
    from spark_rapids_tpu_torch.ops.expression import UnresolvedAttribute
    from spark_rapids_tpu_torch.plan.overrides import default_registry
    from test_torch_fusion import every_expression_frame
    from test_torch_kernels_emulated import _substring_year_frame
    from test_torch_kernels_emulated_cast import _cast_frame
    from test_torch_kernels_emulated_export import (arith_frame,
                                                    unnamed_query)
    from test_torch_kernels_emulated_generate import _null_exprs_frame
    from test_torch_kernels_emulated_strings import _transform_frame

    seen = set()

    def walk_expr(e):
        seen.add(type(e))
        for c in e.children:
            walk_expr(c)

    for sess, df, _batch in (every_expression_frame(),
                             _substring_year_frame(), _cast_frame(),
                             _transform_frame(), _null_exprs_frame(),
                             arith_frame(), arith_frame(unnamed_query)):
        def walk(p):
            if isinstance(p, TpuFusedSegmentExec):
                assert p.program.source
                for m in p.members:
                    if hasattr(m, "projections"):
                        exprs = [e for ps in m.projections for e in ps]
                    else:
                        exprs = getattr(m, "exprs", None) or getattr(
                            m, "elements", None) or [m.condition]
                    for e in exprs:
                        walk_expr(e)
            for c in p.children:
                walk(c)
        walk(sess.physical_plan(df.plan))
    registered = set(default_registry().expr_rules) - {UnresolvedAttribute}
    assert registered <= seen, registered - seen
