"""K16 (parse), K17 (format), K18 (concat) and K12's Cast, ConcatStrings
and normalizer rules, built for the CPU with the host C++ compiler
against ``csrc/emulator/cuda_runtime.h`` (``test_torch_kernels_emulated.
_build_emulated``; the libraries are built once for the module) and held
against their plain PyTorch versions on the same inputs: 2,100 rows (two
2,048-row tiles of K12's grid) holding the hazards' edge rows — INT64_MIN
and its neighbours, year 0's leap day (a negative day count whose
flooring and truncating divisions differ), the microsecond before the
epoch, exponents past the power table, whitespace of every ASCII kind,
NUL and non-ASCII bytes — among seeded random rows.

Every comparison is exact, data and validity in full (invalid and
padding rows included), floats bit for bit: the float parse multiplies by
the same table of powers of ten in both forms, and g++ builds with
``-ffp-contract=off`` as nvcc with ``-fmad=false``.  A copy of the K12
cast segment whose shared flooring division truncates must differ from
the plain version.  The kernels use no CUDA intrinsic the emulator did
not have (``__longlong_as_double``, ``__int_as_float``)."""
import copy

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import f as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data import strings as dstrings
from spark_rapids_tpu_torch.data.column import host_to_device
from spark_rapids_tpu_torch.ops import cast as cst
from spark_rapids_tpu_torch.ops.kernels import _build as B
from spark_rapids_tpu_torch.ops.kernels import castkernels as CK
from spark_rapids_tpu_torch.ops.kernels import fused as FK
from spark_rapids_tpu_torch.ops.kernels import stringkernels as SK
from test_torch_kernels_emulated import (_build_emulated,
                                         _build_generated_emulated,
                                         with_truncating_fdiv)

N = 2100
CONF = {"spark.rapids.tpu.sql.castStringToInteger.enabled": True,
        "spark.rapids.tpu.sql.castStringToFloat.enabled": True,
        "spark.rapids.tpu.sql.castStringToTimestamp.enabled": True}

INT_EDGES = ["-9223372036854775808", "9223372036854775807",
             "9223372036854775808", "-9223372036854775809", "0", "-0",
             "+15", " 42 ", "\t7\n", "\x0b8\x0c", "\r9 ", "1e2", "3.7",
             "-3.7", ".5", "-", "+", "", "   ", "abc", "00123", "1.",
             "1.2.3", "12345678901234567890", "127", "128", "-128", "-129",
             "32767", "32768", "2147483647", "2147483648", "4 2", "++1",
             "\xa042", "4\x002", None]
FLOAT_EDGES = ["1.5", "-2.25", "1e3", "2.5E-2", "inf", "-Infinity", "NaN",
               "nan", "INF", "3", ".5", "1e", "e5", "x", "", "+0.125",
               "1e308", "1e309", "1e-300", "1e-400", "1E+5", "1e-5",
               "1.5e2.5", "1e+-5", "0.01", "0.07", "105000.00", "900.01",
               "123456789012345678901234567890", "0.1", "-0", "-0.0",
               " 6.5 ", "1.e3", ".e3", None]
DATE_EDGES = ["0000-02-29", "0000-01-01", "0000-03-01", "0001-01-01",
              "1969-12-31", "1970-01-01", "2021-02-29", "2020-02-29",
              "2021-13-01", "2021-00-10", "2021-1-5", "2021", "2021-06",
              "9999-12-31", " 1998-09-02 ", "2021-04-31", "junk", "",
              "1900-02-29", "2000-02-29", None]
TS_EDGES = ["1969-12-31 23:59:59.999999", "0000-02-29 12:00:00",
            "0000-01-01 00:00:00.000001", "2021-01-15T10:30:00.5",
            "2021-01-15 10:30:00.123456", "2021-01-15 10:30",
            "2021-01-15 10", "2021-01-15", "2021-01-15 24:00:00",
            "2021-01-15 10:61:00", "2021-01-15x10:30:00", "2021",
            "2021-06", "2021-01-15 10:30:61", "2021-01-15 10:30:00.",
            "2021-01-15 10:30:00.1234567", "9999-12-31 23:59:59.999999",
            None]
BOOL_EDGES = ["t", "TRUE", "Yes", "y", "1", "f", "False", "no", "N", "0",
              "x", "", " true ", "truthy", "yes!", None]


def _fill(edges, rng, draw):
    """The edge rows, then seeded random rows to ``N``."""
    rows = list(edges)
    while len(rows) < N:
        rows.append(draw(rng))
    return rows


def _int_text(rng):
    v = int(rng.integers(-10 ** 6, 10 ** 6)) * int(rng.choice(
        [1, 10 ** 6, 10 ** 12]))
    return str(v) if rng.random() < 0.9 else f" {v}.{rng.integers(0, 99)}"


def _float_text(rng):
    k = int(rng.integers(0, 4))
    if k == 0:
        return f"{rng.integers(0, 10 ** 7) / 100:.2f}"
    if k == 1:
        return repr(float(rng.normal() * 10.0 ** int(rng.integers(-30, 30))))
    if k == 2:
        return f"{rng.integers(-99, 99)}e{rng.integers(-330, 330)}"
    return str(int(rng.integers(0, 10 ** 15)))


def _date_text(rng):
    days = int(rng.integers(-800_000, 2_932_000))
    return str(np.datetime64(days, "D"))


def _ts_text(rng):
    us = int(rng.integers(-10 ** 16, 10 ** 17))
    return str(np.datetime64(us, "us")).replace("T", " ")


def _strings(rows):
    bm, ln = dstrings.encode(rows)
    valid = np.array([r is not None for r in rows])
    return (torch.from_numpy(bm), torch.from_numpy(ln),
            torch.from_numpy(valid))


def _inputs():
    rng = np.random.default_rng(16)
    return {
        "int": _strings(_fill(INT_EDGES, rng, _int_text)),
        "float": _strings(_fill(FLOAT_EDGES, rng, _float_text)),
        "date": _strings(_fill(DATE_EDGES, rng, _date_text)),
        "timestamp": _strings(_fill(TS_EDGES, rng, _ts_text)),
        "bool": _strings(_fill(BOOL_EDGES, rng,
                               lambda r: str(r.choice(BOOL_EDGES[:-1])))),
    }


@pytest.fixture(scope="module")
def emu():
    out = _build_emulated()
    return B.Kernels(lambda: out, lambda t: None, _build_generated_emulated)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype.is_floating_point:
        g = got.view(torch.int64 if want.dtype == torch.float64
                     else torch.int32)
        w = want.view(g.dtype)
        assert torch.equal(g, w), "float bits differ"
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["int", "bool", "float", "date",
                                  "timestamp"])
def test_k16_parse_matches_plain(emu, inputs, kind):
    bm, ln, valid = inputs[kind]
    CK.CAST_PARSE_LAUNCHES.reset()
    got = getattr(CK, f"parse_{kind}")(bm, ln, valid, kernels=emu)
    want = getattr(CK, f"parse_{kind}")(bm, ln, valid)
    assert CK.CAST_PARSE_LAUNCHES.count == 1
    _same(got[1], want[1])
    _same(got[0], want[0])
    assert 0 < int(want[1].sum()) < N


def test_k16_trim_matches_plain(emu, inputs):
    bm, ln, _valid = inputs["int"]
    got = CK.trim_aligned(bm, ln, kernels=emu)
    want = CK.trim_aligned(bm, ln)
    _same(got[0], want[0])
    _same(got[1], want[1])


def _values(rng):
    ints = rng.integers(-2 ** 63, 2 ** 63 - 1, N, dtype=np.int64)
    ints[:6] = [-2 ** 63, 2 ** 63 - 1, 0, -1, 10 ** 18, -10 ** 18]
    days = rng.integers(-1_000_000, 3_500_000, N).astype(np.int32)
    days[:4] = [-719_468 - 60, -719_468 - 1, -1, 2_932_896]
    us = rng.integers(-2 ** 63, 2 ** 63 - 1, N, dtype=np.int64)
    us[:6] = [-1, -86_400_000_001, -2 ** 63, 2 ** 63 - 1, 0,
              -62_167_219_200_000_001]
    valid = rng.random(N) > 0.1
    return {"int": torch.from_numpy(ints),
            "bool": torch.from_numpy(rng.random(N) > 0.5),
            "date": torch.from_numpy(days), "timestamp": torch.from_numpy(us),
            "valid": torch.from_numpy(valid)}


@pytest.mark.parametrize("kind", ["int", "bool", "date", "timestamp"])
def test_k17_format_matches_plain(emu, kind):
    vals = _values(np.random.default_rng(17))
    CK.CAST_FORMAT_LAUNCHES.reset()
    got = getattr(CK, f"format_{kind}")(vals[kind], vals["valid"],
                                        kernels=emu)
    want = getattr(CK, f"format_{kind}")(vals[kind], vals["valid"])
    assert CK.CAST_FORMAT_LAUNCHES.count == 1
    _same(got[1], want[1])
    _same(got[0], want[0])
    assert bool((want[0][~vals["valid"]] == 0).all())


def _lit(text: str, n: int):
    bm, ln = dstrings.encode([text])
    return (torch.from_numpy(bm).expand(n, -1),
            torch.from_numpy(ln).expand(n))


@pytest.mark.parametrize("shape", ["export", "narrow", "many parts"])
def test_k18_concat_matches_plain(emu, inputs, shape):
    """The export's shape (formats, literals and strings; the byte
    kernel), an output of at most 4 bytes (the row kernel), and more
    parts than one launch takes (two launches)."""
    if shape == "export":  # 700 rows: a thread a byte of 37
        vals = _values(np.random.default_rng(18))
        a = CK.format_int(vals["int"][:700], vals["valid"][:700])
        b = CK.format_date(vals["date"][:700], vals["valid"][:700])
        c = (inputs["bool"][0][:700], inputs["bool"][1][:700])
        parts = [a, _lit("|", 700), b, _lit("|", 700), c, _lit("", 700)]
        launches = 1
    elif shape == "narrow":
        bm, ln, _v = inputs["bool"]
        parts = [(bm[:, :1].contiguous(), torch.clamp(ln, max=1)),
                 _lit("|", N), (bm[:, :2].contiguous(),
                                torch.clamp(ln, max=2))]
        launches = 1
    else:
        bm, ln, _v = inputs["bool"]
        one = (bm[:300, :1].contiguous(), torch.clamp(ln[:300], max=1))
        parts = [one, _lit(",", 300)] * 33
        launches = 2
    SK.STRING_CONCAT_LAUNCHES.reset()
    got = SK.concat(parts, kernels=emu)
    want = SK.concat(parts)
    assert SK.STRING_CONCAT_LAUNCHES.count == launches
    _same(got[0], want[0])
    _same(got[1], want[1])


# --------------------------------------------------------------------------
# K12: Cast, ConcatStrings and the normalizers in a fused segment
# --------------------------------------------------------------------------
def _cast_frame_data():
    rng = np.random.default_rng(12)
    vals = _values(rng)
    pick = lambda xs: [None if rng.random() < 0.1 else  # noqa: E731
                       xs[int(rng.integers(0, len(xs)))] for _ in range(N)]
    strs = {k: dstrings.decode(*[t.numpy() for t in v])
            for k, v in _inputs().items()}
    d = rng.choice([0.0, -0.0, np.nan, 1.5, -2.5, np.inf, -np.inf, 3e9,
                    -3e9, 9.3e18, -9.3e18, 1e30, 0.1, 255.9, -128.7], N)
    f32 = rng.choice([0.5, -0.0, np.nan, 2.75, -1.0, 3e9, -3e38,
                      2147483648.0], N)
    valid = vals["valid"].numpy()

    def nulls(a):
        return [None if not ok else v for v, ok in zip(a, valid)]

    return {
        "si": list(strs["int"]), "sf": list(strs["float"]),
        "sd": list(strs["date"]), "st": list(strs["timestamp"]),
        "sb": list(strs["bool"]),
        "i": nulls(rng.integers(-2 ** 31, 2 ** 31 - 1, N).tolist()),
        "l": nulls(vals["int"].tolist()),
        "d": nulls(d.tolist()), "f": nulls(f32.tolist()),
        "b": nulls((rng.random(N) > 0.5).tolist()),
        "dt": nulls(vals["date"].tolist()),
        "ts": nulls(vals["timestamp"].tolist()),
        "w": pick(["AIR", "RAIL", "", "MAIL", "TRUCK"]),
    }


CAST_FIELDS = [("si", "string"), ("sf", "string"), ("sd", "string"),
               ("st", "string"), ("sb", "string"), ("i", "int"),
               ("l", "bigint"), ("d", "double"), ("f", "float"),
               ("b", "boolean"), ("dt", "date"), ("ts", "timestamp"),
               ("w", "string")]

#: (source column, target type) of every Cast the segment holds
CASTS = [("si", "bigint"), ("si", "int"), ("si", "smallint"),
         ("si", "tinyint"), ("sf", "double"), ("sf", "float"),
         ("sd", "date"), ("st", "timestamp"), ("sb", "boolean"),
         ("l", "string"), ("i", "string"), ("b", "string"),
         ("dt", "string"), ("ts", "string"), ("d", "bigint"),
         ("d", "int"), ("d", "tinyint"), ("f", "bigint"), ("f", "int"),
         ("d", "date"), ("d", "timestamp"), ("f", "timestamp"),
         ("ts", "date"), ("ts", "bigint"), ("ts", "int"), ("ts", "double"),
         ("ts", "float"), ("dt", "timestamp"), ("dt", "double"),
         ("dt", "tinyint"), ("l", "int"), ("l", "tinyint"),
         ("l", "double"), ("l", "float"), ("l", "timestamp"),
         ("l", "date"), ("i", "boolean"), ("d", "boolean"),
         ("ts", "boolean"), ("b", "int"), ("b", "double"),
         ("b", "timestamp"), ("d", "float"), ("f", "double"),
         ("i", "smallint"), ("i", "bigint")]


def cast_segment_query(df, F, C):
    """Filter -> Project -> Filter over every K12 rule this slice adds:
    ``C`` the package's cast module (for the normalizers)."""
    line = F.concat(F.col("si"), F.lit("|"), F.col("l").cast("string"),
                    F.lit("|"), F.col("dt").cast("string"))
    exprs = [F.col(c).cast(t).alias(f"{c}_{t}") for c, t in CASTS]
    exprs += [
        line.alias("line"),
        F.concat(F.col("w"), F.col("sb")).alias("wb"),
        F.concat(F.col("w"), F.lit(None, T.STRING)).alias("wnull"),
        F.col("l").cast("string").cast("bigint").alias("round_trip"),
        F.Column(C.NormalizeNaNAndZero(F.col("d").expr)).alias("nd"),
        F.Column(C.NormalizeNaNAndZero(F.col("f").expr)).alias("nf"),
        F.Column(C.KnownFloatingPointNormalized(
            C.NormalizeNaNAndZero(F.col("d").expr))).alias("kd"),
        F.col("w"),
    ]
    return (df.filter((F.concat(F.col("w"), F.lit("|"), F.col("sb"))
                       != F.lit("AIR|t"))
                      | (F.col("i").cast("string") == F.lit("0")))
            .select(*exprs)
            .filter(F.col("line") != F.lit("0|0|1970-01-01")))


def _cast_frame():
    sess = Session(CONF, device="cpu")
    schema = T.Schema([T.Field(n, T.from_name(t)) for n, t in CAST_FIELDS])
    df = sess.create_dataframe(_cast_frame_data(), schema, n_partitions=1)
    batch = host_to_device(df.plan.batches[0], 128, "cpu")
    return sess, cast_segment_query(df, F, cst), batch


def _segment(sess, df):
    from spark_rapids_tpu_torch.exec.fused import TpuFusedSegmentExec

    found = []

    def walk(p):
        if isinstance(p, TpuFusedSegmentExec):
            found.append(p)
        for c in p.children:
            walk(c)

    walk(sess.physical_plan(df.plan))
    assert len(found) == 1
    return found[0]


def test_k12_cast_rules_match_plain(emu):
    sess, df, batch = _cast_frame()
    seg = _segment(sess, df)
    assert len(seg.program.members) == 3
    [(want, want_keep)] = FK.segment_plain(seg.program, batch)
    FK.FUSED_LAUNCHES.reset()
    [(got, got_keep)] = FK.run_segment(seg.program, batch, kernels=emu)
    assert FK.FUSED_LAUNCHES.count == 1
    _same(got_keep, want_keep)
    assert 0 < int(want_keep.sum()) < int(batch.num_rows)
    for g, w, field in zip(got.columns, want.columns, seg.program.schema):
        assert g.dtype == w.dtype, field.name
        _same(g.validity, w.validity)
        _same(g.data.contiguous(), w.data.contiguous())
        if w.lengths is not None:
            _same(g.lengths.contiguous(), w.lengths.contiguous())
    kinds = {o.kind for o in seg.program.outputs[0]}
    assert "scratch" in kinds and "str" in kinds


def test_k12_casts_with_truncating_division_differ(emu):
    """The mutation check: with the shared ``srt::fdiv`` truncating, the
    segment's parses and formats of dates and timestamps before 1970 (and
    year 0's leap day) disagree with the plain version."""
    sess, df, batch = _cast_frame()
    prog = copy.copy(_segment(sess, df).program)
    prog.source = with_truncating_fdiv(prog.source)
    prog.key = B.generated_key(prog.source)
    [(want, _k)] = FK.segment_plain(prog, batch)
    [(got, _k)] = FK.run_segment(prog, batch, kernels=emu)
    names = [f.name for f in prog.schema]
    for name in ("si_bigint", "sd_date", "st_timestamp", "ts_string",
                 "ts_date", "dt_string"):
        j = names.index(name)
        assert not torch.equal(got.columns[j].data, want.columns[j].data), \
            name
