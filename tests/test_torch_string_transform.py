"""The string transforms and string min/max of spark_rapids_tpu_torch (on
CPU tensors, the kernels' plain versions) against the JAX package's
device session on the same rows, at one and two partitions.

* Each new function — ``upper``, ``lower``, ``length``, ``trim``,
  ``ltrim``, ``rtrim``, ``substring_index``, ``replace`` and ``locate`` —
  over the edge rows (empty, null and all-space rows; a delimiter absent,
  leading, trailing or doubled; multi-byte UTF-8; a NUL byte inside a
  row) and seeded random rows: counts of +-1, +-3 and 0, replacements of
  0, 1 and 3 bytes, locate from positions -1, 0, 1 and 3.  Exact.
* String min and max by group and over the whole frame, with a group of
  nulls only (null) and an all-null column.  Exact against the reference
  where no string ends in a NUL byte; with trailing NULs, where the
  reference ties ``"a"`` and ``"a\\x00"`` (ROADMAP C.6), against Python's
  ``min``/``max`` of the bytes.
* The ``incompatibleOps`` gate: with it off, Upper and Lower carry the
  reference's reason and planning raises ``NotImplementedError``; with
  the gate on and the rule's own key off, the reference's other reason.
  A multi-byte delimiter or search string is tagged off the device and
  raises."""
import jax
import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import f as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import f as PF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.benchmarks.tpch_clean import CLEAN_CONF

EDGES = ["", None, " ", "   ", "  lead", "trail  ", "  both  ", "a  b",
         "-", "--", "-lead", "trail-", "a--b", "a-b-c-d-e", "no delims",
         "#7", "Customer#000000042", "15-123-456-7890", "1-URGENT",
         "4-NOT SPECIFIED", "héllo wörld", "日本語-テキスト", "nul\x00in-side",
         "MiXeD CaSe az AZ @[`{", "special handle requests", "ab ab-ab"]
ALPHABET = list("abAB -#xyZ") + ["é"]


def _rows(n=400, seed=8):
    rng = np.random.default_rng(seed)
    rows = list(EDGES)
    while len(rows) < n:
        rows.append(None if rng.random() < 0.05 else
                    "".join(rng.choice(ALPHABET, int(rng.integers(0, 12)))))
    return rows


def _frames(data, fields, n_partitions, conf=CLEAN_CONF):
    """(port session, port DataFrame, reference DataFrame)."""
    pschema = T.Schema([T.Field(n, T.from_name(t)) for n, t in fields])
    jschema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in fields])
    psess = Session(conf, device="cpu")
    pdf = psess.create_dataframe(data, pschema, n_partitions=n_partitions)
    jdf = jsrt.Session(conf).create_dataframe(data, jschema,
                                              n_partitions=n_partitions)
    return psess, pdf, jdf


@pytest.fixture(scope="module", autouse=True)
def quick_reference_compiles():
    """The reference's kernels compiled without most XLA optimizations,
    for this module only (the flag is restored for the next module)."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _case(F, s):
    return [F.upper(s), F.lower(s), F.upper(F.lower(s))]


def _length(F, s):
    return [F.length(s), F.length(F.trim(s))]


def _trim(F, s):
    return [F.trim(s), F.ltrim(s), F.rtrim(s),
            F.trim(F.substring(s, 2, 5))]


def _substring_index(F, s):
    return [F.substring_index(s, d, k) for d in ("-", " ", "#")
            for k in (1, -1, 3, -3, 0)]


def _replace(F, s):
    return [F.replace(s, "-", ""), F.replace(s, " ", "_"),
            F.replace(s, "-", "abc"), F.replace(s, "b", "é")]


def _locate(F, s):
    return [F.locate(n, s, p) for n in ("ab", "-", "")
            for p in (-1, 0, 1, 3)]


FUNCTIONS = {"case": _case, "length": _length, "trim": _trim,
             "substring_index": _substring_index, "replace": _replace,
             "locate": _locate}


@pytest.mark.parametrize("n_partitions", [1, 2])
@pytest.mark.parametrize("kind", sorted(FUNCTIONS))
def test_functions_match_reference(kind, n_partitions):
    data = {"s": _rows()}
    psess, pdf, jdf = _frames(data, [("s", "string")], n_partitions)
    build = FUNCTIONS[kind]
    pq = pdf.select(*[c.alias(f"c{i}") for i, c in
                      enumerate(build(PF, PF.col("s")))])
    jq = jdf.select(*[c.alias(f"c{i}") for i, c in
                      enumerate(build(JF, JF.col("s")))])
    assert pq.explain().splitlines()[0].startswith("* ProjectExec")
    got, want = pq.collect(), jq.collect()
    assert len(got) == len(want) == len(data["s"])
    assert got == want


def test_length_counts_characters_and_nul_bytes():
    psess, pdf, _ = _frames({"s": ["héllo", "日本語", "a\x00b", "", None]},
                            [("s", "string")], 1)
    got = [r[0] for r in pdf.select(PF.length(PF.col("s"))).collect()]
    assert got == [5, 3, 3, 0, None]


def _grouped(F, df):
    return (df.group_by("k")
            .agg(F.min("s").alias("lo"), F.max("s").alias("hi"),
                 F.count("*").alias("n"), F.min("z").alias("zlo"))
            .sort("k"))


def _global(F, df):
    return df.agg(F.min("s").alias("lo"), F.max("s").alias("hi"),
                  F.max("z").alias("zhi"))


def _minmax_data(rows, seed=4):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 9, len(rows)).tolist()
    rows = [None if key == 5 else r for r, key in zip(rows, k)]
    return {"k": k, "s": rows, "z": [None] * len(rows)}


MINMAX_FIELDS = [("k", "bigint"), ("s", "string"), ("z", "string")]


@pytest.mark.parametrize("n_partitions", [1, 2])
@pytest.mark.parametrize("shape", ["grouped", "global"])
def test_string_minmax_matches_reference(shape, n_partitions):
    data = _minmax_data(_rows())
    _psess, pdf, jdf = _frames(data, MINMAX_FIELDS, n_partitions)
    q = _grouped if shape == "grouped" else _global
    got, want = q(PF, pdf).collect(), q(JF, jdf).collect()
    assert got == want
    if shape == "grouped":
        assert [r for r in got if r[0] == 5] == [(5, None, None, got[5][3],
                                                  None)]


@pytest.mark.parametrize("n_partitions", [1, 2])
def test_string_minmax_with_trailing_nuls_matches_python(n_partitions):
    """Strings that differ only in trailing NUL bytes: the port orders the
    shorter first (C.6), as Python's bytes order does."""
    rows = ["a", "a\x00", "a\x00\x00", "", "\x00", "b", "a\x00b",
            "\x00\x00", "ab", "a"] * 3
    k = [i % 4 for i in range(len(rows))]
    _psess, pdf, _ = _frames({"k": k, "s": rows, "z": [None] * len(rows)},
                             MINMAX_FIELDS, n_partitions)
    got = _grouped(PF, pdf).collect()
    for key, lo, hi, n, _z in got:
        members = [r.encode() for r, g in zip(rows, k) if g == key]
        assert lo.encode() == min(members) and hi.encode() == max(members)
        assert n == len(members)


@pytest.mark.parametrize("fn", ["upper", "lower"])
@pytest.mark.parametrize("gate", ["incompat off", "key off"])
def test_incompat_gate_tags_with_reference_reason(fn, gate):
    conf = dict(CLEAN_CONF)
    if gate == "incompat off":
        conf["spark.rapids.tpu.sql.incompatibleOps.enabled"] = False
    else:
        conf[f"spark.rapids.tpu.sql.expr.{fn.capitalize()}"] = False
    psess, pdf, jdf = _frames({"s": ["Ab", None]}, [("s", "string")], 1,
                              conf)
    pq = pdf.select(getattr(PF, fn)(PF.col("s")).alias("u"))
    jq = jdf.select(getattr(JF, fn)(JF.col("s")).alias("u"))
    want = jq.explain().splitlines()[0]
    mark = "!" if gate == "incompat off" else "@"
    assert want.startswith(f"{mark} ProjectExec")
    reason = want.split("expression not supported: ", 1)[1]
    got = pq.explain()
    assert got.splitlines()[0].startswith(f"{mark} ProjectExec")
    assert reason in got
    name = fn.capitalize()
    if gate == "incompat off":
        assert (f"{name} is incompatible (ASCII-only case mapping on "
                "device); enable spark.rapids.tpu.sql.incompatibleOps."
                "enabled to allow") in got
    else:
        assert f"disabled by spark.rapids.tpu.sql.expr.{name}" in got
    with pytest.raises(NotImplementedError, match="host engine is not "
                       "ported yet"):
        pq.collect()


@pytest.mark.parametrize("expr", ["substring_index", "replace"])
def test_multibyte_delimiter_or_search_raises(expr):
    psess, pdf, _ = _frames({"s": ["a--b", "c"]}, [("s", "string")], 1)
    c = PF.col("s")
    e = PF.substring_index(c, "--", 1) if expr == "substring_index" \
        else PF.replace(c, "--", "+")
    q = pdf.select(e.alias("x"))
    assert q.explain().splitlines()[0].startswith("! ProjectExec")
    assert "the device takes one byte" in q.explain()
    with pytest.raises(NotImplementedError, match="the device takes one "
                       "byte"):
        q.collect()
