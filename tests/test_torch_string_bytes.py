"""Strings keep their exact UTF-8 bytes in spark_rapids_tpu_torch (ROADMAP
C.1): ``data/strings.py:encode`` writes each value at its exact length,
so ``"a"`` and ``"a\x00"`` stay two strings, in the data and in string
literals (``isin`` members, comparison literals, K12's constants); and
the sort breaks ties of zero-padded bytes by length (C.6), so group-by,
join and ``distinct`` keep such strings apart.

Twelve distinct strings, ``"a"``, ``"a\x00"``, ``"a\x00\x00"`` and a lone
NUL among them, at one and two partitions, through group-by, sort,
``isin``, an inner join, ``distinct`` and a filter on a literal with a
NUL, against the JAX package's host engine (which keeps every byte) and
its device session where that agrees (all but the join: the reference's
device sort ignores lengths, C.6).  The same with ``"a"`` and
``"a\x00"`` twice more, interleaved, against Python's own grouping,
join and set: there both of the reference's engines split the groups of
the repeated strings (C.6)."""
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import f as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import f as PF
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.data import strings as dstrings

STRINGS = ["a", "a\x00", "b", "a\x00\x00", "", "\x00", "ab", "b\x00", "c",
           "zz", "é", "x"]


def _group(F, df):
    return df.group_by("s").agg(F.sum("v").alias("t"))


def _sort(F, df):
    return df.sort("s")


def _isin(F, df):
    return df.filter(F.col("s").isin(["a", "b", "zz", "q"]))


def _join(F, df):
    other = df.select(F.col("s").alias("s2"), F.col("v").alias("v2"))
    return df.join(other, on=(["s"], ["s2"]), how="inner")


def _distinct(F, df):
    return df.select("s").distinct()


def _literal(F, df):
    return df.filter(F.col("s") == F.lit("a\x00")).select("v")


CASES = {"group_by": (_group, 12), "sort": (_sort, 12), "isin": (_isin, 3),
         "join": (_join, 12), "distinct": (_distinct, 12),
         "literal": (_literal, 1)}
#: the cases where the reference's device session is right on this data
DEVICE_AGREES = {"group_by", "sort", "isin", "distinct", "literal"}


def test_encode_keeps_every_byte():
    bm, ln = dstrings.encode(["a", "a\x00", None, "\x00\x00", "é"])
    assert ln.tolist() == [1, 2, 0, 2, 2]
    assert dstrings.decode(bm, ln).tolist() == ["a", "a\x00", "", "\x00\x00",
                                                "é"]


def _run(fn, strings, n_partitions):
    data = {"s": strings, "v": list(range(len(strings)))}
    jschema = JT.Schema([JT.Field("s", JT.STRING), JT.Field("v", JT.INT64)])
    host = jsrt.Session(tpu_enabled=False).create_dataframe(
        data, jschema, n_partitions=n_partitions)
    dev = jsrt.Session().create_dataframe(data, jschema,
                                          n_partitions=n_partitions)
    pdf = Session(device="cpu").create_dataframe(
        data, PT.Schema([PT.Field("s", PT.STRING), PT.Field("v", PT.INT64)]),
        n_partitions=n_partitions)
    return fn(PF, pdf).collect(), lambda: fn(JF, host).collect(), \
        lambda: fn(JF, dev).collect()


def _same(got, want, ordered):
    if ordered:
        assert got == want
    else:
        assert sorted(map(repr, got)) == sorted(map(repr, want))


@pytest.mark.parametrize("n_partitions", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_nul_bytes_match_reference(case, n_partitions):
    fn, n_rows = CASES[case]
    got, host, device = _run(fn, STRINGS, n_partitions)
    assert len(got) == n_rows
    _same(got, host(), case == "sort")
    if case in DEVICE_AGREES:
        _same(got, device(), case == "sort")
    if case == "sort":
        assert [r[0] for r in got][:5] == ["", "\x00", "a", "a\x00",
                                           "a\x00\x00"]


def _python(case, strings):
    """Spark's answer, computed on Python strings."""
    rows = list(zip(strings, range(len(strings))))
    if case == "group_by":
        sums = {}
        for s, v in rows:
            sums[s] = sums.get(s, 0) + v
        return list(sums.items())
    if case == "distinct":
        return [(s,) for s in set(strings)]
    return [(s, v, s2, v2) for s, v in rows for s2, v2 in rows if s == s2]


@pytest.mark.parametrize("n_partitions", [1, 2])
@pytest.mark.parametrize("case", ["group_by", "join", "distinct"])
def test_nul_bytes_with_duplicates_match_python(case, n_partitions):
    fn, _n = CASES[case]
    strings = STRINGS + ["a", "a\x00"]
    got, _host, _device = _run(fn, strings, n_partitions)
    _same(got, _python(case, strings), False)
    assert len(got) == {"group_by": 12, "distinct": 12, "join": 18}[case]
