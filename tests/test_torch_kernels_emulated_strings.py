"""K19 (case maps, length), K20 (trim, substring_index), K21 (replace),
K13's scalar-start locate, the string min/max composition (K1 + K4 + K3
+ K4) and K12's rules for Upper, Lower, Length, StringLocate,
StringTrim/Left/Right, SubstringIndex and StringReplace, built for the
CPU with the host C++ compiler against ``csrc/emulator/cuda_runtime.h``
(``test_torch_kernels_emulated._build_emulated``; the libraries are built
once for the module) and held against their plain PyTorch versions on the
same inputs.

The rows: 2,100 (two 2,048-row tiles of the grid-strided kernels), 24
bytes wide, holding the edges — empty, null and all-space rows, leading,
trailing and doubled spaces, a delimiter absent, leading, trailing or
doubled, multi-byte UTF-8, NUL bytes inside a row, both cases of every
letter — among seeded random rows of letters, spaces, dashes and ``#``.
Every comparison is exact, bytes and lengths in full (null and padding
rows included), and each wrapper's launch count is checked."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import f as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.benchmarks.tpch_clean import CLEAN_CONF
from spark_rapids_tpu_torch.data import strings as dstrings
from spark_rapids_tpu_torch.data.column import host_to_device
from spark_rapids_tpu_torch.ops.kernels import _build as B
from spark_rapids_tpu_torch.ops.kernels import fused as FK
from spark_rapids_tpu_torch.ops.kernels import gather as G
from spark_rapids_tpu_torch.ops.kernels import segment as S
from spark_rapids_tpu_torch.ops.kernels import stringkernels as SK
from test_torch_kernels_emulated import (_build_emulated,
                                         _build_generated_emulated)

N = 2100
W = 24
EDGES = ["", None, " ", "   ", "  lead", "trail  ", "  both  ", "a  b",
         "-", "--", "-lead", "trail-", "a--b", "a-b-c-d-e", "no delims",
         "#7", "Customer#000000042", "15-123-456-7890", "1-URGENT",
         "4-NOT SPECIFIED", "héllo wörld", "日本語-テキスト", "nul\x00in-side",
         "\x00", "MiXeD CaSe az AZ @[`{", "special handle requests",
         "x" * W, " " * W, "ab-" * 8]
ALPHABET = list("abcdefgXYZ -#") + ["é"]


def _rows(seed=19):
    rng = np.random.default_rng(seed)
    rows = list(EDGES)
    while len(rows) < N:
        if rng.random() < 0.05:
            rows.append(None)
            continue
        k = int(rng.integers(0, 14))
        s = "".join(rng.choice(ALPHABET, k))
        while len(s.encode()) > W:
            s = s[:-1]
        rows.append(s)
    return rows


def _strings(rows):
    bm, ln = dstrings.encode(rows)
    assert bm.shape[1] == W
    return torch.from_numpy(bm), torch.from_numpy(ln)


@pytest.fixture(scope="module")
def emu():
    out = _build_emulated()
    return B.Kernels(lambda: out, lambda t: None, _build_generated_emulated)


@pytest.fixture(scope="module")
def rows():
    return _rows()


def _same(got, want):
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    assert torch.equal(got, want)


def _same_pair(got, want):
    _same(got[0].contiguous(), want[0].contiguous())
    _same(got[1].to(torch.int32), want[1].to(torch.int32))


def test_k19_case_maps_and_length_match_plain(emu, rows):
    bm, ln = _strings(rows)
    SK.STRING_CASE_LAUNCHES.reset()
    for fn in (SK.upper, SK.lower):
        got, want = fn(bm, ln, kernels=emu), fn(bm, ln)
        _same_pair(got, want)
    _same(SK.length(bm, ln, kernels=emu), SK.length(bm, ln))
    assert SK.STRING_CASE_LAUNCHES.count == 3
    # the bytes past a length are zero in both, and a multi-byte row
    # counts characters
    up = SK.upper(bm, ln, kernels=emu)[0]
    assert bytes(up[EDGES.index("héllo wörld")][:13].tolist()) == \
        "HéLLO WöRLD".encode()
    assert int(SK.length(bm, ln, kernels=emu)[
        EDGES.index("日本語-テキスト")]) == 8


@pytest.mark.parametrize("left,right", [(True, True), (True, False),
                                        (False, True)])
def test_k20_trim_matches_plain(emu, rows, left, right):
    bm, ln = _strings(rows)
    SK.STRING_TRIM_LAUNCHES.reset()
    for out_w in (W, 5):
        got = SK.trim_ws(bm, ln, out_w, left, right, kernels=emu)
        _same_pair(got, SK.trim_ws(bm, ln, out_w, left, right))
    assert SK.STRING_TRIM_LAUNCHES.count == 4


@pytest.mark.parametrize("delim", [b"-", b" ", b"#"])
def test_k20_substring_index_matches_plain(emu, rows, delim):
    bm, ln = _strings(rows)
    SK.STRING_TRIM_LAUNCHES.reset()
    counts = (1, -1, 3, -3, 0, 2, -2, W + 5, -(W + 5), 2 ** 40)
    for count in counts:
        got = SK.substring_index(bm, ln, delim, count, kernels=emu)
        _same_pair(got, SK.substring_index(bm, ln, delim, count))
    assert SK.STRING_TRIM_LAUNCHES.count == 2 * len(counts)


@pytest.mark.parametrize("repl", [b"", b"_", b"abc"])
@pytest.mark.parametrize("search", [b"-", b" ", b"\x00"])
def test_k21_replace_matches_plain(emu, rows, search, repl):
    bm, ln = _strings(rows)
    SK.STRING_REPLACE_LAUNCHES.reset()
    got = SK.replace_single(bm, ln, search, repl, kernels=emu)
    want = SK.replace_single(bm, ln, search, repl)
    assert got[0].shape[1] == W * max(len(repl), 1)
    _same_pair(got, want)
    assert SK.STRING_REPLACE_LAUNCHES.count == 1


def test_k13_locate_matches_plain(emu, rows):
    bm, ln = _strings(rows)
    SK.STRING_SEARCH_LAUNCHES.reset()
    calls = 0
    for needle in (b"special", b"", b"a", b"-", b"x" * (W + 1)):
        for pos in (-3, 0, 1, 2, 5, W, W + 3):
            _same(SK.locate(bm, ln, needle, pos, kernels=emu),
                  SK.locate(bm, ln, needle, pos))
            calls += 1
    assert SK.STRING_SEARCH_LAUNCHES.count == calls


@pytest.mark.parametrize("op", ["min", "max"])
def test_string_minmax_matches_plain(emu, rows, op):
    """Groups of 1 to 40 rows in key order, one group of nulls only, and
    the padding rows of a 4,096-row bucket in a group of their own."""
    bm, ln = _strings(rows)
    valid = torch.tensor([r is not None for r in rows])
    rng = np.random.default_rng(5)
    seg = np.sort(rng.integers(0, 120, N)).astype(np.int32)
    valid[torch.from_numpy(seg == 7)] = False
    pad = 4096 - N
    bm = torch.cat([bm, torch.zeros((pad, W), dtype=torch.uint8)])
    ln = torch.cat([ln, torch.zeros(pad, dtype=torch.int32)])
    valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool)])
    seg_ids = torch.from_numpy(np.concatenate(
        [seg, np.full(pad, 120, dtype=np.int32)]))
    S.STRING_MINMAX_LAUNCHES.reset()
    got = S.string_minmax(bm, ln, valid, seg_ids, 4096, op, kernels=emu)
    want = S.string_minmax(bm, ln, valid, seg_ids, 4096, op)
    assert S.STRING_MINMAX_LAUNCHES.count > 0
    has = want[2] > 0
    assert not bool(has[7]) and bool(has[:7].all())
    for g, w in zip(got, want):  # in full, empty groups included
        _same(g.to(w.dtype), w)
    # against Python's min/max over each group's valid strings (bytes,
    # no two of which differ only in trailing NULs here)
    pick = min if op == "min" else max
    enc = [None if r is None else r.encode() for r in rows]
    for g in (0, 3, 50, 119):
        members = [enc[i] for i in np.nonzero(seg == g)[0]
                   if enc[i] is not None]
        if members:
            n = int(got[1][g])
            assert bytes(got[0][g][:n].tolist()) == pick(members)


def test_invert_permutation_matches_plain(emu):
    order = torch.from_numpy(np.random.default_rng(3).permutation(N)
                             .astype(np.int32))
    G.GATHER_LAUNCHES.reset()
    _same(G.invert_permutation(order, emu), G.invert_permutation(order))
    assert G.GATHER_LAUNCHES.count == 1


def transform_segment_query(df, F):
    """Filter -> Project over every K12 rule this slice adds, alone and
    nested (views of views, scratch rows of views, a view of a scratch
    row, a parse of a view)."""
    s = F.col("s")
    exprs = [
        F.upper(s).alias("up"), F.lower(s).alias("lo"),
        F.length(s).alias("len"),
        F.trim(s).alias("tr"), F.ltrim(s).alias("ltr"),
        F.rtrim(s).alias("rtr"),
        F.locate("ab", s).alias("loc1"), F.locate("b", s, -1).alias("loc0"),
        F.locate("-", s, 4).alias("loc4"), F.locate("", s, 3).alias("locE"),
        F.replace(s, "-", "").alias("del"),
        F.replace(s, " ", "_").alias("rep1"),
        F.replace(s, "-", "abc").alias("rep3"),
        F.upper(F.replace(s, " ", "_")).alias("key"),
        F.lower(F.trim(F.substring(s, 1, 9))).alias("prev"),
        F.length(F.substring_index(s, "-", -2)).alias("tail_len"),
        F.locate("a", F.trim(s)).alias("loc_tr"),
        F.trim(F.upper(s)).alias("tr_up"),
        F.substring_index(F.replace(s, "-", "--"), "-", 3).alias("si_rep"),
        F.replace(F.rtrim(s), " ", "").alias("rep_tr"),
        F.substring_index(s, "-", 1).cast("int").alias("code"),
        F.concat(F.ltrim(s), F.lit("|"), F.lower(s)).alias("cat"),
    ]
    for count in (1, -1, 3, -3, 0):
        exprs.append(F.substring_index(s, "-", count).alias(f"si{count}"))
    exprs.append(F.substring_index(s, "#", -1).alias("hash"))
    return (df.filter(F.length(F.col("s")) != F.lit(7))
            .select(*exprs))


def _transform_frame():
    sess = Session(CLEAN_CONF, device="cpu")
    schema = T.Schema([T.Field("s", T.STRING)])
    df = sess.create_dataframe({"s": _rows()}, schema, n_partitions=1)
    batch = host_to_device(df.plan.batches[0], 128, "cpu")
    return sess, transform_segment_query(df, F), batch


def test_k12_string_transform_rules_match_plain(emu):
    from spark_rapids_tpu_torch.exec.fused import TpuFusedSegmentExec

    sess, df, batch = _transform_frame()
    found = []

    def walk(p):
        if isinstance(p, TpuFusedSegmentExec):
            found.append(p)
        for c in p.children:
            walk(c)

    walk(sess.physical_plan(df.plan))
    assert len(found) == 1
    prog = found[0].program
    assert len(prog.members) == 2
    [(want, want_keep)] = FK.segment_plain(prog, batch)
    counters = (SK.STRING_CASE_LAUNCHES, SK.STRING_TRIM_LAUNCHES,
                SK.STRING_REPLACE_LAUNCHES, SK.STRING_SEARCH_LAUNCHES)
    for c in counters + (FK.FUSED_LAUNCHES,):
        c.reset()
    [(got, got_keep)] = FK.run_segment(prog, batch, kernels=emu)
    assert FK.FUSED_LAUNCHES.count == 1
    assert all(c.count == 0 for c in counters)
    _same(got_keep, want_keep)
    assert 0 < int(want_keep.sum()) < int(batch.num_rows)
    for g, w, field in zip(got.columns, want.columns, prog.schema):
        assert g.dtype == w.dtype, field.name
        _same(g.validity, w.validity)
        _same(g.data.contiguous(), w.data.contiguous())
        if w.lengths is not None:
            _same(g.lengths.contiguous(), w.lengths.contiguous())
    kinds = {o.kind for o in prog.outputs[0]}
    assert {"scratch", "str", "num"} <= kinds
