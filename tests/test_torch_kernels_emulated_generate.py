"""K22 (explode), K23 (expand) and K12's Expand and Generate members,
built for the CPU with the host C++ compiler against
``csrc/emulator/cuda_runtime.h`` (``test_torch_kernels_emulated._build_emulated``;
the libraries are built once for the module) and held against their
plain PyTorch versions on the same inputs.

The batches have 2,100 logical rows padded to 4,096, so every kernel
also writes the padding rows, and a second batch of 37 rows padded to
128.  K22 runs with k = 3 and k = 5, with and without ``pos``, over
pass-through columns of every width (bool, int32, int64, float64, a
string column and a broadcast string literal) and elements of mixed
types (a narrower integer, a wider one, a float, an all-null element)
or strings of different widths; K23 runs three projection lists of
column references (shared and widened), literal fills converted to the
field's type, typed nulls of numbers and strings, an untyped null in a
string field and a string literal.  K12 runs the plans' own segments:
a Filter -> Project -> Expand rollup, a Project -> Generate -> Filter ->
Project chain, string elements, an Expand followed by a Generate, and
the Coalesce and NaNvl rules.
Every comparison is exact: data (floats bit for bit, NaNs included),
validity and lengths in full, padding and null rows included, and the
launch counts.

Mutation checks: a K22 that interleaves column-major (element ``j`` of
row ``s`` at ``j * p + s``) and a K23 that skips the row mask, each
built from an edited copy of its source, must disagree with the plain
version."""
import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import f as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.column import (DeviceColumn, HostBatch,
                                                host_to_device)
from spark_rapids_tpu_torch.data import strings as dstrings
from spark_rapids_tpu_torch.exec.fused import TpuFusedSegmentExec
from spark_rapids_tpu_torch.ops.kernels import _build as B
from spark_rapids_tpu_torch.ops.kernels import fused as FK
from spark_rapids_tpu_torch.ops.kernels import generate as GK
from spark_rapids_tpu_torch.plan import logical as L
from test_torch_kernels_emulated import (_LAUNCH, EMULATOR_INCLUDE,
                                         _build_emulated,
                                         _build_generated_emulated)

N, P = 2100, 4096


@pytest.fixture(scope="module")
def emu():
    out = _build_emulated()
    return B.Kernels(lambda: out, lambda t: None, _build_generated_emulated)


def _same(got, want):
    """Equal shapes and types, and equal bits (NaNs included)."""
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    if got.dtype.is_floating_point:
        bits = {torch.float64: torch.int64, torch.float32: torch.int32}
        got, want = (t.contiguous().view(bits[t.dtype]) for t in (got, want))
    assert torch.equal(got, want)


def _same_columns(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        _same(g.validity, w.validity)
        _same(g.data.contiguous(), w.data.contiguous())
        assert (g.lengths is None) == (w.lengths is None)
        if w.lengths is not None:
            _same(g.lengths.to(torch.int32).contiguous(),
                  w.lengths.to(torch.int32).contiguous())


def _strings(rng, n, width):
    rows = ["".join(rng.choice(list("abcXYZ -é"), int(rng.integers(0, 9))))
            for _ in range(n)]
    rows[:4] = ["", None, "x" * 3, "nul\x00"]
    bm, ln = dstrings.encode(rows)
    bm = np.pad(bm, ((0, 0), (0, max(0, width - bm.shape[1]))))
    valid = np.array([r is not None for r in rows])
    return bm, ln, valid


def _pad(arr, p=P):
    out = np.zeros((p,) + arr.shape[1:], dtype=arr.dtype)
    out[:len(arr)] = arr
    return torch.from_numpy(out)


def _columns(seed=5, n=N, p=P):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.1

    def col(dtype, data, v=None, lengths=None):
        return DeviceColumn(dtype, _pad(data, p),
                            _pad(valid if v is None else v, p),
                            None if lengths is None else _pad(lengths, p))

    bm, ln, sv = _strings(rng, n, 12)
    lit_bm, lit_ln = dstrings.encode(["literal!"])
    lit = DeviceColumn(T.STRING, torch.from_numpy(lit_bm).expand(p, -1),
                       torch.ones(p, dtype=torch.bool),
                       torch.from_numpy(lit_ln).expand(p))
    return {
        "b": col(T.BOOL, rng.random(n) > 0.5),
        "i32": col(T.INT32, rng.integers(-2**31, 2**31 - 1, n,
                                         dtype=np.int64).astype(np.int32)),
        "i64": col(T.INT64, rng.integers(-2**62, 2**62, n, dtype=np.int64)),
        "f64": col(T.FLOAT64, rng.normal(0, 1e6, n)),
        "f32": col(T.FLOAT32, rng.normal(0, 1e3, n).astype(np.float32)),
        "s": col(T.STRING, bm, sv, ln),
        "lit": lit,
    }, torch.tensor(n, dtype=torch.int32)


# --------------------------------------------------------------------------
# K22
# --------------------------------------------------------------------------
def _null(dtype, p=P):
    return DeviceColumn(dtype, torch.zeros(p, dtype=dtype.torch_dtype),
                        torch.zeros(p, dtype=torch.bool))


@pytest.mark.parametrize("k,position", [(3, True), (3, False), (5, True)])
def test_k22_numeric_matches_plain(emu, k, position):
    cols, nr = _columns()
    passed = [cols[n] for n in ("b", "i32", "i64", "f64", "s", "lit")]
    pool = [cols["i64"], cols["i32"], cols["f64"], _null(T.INT64),
            cols["b"]]
    elements = pool[:k]
    GK.EXPLODE_LAUNCHES.reset()
    got = GK.explode(passed, nr, elements, T.INT64, position, kernels=emu)
    assert GK.EXPLODE_LAUNCHES.count == 1
    want = GK.explode(passed, nr, elements, T.INT64, position)
    assert got[0].data.shape[0] == P * k
    _same_columns(got, want)
    # row-major: input row 7's k elements are consecutive
    assert int(got[-1].data[7 * k]) == int(cols["i64"].data[7])
    assert int(got[-1].data[7 * k + 1]) == int(cols["i32"].data[7])


def test_k22_float_and_string_elements_match_plain(emu):
    cols, nr = _columns(seed=6)
    passed = [cols["i32"], cols["s"]]
    for elements, out in (
            ([cols["f64"], cols["f32"], cols["i32"]], T.FLOAT64),
            ([cols["f32"], cols["f64"]], T.FLOAT32),
            ([cols["s"], cols["lit"], cols["s"]], T.STRING)):
        got = GK.explode(passed, nr, elements, out, True, kernels=emu)
        want = GK.explode(passed, nr, elements, out, True)
        _same_columns(got, want)
    # a string element narrower than the widest is zero-padded
    assert got[-1].data.shape[1] == 12


def test_k22_small_padded_batch_matches_plain(emu):
    cols, _nr = _columns(seed=7, n=37, p=128)
    nr = torch.tensor(37, dtype=torch.int32)
    elements = [cols["f64"], cols["f64"], cols["f64"]]
    got = GK.explode([cols["s"], cols["i64"]], nr, elements, T.FLOAT64,
                     True, kernels=emu)
    want = GK.explode([cols["s"], cols["i64"]], nr, elements, T.FLOAT64,
                      True)
    _same_columns(got, want)
    assert not bool(got[0].validity[37 * 3:].any())


# --------------------------------------------------------------------------
# K23
# --------------------------------------------------------------------------
def _expand_case():
    cols, nr = _columns(seed=8)
    sources = [cols[n] for n in ("i32", "i64", "f32", "s", "b")]
    I64, F64, S = T.INT64, T.FLOAT64, T.STRING
    fields = [I64, F64, S, T.INT32, I64, S]
    op = GK.ExpandOp
    projections = [
        [op("ref", I64, 1), op("ref", F64, 2), op("ref", S, 3),
         op("ref", T.INT32, 0), op("lit", I64, value=7, lit_dtype=I64),
         op("lit", S, value="grand", lit_dtype=S)],
        [op("ref", I64, 0), op("null", F64), op("null", S),
         op("lit", T.INT32, value=2**40 + 5, lit_dtype=I64),
         op("lit", I64, value=-1, lit_dtype=T.INT32),
         op("lit", S, value=None, lit_dtype=T.NULL)],
        [op("null", I64), op("lit", F64, value=1.25, lit_dtype=F64),
         op("lit", S, value="", lit_dtype=S), op("ref", T.INT32, 4),
         op("lit", I64, value=None, lit_dtype=T.NULL),
         op("ref", S, 3)],
    ]
    assert all(o.dtype == f for ps in projections
               for o, f in zip(ps, fields))
    return sources, nr, projections


def test_k23_matches_plain(emu):
    sources, nr, projections = _expand_case()
    GK.EXPAND_LAUNCHES.reset()
    got = GK.expand(sources, nr, projections, kernels=emu)
    assert GK.EXPAND_LAUNCHES.count == 1
    want = GK.expand(sources, nr, projections)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_columns(g, w)
    # a shared reference keeps its input tensor; a widened one is new
    assert got[0][0].data is sources[1].data
    assert got[1][0].data is not sources[0].data
    assert got[1][0].dtype == T.INT64
    # the untyped null in a string field keeps type NULL, as in the
    # reference
    assert got[1][5].dtype == T.NULL


def test_k23_spec_reused_across_batches_matches_plain(emu):
    """One ExpandSpec (as an Expand exec holds) over two batches of the
    same types: the static words built once, the pointers patched per
    call, every output equal to the plain version."""
    sources, nr, projections = _expand_case()
    spec = GK.ExpandSpec(projections)
    other, nr2 = _columns(seed=14)
    sources2 = [other[n] for n in ("i32", "i64", "f32", "s", "b")]
    for src, n in ((sources, nr), (sources2, nr2), (sources, nr)):
        got = GK.expand(src, n, spec, kernels=emu)
        for g, w in zip(got, GK.expand(src, n, projections)):
            _same_columns(g, w)
    assert len(spec._plans) == 1


def test_explode_bytes_counts_a_shared_array_once():
    """An unpivot's elements are its pass-through columns' arrays: each
    is read once, so the bound counts it once."""
    cols, nr = _columns(seed=15)
    passed = [cols["i64"], cols["f64"]]
    out = GK.explode(passed, nr, passed, T.FLOAT64, True)
    each = sum(c.data.numel() * c.data.element_size() + c.validity.numel()
               for c in passed)
    written = sum(t.numel() * t.element_size() for c in out
                  for t in (c.data, c.validity, c.lengths) if t is not None)
    assert GK.explode_bytes(passed, passed, out) == 4 + each + written
    copies = [DeviceColumn(c.dtype, c.data.clone(), c.validity.clone())
              for c in passed]
    assert GK.explode_bytes(passed, copies, out) == 4 + 2 * each + written


# --------------------------------------------------------------------------
# K12 with Expand and Generate members
# --------------------------------------------------------------------------
def _table(n=N, seed=9):
    rng = np.random.default_rng(seed)
    cats = np.array(["Books", "Home", "Music", "Garden-Tools"],
                    dtype=object)
    return HostBatch.from_pydict({
        "cat": list(cats[rng.integers(0, 4, n)]),
        "cls": [None if i % 17 == 0 else f"c{i % 5}" for i in range(n)],
        "brand": rng.integers(1, 50, n).tolist(),
        "qty": [None if i % 13 == 0 else int(v)
                for i, v in enumerate(rng.integers(1, 20, n))],
        "price": rng.uniform(-5.0, 300.0, n).tolist(),
        "profit": rng.normal(0, 100.0, n).tolist(),
    }, T.Schema([T.Field("cat", T.STRING), T.Field("cls", T.STRING),
                 T.Field("brand", T.INT32), T.Field("qty", T.INT32),
                 T.Field("price", T.FLOAT64),
                 T.Field("profit", T.FLOAT64)]))


def _segments(sess, df):
    found = []

    def walk(p):
        if isinstance(p, TpuFusedSegmentExec):
            found.append(p)
        for c in p.children:
            walk(c)

    walk(sess.physical_plan(df.plan))
    return found


def _check(emu, seg, batch):
    want = FK.segment_plain(seg.program, batch)
    FK.FUSED_LAUNCHES.reset()
    got = FK.run_segment(seg.program, batch, kernels=emu)
    assert FK.FUSED_LAUNCHES.count == 1
    assert len(got) == len(want) == len(seg.program.mults)
    for (g, gk), (w, wk) in zip(got, want):
        assert (gk is None) == (wk is None)
        if wk is not None:
            _same(gk, wk)
        _same(g.num_rows, w.num_rows)
        _same_columns(g.columns, w.columns)
    return got


def _frame(sess, hb):
    return sess.create_dataframe(hb, n_partitions=1)


def _rollup(df, keys, extra):
    types = {n: df.schema.fields[i].dtype for i, n in enumerate(df.columns)}
    projections = []
    for g in range(len(keys) + 1):
        kept = len(keys) - g
        projections.append(
            [F.col(k).expr if i < kept else F.lit(None, types[k]).expr
             for i, k in enumerate(keys)] + extra(g))
    return projections


def test_k12_rollup_segment_matches_plain(emu):
    """Filter -> Project -> Expand: four grouping sets over two string
    keys and an int key (typed nulls), a coalesce computed before the
    branch (written once, shared by the four batches), a widening int
    reference, a grouping id, an untyped null and a computed entry."""
    sess = Session(device="cpu")
    hb = _table()
    df = _frame(sess, hb).filter(F.col("price") > F.lit(10.0)).select(
        "cat", "cls", "brand", "qty",
        F.coalesce(F.col("price") * F.col("qty"), F.lit(0.0))
        .alias("sales"))
    keys = ["cat", "cls", "brand"]
    projections = _rollup(df, keys, lambda g: [
        F.col("sales").expr, F.lit(g).expr, F.col("qty").expr,
        F.lit(None).expr, (F.col("qty") + F.lit(g)).expr])
    # an int64 field: the other lists' int32 qty widens to it
    projections[0][5] = F.col("qty").cast(T.INT64).expr
    ex = type(df)(sess, L.Expand(df.plan, projections,
                                 keys + ["sales", "gid", "q", "u", "c"]))
    [seg] = _segments(sess, ex)
    assert [type(m).__name__ for m in seg.members] == [
        "TpuFilterExec", "TpuProjectExec", "TpuExpandExec"]
    batch = host_to_device(hb, 128, "cpu")
    got = _check(emu, seg, batch)
    assert len(got) == 4
    kinds = [o.kind for o in seg.program.outputs[1]]
    assert "shared" in kinds and "valid" in kinds
    # the sales column is one tensor in all four batches
    j = keys.index("brand") + 1
    assert all(b.columns[j].data is got[0][0].columns[j].data
               for b, _k in got[1:])


@pytest.mark.parametrize("k", [3, 5])
def test_k12_generate_segment_matches_plain(emu, k):
    """Project -> Generate(pos) -> Filter -> Project: each row's k
    elements at r * k + j, the keep mask repeated, members after the
    generate generated once per element."""
    sess = Session(device="cpu")
    hb = _table(seed=10)
    df = _frame(sess, hb).select("cat", "qty", "price", "profit")
    elems = [F.col("price"), F.col("profit"), F.col("qty"),
             F.lit(None), F.col("price") * F.lit(2.0)][:k]
    gen = type(df)(sess, L.Generate(df.plan, [e.expr for e in elems],
                                    "amount", position=True))
    out = gen.filter(F.col("amount") > F.lit(0.0)).select(
        "cat", "pos", "amount", (F.col("amount") + F.col("pos"))
        .alias("shifted"))
    [seg] = _segments(sess, out)
    assert len(seg.members) == 4
    batch = host_to_device(hb, 128, "cpu")
    [(b, keep)] = _check(emu, seg, batch)
    assert b.padded_rows == batch.padded_rows * k
    assert int(b.num_rows) == N * k
    assert 0 < int(keep.sum()) < N * k


def test_k12_string_elements_and_expand_then_generate_match_plain(emu):
    """String elements of different widths (a column, a literal, a
    concat, an untyped null) after a Project, and an Expand of two
    projection lists followed by a Generate: two batches, each three
    times the input's rows."""
    sess = Session(device="cpu")
    hb = _table(seed=11)
    df = _frame(sess, hb).select("cat", "cls", "brand")
    gen = type(df)(sess, L.Generate(df.plan, [
        F.col("cat").expr, F.lit("a literal longer than cat").expr,
        F.concat(F.col("cls"), F.lit("!")).expr, F.lit(None).expr],
        "word"))
    [seg] = _segments(sess, gen)
    batch = host_to_device(hb, 128, "cpu")
    _check(emu, seg, batch)
    df2 = _frame(sess, hb).select("cat", "brand", "price")
    ex = type(df2)(sess, L.Expand(df2.plan, [
        [F.col("cat").expr, F.col("price").expr],
        [F.lit(None, T.STRING).expr, (F.col("price") * F.lit(-1.0)).expr]],
        ["cat", "v"]))
    gen2 = type(ex)(sess, L.Generate(ex.plan, [
        F.col("v").expr, F.lit(0.5).expr, F.col("v").expr], "e",
        position=True))
    [seg2] = _segments(sess, gen2)
    got = _check(emu, seg2, batch)
    assert seg2.program.mults == [3, 3]
    assert [int(b.num_rows) for b, _k in got] == [3 * N, 3 * N]


def test_segment_plain_runs_no_hand_kernel(monkeypatch):
    """The plain composition K12 is held against runs an Expand or
    Generate member on its plain version, not on K23 or K22, on any
    device."""
    sess = Session(device="cpu")
    hb = _table(seed=11)
    df = _frame(sess, hb).select("cat", "brand", "price")
    ex = type(df)(sess, L.Expand(df.plan, [
        [F.col("cat").expr, F.col("price").expr],
        [F.lit(None, T.STRING).expr, (F.col("price") * F.lit(-1.0)).expr]],
        ["cat", "v"]))
    gen = type(ex)(sess, L.Generate(ex.plan, [
        F.col("v").expr, F.lit(0.5).expr], "e", position=True))
    [seg] = _segments(sess, gen)
    batch = host_to_device(hb, 128, "cpu")
    want = FK.segment_plain(seg.program, batch)

    def no_kernel(*a, **kw):
        raise AssertionError("the plain composition called a hand kernel")

    monkeypatch.setattr(GK, "explode", no_kernel)
    monkeypatch.setattr(GK, "expand", no_kernel)
    got = FK.segment_plain(seg.program, batch)
    assert [int(b.num_rows) for b, _k in got] == [2 * N, 2 * N]
    for (g, _gk), (w, _wk) in zip(got, want):
        _same_columns(g.columns, w.columns)


def _null_exprs_frame():
    """A Filter -> Project segment of coalesce and nanvl over nulls,
    NaNs, mixed types and strings (with its input batch)."""
    sess = Session(device="cpu")
    n = 300
    rng = np.random.default_rng(13)
    b = rng.normal(size=n)
    b[::7] = np.nan
    hb = HostBatch.from_pydict({
        "a": [None if i % 5 == 0 else i for i in range(n)],
        "b": [None if i % 11 == 0 else float(v) for i, v in enumerate(b)],
        "s": [None if i % 4 == 0 else f"w{i % 9}" for i in range(n)],
    }, T.Schema([T.Field("a", T.INT32), T.Field("b", T.FLOAT64),
                 T.Field("s", T.STRING)]))
    c = F.col
    df = _frame(sess, hb).filter(c("a").is_null() | (c("a") > F.lit(3))) \
        .select(F.coalesce(c("a"), F.lit(-1)).alias("c1"),
                F.coalesce(F.lit(None, T.FLOAT64), c("b"), c("a"))
                .alias("c2"),
                F.coalesce(c("s"), F.lit("none at all")).alias("c3"),
                F.coalesce(F.lit(None), c("s")).alias("c4"),
                F.coalesce(F.lit(None, T.INT64)).alias("c5"),
                F.nanvl(c("b"), F.lit(0.5)).alias("n1"),
                F.nanvl(c("b"), F.lit(None, T.FLOAT64)).alias("n2"),
                F.nanvl(c("a"), c("b")).alias("n3"))
    return sess, df, host_to_device(hb, 128, "cpu")


def test_k12_coalesce_and_nanvl_match_plain(emu):
    sess, df, batch = _null_exprs_frame()
    [seg] = _segments(sess, df)
    [(b, keep)] = _check(emu, seg, batch)
    assert 0 < int(keep.sum()) < 300


# --------------------------------------------------------------------------
# mutation checks
# --------------------------------------------------------------------------
def _mutant(name: str, *edits) -> B.Kernels:
    """The emulated library ``name`` built from its source with each
    ``(old, new)`` of ``edits`` replaced (into
    ``csrc/build/emulated-mutant-<hash>/``)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emulated "
                    "kernels")
    cu = B.KERNELS[name][0]
    text = (B.CSRC / cu).read_text()
    for old, new in edits:
        assert old in text
        text = text.replace(old, new)
    key = hashlib.sha256(text.encode()).hexdigest()[:12]
    out = B.BUILD_ROOT / f"emulated-mutant-{name}-{key}"
    lib = out / f"lib{name}.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        for f in B.CSRC.iterdir():
            if f.suffix == ".cuh":
                (out / f.name).write_text(_LAUNCH.sub(
                    lambda m: f"srt_launch(srt_cfg({m.group(2)}), "
                    f"{m.group(1)}, ", f.read_text()))
        src = out / cu
        src.write_text(_LAUNCH.sub(
            lambda m: f"srt_launch(srt_cfg({m.group(2)}), {m.group(1)}, ",
            text))
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", "-Wno-unknown-pragmas", "-x", "c++",
                        "-I", str(EMULATOR_INCLUDE), "-I", str(out),
                        "-o", str(tmp), str(src)], check=True)
        os.replace(tmp, lib)
    cdll = ctypes.CDLL(str(lib))
    for fn, (argtypes, _n) in B.KERNELS[name][1].items():
        getattr(cdll, fn).argtypes = argtypes
        getattr(cdll, fn).restype = ctypes.c_int
    kernels = B.Kernels(lambda: out, lambda t: None)
    kernels.libs = {name: cdll}
    return kernels


def test_k22_column_major_mutant_differs():
    # out_row takes the padded row count p and puts element j of row s
    # at j * p + s
    mutant = _mutant(
        "generate",
        ("out_row(long long s, int j, int k) {\n  return s * k + j;",
         "out_row(long long s, int j, int k, long long p) {\n"
         "  return (long long)j * p + s;"),
        ("out_row(s, j, k)", "out_row(s, j, k, p)"))
    cols, nr = _columns(seed=12)
    elements = [cols["i64"], cols["f64"], cols["i32"]]
    got = GK.explode([cols["i64"]], nr, elements, T.INT64, True,
                     kernels=mutant)
    want = GK.explode([cols["i64"]], nr, elements, T.INT64, True)
    assert not torch.equal(got[0].data, want[0].data)
    assert not torch.equal(got[-1].data, want[-1].data)


def test_k23_without_row_mask_mutant_differs():
    mutant = _mutant("expand", ("lit_valid) && rm;", "lit_valid);"))
    sources, nr, projections = _expand_case()
    got = GK.expand(sources, nr, projections, kernels=mutant)
    want = GK.expand(sources, nr, projections)
    # a literal is then valid on the padding rows too
    assert not torch.equal(got[0][4].validity, want[0][4].validity)
    assert bool(got[0][4].validity[N:].all())
