"""The CUDA kernels K1–K15 of spark_rapids_tpu_torch, built for the CPU
and held against their plain PyTorch versions on the same inputs (2,100
rows: two 2,048-row tiles, so the cross-tile scans and carries run; the
join's two sides together).  Exact, except float sums (rel 1e-12; K14's
float window sums rel 1e-9 of max(|result|, sum of |v|), as a prefix-sum
difference carries the prefix's rounding).
K12's generated sources (Q12's lineitem segment, Q13's orders segment,
one segment over every expression the code generator covers, and one
with Substring and Year) are built once each for the module; a copy of
the Year segment whose flooring division truncates instead must differ
from the plain version on dates before 1970.

``_build_emulated`` compiles every ``csrc/*.cu`` with the host C++
compiler against ``csrc/emulator/cuda_runtime.h`` (one thread per
CUDA thread, blocks one after another), rewriting each ``<<<...>>>``
launch into a call of the emulated launcher; the ``emu`` fixture hands
the libraries to the wrappers through their ``kernels=`` argument.  It
checks logic only: timing, coalescing and device-memory races are not
modelled."""
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.column import DeviceBatch, DeviceColumn
from spark_rapids_tpu_torch.ops.kernels import _build as B
from spark_rapids_tpu_torch.data.column import bucket_rows
from spark_rapids_tpu_torch.ops.kernels import gather as G
from spark_rapids_tpu_torch.ops.kernels import join as J
from spark_rapids_tpu_torch.ops.kernels import segment as S
from spark_rapids_tpu_torch.ops.kernels import stringkernels as SK
from spark_rapids_tpu_torch.ops.kernels import window as W
from spark_rapids_tpu_torch.exec import exchange as EX
from spark_rapids_tpu_torch.shuffle import device_shuffle as DS
from spark_rapids_tpu_torch.utils import hashing as H

N = 2100
N_REAL = 2063
EMULATOR_INCLUDE = B.CSRC / "emulator"
_LAUNCH = re.compile(r"(\b[\w:]+(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>\s*\(", re.S)


def _build_emulated() -> pathlib.Path:
    """Compile the emulated kernel libraries (all sources in parallel)
    into ``csrc/build/emulated-<hash>/``; returns that directory."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emulated "
                    "kernels")
    header = hashlib.sha256(
        (EMULATOR_INCLUDE / "cuda_runtime.h").read_bytes()).hexdigest()[:8]
    out = B.BUILD_ROOT / f"emulated-{B.source_hash()}-{header}"
    if all((out / f"lib{n}.so").exists() for n in B.KERNELS):
        return out
    src = out / f"src.{os.getpid()}"
    src.mkdir(parents=True, exist_ok=True)
    for f in B.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            text = _LAUNCH.sub(
                lambda m: f"srt_launch(srt_cfg({m.group(2)}), {m.group(1)}, ",
                f.read_text())
            (src / f.name).write_text(text)
    procs = []
    for name, (cu, _fns) in B.KERNELS.items():
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
               "-Wno-unknown-pragmas", "-x", "c++",
               "-I", str(EMULATOR_INCLUDE), "-I", str(src),
               "-o", str(tmp), str(src / cu)]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
        else:
            os.replace(tmp, out / f"lib{name}.so")
    assert not failed, "emulated build failed:\n" + "\n".join(failed)
    return out


def _build_generated_emulated(sources):
    """The emulated form of ``_build.build_generated``: each generated
    source (key -> text) compiled with the host compiler against the
    emulator, into ``csrc/build/emulated-k12-<key>-<header hash>/``."""
    cxx = shutil.which("g++") or shutil.which("c++")
    header = hashlib.sha256(
        (EMULATOR_INCLUDE / "cuda_runtime.h").read_bytes()).hexdigest()[:8]
    out = {k: B.BUILD_ROOT / f"emulated-k12-{k}-{header}" / "libk12.so"
           for k in sources}
    procs = []
    for key, text in sources.items():
        if out[key].exists():
            continue
        d = out[key].parent
        d.mkdir(parents=True, exist_ok=True)
        for h in B.GENERATED_HEADERS:
            (d / h).write_text(_LAUNCH.sub(
                lambda m: f"srt_launch(srt_cfg({m.group(2)}), "
                f"{m.group(1)}, ", (B.CSRC / h).read_text()))
        src = d / "k12.cu"
        src.write_text(_LAUNCH.sub(
            lambda m: f"srt_launch(srt_cfg({m.group(2)}), {m.group(1)}, ",
            text))
        tmp = d / f"libk12.so.{os.getpid()}.tmp"
        cmd = [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
               "-fPIC", "-pthread", "-Wno-unknown-pragmas", "-x", "c++",
               "-I", str(EMULATOR_INCLUDE), "-I", str(d), "-o", str(tmp),
               str(src)]
        procs.append((key, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for key, tmp, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{key}:\n{text}")
        else:
            os.replace(tmp, out[key])
    assert not failed, "emulated build failed:\n" + "\n".join(failed)
    return out


@pytest.fixture(scope="module")
def emu():
    """The emulated libraries as the wrappers' ``kernels=`` (no stream);
    generated sources build at first use and stay loaded for the
    module."""
    out = _build_emulated()
    return B.Kernels(lambda: out, lambda t: None, _build_generated_emulated)


def _keys(rng):
    """A one-byte string key and an int32 key, with nulls."""
    s = DeviceColumn(
        T.STRING,
        torch.from_numpy(rng.integers(65, 68, (N, 1)).astype(np.uint8)),
        torch.from_numpy(rng.random(N) > 0.1),
        torch.ones(N, dtype=torch.int32))
    i = DeviceColumn(
        T.INT32, torch.from_numpy(rng.integers(-3, 3, N).astype(np.int32)),
        torch.from_numpy(rng.random(N) > 0.1))
    return [s, i]


def _pad():
    return torch.arange(N) < N_REAL


def _same(got, want, rel=None):
    """Equal (NaN equal to NaN), or within ``rel`` for float sums."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype.is_floating_point:
        assert torch.allclose(got, want, rtol=rel or 0.0, atol=0,
                              equal_nan=True)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("desc", [False, True])
def test_k1_k2_match_plain(emu, desc):
    rng = np.random.default_rng(1 + desc)
    keys = _keys(rng)
    order = [desc, not desc]
    nfs = [True, desc]
    want = S.lexsort_plain(keys, order, nfs, _pad())
    S.SORT_LAUNCHES.reset()
    readbacks = S.SORT_READBACKS.count
    got = S.lexsort_device(keys, order, nfs, _pad(), kernels=emu)
    _same(got, want)
    # N rows fit one block: the encoding and every live digit of every
    # pass in one launch, and no host read back
    assert N <= S.SMALL_SORT_ROWS
    assert S.SORT_LAUNCHES.count == 1
    assert S.SORT_READBACKS.count == readbacks
    sorted_keys = [G.gather_column_plain(k, want) for k in keys]
    pad_sorted = _pad()[want.long()]
    want_ids = S.segment_ids_plain(sorted_keys, pad_sorted)
    S.SEGMENT_IDS_LAUNCHES.reset()
    got_ids = S.segment_ids_device(sorted_keys, pad_sorted, kernels=emu)
    _same(got_ids, want_ids)
    # every key's flags, the scan and the look-back in one launch
    assert S.SEGMENT_IDS_LAUNCHES.count == 1


def _ids(rng):
    keys = np.sort(rng.integers(0, 5, N_REAL))
    change = np.ones(N, dtype=bool)
    change[1:N_REAL] = keys[1:] != keys[:-1]
    return torch.from_numpy((np.cumsum(change) - 1).astype(np.int32))


@pytest.mark.parametrize("vkind,op", [
    ("float64", "sum"), ("float64", "min"), ("float64", "max"),
    ("int32", "min"), ("int64", "sum"), ("bool", "count"),
    ("float64", "first"), ("int32", "last_any")])
def test_k3_matches_plain(emu, vkind, op):
    rng = np.random.default_rng(7)
    ids = _ids(rng)
    values = {
        "float64": torch.from_numpy(rng.choice(
            [0.5, -1.25, np.nan, np.inf, 3.0, 1e9], N)),
        "int32": torch.from_numpy(rng.integers(-9, 9, N).astype(np.int32)),
        "int64": torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, N)),
        "bool": torch.from_numpy(rng.random(N) > 0.5),
    }[vkind]
    valid = torch.from_numpy(rng.random(N) > 0.2) & _pad()
    want = S.segment_reduce_device(values, valid, ids, N, op,
                                   present=_pad())
    got = S.segment_reduce_device(values, valid, ids, N, op,
                                  present=_pad(), kernels=emu)
    _same(got[1], want[1])
    _same(got[0], want[0], rel=1e-12 if op == "sum" else None)


def test_k3_segment_starts_match_plain(emu):
    ids = _ids(np.random.default_rng(3))
    want = S.segment_min_index(ids, N)
    S.SEGMENT_REDUCE_LAUNCHES.reset()
    got = S.segment_min_index(ids, N, kernels=emu)
    _same(got, want)
    assert S.SEGMENT_REDUCE_LAUNCHES.count == 2  # the tiles, the runs


@pytest.mark.parametrize("mask", ["random", "none", "all"])
def test_k4_compact_and_gather_match_plain(emu, mask):
    rng = np.random.default_rng(11)
    keys = _keys(rng)
    batch = DeviceBatch(T.Schema([T.Field("s", T.STRING),
                                  T.Field("i", T.INT32)]), keys,
                        torch.tensor(N_REAL, dtype=torch.int32))
    keep = {"random": torch.from_numpy(rng.random(N) > 0.4),
            "none": torch.zeros(N, dtype=torch.bool),
            "all": torch.ones(N, dtype=torch.bool)}[mask]
    want = G.compact_plain(batch, keep)
    G.COMPACT_LAUNCHES.reset()
    got = G.compact(batch, keep, kernels=emu)
    # plan: 2 (tile sums, offsets); every column's arrays: 1
    assert G.COMPACT_LAUNCHES.count == 2 + 1
    _same(got.num_rows, want.num_rows)
    for g, w in zip(got.columns, want.columns):
        _same(g.data, w.data)
        _same(g.validity, w.validity)
        if w.lengths is not None:
            _same(g.lengths, w.lengths)
    order = torch.from_numpy(rng.permutation(N).astype(np.int32))
    vmask = torch.from_numpy(rng.random(N) > 0.5)
    want_g = G.gather_column_plain(keys[0], order, vmask)
    G.GATHER_LAUNCHES.reset()
    got_g = G.gather_column(keys[0], order, vmask, kernels=emu)
    assert G.GATHER_LAUNCHES.count == 1  # validity, bytes and lengths
    _same(got_g.data, want_g.data)
    _same(got_g.validity, want_g.validity)
    _same(got_g.lengths, want_g.lengths)


def _join_side(rng, n, n_real, w):
    """An int64 key, a string key of width ``w`` and a double payload,
    with nulls; and the side's row mask."""
    words = [b"", b"a", b"ab", b"abc", b"abd", b"\xc3\xa9"]
    bm = np.zeros((n, w), dtype=np.uint8)
    ln = np.zeros(n, dtype=np.int32)
    for i, k in enumerate(rng.integers(0, len(words), n)):
        b = words[k][:w]
        bm[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        ln[i] = len(b)
    cols = [
        DeviceColumn(T.INT64, torch.from_numpy(rng.integers(0, 40, n)),
                     torch.from_numpy(rng.random(n) > 0.1)),
        DeviceColumn(T.STRING, torch.from_numpy(bm),
                     torch.from_numpy(rng.random(n) > 0.1),
                     torch.from_numpy(ln)),
        DeviceColumn(T.FLOAT64, torch.from_numpy(rng.uniform(-9, 9, n)),
                     torch.from_numpy(rng.random(n) > 0.1)),
    ]
    return cols, torch.arange(n) < n_real


@pytest.mark.parametrize("how", ["inner", "full"])
def test_k5_k6_k7_match_plain(emu, how):
    rng = np.random.default_rng(21)
    lcols, l_rm = _join_side(rng, 900, 850, 3)
    rcols, r_rm = _join_side(rng, 1200, 1111, 2)
    want = J.probe(lcols[:2], rcols[:2], l_rm, r_rm)
    J.JOIN_PROBE_LAUNCHES.reset()
    S.SORT_LAUNCHES.reset()
    got = J.probe(lcols[:2], rcols[:2], l_rm, r_rm, kernels=emu)
    # ok (all keys), concat (int64; string bytes + lengths), ids (with
    # the right rows' order), search, has_r (zero, mark, test); one K1
    # sort, on the one-block path
    assert J.JOIN_PROBE_LAUNCHES.count == 1 + 3 + 1 + 1 + 3
    assert S.SORT_LAUNCHES.count == 1
    for name in J.Probe._fields:
        _same(getattr(got, name), getattr(want, name))
    assert int(want.cnt.max()) > 1
    e_want = J.emit_counts(want, how, l_rm, r_rm)
    J.JOIN_EXPAND_LAUNCHES.reset()
    e_got = J.emit_counts(got, how, l_rm, r_rm, kernels=emu)
    assert J.JOIN_EXPAND_LAUNCHES.count == 1 + 3
    for name in ("emit", "total", "offs"):
        _same(getattr(e_got, name), getattr(e_want, name))
    if how == "full":
        _same(e_got.r_extra, e_want.r_extra)
        _same(e_got.unmatched_order, e_want.unmatched_order)
        assert bool(e_want.r_extra.any())
    else:
        assert e_got.r_extra is None and e_want.r_extra is None
    c_out = bucket_rows(int(e_want.total))
    pairs_want = J.expand_pairs(want, e_want, c_out)
    pairs_got = J.expand_pairs(got, e_got, c_out, kernels=emu)
    for g, w in zip(pairs_got, pairs_want):
        _same(g, w)
    J.GATHER_SIDE_LAUNCHES.reset()
    for cols, gi, wi in ((lcols, pairs_got[0], pairs_want[0]),
                         (rcols, pairs_got[1], pairs_want[1])):
        g_cols = J.gather_side(cols, gi, pairs_got[2], kernels=emu)
        w_cols = J.gather_side(cols, wi, pairs_want[2])
        for g, w in zip(g_cols, w_cols):
            _same(g.data, w.data)
            _same(g.validity, w.validity)
            if w.lengths is not None:
                _same(g.lengths, w.lengths)
    # one a call: K7 takes all of a side's columns in one launch
    assert J.GATHER_SIDE_LAUNCHES.count == 2


def test_k5_k6_without_has_r_match_plain(emu):
    """An inner join's probe skips the has_r launches, and its emit
    counts build no unmatched-right mask."""
    rng = np.random.default_rng(22)
    lcols, l_rm = _join_side(rng, 700, 650, 3)
    rcols, r_rm = _join_side(rng, 800, 777, 2)
    want = J.probe(lcols[:2], rcols[:2], l_rm, r_rm, with_has_r=False)
    J.JOIN_PROBE_LAUNCHES.reset()
    got = J.probe(lcols[:2], rcols[:2], l_rm, r_rm, with_has_r=False,
                  kernels=emu)
    assert J.JOIN_PROBE_LAUNCHES.count == 1 + 3 + 1 + 1
    assert got.has_r is None
    for name in J.Probe._fields[:-1]:
        _same(getattr(got, name), getattr(want, name))
    e_want = J.emit_counts(want, "inner", l_rm, r_rm)
    e_got = J.emit_counts(got, "inner", l_rm, r_rm, kernels=emu)
    for name in ("emit", "total", "offs"):
        _same(getattr(e_got, name), getattr(e_want, name))
    assert e_got.r_extra is None


def test_k8_matches_plain(emu):
    rng = np.random.default_rng(5)
    (l,), _ = _join_side(rng, N, N, 10)[0][1:2], None
    (r,), _ = _join_side(rng, N, N, 8)[0][1:2], None
    lit = torch.tensor([[ord(c) for c in "ab"]], dtype=torch.uint8)
    lit_len = torch.tensor([2], dtype=torch.int32)
    SK.STRING_COMPARE_LAUNCHES.reset()
    for args in ((l.data, l.lengths, r.data, r.lengths),
                 (l.data, l.lengths, lit.expand(N, -1), lit_len.expand(N)),
                 (lit, lit_len, r.data, r.lengths)):
        _same(SK.equals(*args, kernels=emu), SK.equals_plain(*args))
        _same(SK.compare(*args, kernels=emu), SK.compare_plain(*args))
    assert SK.STRING_COMPARE_LAUNCHES.count == 6


def _hash_cols(rng):
    """Every hashable type with nulls: -0.0 and NaN among the floats,
    strings of 0-9 bytes (0-3 tail bytes) with bytes >= 0x80."""
    def valid():
        return torch.from_numpy(rng.random(N) > 0.15)

    w = 9
    bm = rng.integers(0, 256, (N, w)).astype(np.uint8)
    ln = rng.integers(0, w + 1, N).astype(np.int32)
    bm[np.arange(w)[None, :] >= ln[:, None]] = 0
    f64 = rng.choice([0.0, -0.0, np.nan, 1.5, -2.25, 1e300], N)
    return [
        DeviceColumn(T.INT32, torch.from_numpy(
            rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32)), valid()),
        DeviceColumn(T.INT64, torch.from_numpy(
            rng.integers(-2 ** 63, 2 ** 63, N, dtype=np.int64)), valid()),
        DeviceColumn(T.FLOAT64, torch.from_numpy(f64), valid()),
        DeviceColumn(T.FLOAT32, torch.from_numpy(np.where(
            np.abs(f64) > 1e30, 3.5, f64).astype(np.float32)), valid()),
        DeviceColumn(T.STRING, torch.from_numpy(bm), valid(),
                     torch.from_numpy(ln)),
        DeviceColumn(T.INT8, torch.from_numpy(
            rng.integers(-128, 128, N).astype(np.int8)), valid()),
        DeviceColumn(T.INT16, torch.from_numpy(
            rng.integers(-2 ** 15, 2 ** 15, N).astype(np.int16)), valid()),
        DeviceColumn(T.BOOL, torch.from_numpy(rng.random(N) > 0.5), valid()),
        DeviceColumn(T.DATE32, torch.from_numpy(
            rng.integers(-9000, 20000, N).astype(np.int32)), valid()),
    ]


def test_k9_matches_plain(emu):
    cols = _hash_cols(np.random.default_rng(31))
    H.HASH_LAUNCHES.reset()
    _same(H.hash_device_batch(cols, kernels=emu), H.hash_batch_plain(cols))
    for n_out in (2, 3, 8):
        _same(H.hash_pids(cols[:2] + cols[4:5], n_out, kernels=emu),
              H.pmod(H.hash_batch_plain(cols[:2] + cols[4:5]), n_out))
    assert H.HASH_LAUNCHES.count == 4  # one a call, every column in it


@pytest.mark.parametrize("n_out", [3, 300], ids=["shared", "wide"])
def test_k10_build_and_slice_match_plain(emu, n_out):
    rng = np.random.default_rng(41)
    pids = torch.from_numpy(rng.integers(0, n_out, N).astype(np.int32))
    num_rows = torch.tensor(N_REAL, dtype=torch.int32)
    want = DS.partition_order_plain(pids, num_rows, n_out)
    DS.BUILD_LAUNCHES.reset()
    got = DS.partition_order(pids, num_rows, n_out, kernels=emu)
    for g, w in zip(got, want):
        _same(g, w)
    # histogram and look-back scatter; or global histogram and scan (+ K1)
    assert DS.BUILD_LAUNCHES.count == 2
    cols = _keys(rng) + [DeviceColumn(
        T.FLOAT64, torch.from_numpy(rng.uniform(-5, 5, N)),
        torch.from_numpy(rng.random(N) > 0.2))]
    batch = DeviceBatch(T.Schema([T.Field("s", T.STRING),
                                  T.Field("i", T.INT32),
                                  T.Field("d", T.FLOAT64)]), cols, num_rows)
    # K10's split of the batch by the build's order (the exchange slices
    # no block since the split replaced the slice)
    counts = want[1].tolist()
    DS.PARTITION_SPLIT_LAUNCHES.reset()
    got_parts = DS.partition_split(batch, got[0], counts, kernels=emu)
    want_parts = DS.partition_split_plain(batch, want[0], counts)
    assert DS.PARTITION_SPLIT_LAUNCHES.count == 1  # every column, once
    for g, w in zip(got_parts, want_parts):
        assert (g is None) == (w is None)
        if w is None:
            continue
        _same(g.num_rows, w.num_rows)
        for gc, wc in zip(g.columns, w.columns):
            _same(gc.data, wc.data)
            _same(gc.validity, wc.validity)
            if wc.lengths is not None:
                _same(gc.lengths, wc.lengths)


def test_k11_matches_plain(emu):
    rng = np.random.default_rng(51)
    # few distinct values, so rows tie with bounds on leading passes
    passes = torch.from_numpy(rng.integers(-3, 3, (3, N)).astype(np.int64))
    passes[0, :7] = torch.tensor([-2 ** 63, 2 ** 63 - 1, 0, 0, 0, 1, 2])
    bounds = torch.sort(torch.from_numpy(
        rng.integers(-3, 3, (3, 4)).astype(np.int64)), dim=1).values
    EX.RANGE_PID_LAUNCHES.reset()
    got = EX.range_pids_from_bounds(passes, bounds, kernels=emu)
    _same(got, EX.range_pids_plain(passes, bounds))
    assert EX.RANGE_PID_LAUNCHES.count == 1
    assert len(torch.unique(got)) > 2


# --------------------------------------------------------------------------
# K13: string search
# --------------------------------------------------------------------------
NEEDLES = [b"", b"a", b"ab", b"abc", b"\xc3\xa9", b"special", b"x" * 9,
           b"x" * 10]


def test_k13_matches_plain(emu):
    rng = np.random.default_rng(61)
    w = 9
    words = [b"", b"a", b"ab", b"abc", b"cab", b"babab", b"\xc3\xa9ab",
             b"special", b"x" * 9, b"aspecial"]
    bm = np.zeros((N, w), dtype=np.uint8)
    ln = np.zeros(N, dtype=np.int32)
    for i, k in enumerate(rng.integers(0, len(words), N)):
        bm[i, :len(words[k])] = np.frombuffer(words[k], dtype=np.uint8)
        ln[i] = len(words[k])
    bm, ln = torch.from_numpy(bm), torch.from_numpy(ln)
    start = torch.from_numpy(rng.integers(-2, w + 2, N).astype(np.int32))
    SK.STRING_SEARCH_LAUNCHES.reset()
    for needle in NEEDLES:
        for fn in (SK.contains, SK.startswith, SK.endswith):
            _same(fn(bm, ln, needle, kernels=emu), fn(bm, ln, needle))
        got = SK.locate_from(bm, ln, needle, start, kernels=emu)
        _same(got, SK.locate_from(bm, ln, needle, start))
    assert SK.STRING_SEARCH_LAUNCHES.count == 4 * len(NEEDLES)
    assert bool(SK.contains(bm, ln, b"ab").any())


# --------------------------------------------------------------------------
# K15: substring
# --------------------------------------------------------------------------
def test_k15_matches_plain(emu):
    """Every start and length shape, by the row kernel (out_w <= 4) and
    the byte kernel, over rows of every length (15 bytes wide, as
    c_phone) with zero padding."""
    rng = np.random.default_rng(15)
    w = 15
    ln = rng.integers(0, w + 1, N).astype(np.int32)
    bm = rng.integers(1, 256, (N, w)).astype(np.uint8)
    bm = np.where(np.arange(w)[None, :] < ln[:, None], bm, 0).astype(
        np.uint8)
    bm, ln = torch.from_numpy(bm), torch.from_numpy(ln)
    SK.STRING_TRANSFORM_LAUNCHES.reset()
    calls = 0
    for start in (-w - 3, -1, 0, 5, w + 2):
        for sub_len in (0, 2, 8, w + 4):
            out_w = min(max(sub_len, 1), w)
            got = SK.substring(bm, ln, start, sub_len, out_w, kernels=emu)
            want = SK.substring(bm, ln, start, sub_len, out_w)
            _same(got[0], want[0])
            _same(got[1], want[1])
            calls += 1
    assert SK.STRING_TRANSFORM_LAUNCHES.count == calls


# --------------------------------------------------------------------------
# K12: generated fused segments
# --------------------------------------------------------------------------
def _segment(sess, df):
    """The first fused segment of ``df``'s device plan."""
    from spark_rapids_tpu_torch.exec.fused import TpuFusedSegmentExec

    found = []

    def walk(p):
        if isinstance(p, TpuFusedSegmentExec):
            found.append(p)
        for c in p.children:
            walk(c)

    walk(sess.physical_plan(df.plan))
    assert found, "the plan has no fused segment"
    return found[0]


def _check_segment(emu, seg, batch):
    from spark_rapids_tpu_torch.ops.kernels import fused as FK

    [(want, want_keep)] = FK.segment_plain(seg.program, batch)
    FK.FUSED_LAUNCHES.reset()
    [(got, got_keep)] = FK.run_segment(seg.program, batch, kernels=emu)
    assert FK.FUSED_LAUNCHES.count == 1
    assert (got_keep is None) == (want_keep is None)
    if want_keep is not None:
        _same(got_keep, want_keep)
    _same(got.num_rows, want.num_rows)
    for g, w in zip(got.columns, want.columns):
        assert g.dtype == w.dtype
        _same(g.validity, w.validity)
        # data and lengths in full, padding and invalid rows included
        _same(g.data.contiguous(), w.data.contiguous())
        if w.lengths is not None:
            _same(g.lengths.contiguous(), w.lengths.contiguous())
    return want_keep


@pytest.mark.parametrize("q", [12, 13])
def test_k12_tpch_segment_matches_plain(emu, q):
    """Q12's lineitem segment (InSet on a string, date column compares)
    and Q13's orders segment (two contains under a NOT) on 2,000 lines
    (500 orders) of the generator's data."""
    from spark_rapids_tpu_torch import Session
    from spark_rapids_tpu_torch.benchmarks import tpch, tpch_datagen
    from spark_rapids_tpu_torch.data.column import host_to_device

    sess = Session(device="cpu")
    host = tpch_datagen.tables(q, seed=5, n_rows=2000)
    frames = {t: sess.create_dataframe(b, n_partitions=1)
              for t, b in host.items()}
    seg = _segment(sess, tpch.QUERIES[q](frames))
    table = "lineitem" if q == 12 else "orders"
    batch = host_to_device(host[table], 128, "cpu")
    keep = _check_segment(emu, seg, batch)
    assert 0 < int(keep.sum()) < int(batch.num_rows)


def test_k12_every_expression_matches_plain(emu):
    """One segment (filter, project, filter, project) over every
    expression the code generator covers, with nulls, NaN, -0.0, integer
    overflow, zero divisors and padding rows (300 rows in a 512-row
    bucket)."""
    from test_torch_fusion import every_expression_frame

    sess, df, batch = every_expression_frame()
    _check_segment(emu, _segment(sess, df), batch)


def _substring_year_frame():
    """(session, DataFrame, device batch): Q22's customer segment shape
    (a substring filtered by ``isin``) with Year of a date and of a
    timestamp and a substring of every start kind, over 2,100 rows with
    nulls, dates from before year 0 (where the day count plus 719,468 is
    negative, so truncating and flooring divisions differ) to 9999, and
    timestamps on both sides of midnight before the epoch."""
    from spark_rapids_tpu_torch import Session
    from spark_rapids_tpu_torch import f as F
    from spark_rapids_tpu_torch.data.column import host_to_device
    from spark_rapids_tpu_torch.ops.stringexprs import Substring

    rng = np.random.default_rng(17)
    phones = [None if i % 97 == 0 else
              f"{a}-{b}" + "x" * int(e) for i, (a, b, e) in enumerate(zip(
                  rng.integers(10, 35, N), rng.integers(100, 1000, N),
                  rng.integers(0, 9, N)))]
    days = rng.integers(-1_000_000, 2932897, N)
    micros = days * 86_400_000_000 + rng.integers(-10 ** 11, 10 ** 11, N)
    micros[:8] = [-1, -86_400_000_000, -86_400_000_001, 0, 1, -10 ** 6,
                  -31_536_000_000_000, -31_536_000_000_001]
    data = {"k": list(range(N)), "s": phones, "d": days.tolist(),
            "t": micros.tolist()}
    schema = T.Schema([T.Field("k", T.INT64), T.Field("s", T.STRING),
                       T.Field("d", T.DATE32), T.Field("t", T.TIMESTAMP)])
    sess = Session(device="cpu")
    df = sess.create_dataframe(data, schema, n_partitions=1)
    sub = [F.Column(Substring(F.col("s").expr, p, n)).alias(f"s{i}")
           for i, (p, n) in enumerate([(-3, None), (0, 4), (5, 100),
                                       (-20, 2)])]
    q = (df.with_column("cc", F.substring(F.col("s"), 1, 2))
         .filter(F.col("cc").isin("13", "31", "23", "29", "30", "18", "17")
                 | (F.year(F.col("d")) < F.lit(1970)))
         .select("k", "cc", F.year(F.col("d")).alias("y"),
                 F.year(F.col("t")).alias("yt"), *sub))
    batch = host_to_device(df.plan.batches[0], 128, "cpu")
    return sess, q, batch


def test_k12_substring_and_year_match_plain(emu):
    sess, df, batch = _substring_year_frame()
    seg = _segment(sess, df)
    assert "Substring(s)" in seg.describe() and "Year(d)" in seg.describe()
    keep = _check_segment(emu, seg, batch)
    assert 0 < int(keep.sum()) < int(batch.num_rows)


def with_truncating_fdiv(source: str) -> str:
    """``source`` with ``strings.cuh`` inlined and its flooring division
    ``srt::fdiv`` truncating instead (C++ ``/``)."""
    floor = "return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;"
    header = (B.CSRC / "strings.cuh").read_text()
    assert floor in header and "srt::fdiv" in source
    return source.replace('#include "strings.cuh"',
                          header.replace(floor, "return q;"))


def test_k12_year_with_truncating_division_differs(emu):
    """The mutation check of the Year rule: the same segment with
    ``srt::fdiv`` truncating (C++ ``/``) disagrees with the plain
    version."""
    import copy

    from spark_rapids_tpu_torch.ops.kernels import fused as FK

    sess, df, batch = _substring_year_frame()
    seg = _segment(sess, df)
    prog = copy.copy(seg.program)
    prog.source = with_truncating_fdiv(prog.source)
    prog.key = B.generated_key(prog.source)
    [(want, _k)] = FK.segment_plain(prog, batch)
    [(got, _k)] = FK.run_segment(prog, batch, kernels=emu)
    for name in ("y", "yt"):
        j = [f.name for f in prog.schema].index(name)
        assert not torch.equal(got.columns[j].data, want.columns[j].data)


# --------------------------------------------------------------------------
# K14 — the window kernel
# --------------------------------------------------------------------------
def _window_input(seed=21):
    """Rows sorted by (k, t) with K1's plain version: the order, the
    sorted segment ids (K2's plain version) and the row mask."""
    rng = np.random.default_rng(seed)
    k = DeviceColumn(T.INT32, torch.from_numpy(
        rng.integers(0, 12, N).astype(np.int32)),
        torch.from_numpy(rng.random(N) > 0.05))
    t = DeviceColumn(T.INT32, torch.from_numpy(
        rng.integers(0, 40, N).astype(np.int32)),
        torch.from_numpy(rng.random(N) > 0.05))
    rm = _pad()
    order = S.lexsort_plain([k, t], [False, True], [True, False], rm)
    rm_s = rm[order.long()]
    seg = S.segment_ids_plain([G.gather_column_plain(k, order)], rm_s)
    return rng, order, rm, seg


def _window_values(rng, dtype):
    if dtype == "float64":
        v = rng.choice([0.0, -0.0, np.nan, 1.5, -2.25, np.inf, 7.0, 1e9], N)
        return torch.from_numpy(v)
    if dtype == "float64_finite":
        return torch.from_numpy(rng.random(N) * 1e6 - 3e5)
    if dtype == "int64":
        return torch.from_numpy(rng.integers(2 ** 61, 2 ** 62, N)
                                * rng.choice([-1, 1], N))
    if dtype == "bool":
        return torch.from_numpy(rng.random(N) > 0.5)
    return torch.from_numpy(rng.integers(-100, 100, N).astype(dtype))


def _same_bits(got, want):
    """Equal bit for bit (NaN payloads and the sign of zero count)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype.is_floating_point:
        ib = torch.int64 if want.dtype == torch.float64 else torch.int32
        assert torch.equal(got.view(ib), want.view(ib))
    else:
        assert torch.equal(got, want)


def test_k14_bounds_and_ranks_match_plain(emu):
    _rng, order, rm, seg = _window_input()
    W.WINDOW_LAUNCHES.reset()
    start, end = W.segment_bounds(seg, kernels=emu)
    assert W.WINDOW_LAUNCHES.count == 3
    ws, we = W.segment_bounds_plain(seg)
    _same_bits(start, ws)
    _same_bits(end, we)
    # no partition keys: every padding row its own segment
    lane = torch.arange(N, dtype=torch.int32)
    ids0 = torch.where(rm[order.long()], torch.zeros_like(lane), lane + 1)
    for g, w in zip(W.segment_bounds(ids0, kernels=emu),
                    W.segment_bounds_plain(ids0)):
        _same_bits(g, w)
    ok_ids = torch.from_numpy(np.cumsum(
        np.random.default_rng(2).random(N) > 0.6).astype(np.int32))
    ok_ids = torch.maximum(ok_ids, seg)  # nondecreasing, runs in segments
    ok_start = W.segment_bounds_plain(ok_ids)[0]
    for kind in W.RANK_KINDS:
        got = W.rank_values(kind, order, rm, ws, ok_ids, ok_start,
                            kernels=emu)
        want = W.rank_values_plain(kind, order, rm, ws, ok_ids, ok_start)
        _same_bits(got[0], want[0])
        _same_bits(got[1], want[1])


FRAMES = {"unbounded": (None, None), "running": (None, 0),
          "reverse": (0, None), "rows_-4_0": (-4, 0), "rows_-2_2": (-2, 2),
          "wide": (-700, 300)}
# every frame mode for min (float64: NaN and -0.0) and first (both
# ignore_nulls settings); the other kinds and dtypes on the frames whose
# code paths differ for them (prefix sums are frame-independent; min/max
# split into forward scan, reverse scan and sparse table)
K14_CASES = (
    [("min", "float64", f) for f in FRAMES]
    + [("first", "float64", f) for f in FRAMES]
    + [("count", None, "rows_-2_2"), ("count", "float64", "running"),
       ("count", "float64", "unbounded"), ("sum", "int64", "rows_-4_0"),
       ("sum", "int64", "reverse"), ("sum", "float64_finite", "wide"),
       ("sum", "float64_finite", "unbounded"), ("avg", "int32", "rows_-2_2"),
       ("avg", "float64_finite", "running"), ("max", "float64", "unbounded"),
       ("max", "float64", "rows_-2_2"), ("max", "float64", "reverse"),
       ("min", "int64", "running"), ("min", "int64", "wide"),
       ("max", "int16", "reverse"), ("max", "int16", "rows_-2_2"),
       ("min", "float32", "running"), ("min", "float32", "rows_-4_0"),
       ("last", "bool", "running"), ("last", "bool", "reverse"),
       ("last", "bool", "rows_-2_2")])


@pytest.mark.parametrize("kind,dtype,frame", K14_CASES)
def test_k14_frame_aggregates_match_plain(emu, kind, dtype, frame):
    rng, order, rm, seg = _window_input()
    start, end = W.segment_bounds_plain(seg)
    values = valid = None
    if dtype is not None:
        values = _window_values(rng, dtype)
        valid = torch.from_numpy(rng.random(N) > 0.25)
    lower, upper = FRAMES[frame]
    for ignore in ((False, True) if kind in ("first", "last") else (False,)):
        args = (kind, lower, upper, ignore, values, valid, order, rm, seg,
                start, end)
        want = W.frame_aggregate_plain(*args)
        got = W.frame_aggregate(*args, kernels=emu)
        _same_bits(got[1], want[1])
        if kind in ("sum", "avg") and values.dtype.is_floating_point:
            scale = float(values.abs().sum())
            assert torch.all((got[0] - want[0]).abs()
                             <= 1e-9 * torch.clamp(want[0].abs(),
                                                   min=scale))
        else:
            _same_bits(got[0], want[0])
