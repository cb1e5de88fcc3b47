"""The CUDA kernels K1–K4 of spark_rapids_tpu_torch, built for the CPU
and held against their plain PyTorch versions on the same inputs (2,100
rows: two 2,048-row tiles, so the cross-tile scans and carries run).
Exact, except float sums (rel 1e-12).

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
from spark_rapids_tpu_torch.ops.kernels import gather as G
from spark_rapids_tpu_torch.ops.kernels import segment as S

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


@pytest.fixture(scope="module")
def emu():
    """The emulated libraries as the wrappers' ``kernels=`` (no stream)."""
    out = _build_emulated()
    return B.Kernels(lambda: out, lambda t: None)


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
    got = S.lexsort_device(keys, order, nfs, _pad(), kernels=emu)
    _same(got, want)
    # one CUDA kernel per encoded column and for the padding, one
    # histogram, and per pass with a live digit one key gather plus 3
    # launches per live digit
    passes = [S._rank_pass(~_pad())] + S.key_passes(keys, order, nfs)
    digits = [[len(torch.unique((p >> (8 * d)) & 0xFF)) > 1
               for d in range(8)] for p in passes]
    assert S.SORT_LAUNCHES.count == 3 + 1 + sum(
        any(ds) + 3 * sum(ds) for ds in digits)
    sorted_keys = [G.gather_column_plain(k, want) for k in keys]
    pad_sorted = _pad()[want.long()]
    want_ids = S.segment_ids_plain(sorted_keys, pad_sorted)
    S.SEGMENT_IDS_LAUNCHES.reset()
    got_ids = S.segment_ids_device(sorted_keys, pad_sorted, kernels=emu)
    _same(got_ids, want_ids)
    # change flags: padding + one per key; scan: 3
    assert S.SEGMENT_IDS_LAUNCHES.count == 1 + 2 + 3


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
    assert S.SEGMENT_REDUCE_LAUNCHES.count == 4  # fill, 2 passes, scan


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
    # plan: 4; per column a validity scatter and one per data array
    assert G.COMPACT_LAUNCHES.count == 4 + 2 + 3
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
    assert G.GATHER_LAUNCHES.count == 3  # validity, bytes, lengths
    _same(got_g.data, want_g.data)
    _same(got_g.validity, want_g.validity)
    _same(got_g.lengths, want_g.lengths)
