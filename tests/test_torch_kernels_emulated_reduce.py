"""K3 (the segmented reduction of every buffer of an aggregate node in one
data pass) built for the CPU with the host C++ compiler against
``csrc/emulator/cuda_runtime.h`` (``test_torch_kernels_emulated.
_build_emulated``) and held against its plain PyTorch version on the same
inputs: counts, integer results, min/max and picks exactly, float sums
within rel 1e-9 (K3's tolerance: the tree of a tile and the carries
between tiles add in another order than ``index_add_``) and with the same
bits in two runs.

One call takes buffers of mixed value types (bool, int8, int16, int32,
int64, float32, float64, the row index) and ops (sum, min, max, count,
counts as ``count > 0``, none) against one set of ids over 10,573 rows:
five 2,048-row tiles and a ragged sixth.  The ids hold runs inside one
tile, runs that cross 1, 2 and 4 tile borders, one run of all rows, a
run a row, ids that end before ``n_segments``, gaps between ids, ids past
``n_segments`` (dropped) and no rows at all; a call of more buffers than
one launch's table splits.  Each call's launches are counted: two a
``S.REDUCE_TABLE_BUFFERS`` buffers (one with no rows).

Mutations it catches (each built from an edited copy of
``segment_reduce.cu``): a finish that writes a run crossing tiles without
its carry, and one that leaves the slots past the last id unwritten.  The
emulator runs a launch's blocks one after another in index order, so it
cannot show a race between blocks: the card's repeated runs in
chip_smoke.py and ``tools/k3_k4_split.py`` are that check.  Run:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_kernels_emulated_reduce.py -q``."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.ops.kernels import _build as B
from spark_rapids_tpu_torch.ops.kernels import segment as S

from test_torch_kernels_emulated import _build_emulated
from test_torch_kernels_emulated_generate import _mutant

N = 5 * B.TILE + 333


@pytest.fixture(scope="module")
def emu():
    out = _build_emulated()
    return B.Kernels(lambda: out, lambda t: None)


def _ids(kind, n=N):
    """Nondecreasing segment ids of ``n`` rows, by kind."""
    if kind == "mixed":
        # runs of 1 to 9 rows, then runs over 1, 2 and 4 tile borders,
        # then short runs again, and a gap of 5 ids
        lens = [1, 2, 3, 9, 1, 1, 7] * 40 + [2 * B.TILE + 11, 900,
                                             B.TILE + 5, 4 * B.TILE]
        ids = np.repeat(np.arange(len(lens)), lens)[:n]
        ids = np.concatenate([ids, np.arange(n - len(ids)) + ids[-1] + 6])
        return ids
    if kind == "one_run":
        return np.zeros(n, dtype=np.int64)
    if kind == "run_per_row":
        return np.arange(n)
    if kind == "ids_end_early":
        return np.sort(np.random.default_rng(1).integers(0, 40, n))
    if kind == "no_key":  # the aggregate without keys: rows, then padding
        return (np.arange(n) >= n - 77).astype(np.int64)
    if kind == "gaps_and_outside":  # gaps, and ids past n_segments
        return np.sort(np.random.default_rng(2).integers(-3, n + 40, n) // 3)
    raise ValueError(kind)


def _buffers(rng, n):
    """(values, valid, op[, counts]) of every value type and op."""
    def valid():
        return torch.from_numpy(rng.random(n) > 0.2)
    f64 = torch.from_numpy(rng.choice([0.5, -1.25, np.nan, 3.0, 1e9, -0.0],
                                      n) * rng.random(n))
    f32 = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    i8 = torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8))
    i16 = torch.from_numpy(rng.integers(-999, 999, n).astype(np.int16))
    i32 = torch.from_numpy(rng.integers(-9, 9, n).astype(np.int32))
    i64 = torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, n))
    b = torch.from_numpy(rng.random(n) > 0.5)
    return [(f64, valid(), "sum"), (f64, valid(), "min", "has"),
            (f64, valid(), "max"), (f32, valid(), "sum", False),
            (f32, None, "min"), (i8, valid(), "max"), (i16, valid(), "min"),
            (i32, valid(), "sum", "has"), (i32, valid(), "max"),
            (i64, valid(), "sum"), (b, valid(), "sum"),
            (f64, valid(), "count"), (None, None, "min", False),
            (None, valid(), "max", "has"), (None, valid(), "sum")]


def _same(got, want):
    assert len(got) == len(want)
    for (ga, gc), (wa, wc) in zip(got, want):
        for g, w in ((ga, wa), (gc, wc)):
            assert (g is None) == (w is None)
            if w is None:
                continue
            assert g.dtype == w.dtype and g.shape == w.shape
            if w.dtype.is_floating_point:
                assert torch.allclose(g, w, rtol=1e-9, atol=0,
                                      equal_nan=True)
            else:
                assert torch.equal(g, w)


def _bits(res):
    return [t.reshape(-1).view(torch.uint8) for pair in res for t in pair
            if t is not None]


@pytest.mark.parametrize("kind", ["mixed", "one_run", "run_per_row",
                                  "ids_end_early", "no_key",
                                  "gaps_and_outside"])
def test_k3_every_buffer_in_one_call(emu, kind):
    rng = np.random.default_rng(len(kind))
    ids = torch.from_numpy(_ids(kind).astype(np.int32))
    n_segments = N
    specs = _buffers(rng, N)
    want = S.segment_aggregate_many(specs, ids, n_segments)
    S.SEGMENT_REDUCE_LAUNCHES.reset()
    got = S.segment_aggregate_many(specs, ids, n_segments, kernels=emu)
    assert S.SEGMENT_REDUCE_LAUNCHES.count == 2
    _same(got, want)
    again = S.segment_aggregate_many(specs, ids, n_segments, kernels=emu)
    assert all(torch.equal(a, b) for a, b in zip(_bits(got), _bits(again)))


@pytest.mark.parametrize("n_segments", [1, 50, N + 7])
def test_k3_segment_counts_below_and_above_the_rows(emu, n_segments):
    rng = np.random.default_rng(n_segments)
    ids = torch.from_numpy(_ids("mixed").astype(np.int32))
    specs = _buffers(rng, N)[:6]
    _same(S.segment_aggregate_many(specs, ids, n_segments, kernels=emu),
          S.segment_aggregate_many(specs, ids, n_segments))


def test_k3_no_rows(emu):
    ids = torch.zeros(0, dtype=torch.int32)
    specs = [(torch.zeros(0, dtype=torch.float64),
              torch.zeros(0, dtype=torch.bool), "min"),
             (None, None, "count")]
    S.SEGMENT_REDUCE_LAUNCHES.reset()
    got = S.segment_aggregate_many(specs, ids, 5, kernels=emu)
    assert S.SEGMENT_REDUCE_LAUNCHES.count == 1  # the slots alone
    _same(got, S.segment_aggregate_many(specs, ids, 5))


def test_k3_more_buffers_than_a_table(emu):
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(_ids("mixed").astype(np.int32))
    specs = _buffers(rng, N) * 3
    assert len(specs) > S.REDUCE_TABLE_BUFFERS
    S.SEGMENT_REDUCE_LAUNCHES.reset()
    got = S.segment_aggregate_many(specs, ids, N, kernels=emu)
    assert S.SEGMENT_REDUCE_LAUNCHES.count == \
        2 * -(-len(specs) // S.REDUCE_TABLE_BUFFERS)
    _same(got, S.segment_aggregate_many(specs, ids, N))


def test_k3_reduce_many_with_picks_and_starts(emu):
    """The aggregate's call: the reference's ops, first/last picks (one K4
    gather each) and the segment starts, against the plain version."""
    rng = np.random.default_rng(11)
    ids = torch.from_numpy(_ids("mixed").astype(np.int32))
    present = torch.arange(N) < N - 50
    vals = torch.from_numpy(rng.integers(-50, 50, N).astype(np.int32))
    valid = torch.from_numpy(rng.random(N) > 0.3) & present
    specs = [(vals, valid, op) for op in ("sum", "min", "max", "count",
                                          "first", "last", "first_any",
                                          "last_any")]
    want, want_starts = S.segment_reduce_many(specs, ids, N, present,
                                              starts=True)
    S.SEGMENT_REDUCE_LAUNCHES.reset()
    got, starts = S.segment_reduce_many(specs, ids, N, present, starts=True,
                                        kernels=emu)
    assert S.SEGMENT_REDUCE_LAUNCHES.count == 2
    assert torch.equal(starts, want_starts)
    for (gd, gv), (wd, wv) in zip(got, want):
        assert torch.equal(gd, wd) and torch.equal(gv, wv)


def test_k3_mutant_without_carry_differs(emu):
    mutant = _mutant("segment_reduce", (
        "const Agg<A> v = combine<A, OP>(carry, h);", "const Agg<A> v = h;"))
    rng = np.random.default_rng(12)
    ids = torch.from_numpy(_ids("mixed").astype(np.int32))
    specs = _buffers(rng, N)
    want = S.segment_aggregate_many(specs, ids, N)
    _same(S.segment_aggregate_many(specs, ids, N, kernels=emu), want)
    with pytest.raises(AssertionError):
        _same(S.segment_aggregate_many(specs, ids, N, kernels=mutant), want)


def test_k3_mutant_without_tail_slots_differs(emu):
    mutant = _mutant("segment_reduce", (
        "       s < n_segments; s += stride)",
        "       s < 0 * n_segments; s += stride)"))
    ids = torch.from_numpy(_ids("ids_end_early").astype(np.int32))
    specs = [(None, None, "min", False), (None, None, "max", False)]
    want = S.segment_aggregate_many(specs, ids, N)
    good = S.segment_aggregate_many(specs, ids, N, kernels=emu)
    _same(good, want)
    # the results' block is (2, N) int64: leave other values where the
    # mutant's is likely to land
    junk = torch.full((2, N), 7, dtype=torch.int64)
    del junk
    got = S.segment_aggregate_many(specs, ids, N, kernels=mutant)
    assert not all(torch.equal(g[0], w[0]) for g, w in zip(got, want))
