"""K1 (``csrc/sort.cu``) and K5 (``csrc/join_probe.cu``) built for the CPU
with the host C++ compiler against ``csrc/emulator/cuda_runtime.h``
(``test_torch_kernels_emulated._build_emulated``) and held bit for bit
against their plain PyTorch versions on the same inputs.

K1's two paths: the one-block sort (up to ``SMALL_SORT_ROWS`` rows, one
launch, no read back) and the large path (one read back of the live-bit
masks, the live bits packed into words, one onesweep launch a packed
byte, tile offsets by decoupled look-back) at 4 tiles of 2,048 rows and
more, with ``n`` a multiple of the tile and not; one packed word and
several (a string key with more than 8 live bytes, int64 and float64
keys with all 64 bits live, NaN and -0.0); no live byte (the identity); 0 and
1 rows; descending and nulls-first mixes; trailing NUL bytes (ROADMAP
C.6).  Launch and read-back counts follow the design.  K5: duplicates on
both sides, null and ineligible rows on both sides, string keys of
different widths, two keys, an empty side, ``with_has_r`` both ways, on
both of K1's paths; every ``Probe`` field equal.

The emulator runs a launch's blocks one after another in index order, so
a look-back always finds its predecessors' words set (its wait aborts
where one is not): it cannot show a race between blocks.  The card's
repeated runs (``chip_smoke.py`` phase 3, 10 runs a shape) check that.
Mutation checks: a onesweep that ignores its predecessors' counts and a
``k5_ids`` that ignores the earlier tiles' key changes, each built from
an edited copy of its source, must disagree with the plain version."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.column import DeviceColumn
from spark_rapids_tpu_torch.ops.kernels import _build as B
from spark_rapids_tpu_torch.ops.kernels import join as J
from spark_rapids_tpu_torch.ops.kernels import segment as S
from test_torch_kernels_emulated import _build_emulated
from test_torch_kernels_emulated_generate import _mutant

TILE = B.TILE
LARGE = [4 * TILE, 4 * TILE + 37, 6 * TILE + 1]


@pytest.fixture(scope="module")
def emu():
    out = _build_emulated()
    return B.Kernels(lambda: out, lambda t: None)


def _col(dtype, data, valid, lengths=None):
    return DeviceColumn(dtype, torch.from_numpy(data),
                        torch.from_numpy(valid),
                        None if lengths is None else torch.from_numpy(lengths))


def _strings(rng, n, w, alphabet, max_len=None, null=0.1):
    """A byte-matrix string column of width ``w``: random lengths up to
    ``max_len`` (default w) over ``alphabet``, zero-padded."""
    max_len = w if max_len is None else max_len
    ln = rng.integers(0, max_len + 1, n).astype(np.int32)
    bm = rng.choice(np.array(alphabet, dtype=np.uint8), (n, w))
    bm[np.arange(w)[None, :] >= ln[:, None]] = 0
    return _col(T.STRING, bm, rng.random(n) > null, ln)


def _floats(rng, n, dtype=np.float64):
    vals = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5,
                     -2.25, 1e300 if dtype == np.float64 else 1e30,
                     5e-324 if dtype == np.float64 else 1e-45], dtype=dtype)
    data = np.where(rng.random(n) < 0.3, rng.choice(vals, n),
                    rng.standard_normal(n).astype(dtype) * 1e6)
    return _col(T.FLOAT64 if dtype == np.float64 else T.FLOAT32,
                data.astype(dtype), rng.random(n) > 0.1)


def _int64(rng, n):
    return _col(T.INT64, rng.integers(-2 ** 63, 2 ** 63 - 1, n,
                                      dtype=np.int64), rng.random(n) > 0.1)


def _live_bits(key_cols, descending, nulls_first, pad_valid):
    """The live bits of the plain passes, as the large path packs them:
    per pass, the bits that differ between rows."""
    cols, desc, nf = S._with_lengths(key_cols, descending, nulls_first)
    passes = S.key_passes(cols, desc, nf)
    if pad_valid is not None:
        passes.insert(0, S._rank_pass(~pad_valid))
    bits = 0
    for p in passes:
        u = p.numpy().view(np.uint64)
        if len(u):
            bits += bin(int(np.bitwise_or.reduce(u)) &
                        ~int(np.bitwise_and.reduce(u))).count("1")
    return bits


def _check_sort(emu, key_cols, descending=None, nulls_first=None,
                pad_valid=None):
    want = S.lexsort_plain(key_cols, descending, nulls_first, pad_valid)
    S.SORT_LAUNCHES.reset()
    readbacks = S.SORT_READBACKS.count
    got = S.lexsort_device(key_cols, descending, nulls_first, pad_valid,
                           kernels=emu)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    n = want.shape[0]
    launches = S.SORT_LAUNCHES.count
    if n == 0:
        assert launches == 0
    elif n <= S.SMALL_SORT_ROWS:
        assert launches == 1 and S.SORT_READBACKS.count == readbacks
    else:
        bits = _live_bits(key_cols, descending, nulls_first, pad_valid)
        words = -(-bits // 64)
        # the masks and their read back; the pack; a gather a further
        # word; one onesweep a byte of the packed bits
        assert S.SORT_READBACKS.count == readbacks + 1
        assert launches == (2 + (words - 1) + -(-bits // 8) if bits else 1)
    return got


@pytest.mark.parametrize("n", [2, 300, 2100, 8192] + LARGE)
def test_k1_one_word_matches_plain(emu, n):
    """Q1's keys: two one-byte flags and the padding: one packed word."""
    rng = np.random.default_rng(n)
    keys = [_strings(rng, n, 1, [65, 78, 82], 1),
            _strings(rng, n, 1, [70, 79], 1)]
    pad = torch.arange(n) < max(1, n - 29)
    _check_sort(emu, keys, pad_valid=pad)


@pytest.mark.parametrize("n", [1000, 8000] + LARGE)
def test_k1_several_words_matches_plain(emu, n):
    """A 20-byte string (more than 8 live bytes) with its lengths and an
    int64 and a float64 key with all 8 bytes live, NaN and -0.0: more
    packed words than the pack kernel fills in one sweep, and a gather
    of each further word."""
    rng = np.random.default_rng(100 + n)
    keys = [_strings(rng, n, 20, list(range(1, 256)), null=0.05),
            _int64(rng, n), _floats(rng, n)]
    assert _live_bits(keys, None, None, None) > 4 * 64
    _check_sort(emu, keys)
    # the string alone ties often on its first bytes: the int64 decides
    keys[0] = _strings(rng, n, 20, [97, 98], 3)
    _check_sort(emu, keys, [True, False, True], [False, True, False])


@pytest.mark.parametrize("n", [700] + LARGE)
@pytest.mark.parametrize("mix", [(False, True), (True, False), (True, True),
                                 (False, False)])
def test_k1_descending_nulls_first_mixes(emu, n, mix):
    rng = np.random.default_rng(7 * n + sum(mix))
    desc, nf = mix
    keys = [_col(T.INT32, rng.integers(-50, 50, n).astype(np.int32),
                 rng.random(n) > 0.2),
            _floats(rng, n, np.float32),
            _strings(rng, n, 3, [120, 121, 0], 3)]
    pad = torch.from_numpy(rng.random(n) > 0.05)
    _check_sort(emu, keys, [desc, not desc, desc], [nf, nf, not nf], pad)


@pytest.mark.parametrize("n", [0, 1, 5000] + LARGE[:1])
def test_k1_no_live_byte_is_the_identity(emu, n):
    keys = [_col(T.INT64, np.full(n, 42, dtype=np.int64),
                 np.ones(n, dtype=bool)),
            _col(T.STRING, np.full((n, 2), 65, dtype=np.uint8),
                 np.ones(n, dtype=bool), np.full(n, 2, dtype=np.int32))]
    got = _check_sort(emu, keys, pad_valid=torch.ones(n, dtype=torch.bool))
    assert torch.equal(got, torch.arange(n, dtype=torch.int32))


@pytest.mark.parametrize("n", [64, LARGE[1]])
def test_k1_trailing_nul_bytes_order_by_length(emu, n):
    """ROADMAP C.6: "a" < "a\\x00" < "a\\x00\\x00" < "b"."""
    rng = np.random.default_rng(n + 3)
    words = [b"a", b"a\x00", b"a\x00\x00", b"b", b"", b"\x00"]
    pick = rng.integers(0, len(words), n)
    bm = np.zeros((n, 4), dtype=np.uint8)
    ln = np.array([len(words[k]) for k in pick], dtype=np.int32)
    for i, k in enumerate(pick):
        bm[i, :len(words[k])] = np.frombuffer(words[k], dtype=np.uint8)
    col = _col(T.STRING, bm, np.ones(n, dtype=bool), ln)
    got = _check_sort(emu, [col])
    ordered = [words[k] for k in pick[got.numpy()]]
    assert ordered == sorted(ordered)


@pytest.mark.parametrize("n", [500, LARGE[0]])
def test_k1_encode_matches_plain(emu, n):
    """``key_passes_device`` (the range exchange's encoding): every pass
    in one launch, equal to ``key_passes``."""
    rng = np.random.default_rng(n + 11)
    keys = [_int64(rng, n), _floats(rng, n),
            _strings(rng, n, 10, [0, 65, 255]),
            _col(T.BOOL, rng.random(n) > 0.5, rng.random(n) > 0.3)]
    desc, nf = [True, False, True, False], [False, True, True, False]
    want = torch.stack(S.key_passes(keys, desc, nf))
    S.SORT_LAUNCHES.reset()
    got = S.key_passes_device(keys, desc, nf, kernels=emu)
    assert S.SORT_LAUNCHES.count == 1
    assert torch.equal(got, want)


def test_k1_mutant_without_look_back_differs(emu):
    """A onesweep that takes no count of the tiles before it places every
    tile's rows from the digit's first slot.  The key has 8 live bits, so
    the mutant's one step is the last (a later step would read the slots
    it left unwritten)."""
    mutant = _mutant("sort", (
        "srt::lookback_prefix(status + tid, 256, tile, epoch, c);",
        "(srt::lookback_prefix(status + tid, 256, tile, epoch, c), 0ull);"))
    rng = np.random.default_rng(5)
    n = LARGE[1]
    keys = [_col(T.INT32, rng.integers(0, 256, n).astype(np.int32),
                 np.ones(n, dtype=bool))]
    assert _live_bits(keys, None, None, None) == 8
    want = S.lexsort_plain(keys)
    assert torch.equal(S.lexsort_device(keys, kernels=emu), want)
    assert not torch.equal(S.lexsort_device(keys, kernels=mutant), want)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------
def _side(rng, n, n_real, w, keys=40):
    """An int64 key with duplicates, a string key of width ``w`` (lengths
    up to 3, so sides of different widths share values), with nulls;
    the side's row mask (padding past ``n_real``, and a few more rows
    switched off)."""
    cols = [_col(T.INT64, rng.integers(0, keys, n), rng.random(n) > 0.1),
            _strings(rng, n, w, [97, 98, 0xC3, 0xA9], min(w, 3))]
    rm = (torch.arange(n) < n_real) & torch.from_numpy(rng.random(n) > 0.03)
    return cols, rm


def _cut(cols, rm, n):
    return [DeviceColumn(c.dtype, c.data[:n], c.validity[:n],
                         None if c.lengths is None else c.lengths[:n])
            for c in cols], rm[:n]


def _check_probe(emu, l, r, with_has_r):
    (lc, lrm), (rc, rrm) = l, r
    want = J.probe_plain(lc, rc, lrm, rrm, with_has_r)
    J.JOIN_PROBE_LAUNCHES.reset()
    S.SORT_LAUNCHES.reset()
    readbacks = S.SORT_READBACKS.count
    got = J.probe(lc, rc, lrm, rrm, with_has_r, kernels=emu)
    for f in J.Probe._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            assert g.dtype == w.dtype and torch.equal(g, w), f
    # one sort a probe: one launch on the one-block path, one read back
    # above it
    n = lrm.shape[0] + rrm.shape[0]
    concat = sum(2 if c.dtype.is_string else 1 for c in lc)
    assert J.JOIN_PROBE_LAUNCHES.count == 1 + concat + (n > 0) + 1 + \
        3 * with_has_r
    small = n <= S.SMALL_SORT_ROWS
    assert S.SORT_READBACKS.count == readbacks + (0 if small or not n
                                                  else 1)
    if small and n:
        assert S.SORT_LAUNCHES.count == 1
    return want


@pytest.mark.parametrize("with_has_r", [False, True])
@pytest.mark.parametrize("sizes", [(900, 1200), (3000, 2 * TILE + 100),
                                   (TILE + 5, 3 * TILE), (0, 700),
                                   (700, 0), (0, 0)],
                         ids=["small", "large", "large2", "nl0", "nr0",
                              "empty"])
def test_k5_probe_matches_plain(emu, sizes, with_has_r):
    nl, nr = sizes
    rng = np.random.default_rng(nl * 7 + nr)
    l = _cut(*_side(rng, max(nl, 1), max(nl - 13, 0), 5), nl)
    r = _cut(*_side(rng, max(nr, 1), max(nr - 21, 0), 9), nr)
    want = _check_probe(emu, l, r, with_has_r)
    if nl and nr:
        assert int(want.cnt.max()) > 1          # duplicates on the right
        assert int((want.gl == -1).sum()) > 0   # ineligible left rows
        assert int((want.gr == -2).sum()) > 0   # ineligible right rows


@pytest.mark.parametrize("n", [1500, 2 * TILE + 300])
def test_k5_one_string_key_and_float_key(emu, n):
    """One key each: strings of widths 2 and 6 that tie up to trailing
    NULs (compared by length), and float64 keys with NaN and -0.0 (NaN
    matches NaN, -0.0 matches 0.0)."""
    rng = np.random.default_rng(n + 1)
    for lw, rw in ((2, 6),):
        lcol = _strings(rng, n, lw, [0, 97], 2)
        rcol = _strings(rng, n + 17, rw, [0, 97], 3)
        lrm = torch.arange(n) < n - 3
        rrm = torch.arange(n + 17) < n + 10
        want = _check_probe(emu, ([lcol], lrm), ([rcol], rrm), True)
        assert bool(want.has_r.any())
    vals = np.array([0.0, -0.0, np.nan, 1.0, -1.0])
    lcol = _col(T.FLOAT64, rng.choice(vals, n), rng.random(n) > 0.1)
    rcol = _col(T.FLOAT64, rng.choice(vals, n), rng.random(n) > 0.1)
    ones = torch.ones(n, dtype=torch.bool)
    _check_probe(emu, ([lcol], ones), ([rcol], ones), True)


def test_k5_group_ids_match_plain(emu):
    rng = np.random.default_rng(9)
    (lc, lrm), (rc, rrm) = _side(rng, 3000, 2900, 4), \
        _side(rng, 7000, 6900, 4)
    want = J.group_ids_plain(lc, rc, lrm, rrm)
    got = J.group_ids(lc, rc, lrm, rrm, kernels=emu)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_k5_mutant_without_look_back_differs(emu):
    """A k5_ids whose tiles count no key change before them numbers
    every tile's groups from 0."""
    mutant = _mutant("join_probe", (
        "const long long changes = (long long)s_before[0] +",
        "const long long changes = 0 * (long long)s_before[0] +"))
    mutant.libs["sort"] = emu.library("sort")  # K1 as built
    rng = np.random.default_rng(4)
    l, r = _side(rng, 3000, 3000, 4), _side(rng, 3 * TILE, 3 * TILE, 4)
    want = J.probe_plain(l[0], r[0], l[1], r[1])
    got = J.probe(l[0], r[0], l[1], r[1], kernels=emu)
    assert torch.equal(got.gl, want.gl)
    bad = J.probe(l[0], r[0], l[1], r[1], kernels=mutant)
    assert not torch.equal(bad.gl, want.gl)


def test_k5_wide_keys_on_the_large_path(emu):
    """Keys of more than 64 live bits (a 12-byte string drawn from a pool,
    so that both sides repeat values): K1 packs two words and gives no
    sorted key, and k5_ids reads the key columns through the order."""
    rng = np.random.default_rng(12)
    pool = rng.integers(1, 256, (50, 12)).astype(np.uint8)

    def side(n):
        bm = pool[rng.integers(0, len(pool), n)]
        ln = np.full(n, 12, dtype=np.int32)
        return [_col(T.STRING, bm, rng.random(n) > 0.1, ln)], \
            torch.from_numpy(rng.random(n) > 0.05)

    l, r = side(3000), side(2 * TILE + 900)
    combined = [J._concat_key_cols(l[0][0], r[0][0])]
    ok = torch.cat([l[1], r[1]]) & combined[0].validity
    combined[0] = DeviceColumn(T.STRING, combined[0].data, ok,
                               combined[0].lengths)
    _perm, key = S.lexsort_with_key(combined, ok, emu)
    assert key is None
    want = _check_probe(emu, l, r, True)
    assert int(want.cnt.max()) > 1 and bool(want.has_r.any())


def test_k1_sorted_key_of_one_word(emu):
    """The large path's sorted packed key: nondecreasing, and equal
    exactly where the rows are equal on every plain pass."""
    rng = np.random.default_rng(13)
    n = 5 * TILE + 11
    keys = [_col(T.INT64, rng.integers(0, 300, n), rng.random(n) > 0.1),
            _strings(rng, n, 2, [97, 98], 2)]
    pad = torch.from_numpy(rng.random(n) > 0.1)
    perm, key = S.lexsort_with_key(keys, pad, emu)
    assert torch.equal(perm, S.lexsort_plain(keys, pad_valid=pad))
    u = key.numpy().view(np.uint64)
    assert (u[1:] >= u[:-1]).all()
    cols, desc, nf = S._with_lengths(keys, None, None)
    passes = torch.stack([S._rank_pass(~pad)] +
                         S.key_passes(cols, desc, nf))[:, perm.long()]
    same = (passes[:, 1:] == passes[:, :-1]).all(0).numpy()
    assert np.array_equal(same, u[1:] == u[:-1])


def test_k1_many_passes_and_scattered_live_bits(emu):
    """More passes than a block stages (a 560-byte string: 70 chunk
    passes, each with one live bit) and an int64 key whose live bits are
    every other bit (a run of one bit each): the runs of the packed key
    cross words."""
    rng = np.random.default_rng(14)
    n = 4 * TILE + 99
    bm = np.zeros((n, 560), dtype=np.uint8)
    bm[:, ::8] = rng.integers(0, 2, (n, 70)).astype(np.uint8) << 4
    wide = _col(T.STRING, bm, rng.random(n) > 0.05,
                np.full(n, 560, dtype=np.int32))
    odd = _col(T.INT64, rng.integers(0, 2 ** 40, n) & 0x5555555555,
               np.ones(n, dtype=bool))
    assert _live_bits([wide, odd], None, None, None) > 64
    _check_sort(emu, [wide, odd])
    _check_sort(emu, [odd, wide], [True, False], [False, True])
