"""K2 (``ops/kernels/segment.py:segment_ids_device``, ``csrc/
segment_ids.cu``) built for the CPU with the host C++ compiler against
``csrc/emulator/cuda_runtime.h``
(``test_torch_kernels_emulated._build_emulated``) and held against its
plain PyTorch version (``segment_ids_plain``) on the same inputs, bit for
bit.

Keys are runs of sorted group numbers mapped through a table a key, so
that equal rows sit next to each other and runs cross K2's tiles (the
look-back carries them; 1,024 rows below a million, 2,048 and 8,192 in
the two large calls past the thresholds of ``rounds_for``): 1 to 8 keys of every dtype (bool,
int8, int16, int32, int64, float32, float64, date, strings of widths 1,
3, 16 and 63), NaN next to NaN and -0.0 next to 0.0 (no boundary), nulls
next to rows whose data differ (no boundary) and to valid rows (a
boundary), strings that differ only in a trailing NUL or only in their
length, padding rows (each its own segment), one row, a partial last
tile, no rows (no launch), 33 keys (two launches: the ids of the first
32 are a key of the second), and arrays whose bases are cut at an
element offset (no vector loads).  One launch a call otherwise; the
look-back's status words are reused with a new epoch by every call.

A mutation it catches (from an edited copy of ``segment_ids.cu``): a
tile that leaves out its look-back prefix, so the ids restart at every
tile.  Run: ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_kernels_emulated_ids.py -q``."""
import array

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.column import DeviceColumn
from spark_rapids_tpu_torch.ops.kernels import _build as B
from spark_rapids_tpu_torch.ops.kernels import segment as S

from test_torch_kernels_emulated import _build_emulated
from test_torch_kernels_emulated_generate import _mutant

N = 3 * S.SEGMENT_ID_TILE + 517


@pytest.fixture(scope="module")
def emu():
    out = _build_emulated()
    return B.Kernels(lambda: out, lambda t: None)


def _strings(values, w):
    bm = np.zeros((len(values), w), dtype=np.uint8)
    ln = np.zeros(len(values), dtype=np.int32)
    for i, v in enumerate(values):
        bm[i, :len(v)] = np.frombuffer(v, dtype=np.uint8)
        ln[i] = len(v)
    return torch.from_numpy(bm), torch.from_numpy(ln)


# per kind: a value table (consecutive entries that are equal under K2's
# rules sit side by side) and the column's dtype
_TABLES = {
    "bool": (T.BOOL, np.array([False, True, True, False])),
    "int8": (T.INT8, np.array([-128, 0, 0, 127, 5], dtype=np.int8)),
    "int16": (T.INT16, np.array([-3, 300, 300, -3], dtype=np.int16)),
    "int32": (T.INT32, np.array([7, -2 ** 31, 2 ** 31 - 1, 7],
                                dtype=np.int32)),
    "int64": (T.INT64, np.array([2 ** 62, -1, 0, 0, 2 ** 62],
                                dtype=np.int64)),
    "date": (T.DATE32, np.array([-9000, 19000, 19000, 3], dtype=np.int32)),
    "float32": (T.FLOAT32, np.array([np.nan, np.nan, -0.0, 0.0, 1.5, -1.5],
                                    dtype=np.float32)),
    "float64": (T.FLOAT64, np.array([0.0, -0.0, np.nan, np.nan, np.inf,
                                     -np.inf, 2.5])),
    # "ab" / "ab\0" differ only in a trailing NUL, "x" / "" and "abc" /
    # "abd" elsewhere
    "str1": (T.STRING, [b"a", b"a", b"", b"b", b"\x00", b""]),
    "str3": (T.STRING, [b"ab", b"ab\x00", b"ab", b"x", b"", b"abc",
                        b"abd"]),
    "str16": (T.STRING, [b"0123456789abcdef", b"0123456789abcdeg",
                         b"0123456789abcdef", b"", b"\x00" * 16]),
    "str63": (T.STRING, [b"q" * 63, b"q" * 62, b"q" * 62 + b"\x00",
                         b"q" * 63, b"r"]),
}
_WIDTHS = {"str1": 1, "str3": 3, "str16": 16, "str63": 63}


def _key(kind, groups, rng, null_share=0.1):
    """A key column whose row i holds entry ``groups[i] % len(table)`` of
    the kind's table; some rows null (their data left as the table's, so
    two null rows with different data sit side by side)."""
    dtype, table = _TABLES[kind]
    pick = groups % len(table)
    valid = torch.from_numpy(rng.random(len(groups)) > null_share)
    if dtype.is_string:
        data, lengths = _strings([table[k] for k in pick], _WIDTHS[kind])
        return DeviceColumn(dtype, data, valid, lengths)
    return DeviceColumn(dtype, torch.from_numpy(table[pick]), valid)


def _groups(rng, n, runs):
    """Sorted group numbers with about ``runs`` runs over ``n`` rows."""
    return np.sort(rng.integers(0, runs, n))


def _check(emu, keys, pad, launches=1):
    want = S.segment_ids_plain(keys, pad)
    S.SEGMENT_IDS_LAUNCHES.reset()
    got = S.segment_ids_device(keys, pad, kernels=emu)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert S.SEGMENT_IDS_LAUNCHES.count == launches
    return got


KINDS = list(_TABLES)


@pytest.mark.parametrize("n_keys", [1, 2, 3, 5, 8])
def test_k2_keys_of_every_dtype_match_plain(emu, n_keys):
    rng = np.random.default_rng(n_keys)
    for start in range(0, len(KINDS), n_keys):
        kinds = (KINDS * 2)[start:start + n_keys]
        groups = _groups(rng, N, 40)
        keys = [_key(k, groups + j, rng) for j, k in enumerate(kinds)]
        pad = torch.arange(N) < N - 77
        _check(emu, keys, pad)


def test_k2_runs_cross_tiles(emu):
    """Few long runs: most tiles start inside a run, so each id comes
    from the look-back's prefix."""
    rng = np.random.default_rng(3)
    groups = _groups(rng, N, 3)
    keys = [_key("int64", groups, rng, 0.0), _key("str3", groups, rng, 0.0)]
    got = _check(emu, keys, None)
    assert int(got[-1]) < 10


@pytest.mark.parametrize("kind", ["float32", "float64"])
def test_k2_nan_and_signed_zero_are_one_group(emu, kind):
    dtype, _ = _TABLES[kind]
    np_t = np.float32 if kind == "float32" else np.float64
    vals = np.array([np.nan, np.nan, -0.0, 0.0, -0.0, 1.0], dtype=np_t)
    col = DeviceColumn(dtype, torch.from_numpy(vals), torch.ones(6,
                                                                 dtype=bool))
    got = _check(emu, [col], None)
    assert got.tolist() == [0, 0, 1, 1, 1, 2]


def test_k2_nulls_and_strings(emu):
    """Two null rows with different data are one group; a null next to a
    valid row is a boundary; "ab" and "ab\\0" differ (lengths)."""
    data, lengths = _strings([b"ab", b"ab\x00", b"zz", b"yy", b"yy", b"ab"],
                             3)
    valid = torch.tensor([True, True, False, False, True, True])
    got = _check(emu, [DeviceColumn(T.STRING, data, valid, lengths)], None)
    assert got.tolist() == [0, 1, 2, 2, 3, 4]


def test_k2_padding_rows_are_their_own_segments(emu):
    rng = np.random.default_rng(4)
    groups = _groups(rng, 300, 2)
    keys = [_key("int32", groups, rng, 0.0)]
    pad = torch.arange(300) < 250
    got = _check(emu, keys, pad)
    assert torch.equal(got[250:] - got[249],
                       torch.arange(1, 51, dtype=torch.int32))


@pytest.mark.parametrize("n", [0, 1, S.SEGMENT_ID_TILE,
                               S.SEGMENT_ID_TILE + 1])
def test_k2_small_and_partial_tiles(emu, n):
    rng = np.random.default_rng(5)
    groups = _groups(rng, n, 5)
    keys = [_key("str16", groups, rng), _key("float64", groups, rng)]
    pad = torch.arange(n) < max(n - 3, 0)
    got = _check(emu, keys, pad, launches=1 if n else 0)
    assert got.shape == (n,)


def test_k2_no_keys_only_padding(emu):
    pad = torch.arange(N) < 1000
    got = _check(emu, [], pad)
    assert int(got[999]) == 0 and int(got[-1]) == N - 1000


def test_k2_more_keys_than_a_launch(emu):
    """33 keys: the first 32 in one launch, their ids the first key of a
    second."""
    rng = np.random.default_rng(6)
    groups = _groups(rng, 3000, 60)
    keys = [_key(KINDS[j % len(KINDS)], groups // (1 + j % 3) + j, rng)
            for j in range(S.SEGMENT_ID_KEYS + 1)]
    _check(emu, keys, torch.arange(3000) < 2990, launches=2)


def test_k2_epochs_reuse_the_status_words(emu):
    """Calls in a row reuse one status buffer, a new epoch each; once the
    epochs run out the buffer is zeroed and the ids stay right."""
    rng = np.random.default_rng(7)
    groups = _groups(rng, N, 30)
    keys = [_key("int32", groups, rng)]
    tiles = -(-N // S.SEGMENT_ID_TILE)
    buf, epoch = S.LOOKBACK.take(tiles, torch.device("cpu"), None)
    _check(emu, keys, None)
    buf2, epoch2 = S.LOOKBACK.take(tiles, torch.device("cpu"), None)
    assert buf2.data_ptr() == buf.data_ptr() and epoch2 > epoch
    S.LOOKBACK._by_stream[("cpu", None, "k2")] = (buf2, S.LOOKBACK_EPOCHS)
    _check(emu, keys, None)
    _buf, epoch3 = S.LOOKBACK.take(tiles, torch.device("cpu"), None)
    assert epoch3 == 2
    _check(emu, keys, None)


@pytest.mark.parametrize("offset", [1, 3])
def test_k2_unaligned_bases(emu, offset):
    """Arrays cut from larger buffers at an element offset: a lane's four
    rows cannot go as one vector load and take the element loads."""
    rng = np.random.default_rng(9 + offset)
    n = S.SEGMENT_ID_TILE + 300
    groups = _groups(rng, n, 30)

    def cut(t):
        whole = torch.cat([t[:offset], t])
        return whole[offset:]

    keys = []
    for kind in ("int32", "str1", "float64", "bool"):
        c = _key(kind, groups, rng)
        keys.append(DeviceColumn(
            c.dtype, cut(c.data), cut(c.validity),
            None if c.lengths is None else cut(c.lengths)))
    assert keys[0].data.data_ptr() % 16 != 0
    _check(emu, keys, cut(torch.arange(n) < n - 5))


# csrc/segment_ids.cu rounds_for: tiles of 2 rounds (2,048 rows) from
# 2 x 1,024 x 264 rows, of 8 rounds (8,192 rows) from 8 x 1,024 x 264
# (two blocks on each of 132 SMs)
ROUNDS_FROM = {2: 2 * 1024 * 264, 8: 8 * 1024 * 264}


@pytest.mark.parametrize("rounds", [2, 8])
def test_k2_large_calls_take_wider_tiles(emu, rounds):
    """Calls just past each threshold, a partial last tile, runs of ~300
    rows crossing the wider tiles, nulls and padding."""
    n = ROUNDS_FROM[rounds] + 517
    rng = np.random.default_rng(20 + rounds)
    groups = _groups(rng, n, n // 300)
    keys = [_key("int32", groups, rng), _key("float64", groups // 7, rng)]
    if rounds == 2:
        keys.append(_key("str1", groups // 3, rng))
    _check(emu, keys, torch.arange(n) < n - 1000)


def test_k2_too_few_status_words_is_an_error(emu):
    """A status buffer shorter than the call's tiles is refused with
    cudaErrorInvalidValue (a look-back over it would wait on a word no
    tile writes); one word a tile suffices."""
    lib = emu.library("segment_ids")
    n = 3 * S.SEGMENT_ID_TILE  # three 1,024-row tiles
    data = torch.arange(n, dtype=torch.int32) // 100
    table = array.array("q", [data.data_ptr(), 0, 0, 0,
                              B.DTYPE_CODES[torch.int32]])
    ids = torch.full((n,), -7, dtype=torch.int32)
    status = torch.zeros(4, dtype=torch.int64)  # 3 words and the counter
    args = (table.buffer_info()[0], 1, None, n, status.data_ptr())
    rest = (status[3:].data_ptr(), 1, ids.data_ptr(), None)
    assert lib.k2_segment_ids(*args, 2, *rest) != 0
    assert bool((ids == -7).all())
    assert lib.k2_segment_ids(*args, 3, *rest) == 0
    assert torch.equal(ids, S.segment_ids_plain(
        [DeviceColumn(T.INT32, data, torch.ones(n, dtype=torch.bool))],
        None))


def test_k2_mutant_without_lookback_prefix_differs(emu):
    mutant = _mutant("segment_ids", (
        "long long run = (long long)prior + warp_before;",
        "long long run = (long long)warp_before;"))
    rng = np.random.default_rng(8)
    groups = _groups(rng, N, 50)
    keys = [_key("int64", groups, rng)]
    want = S.segment_ids_plain(keys, None)
    assert torch.equal(S.segment_ids_device(keys, None, kernels=emu), want)
    assert not torch.equal(S.segment_ids_device(keys, None, kernels=mutant),
                           want)
