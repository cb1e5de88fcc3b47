"""Sort-based group-by kernels: K1 sort permutation, K2 segment ids, K3
segmented reduction.

Counterpart of the device half of ``spark_rapids_tpu/ops/kernels/
segment.py``: sort rows by key, derive segment ids at key changes, reduce
per segment with a static segment count (the row bucket).  Each kernel
sits beside its plain PyTorch version.  A wrapper launches the kernel for
CUDA tensors and takes the plain version only for CPU tensors, unless its
``kernels=`` argument names the libraries to launch; the CUDA sources are
``csrc/sort.cu``, ``csrc/segment_ids.cu`` and ``csrc/segment_reduce.cu``.  The reference's numpy host engine is not
ported (the host engine comes with a later slice).

Key passes are int64 in "signed order": the reference's order-preserving
uint64 key with its top bit flipped, so that torch's signed compare and
sort order them as the reference orders the uint64 keys.  The sort
(``lexsort_plain`` / ``lexsort_device``) follows each string key's byte
passes with a pass over its lengths, so strings whose zero-padded bytes
tie (``"a"``, ``"a\x00"``) order shorter first, as Spark's binary order
does; the reference's encoding has no length pass and keeps such rows in
input order, which splits groups and misses join matches (ROADMAP C.6).
``key_passes`` and ``key_passes_device`` stay the reference's encoding
(range-exchange bounds, which place tied strings in one partition).
"""
from __future__ import annotations

import array
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from ... import types as T
from ...data.column import DeviceColumn
from . import _build as B
from . import gather as G

INT64_MIN = -(2 ** 63)
#: rows that K1 sorts in one block with no read back (csrc/sort.cu
#: SMALL_ROWS)
SMALL_SORT_ROWS = 8192
#: signed-order value of the reference's NaN key 0xFFFFFFFFFFFFFFFE
NAN_KEY = 2 ** 63 - 2

#: CUDA kernels launched by K1 (encode + radix sort), K2 and K3
SORT_LAUNCHES = B.LaunchCounter("sort_permutation")
#: host reads of K1's histogram (one a sort above SMALL_SORT_ROWS rows)
SORT_READBACKS = B.LaunchCounter("sort_readbacks")
SEGMENT_IDS_LAUNCHES = B.LaunchCounter("segment_ids")
SEGMENT_REDUCE_LAUNCHES = B.LaunchCounter("segment_reduce")


def _defaults(key_cols, descending, nulls_first):
    if descending is None:
        descending = [False] * len(key_cols)
    if nulls_first is None:
        nulls_first = [True] * len(key_cols)
    return descending, nulls_first


# ===========================================================================
# K1 — key passes + stable multi-pass sort
# ===========================================================================
def _rank_pass(flag: torch.Tensor) -> torch.Tensor:
    """0/1 rank as a signed-order pass."""
    return flag.to(torch.int64) + INT64_MIN


def _value_pass_plain(col: DeviceColumn) -> torch.Tensor:
    tid = col.dtype.id
    data = col.data
    if tid is T.TypeId.BOOL:
        return data.to(torch.int64) + INT64_MIN
    if tid is T.TypeId.FLOAT64:
        d = torch.where(data == 0.0, torch.zeros_like(data), data)
        bits = d.view(torch.int64)
        s = torch.where(bits < 0, (~bits) ^ INT64_MIN, bits)
        return torch.where(torch.isnan(d), torch.full_like(s, NAN_KEY), s)
    if tid is T.TypeId.FLOAT32:
        d = torch.where(data == 0.0, torch.zeros_like(data), data)
        bits = d.view(torch.int32)
        flipped = torch.where(bits < 0, ~bits, bits ^ (-(2 ** 31)))
        u32 = flipped.to(torch.int64) & 0xFFFFFFFF
        s = u32 + INT64_MIN
        return torch.where(torch.isnan(d), torch.full_like(s, NAN_KEY), s)
    # integral, DATE32, TIMESTAMP: signed order is the value itself
    return data.to(torch.int64)


def _string_passes_plain(col: DeviceColumn) -> List[torch.Tensor]:
    n, w = col.data.shape
    out = []
    for start in range(0, w, 8):
        chunk = col.data[:, start:start + 8].to(torch.int64)
        if chunk.shape[1] < 8:
            chunk = torch.cat([chunk, torch.zeros(
                (n, 8 - chunk.shape[1]), dtype=torch.int64,
                device=chunk.device)], dim=1)
        # the top byte carries the flipped sign bit; the rest stay below
        # 2**56, so no step overflows
        top = (chunk[:, 0] ^ 0x80).to(torch.int8).to(torch.int64)
        s = top * (2 ** 56)
        for b in range(1, 8):
            s = s + chunk[:, b] * (2 ** (8 * (7 - b)))
        out.append(s)
    return out


def key_passes(key_cols: Sequence[DeviceColumn],
               descending: Optional[List[bool]] = None,
               nulls_first: Optional[List[bool]] = None
               ) -> List[torch.Tensor]:
    """Plain version of K1's encoding (reference ``key_passes_device``):
    per column a null-rank pass, then one value pass (or one pass per 8
    string bytes); passes[0] dominates."""
    descending, nulls_first = _defaults(key_cols, descending, nulls_first)
    passes = []
    for col, desc, nf in zip(key_cols, descending, nulls_first):
        valid = col.validity
        passes.append(_rank_pass(valid if nf else ~valid))
        values = _string_passes_plain(col) if col.dtype.is_string \
            else [_value_pass_plain(col)]
        for s in values:
            if desc:
                s = ~s
            passes.append(torch.where(valid, s, torch.full_like(
                s, INT64_MIN)))
    return passes


def sort_permutation(passes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of K1's sort: stable lexicographic argsort over the
    signed-order passes (passes[0] dominates), as one stable sort per
    pass from the last to the first."""
    order = torch.arange(passes[0].shape[0], dtype=torch.int64,
                         device=passes[0].device)
    for k in reversed(list(passes)):
        idx = torch.sort(k[order], stable=True).indices
        order = order[idx]
    return order.to(torch.int32)


def _with_lengths(key_cols, descending, nulls_first):
    """The sort's keys: each string key followed by its lengths, an INT32
    key in the string's direction that is never null: a null (or
    padding) row reads the first valid row's length, as the string's own
    null pass already placed it, so the pass adds no live digit where
    the valid rows' lengths do not vary (Q1's one-byte flags)."""
    descending, nulls_first = _defaults(key_cols, descending, nulls_first)
    cols, desc, nf = [], [], []
    for c, d, f in zip(key_cols, descending, nulls_first):
        cols.append(c)
        desc.append(d)
        nf.append(f)
        if c.dtype.is_string:
            lengths = c.lengths.to(torch.int32)
            first = lengths[torch.argmax(c.validity.to(torch.uint8))] \
                if lengths.numel() else lengths.new_zeros(())
            lengths = torch.where(c.validity, lengths, first)
            cols.append(DeviceColumn(T.INT32, lengths,
                                     torch.ones_like(c.validity)))
            desc.append(d)
            nf.append(f)
    return cols, desc, nf


def lexsort_plain(key_cols: Sequence[DeviceColumn],
                  descending: Optional[List[bool]] = None,
                  nulls_first: Optional[List[bool]] = None,
                  pad_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    passes = key_passes(*_with_lengths(key_cols, descending, nulls_first))
    if pad_valid is not None:
        passes.insert(0, _rank_pass(~pad_valid))
    return sort_permutation(passes)


_SORTABLE_DTYPES = {torch.bool, torch.int8, torch.int16, torch.int32,
                  torch.int64, torch.float32, torch.float64}
_PASS_PAD, _PASS_NULL, _PASS_NUM, _PASS_STR, _PASS_LEN = 0, 1, 2, 3, 4


def _pass_table(key_cols, descending, nulls_first, pad_valid=None,
                lengths=True):
    """K1's pass descriptors (csrc/sort.cu load_pass), 8 int64 words a
    pass in the order of ``key_passes`` (the padding rank first where
    ``pad_valid`` is given; with ``lengths``, each string's bytes followed
    by its lengths, the sort's order of ``_with_lengths``), and the
    contiguous arrays they point at (kept alive by the caller until the
    kernel has run)."""
    words, keep = [], []

    def arr(t):
        t = t.contiguous()
        keep.append(t)
        return B.ptr(t)

    if pad_valid is not None:
        words += [_PASS_PAD, arr(pad_valid), 0, 0, 0, 0, 0, 0]
    for col, desc, nf in zip(key_cols, descending, nulls_first):
        valid = arr(col.validity)
        words += [_PASS_NULL, 0, valid, 0, 0, 0, 0, int(nf)]
        if col.dtype.is_string:
            w = col.data.shape[1]
            data = arr(col.data)
            for c in range(-(-w // 8)):
                words += [_PASS_STR, data, valid, 0, w, c, int(desc), 0]
            if lengths:
                words += [_PASS_LEN, arr(col.lengths.to(torch.int32)), valid,
                          B.DTYPE_CODES[torch.int32], 0, 0, int(desc), 0]
        else:
            if col.data.dtype not in _SORTABLE_DTYPES:
                raise TypeError(f"K1 cannot sort a {col.data.dtype} key")
            words += [_PASS_NUM, arr(col.data), valid,
                      B.DTYPE_CODES[col.data.dtype], 0, 0, int(desc), 0]
    return words, keep


def key_passes_device(key_cols: Sequence[DeviceColumn],
                      descending: Optional[List[bool]] = None,
                      nulls_first: Optional[List[bool]] = None,
                      kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K1's encoding alone (reference ``key_passes_device``), with no
    sort: the signed-order passes stacked as int64[k, n], passes[0]
    dominating."""
    kernels = B.kernels_for(key_cols[0].data, kernels)
    if kernels is None:
        return torch.stack(key_passes(key_cols, descending, nulls_first))
    descending, nulls_first = _defaults(key_cols, descending, nulls_first)
    dev = key_cols[0].data.device
    n = key_cols[0].data.shape[0]
    words, _keep = _pass_table(key_cols, descending, nulls_first,
                               lengths=False)
    table = B.device_table(words, dev)
    k = len(words) // 8
    passes = torch.empty((k, n), dtype=torch.int64, device=dev)
    B.launch(SORT_LAUNCHES, kernels.library("sort"), "k1_encode",
             B.ptr(table), k, n, B.ptr(passes), kernels.stream(passes))
    return passes


def lexsort_device(key_cols: Sequence[DeviceColumn],
                   descending: Optional[List[bool]] = None,
                   nulls_first: Optional[List[bool]] = None,
                   pad_valid: Optional[torch.Tensor] = None,
                   kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K1: stable multi-key argsort; padding rows (``pad_valid`` False)
    sort last.  Returns an int32 permutation, bit-identical to the
    reference's ``lexsort_device`` but where string keys tie in their
    zero-padded bytes (broken by length here).  Up to SMALL_SORT_ROWS
    rows: one launch and no read back; above, one read back."""
    probe = key_cols[0].data if key_cols else pad_valid
    kernels = B.kernels_for(probe, kernels)
    if kernels is None:
        return lexsort_plain(key_cols, descending, nulls_first, pad_valid)
    descending, nulls_first = _defaults(key_cols, descending, nulls_first)
    # _keep holds the arrays the table points at while the launches run
    words, _keep = _pass_table(key_cols, descending, nulls_first, pad_valid)
    return _sort_cuda(kernels.library("sort"), words, probe.shape[0],
                      probe.device, kernels.stream(probe))


def lexsort_with_key(key_cols: Sequence[DeviceColumn],
                     pad_valid: Optional[torch.Tensor],
                     kernels: B.Kernels):
    """K1 (ascending, nulls first) on the kernels, for K5: (permutation,
    sorted packed key or None; see ``_sort_cuda``)."""
    descending, nulls_first = _defaults(key_cols, None, None)
    words, _keep = _pass_table(key_cols, descending, nulls_first, pad_valid)
    probe = key_cols[0].data
    return _sort_cuda(kernels.library("sort"), words, probe.shape[0],
                      probe.device, kernels.stream(probe), want_key=True)


def _sort_cuda(lib, words, n: int, dev, st, want_key: bool = False):
    """LSD radix sort over the passes that ``words`` describes, 8 bits a
    step, skipping what every row shares: bytes on the one-block path,
    bits on the large path.  Returns the permutation; with ``want_key``,
    (permutation, sorted packed key), the key a uint64 a row in sorted
    order as int64 where the large path packed every live bit into one
    word (equal keys: equal on every pass), else None."""
    k = len(words) // 8
    perm = key = None
    if n == 0:
        perm = torch.empty(0, dtype=torch.int32, device=dev)
    elif n <= SMALL_SORT_ROWS:
        table = B.device_table(words, dev)
        perm = torch.empty(n, dtype=torch.int32, device=dev)
        B.launch(SORT_LAUNCHES, lib, "k1_sort_small", B.ptr(table), k, n,
                 B.ptr(perm), st)
    else:
        perm, key = _sort_large(lib, words, n, dev, st, want_key)
    return (perm, key) if want_key else perm


def _live_runs(live):
    """The live bits of every pass as runs of adjacent bits, least
    significant first (the last pass's low bit), for k1_pack: pass << 16
    | start << 8 | bits."""
    runs = []
    for p in reversed(range(len(live))):
        m = live[p]
        while m:
            start = (m & -m).bit_length() - 1
            width = ((m >> start) + 1 & ~(m >> start)).bit_length() - 1
            runs.append(p << 16 | start << 8 | width)
            m &= ~(((1 << width) - 1) << start)
    return runs


def _sort_large(lib, words, n: int, dev, st, want_key: bool):
    k = len(words) // 8
    # one copy: the masks' start values (OR 0, AND ~0), then the passes
    both = B.device_table([0, -1] * k + list(words), dev)
    masks, table = both[:2 * k], both[2 * k:]
    B.launch(SORT_LAUNCHES, lib, "k1_live", B.ptr(table), k, n, B.ptr(masks),
             st)
    # what the steps need, made while the masks are computed: one buffer
    # of int64 words, zeroed once: at most one word a pass and 8 digits a
    # word of uint32 histograms, then one status word a tile and digit
    # (an epoch a step), then one tile counter a step
    status_words = 256 * B.tiles(n)
    hist_words = k * 8 * 256 // 2
    scratch = torch.zeros(hist_words + status_words + 8 * k,
                          dtype=torch.int64, device=dev)
    # two buffers each, so that the permutation returned holds only its own
    keys = [torch.empty(n, dtype=torch.int64, device=dev) for _ in range(2)]
    ids = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
    m = masks.cpu().tolist()
    SORT_READBACKS.add()
    live = [(m[2 * p] & ~m[2 * p + 1]) & (2 ** 64 - 1) for p in range(k)]
    bits = sum(x.bit_count() for x in live)
    if bits == 0:
        return torch.arange(n, dtype=torch.int32, device=dev), None
    nwords = -(-bits // 64)
    runs = _live_runs(live)
    run_table = B.device_table(runs, dev)
    packed = torch.empty((nwords, n), dtype=torch.int64, device=dev)
    # raw addresses: the digit loop below makes no tensor views
    hist = scratch.data_ptr()
    status = hist + 8 * hist_words
    counters = status + 8 * status_words
    key_buf = [t.data_ptr() for t in keys]
    id_buf = [t.data_ptr() for t in ids]
    B.launch(SORT_LAUNCHES, lib, "k1_pack", B.ptr(table), k, n,
             B.ptr(run_table), len(runs), nwords, B.ptr(packed), hist, st)
    # word w's digits: 8, the most significant word's what its bits need
    digits = [8] * (nwords - 1) + [-(-(bits - 64 * (nwords - 1)) // 8)]
    step = 0
    perm = None
    cur = 0
    for w in range(nwords):  # the least significant word first
        if perm is None:
            keys_in = packed.data_ptr() + 8 * n * w
        else:
            B.launch(SORT_LAUNCHES, lib, "k1_gather_keys",
                     packed.data_ptr() + 8 * n * w, perm, n, key_buf[cur],
                     st)
            keys_in = key_buf[cur]
        for b in range(digits[w]):
            # the keys move with the ids up to the word's last digit (and
            # through it where the caller wants the one word's sorted key)
            out_keys = b < digits[w] - 1 or (want_key and nwords == 1)
            B.launch(SORT_LAUNCHES, lib, "k1_onesweep", keys_in, perm, n,
                     8 * b, hist + 4 * 256 * (8 * w + b), status,
                     counters + 8 * step, step + 1,
                     key_buf[1 - cur] if out_keys else None,
                     id_buf[1 - cur], st)
            step += 1
            cur = 1 - cur
            keys_in, perm = key_buf[cur], id_buf[cur]
    return ids[cur], (keys[cur] if want_key and nwords == 1 else None)


# ===========================================================================
# K2 — segment ids of sorted keys
# ===========================================================================
def segment_ids_plain(sorted_keys: Sequence[DeviceColumn],
                      pad_valid: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    probe = sorted_keys[0].data if sorted_keys else pad_valid
    n = probe.shape[0]
    change = torch.zeros(n, dtype=torch.bool, device=probe.device)
    if n:
        change[0] = True
    for col in sorted_keys:
        v = col.validity
        bv = v[1:] & v[:-1]
        vchange = v[1:] != v[:-1]
        d = col.data
        if col.dtype.is_string:
            diff = (d[1:] != d[:-1]).any(dim=1) | \
                (col.lengths[1:] != col.lengths[:-1])
            neq = (diff & bv) | vchange
        elif col.dtype.is_floating:
            d = torch.where(d == 0.0, torch.zeros_like(d), d)
            both_nan = torch.isnan(d[1:]) & torch.isnan(d[:-1])
            neq = ((d[1:] != d[:-1]) & ~both_nan & bv) | vchange
        else:
            neq = ((d[1:] != d[:-1]) & bv) | vchange
        change[1:] |= neq
    if pad_valid is not None:
        change |= ~pad_valid
    return torch.cumsum(change.to(torch.int32), 0, dtype=torch.int32) - 1


#: keys one K2 launch takes (csrc/segment_ids.cu MAX_KEYS); more are
#: chained: the ids of the first ones become one int32 key of the next
#: launch
SEGMENT_ID_KEYS = 32
#: rows of K2's smallest tile (csrc/segment_ids.cu: one round of 1,024
#: rows; larger calls take 2 or 8 rounds a tile): a call's look-back
#: status words, one a tile, are at most n / SEGMENT_ID_TILE rounded up
SEGMENT_ID_TILE = 1024
#: look-back epochs a status buffer serves before it is zeroed again (the
#: 16 epoch bits of csrc/common.cuh's status words, 0 never used)
LOOKBACK_EPOCHS = 0xFFFF


class LookbackScratch:
    """Decoupled look-back state kept between calls (K2's, and K10's build
    with its histograms): a zeroed int64 buffer whose last word is the
    tile counter, reused with a new epoch a call, so no call zeroes
    memory.  One a (device, stream, user): calls on one stream run in
    order, so none sees another's epoch.  ``take(words, device, stream,
    user)`` returns ``(buffer, epoch)``: at least ``words`` words before
    the counter, the buffer grown (zeroed, epochs restart) where it holds
    fewer, and zeroed once the epochs run out."""

    def __init__(self):
        self._by_stream = {}
        self._lock = threading.Lock()

    def take(self, words: int, device, stream, user: str = "k2"):
        with self._lock:
            key = (str(device), stream, user)
            buf, epoch = self._by_stream.get(key, (None, LOOKBACK_EPOCHS))
            if buf is None or buf.shape[0] < words + 1:
                buf = torch.zeros(max(words, 64) + 1, dtype=torch.int64,
                                  device=device)
                epoch = 0
            elif epoch >= LOOKBACK_EPOCHS:
                buf.zero_()
                epoch = 0
            epoch += 1
            self._by_stream[key] = (buf, epoch)
            return buf, epoch


#: THE process-wide instance
LOOKBACK = LookbackScratch()


def _key_words(col: DeviceColumn, keep: list) -> list:
    """K2's five table words of a key column (data, validity or 0, lengths
    or 0, bytes a row of a byte matrix or 0, dtype code); the arrays it
    reads go into ``keep``."""
    data = col.data.contiguous()
    valid = None if col.validity is None else col.validity.contiguous()
    lengths = None
    if col.dtype is not None and col.dtype.is_string:
        lengths = col.lengths.to(torch.int32).contiguous()
    keep += [data, valid, lengths]
    return [data.data_ptr(), B.ptr(valid) or 0, B.ptr(lengths) or 0,
            data.shape[1] if data.dim() == 2 else 0,
            B.DTYPE_CODES[data.dtype]]


def segment_ids_device(sorted_keys: Sequence[DeviceColumn],
                       pad_valid: Optional[torch.Tensor] = None,
                       kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K2: int32 segment ids of rows in sorted key order; every padding
    row (``pad_valid`` False) gets its own segment.  One launch for up to
    ``SEGMENT_ID_KEYS`` keys (none for no rows); past that the ids of
    the first keys are the first key of the next launch."""
    probe = sorted_keys[0].data if sorted_keys else pad_valid
    kernels = B.kernels_for(probe, kernels)
    if kernels is None:
        return segment_ids_plain(sorted_keys, pad_valid)
    n = probe.shape[0]
    dev = probe.device
    if not n:
        return torch.empty(0, dtype=torch.int32, device=dev)
    lib = kernels.library("segment_ids")
    st = kernels.stream(probe)
    pad = None if pad_valid is None else pad_valid.contiguous()
    keys = list(sorted_keys)
    while True:
        now, keys = keys[:SEGMENT_ID_KEYS], keys[SEGMENT_ID_KEYS:]
        keep: list = []
        words = [w for c in now for w in _key_words(c, keep)]
        table = array.array("q", words or [0])
        ids = torch.empty(n, dtype=torch.int32, device=dev)
        scratch, epoch = LOOKBACK.take(-(-n // SEGMENT_ID_TILE), dev, st)
        B.launch(SEGMENT_IDS_LAUNCHES, lib, "k2_segment_ids",
                 table.buffer_info()[0], len(now), B.ptr(pad), n,
                 B.ptr(scratch), scratch.shape[0] - 1, B.ptr(scratch[-1]),
                 epoch, B.ptr(ids), st)
        if not keys:
            return ids
        keys.insert(0, DeviceColumn(T.INT32, ids, None))


# ===========================================================================
# K3 — segmented reduction
# ===========================================================================
_OPS = {"sum": 0, "min": 1, "max": 2, "count": 3}
#: buffers one K3 launch takes (``K3_BUFS`` of csrc/segment_reduce.cu); a
#: wider call is split into as few calls as it needs
REDUCE_TABLE_BUFFERS = 32


def _acc_dtype(values: Optional[torch.Tensor], op: str) -> torch.dtype:
    if values is None:
        return torch.int64
    if op == "sum":
        return torch.float64 if values.dtype.is_floating_point \
            else torch.int64
    if values.dtype == torch.bool:
        raise TypeError("min/max over booleans is not supported")
    return values.dtype


def _identity(dtype: torch.dtype, op: str):
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def segment_aggregate_plain(values, valid, seg_ids, n_segments: int,
                            op: str) -> Tuple[torch.Tensor, torch.Tensor]:
    n = seg_ids.shape[0]
    dev = seg_ids.device
    acc_t = _acc_dtype(values, op)
    vals = torch.arange(n, dtype=torch.int64, device=dev) \
        if values is None else values
    ok = torch.ones(n, dtype=torch.bool, device=dev) if valid is None \
        else valid
    idx = seg_ids.to(torch.int64)
    # ids outside [0, n_segments) are dropped, as jax.ops.segment_* does
    inr = (idx >= 0) & (idx < n_segments)
    if not bool(inr.all()):
        idx, vals, ok = idx[inr], vals[inr], ok[inr]
    counts = torch.zeros(n_segments, dtype=torch.int64, device=dev
                         ).index_add_(0, idx, ok.to(torch.int64))
    ident = _identity(acc_t, op)
    masked = torch.where(ok, vals.to(acc_t),
                         torch.full((), ident, dtype=acc_t, device=dev))
    if op == "sum":
        acc = torch.zeros(n_segments, dtype=acc_t, device=dev
                          ).index_add_(0, idx, masked)
    else:
        acc = torch.full((n_segments,), ident, dtype=acc_t, device=dev
                         ).scatter_reduce_(0, idx, masked,
                                           "amin" if op == "min" else "amax",
                                           include_self=True)
    return acc, counts


def _spec(sp):
    """(values, valid, op, counts wanted) of a ``segment_aggregate_many``
    spec."""
    return (tuple(sp) + (True,))[:4]


def segment_aggregate_many_plain(specs, seg_ids, n_segments: int):
    out = []
    for sp in specs:
        values, valid, op, want = _spec(sp)
        acc, counts = segment_aggregate_plain(
            None if op == "count" else values, valid, seg_ids, n_segments,
            "sum" if op == "count" else op)
        if want == "has":
            counts = counts > 0
        out.append((None if op == "count" else acc,
                    counts if want else None))
    return out


def segment_aggregate_many(specs, seg_ids: torch.Tensor, n_segments: int,
                           kernels: Optional[B.Kernels] = None
                           ) -> List[Tuple[Optional[torch.Tensor],
                                           Optional[torch.Tensor]]]:
    """K3: for every spec ``(values, valid, op[, counts])``, per segment
    the ``op`` (sum/min/max) of the valid rows' values (identity where
    none) and the count of valid rows, as ``(result, counts)``.
    ``values=None`` reduces the row index; ``valid=None`` takes every
    row; op ``"count"`` gives the counts alone (result None); ``counts``
    False leaves them out (None), ``"has"`` gives ``counts > 0`` (bool).  Sums accumulate in float64 for floats,
    int64 otherwise.  Every buffer reduces in one data pass over the ids
    (two launches a ``REDUCE_TABLE_BUFFERS`` buffers).  The kernel needs
    nondecreasing ``seg_ids`` (contiguous segments)."""
    kernels = B.kernels_for(seg_ids, kernels)
    if kernels is None:
        return segment_aggregate_many_plain(specs, seg_ids, n_segments)
    if not specs:
        return []
    specs = [_spec(sp) for sp in specs]
    dev = seg_ids.device
    n = seg_ids.shape[0]
    # results: one block a dtype, the counts one block, cut into views
    acc_ts = [None if op == "count" else _acc_dtype(v, op)
              for v, _ok, op, _w in specs]
    results = [None] * len(specs)
    groups = {}
    for k, t in enumerate(acc_ts):
        if t is not None:
            groups.setdefault(t, []).append(k)
    for t, ks in groups.items():
        for k, x in zip(ks, torch.empty((len(ks), n_segments), dtype=t,
                                        device=dev).unbind(0)):
            results[k] = x
    counts = [None] * len(specs)
    for want, dtype in ((True, torch.int64), ("has", torch.bool)):
        ks = [k for k, sp in enumerate(specs) if sp[3] == want]
        if ks:
            for k, x in zip(ks, torch.empty((len(ks), n_segments),
                                            dtype=dtype,
                                            device=dev).unbind(0)):
                counts[k] = x
    lib = kernels.library("segment_reduce")
    st = kernels.stream(seg_ids)
    ids = seg_ids.to(torch.int32).contiguous()
    words, keep = [], [ids]
    for (values, valid, op, want), res, cnt in zip(specs, results,
                                                    counts):
        if op == "count":
            values = None  # a count reads the validity alone
        if values is not None:
            values = values.contiguous()
            keep.append(values)
        if valid is not None:
            valid = valid.contiguous()
            keep.append(valid)
        words += [B.ptr(values) or 0, B.ptr(valid) or 0, B.ptr(res) or 0,
                  B.ptr(cnt) or 0,
                  B.DTYPE_CODES[(values if values is not None
                                 else ids).dtype],
                  _OPS[op] | (256 if want == "has" else 0)
                  | (512 if values is None else 0)]
    per = 6 * REDUCE_TABLE_BUFFERS
    nt = B.tiles(n)
    for w in range(0, len(words), per):
        table = array.array("q", words[w:w + per])
        nb = len(table) // 6
        scratch = torch.empty(nt * (5 * nb + 1), dtype=torch.int64,
                              device=dev)
        B.launch(SEGMENT_REDUCE_LAUNCHES, lib, "k3_segment_reduce_many",
                 table.buffer_info()[0], nb, ids.data_ptr(), n, n_segments,
                 scratch.data_ptr(), st, launched=None if n else 1)
    return list(zip(results, counts))


def segment_aggregate(values: Optional[torch.Tensor],
                      valid: Optional[torch.Tensor], seg_ids: torch.Tensor,
                      n_segments: int, op: str,
                      kernels: Optional[B.Kernels] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: per segment, the ``op`` (sum/min/max) of the valid rows'
    values (identity where none) and the count of valid rows: the
    one-buffer case of ``segment_aggregate_many``."""
    return segment_aggregate_many([(values, valid, op)], seg_ids,
                                  n_segments, kernels)[0]


def segment_min_index(seg_ids: torch.Tensor, n_segments: int,
                      kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """First row index of each segment (int64 max where empty): the
    reference aggregate's ``segment_min`` of the row index."""
    return segment_aggregate_many([(None, None, "min", False)], seg_ids,
                                  n_segments, kernels)[0][0]


def segment_pick_device(eligible, seg_ids, n_segments: int, op: str,
                        kernels: Optional[B.Kernels] = None):
    """First/last eligible row index per segment, clipped into range,
    and whether the segment has one (reference ``segment_pick_device``)."""
    n = eligible.shape[0]
    pick, counts = segment_aggregate(
        None, eligible, seg_ids, n_segments,
        "min" if op.startswith("first") else "max", kernels)
    safe = torch.clamp(pick, 0, max(n - 1, 0)).to(torch.int32)
    return safe, counts > 0


_PICKS = ("first", "last", "first_any", "last_any")


def segment_reduce_many(specs, seg_ids, n_segments: int, present=None,
                        starts: bool = False,
                        kernels: Optional[B.Kernels] = None):
    """``segment_reduce_device`` over every ``(values, valid, op)`` of
    ``specs`` against one ``seg_ids``: one K3 call for all of them (and,
    with ``starts``, each segment's first row index, the aggregate's
    segment starts), then one K4 gather a first/last pick.  Returns
    ([(values, validity)], starts or None)."""
    k3 = []
    for values, valid, op in specs:
        if op == "count":
            k3.append((None, valid, "count"))
        elif op in ("sum", "min", "max"):
            k3.append((values, valid, op, "has"))
        elif op in _PICKS:
            eligible = valid if op in ("first", "last") else (
                present if present is not None else torch.ones_like(valid))
            k3.append((None, eligible,
                       "min" if op.startswith("first") else "max", "has"))
        else:
            raise ValueError(op)
    if starts:
        k3.append((None, None, "min", False))
    res = segment_aggregate_many(k3, seg_ids, n_segments, kernels)
    n = seg_ids.shape[0]
    out = []
    for (values, valid, op), (acc, counts) in zip(specs, res):
        if op == "count":
            out.append((counts, torch.ones(n_segments, dtype=torch.bool,
                                           device=seg_ids.device)))
        elif op in ("sum", "min", "max"):
            out.append((acc, counts))
        else:
            safe = torch.clamp(acc, 0, max(n - 1, 0)).to(torch.int32)
            has = counts
            if op in ("first", "last"):
                out.append((G.gather_array(values, safe, kernels), has))
            else:  # the value and its validity, ANDed with has
                c = G.gather_columns([DeviceColumn(None, values, valid)],
                                     safe, has, kernels)[0]
                out.append((c.data, c.validity))
    return out, (res[-1][0] if starts else None)


def segment_reduce_device(values, valid, seg_ids, n_segments: int, op: str,
                          present=None, kernels: Optional[B.Kernels] = None):
    """Per-segment reduction with the reference's semantics
    (``segment_reduce_device``): returns (values, validity) with
    ``n_segments`` rows."""
    return segment_reduce_many([(values, valid, op)], seg_ids, n_segments,
                               present, kernels=kernels)[0][0]


# ===========================================================================
# string min/max (K1 + K4 + K3 + K4)
# ===========================================================================
#: CUDA kernels the string min/max composition launched (its K1, K3 and
#: K4 launches, also counted by those kernels' own counters)
STRING_MINMAX_LAUNCHES = B.LaunchCounter("string_minmax")


def string_minmax_plain(bm, lengths, valid, seg_ids, n_segments: int,
                        op: str):
    """The reference's rank encoding (``exec/aggregate.py:32
    _string_minmax_device``) in torch: sort the strings (null rows
    last), invert the order to ranks, take each segment's least (min)
    or greatest (max) rank among its valid rows, and gather that row.
    Returns (bytes[n_segments, w], lengths, count of valid rows)."""
    n = bm.shape[0]
    col = DeviceColumn(T.STRING, bm, valid, lengths)
    order = lexsort_plain([col], pad_valid=valid)
    rank = torch.empty(n, dtype=torch.int32, device=bm.device)
    rank[order.to(torch.int64)] = torch.arange(n, dtype=torch.int32,
                                               device=bm.device)
    picked, counts = segment_aggregate_plain(rank, valid, seg_ids,
                                             n_segments, op)
    row = order.to(torch.int64)[torch.clamp(picked, 0, max(n - 1, 0))
                                .to(torch.int64)]
    return bm[row], lengths[row], counts


def string_minmax(bm, lengths, valid, seg_ids, n_segments: int, op: str,
                  kernels: Optional[B.Kernels] = None):
    """Per segment, the min or max (``op``) of a string column over its
    valid rows, as the reference's rank encoding, on the hand-written
    kernels: K1 sorts the strings, K4 scatters the row index into ranks,
    K3 reduces the ranks of each segment (``seg_ids`` nondecreasing), K4
    gathers the winning rows.  Returns (bytes[n_segments, w], lengths,
    count of valid rows); a segment with none gets an arbitrary row and
    a count of 0.  Strings that differ only in trailing NUL bytes rank
    by length (ROADMAP C.6), where the reference ties them."""
    kernels = B.kernels_for(bm, kernels)
    if kernels is None:
        return string_minmax_plain(bm, lengths, valid, seg_ids, n_segments,
                                   op)
    counters = (SORT_LAUNCHES, SEGMENT_REDUCE_LAUNCHES, G.GATHER_LAUNCHES)
    before = sum(c.count for c in counters)
    n = bm.shape[0]
    col = DeviceColumn(T.STRING, bm, valid, lengths)
    order = lexsort_device([col], pad_valid=valid, kernels=kernels)
    rank = G.invert_permutation(order, kernels)
    picked, counts = segment_aggregate(rank, valid, seg_ids, n_segments, op,
                                       kernels)
    safe = torch.clamp(picked, 0, max(n - 1, 0)).to(torch.int32)
    row = G.gather_array(order, safe, kernels)
    out = (G.gather_array(bm, row, kernels),
           G.gather_array(lengths.to(torch.int32), row, kernels), counts)
    STRING_MINMAX_LAUNCHES.add(sum(c.count for c in counters) - before)
    return out
