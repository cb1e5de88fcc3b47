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

from typing import List, Optional, Sequence, Tuple

import torch

from ... import types as T
from ...data.column import DeviceColumn
from . import _build as B
from . import gather as G

INT64_MIN = -(2 ** 63)
#: signed-order value of the reference's NaN key 0xFFFFFFFFFFFFFFFE
NAN_KEY = 2 ** 63 - 2

#: CUDA kernels launched by K1 (encode + radix sort), K2 and K3
SORT_LAUNCHES = B.LaunchCounter("sort_permutation")
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
            first = lengths[torch.argmax(c.validity.to(torch.uint8))]
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


def _n_passes(key_cols: Sequence[DeviceColumn]) -> int:
    return sum(1 + (-(-c.data.shape[1] // 8) if c.dtype.is_string else 1)
               for c in key_cols)


def _encode_cuda(lib, key_cols, descending, nulls_first,
                 passes: torch.Tensor, st) -> None:
    """K1's encoding of ``key_cols`` into the rows of ``passes``."""
    n = passes.shape[1]
    p = 0
    for col, desc, nf in zip(key_cols, descending, nulls_first):
        valid = col.validity.contiguous()
        data = col.data.contiguous()
        if col.dtype.is_string:
            w = data.shape[1]
            B.launch(SORT_LAUNCHES, lib, "k1_encode_str",
                     B.ptr(data), B.ptr(valid), w, n, int(desc), int(nf),
                     B.ptr(passes[p]), B.ptr(passes[p + 1]), st)
            p += 1 + -(-w // 8)
        else:
            B.launch(SORT_LAUNCHES, lib, "k1_encode_num",
                     B.ptr(data), B.ptr(valid), B.DTYPE_CODES[data.dtype], n,
                     int(desc), int(nf), B.ptr(passes[p]),
                     B.ptr(passes[p + 1]), st)
            p += 2


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
    n = key_cols[0].data.shape[0]
    passes = torch.empty((_n_passes(key_cols), n), dtype=torch.int64,
                         device=key_cols[0].data.device)
    _encode_cuda(kernels.library("sort"), key_cols, descending, nulls_first,
                 passes, kernels.stream(passes))
    return passes


def lexsort_device(key_cols: Sequence[DeviceColumn],
                   descending: Optional[List[bool]] = None,
                   nulls_first: Optional[List[bool]] = None,
                   pad_valid: Optional[torch.Tensor] = None,
                   kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K1: stable multi-key argsort; padding rows (``pad_valid`` False)
    sort last.  Returns an int32 permutation, bit-identical to the
    reference's ``lexsort_device`` but where string keys tie in their
    zero-padded bytes (broken by length here)."""
    probe = key_cols[0].data if key_cols else pad_valid
    kernels = B.kernels_for(probe, kernels)
    if kernels is None:
        return lexsort_plain(key_cols, descending, nulls_first, pad_valid)
    key_cols, descending, nulls_first = _with_lengths(key_cols, descending,
                                                      nulls_first)
    lib = kernels.library("sort")
    n = probe.shape[0]
    st = kernels.stream(probe)
    first = 1 if pad_valid is not None else 0
    passes = torch.empty((first + _n_passes(key_cols), n), dtype=torch.int64,
                         device=probe.device)
    if pad_valid is not None:
        B.launch(SORT_LAUNCHES, lib, "k1_encode_pad", B.ptr(pad_valid), n,
                 B.ptr(passes[0]), st)
    _encode_cuda(lib, key_cols, descending, nulls_first, passes[first:], st)
    return _sort_passes_cuda(lib, passes, st)


def _sort_passes_cuda(lib, passes: torch.Tensor, st) -> torch.Tensor:
    """LSD radix sort over the [k, n] passes, 8 bits a step, from the
    last pass's low byte to the first pass's high byte; digits with a
    single live bucket are skipped (one histogram readback decides)."""
    k, n = passes.shape
    dev = passes.device
    hist = torch.zeros((k, 8, 256), dtype=torch.int32, device=dev)
    B.launch(SORT_LAUNCHES, lib, "k1_global_hist", B.ptr(passes), k, n,
             B.ptr(hist), st)
    live = ((hist > 0).sum(dim=2) > 1).cpu().tolist()
    keys = [torch.empty(n, dtype=torch.int64, device=dev) for _ in range(2)]
    perms = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
    counts = torch.empty(256 * B.tiles(n), dtype=torch.int32, device=dev)
    cur = 0
    started = False
    for pi in reversed(range(k)):
        digits = [d for d in range(8) if live[pi][d]]
        if not digits:
            continue
        B.launch(SORT_LAUNCHES, lib, "k1_gather_keys",
                 B.ptr(passes[pi]), B.ptr(perms[cur]) if started else None,
                 n, B.ptr(keys[cur]), None if started else B.ptr(perms[cur]),
                 st)
        started = True
        for d in digits:
            B.launch(SORT_LAUNCHES, lib, "k1_digit_step",
                     B.ptr(keys[cur]), B.ptr(perms[cur]), n, 8 * d,
                     B.ptr(counts), B.ptr(hist[pi, d]), B.ptr(keys[1 - cur]),
                     B.ptr(perms[1 - cur]), st)
            cur = 1 - cur
    if not started:
        return torch.arange(n, dtype=torch.int32, device=dev)
    return perms[cur]


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


def segment_ids_device(sorted_keys: Sequence[DeviceColumn],
                       pad_valid: Optional[torch.Tensor] = None,
                       kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K2: int32 segment ids of rows in sorted key order; every padding
    row (``pad_valid`` False) gets its own segment."""
    probe = sorted_keys[0].data if sorted_keys else pad_valid
    kernels = B.kernels_for(probe, kernels)
    if kernels is None:
        return segment_ids_plain(sorted_keys, pad_valid)
    lib = kernels.library("segment_ids")
    n = probe.shape[0]
    st = kernels.stream(probe)
    change = torch.empty(n, dtype=torch.uint8, device=probe.device)
    B.launch(SEGMENT_IDS_LAUNCHES, lib, "k2_flags_init", B.ptr(pad_valid), n,
             B.ptr(change), st)
    for col in sorted_keys:
        valid = col.validity.contiguous()
        data = col.data.contiguous()
        if col.dtype.is_string:
            B.launch(SEGMENT_IDS_LAUNCHES, lib, "k2_flags_str",
                     B.ptr(data), B.ptr(col.lengths.contiguous()),
                     B.ptr(valid), data.shape[1], n, B.ptr(change), st)
        else:
            B.launch(SEGMENT_IDS_LAUNCHES, lib, "k2_flags_num",
                     B.ptr(data), B.ptr(valid), B.DTYPE_CODES[data.dtype], n,
                     B.ptr(change), st)
    ids = torch.empty(n, dtype=torch.int32, device=probe.device)
    tile_sums = torch.empty(B.tiles(n), dtype=torch.int32,
                            device=probe.device)
    B.launch(SEGMENT_IDS_LAUNCHES, lib, "k2_scan_ids", B.ptr(change), n,
             B.ptr(tile_sums), B.ptr(ids), st)
    return ids


# ===========================================================================
# K3 — segmented reduction
# ===========================================================================
_OPS = {"sum": 0, "min": 1, "max": 2}


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


def segment_aggregate(values: Optional[torch.Tensor],
                      valid: Optional[torch.Tensor], seg_ids: torch.Tensor,
                      n_segments: int, op: str,
                      kernels: Optional[B.Kernels] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: per segment, the ``op`` (sum/min/max) of the valid rows'
    values (identity where none) and the count of valid rows.
    ``values=None`` reduces the row index; ``valid=None`` takes every
    row.  Sums accumulate in float64 for floats, int64 otherwise.  The
    kernel needs nondecreasing ``seg_ids`` (contiguous segments)."""
    kernels = B.kernels_for(seg_ids, kernels)
    if kernels is None:
        return segment_aggregate_plain(values, valid, seg_ids, n_segments,
                                       op)
    lib = kernels.library("segment_reduce")
    n = seg_ids.shape[0]
    dev = seg_ids.device
    st = kernels.stream(seg_ids)
    acc_t = _acc_dtype(values, op)
    out = torch.empty(n_segments, dtype=acc_t, device=dev)
    out_cnt = torch.empty(n_segments, dtype=torch.int64, device=dev)
    nt = B.tiles(n)
    tile_f = torch.empty(nt, dtype=torch.int32, device=dev)
    tile_acc = torch.empty(nt, dtype=acc_t, device=dev)
    tile_cnt = torch.empty(nt, dtype=torch.int64, device=dev)
    vals = None if values is None else values.contiguous()
    code = 4 if vals is None else B.DTYPE_CODES[vals.dtype]
    B.launch(SEGMENT_REDUCE_LAUNCHES, lib, "k3_segment_reduce",
             B.ptr(vals), code,
             B.ptr(None if valid is None else valid.contiguous()),
             B.ptr(seg_ids.contiguous()), n, n_segments, _OPS[op],
             B.ptr(out), B.ptr(out_cnt), B.ptr(tile_f), B.ptr(tile_acc),
             B.ptr(tile_cnt), st, launched=None if n else 1)
    return out, out_cnt


def segment_min_index(seg_ids: torch.Tensor, n_segments: int,
                      kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """First row index of each segment (int64 max where empty): the
    reference aggregate's ``segment_min`` of the row index."""
    return segment_aggregate(None, None, seg_ids, n_segments, "min",
                             kernels)[0]


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


def segment_reduce_device(values, valid, seg_ids, n_segments: int, op: str,
                          present=None, kernels: Optional[B.Kernels] = None):
    """Per-segment reduction with the reference's semantics
    (``segment_reduce_device``): returns (values, validity) with
    ``n_segments`` rows."""
    if op == "count":
        _acc, counts = segment_aggregate(None, valid, seg_ids, n_segments,
                                         "sum", kernels)
        return counts, torch.ones(n_segments, dtype=torch.bool,
                                  device=seg_ids.device)
    if op in ("sum", "min", "max"):
        acc, counts = segment_aggregate(values, valid, seg_ids, n_segments,
                                        op, kernels)
        return acc, counts > 0
    if op in ("first", "last"):
        safe, has = segment_pick_device(valid, seg_ids, n_segments, op,
                                        kernels)
        return G.gather_array(values, safe, kernels), has
    if op in ("first_any", "last_any"):
        eligible = present if present is not None \
            else torch.ones_like(valid)
        safe, has = segment_pick_device(eligible, seg_ids, n_segments, op,
                                        kernels)
        return G.gather_array(values, safe, kernels), \
            has & G.gather_array(valid, safe, kernels)
    raise ValueError(op)


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
