"""K14 — the window kernel: segment bounds, ranks and frame aggregates
over rows in window order, scattered back to row order.

Counterpart of the device half of ``spark_rapids_tpu/exec/window.py``
(``_seg_scan`` :63, ``_one_window`` :111, ``_frame_agg`` :179).  The
caller sorts the rows by (partition keys, order keys) with K1 and gives
the sorted segment ids from K2; these wrappers do the rest:

  * ``segment_bounds``: each sorted row's segment start (a max-scan of
    start positions) and end (a reverse min-scan of end positions);
  * ``rank_values``: row_number, rank and dense_rank;
  * ``frame_aggregate``: count, sum, avg, min, max, first and last over
    a row frame [lower, upper] clamped to the segment, as the reference
    formulates them (prefix-sum differences; segment-reset scans or a
    sparse table for min/max; edge-row gathers, through next/previous
    valid-index scans with ``ignore_nulls``).  The kernels read the
    values, their validity and the row mask through ``order`` in one
    pass and write the result through it in one: a bounded frame within
    ``HALO`` rows of the row (except a float sum) is one launch
    (``k14_frame_halo``), any other frame stages the sorted values and
    scans them (``k14_frame_sums``, ``k14_frame_minmax``,
    ``k14_frame_pick``).

Each returns its column in ROW order (``out[order[i]]`` = the value of
sorted row ``i``), with validity ANDed with the row mask and the data
set to 0 where the result is null (the reference leaves it unspecified
there).  min/max order floats as ``jnp.minimum``/``jnp.maximum`` do: NaN
propagates and -0.0 is below 0.0.  A wrapper launches the kernels of
``csrc/window.cu`` for CUDA tensors and takes the plain PyTorch version
only for CPU tensors, unless its ``kernels=`` argument names the
libraries to launch.

Float sums: both versions subtract two prefix sums, ``P[hi] - P[lo]``,
whose error is about eps x |P|, not eps x |the frame's sum|; the kernel
adds in a fixed tile order and the plain version in ``torch.cumsum``'s,
so float window sums agree to rel 1e-9 of max(|result|, |P[hi]|).
Integer sums wrap as int64 and are exact.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build as B

#: CUDA kernels launched by K14
WINDOW_LAUNCHES = B.LaunchCounter("window")

RANK_KINDS = {"row_number": 0, "rank": 1, "dense_rank": 2}
#: frame kinds of csrc/window.cu (K_COUNT..K_LAST)
FRAME_KINDS = {"count": 0, "sum": 1, "avg": 2, "min": 3, "max": 4,
               "first": 5, "last": 6}
#: rows a halo block reads on each side of its tile (csrc/window.cu HALO):
#: bounded frames within [i - HALO, i + HALO] take one launch
HALO = 32
#: min/max frame modes of k14_frame_minmax
_UNBOUNDED, _RUNNING, _REVERSE, _BOUNDED = range(4)
_LOWER_UNBOUNDED, _UPPER_UNBOUNDED = 1, 2
_MINMAX_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
                  torch.float32, torch.float64)


def _arange(n: int, ref: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=ref.device)


# ===========================================================================
# plain versions
# ===========================================================================
def segment_bounds_plain(seg_ids: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = seg_ids.shape[0]
    i = _arange(n, seg_ids)
    first = torch.ones(n, dtype=torch.bool, device=seg_ids.device)
    first[1:] = seg_ids[1:] != seg_ids[:-1]
    last = torch.ones(n, dtype=torch.bool, device=seg_ids.device)
    last[:-1] = seg_ids[:-1] != seg_ids[1:]
    start = torch.cummax(torch.where(first, i, -1), 0).values
    end_c = torch.where(last, i + 1, n)
    end = torch.flip(torch.cummin(torch.flip(end_c, [0]), 0).values, [0])
    return start.to(torch.int32), end.to(torch.int32)


def _scatter(data_s, valid_s, order, row_mask):
    """Sorted results back to row order; null rows get data 0."""
    o = order.to(torch.int64)
    valid_s = valid_s & row_mask[o]
    data_s = torch.where(valid_s, data_s, torch.zeros_like(data_s))
    data = torch.empty_like(data_s)
    valid = torch.empty_like(valid_s)
    data[o] = data_s
    valid[o] = valid_s
    return data, valid


def rank_values_plain(kind: str, order, row_mask, start,
                      ok_ids=None, ok_start=None):
    n = order.shape[0]
    i = _arange(n, order)
    s = start.to(torch.int64)
    if kind == "row_number":
        data = i - s + 1
    elif kind == "rank":
        data = ok_start.to(torch.int64) - s + 1
    elif kind == "dense_rank":
        ok = ok_ids.to(torch.int64)
        data = ok - ok[torch.clamp(s, 0, n - 1)] + 1
    else:
        raise ValueError(kind)
    return _scatter(data.to(torch.int32),
                    torch.ones(n, dtype=torch.bool, device=order.device),
                    order, row_mask)


def _frame_edges(n, start, end, lower, upper, ref):
    i = _arange(n, ref)
    s, e = start.to(torch.int64), end.to(torch.int64)
    lo = s if lower is None else torch.minimum(
        torch.maximum(i + lower, s), e)
    hi = e if upper is None else torch.minimum(
        torch.maximum(i + upper + 1, s), e)
    return lo, torch.maximum(hi, lo)


def _identity(dtype: torch.dtype, is_min: bool):
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def _comb(a, b, is_min: bool):
    """jnp.minimum / jnp.maximum: NaN propagates; -0.0 < 0.0."""
    if not a.dtype.is_floating_point:
        return torch.minimum(a, b) if is_min else torch.maximum(a, b)
    a_wins = (a < b) if is_min else (a > b)
    b_wins = (b < a) if is_min else (b > a)
    # equal values: min takes the one with the sign bit, max the other
    tie = torch.where(torch.signbit(a) == is_min, a, b)
    r = torch.where(a_wins, a, torch.where(b_wins, b, tie))
    return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, r))


def _seg_scan_plain(vals, seg, is_min: bool, reverse: bool):
    """Segment-reset running min/max (doubling steps)."""
    n = vals.shape[0]
    v = vals
    o = 1
    while o < n:
        nv = v.clone()
        same = seg[o:] == seg[:-o]
        if reverse:
            nv[:-o] = torch.where(same, _comb(v[:-o], v[o:], is_min), v[:-o])
        else:
            nv[o:] = torch.where(same, _comb(v[:-o], v[o:], is_min), v[o:])
        v = nv
        o *= 2
    return v


def frame_aggregate_plain(kind: str, lower: Optional[int],
                          upper: Optional[int], ignore_nulls: bool,
                          values, valid, order, row_mask, seg_ids, start,
                          end):
    n = order.shape[0]
    o = order.to(torch.int64)
    rm_s = row_mask[o]
    valid_s = rm_s if valid is None else valid[o] & rm_s
    lo, hi = _frame_edges(n, start, end, lower, upper, order)
    last = n - 1
    if kind in ("first", "last"):
        vals = values[o]
        i = _arange(n, order)
        nonempty = lo < hi
        if kind == "first":
            if ignore_nulls:
                cand = torch.where(valid_s, i, n)
                nxt = torch.flip(torch.cummin(torch.flip(cand, [0]), 0)
                                 .values, [0])
                j = nxt[torch.clamp(lo, 0, last)]
                ok = nonempty & (j < hi)
            else:
                j, ok = lo, nonempty
        else:
            if ignore_nulls:
                prv = torch.cummax(torch.where(valid_s, i, -1), 0).values
                j = prv[torch.clamp(hi - 1, 0, last)]
                ok = nonempty & (j >= lo)
            else:
                j, ok = hi - 1, nonempty
        jc = torch.clamp(j, 0, last)
        out_valid = ok if ignore_nulls else ok & valid_s[jc]
        return _scatter(vals[jc], out_valid, order, row_mask)
    counts = torch.zeros(n + 1, dtype=torch.int64, device=order.device)
    counts[1:] = torch.cumsum(valid_s.to(torch.int64), 0)
    cnt = counts[hi] - counts[lo]
    if kind == "count":
        return _scatter(cnt, torch.ones_like(valid_s), order, row_mask)
    vals = values[o]
    if kind in ("sum", "avg"):
        acc_t = torch.float64 if vals.dtype.is_floating_point \
            else torch.int64
        z = torch.where(valid_s, vals.to(acc_t), torch.zeros((), dtype=acc_t,
                                                             device=o.device))
        sums = torch.zeros(n + 1, dtype=acc_t, device=order.device)
        sums[1:] = torch.cumsum(z, 0)
        s = sums[hi] - sums[lo]
        if kind == "avg":
            s = s.to(torch.float64) / torch.clamp(cnt, min=1)
        return _scatter(s, cnt > 0, order, row_mask)
    if kind not in ("min", "max"):
        raise ValueError(kind)
    is_min = kind == "min"
    if vals.dtype not in _MINMAX_DTYPES:
        raise TypeError(f"window {kind} over {vals.dtype} is not supported")
    ident = torch.full((), _identity(vals.dtype, is_min), dtype=vals.dtype,
                       device=o.device)
    masked = torch.where(valid_s, vals, ident)
    if lower is None:
        run = _seg_scan_plain(masked, seg_ids, is_min, reverse=False)
        at = end.to(torch.int64) - 1 if upper is None else hi - 1
        out = run[torch.clamp(at, 0, last)]
    elif upper is None:
        run = _seg_scan_plain(masked, seg_ids, is_min, reverse=True)
        out = run[torch.clamp(lo, 0, last)]
    else:
        # sparse table: level k holds the min/max over [i, i + 2**k)
        n_levels = max(1, min(upper - lower + 1, n).bit_length())
        levels = [masked]
        for k in range(1, n_levels):
            prev = levels[-1]
            sh = 1 << (k - 1)
            shifted = torch.cat([prev[sh:], ident.expand(min(sh, n))])[:n]
            levels.append(_comb(prev, shifted, is_min))
        table = torch.stack(levels)
        ln = hi - lo
        lvl = torch.zeros(n, dtype=torch.int64, device=o.device)
        for k in range(1, n_levels):
            lvl += (ln >= (1 << k)).to(torch.int64)
        a = table[lvl, torch.clamp(lo, 0, last)]
        b = table[lvl, torch.clamp(
            hi - torch.bitwise_left_shift(torch.ones_like(lvl), lvl), 0,
            last)]
        out = torch.where(ln > 0, _comb(a, b, is_min), ident)
    return _scatter(out, cnt > 0, order, row_mask)


# ===========================================================================
# kernels
# ===========================================================================
def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def segment_bounds(seg_ids: torch.Tensor,
                   kernels: Optional[B.Kernels] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K14: int32 start and end (exclusive) of each sorted row's segment;
    ``seg_ids`` nondecreasing (contiguous segments)."""
    kernels = B.kernels_for(seg_ids, kernels)
    if kernels is None:
        return segment_bounds_plain(seg_ids)
    n = seg_ids.shape[0]
    dev = seg_ids.device
    start = torch.empty(n, dtype=torch.int32, device=dev)
    end = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty((2, B.tiles(n)), dtype=torch.int32, device=dev)
    B.launch(WINDOW_LAUNCHES, kernels.library("window"), "k14_bounds",
             B.ptr(_i32(seg_ids)), n, B.ptr(start), B.ptr(end),
             B.ptr(scratch[0]), B.ptr(scratch[1]), kernels.stream(seg_ids))
    return start, end


def rank_values(kind: str, order, row_mask, start, ok_ids=None,
                ok_start=None, kernels: Optional[B.Kernels] = None):
    """K14: row_number / rank / dense_rank in row order (int32, valid on
    real rows).  rank needs ``ok_start`` (the start of each row's run of
    equal partition and order keys), dense_rank ``ok_ids`` (K2's ids over
    those keys)."""
    kernels = B.kernels_for(order, kernels)
    if kernels is None:
        return rank_values_plain(kind, order, row_mask, start, ok_ids,
                                 ok_start)
    n = order.shape[0]
    data = torch.empty(n, dtype=torch.int32, device=order.device)
    valid = torch.empty(n, dtype=torch.bool, device=order.device)
    B.launch(WINDOW_LAUNCHES, kernels.library("window"), "k14_rank",
             RANK_KINDS[kind], B.ptr(_i32(order)),
             B.ptr(row_mask.contiguous()), B.ptr(_i32(start)),
             B.ptr(None if ok_ids is None else _i32(ok_ids)),
             B.ptr(None if ok_start is None else _i32(ok_start)), n,
             B.ptr(data), B.ptr(valid), kernels.stream(order))
    return data, valid


def _frame_args(lower, upper):
    flags = (_LOWER_UNBOUNDED if lower is None else 0) | \
        (_UPPER_UNBOUNDED if upper is None else 0)
    return (0 if lower is None else lower), (0 if upper is None else upper), \
        flags


def in_halo(kind: str, lower: Optional[int], upper: Optional[int],
            dtype: Optional[torch.dtype]) -> bool:
    """True where ``frame_aggregate`` takes the one-launch halo path: a
    bounded frame within ``HALO`` rows of the row, and no float sum."""
    if lower is None or upper is None or max(abs(lower), abs(upper)) > HALO:
        return False
    return not (kind in ("sum", "avg") and dtype is not None
                and dtype.is_floating_point)


def frame_aggregate(kind: str, lower: Optional[int], upper: Optional[int],
                    ignore_nulls: bool, values: Optional[torch.Tensor],
                    valid: Optional[torch.Tensor], order, row_mask, seg_ids,
                    start, end, kernels: Optional[B.Kernels] = None):
    """K14: ``kind`` (count/sum/avg/min/max/first/last) of each sorted
    row's frame [i + lower, i + upper] (None = unbounded), clamped to its
    segment, in row order.  ``values``/``valid`` are in row order;
    ``values=None`` with ``valid=None`` is count(*).  Sums are int64 for
    integers and float64 for floats; avg float64; min/max/first/last
    keep the value dtype."""
    kernels = B.kernels_for(order, kernels)
    if kernels is None:
        return frame_aggregate_plain(kind, lower, upper, ignore_nulls,
                                     values, valid, order, row_mask,
                                     seg_ids, start, end)
    if kind not in FRAME_KINDS:
        raise ValueError(kind)
    vals = None if values is None else values.contiguous()
    if kind in ("min", "max") and vals.dtype not in _MINMAX_DTYPES:
        raise TypeError(f"window {kind} over {vals.dtype} is not supported")
    lib = kernels.library("window")
    st = kernels.stream(order)
    n = order.shape[0]
    dev = order.device
    nt = B.tiles(n)
    order = _i32(order)
    row_mask = row_mask.contiguous()
    valid_p = B.ptr(None if valid is None else valid.contiguous())
    float_vals = vals is not None and vals.dtype.is_floating_point
    if kind in ("count", "sum", "avg"):
        out_t = torch.float64 if kind == "avg" or (
            kind == "sum" and float_vals) else torch.int64
    else:
        out_t = vals.dtype
    out = torch.empty(n, dtype=out_t, device=dev)
    out_valid = torch.empty(n, dtype=torch.bool, device=dev)
    code = 0 if vals is None else B.DTYPE_CODES[vals.dtype]
    if in_halo(kind, lower, upper, None if vals is None else vals.dtype):
        B.launch(WINDOW_LAUNCHES, lib, "k14_frame_halo", FRAME_KINDS[kind],
                 code, int(ignore_nulls),
                 B.ptr(None if kind == "count" else vals), valid_p,
                 B.ptr(order), B.ptr(row_mask), B.ptr(_i32(seg_ids)), n,
                 lower, upper, B.ptr(out), B.ptr(out_valid), st)
        return out, out_valid
    start, end = _i32(start), _i32(end)
    lo_v, up_v, flags = _frame_args(lower, upper)
    fl = torch.empty(n, dtype=torch.uint8, device=dev)
    if kind in ("count", "sum", "avg"):
        v = None if kind == "count" else vals
        acc_t = torch.float64 if float_vals else torch.int64
        staged = sums = None
        if v is not None:
            staged = torch.empty(n, dtype=acc_t, device=dev)
            sums = torch.empty(n + 1, dtype=acc_t, device=dev)
        counts = torch.empty(n + 1, dtype=torch.int64, device=dev)
        tiles = torch.empty(2 * nt, dtype=torch.int64, device=dev)
        B.launch(WINDOW_LAUNCHES, lib, "k14_frame_sums", FRAME_KINDS[kind],
                 B.ptr(v), code, valid_p, B.ptr(order), B.ptr(row_mask),
                 B.ptr(start), B.ptr(end), n, lo_v, up_v, flags,
                 B.ptr(staged), B.ptr(fl), B.ptr(tiles), B.ptr(counts),
                 B.ptr(sums), B.ptr(out), B.ptr(out_valid), st)
        return out, out_valid
    if kind in ("min", "max"):
        bounded = lower is not None and upper is not None
        if bounded:
            mode = _BOUNDED
            n_levels = max(1, min(upper - lower + 1, n).bit_length())
        else:
            mode = (_UNBOUNDED if upper is None else _RUNNING) \
                if lower is None else _REVERSE
            n_levels = 1
        table = torch.empty((n_levels, n), dtype=vals.dtype, device=dev)
        tile_c = torch.empty(nt, dtype=torch.int64, device=dev)
        tile_f = tile_acc = None
        if not bounded:
            tile_f = torch.empty(nt, dtype=torch.int32, device=dev)
            tile_acc = torch.empty(nt, dtype=vals.dtype, device=dev)
        counts = torch.empty(n + 1, dtype=torch.int64, device=dev)
        B.launch(WINDOW_LAUNCHES, lib, "k14_frame_minmax", mode, B.ptr(vals),
                 code, int(kind == "min"), valid_p, B.ptr(order),
                 B.ptr(row_mask), B.ptr(_i32(seg_ids)), B.ptr(start),
                 B.ptr(end), n, lo_v, up_v, flags, n_levels, B.ptr(table),
                 B.ptr(fl), B.ptr(tile_c), B.ptr(tile_f), B.ptr(tile_acc),
                 B.ptr(counts), B.ptr(out), B.ptr(out_valid), st,
                 launched=4 + n_levels - 1)
        return out, out_valid
    staged = torch.empty(n, dtype=vals.dtype, device=dev)
    edge = tile_f = tile_r = None
    if ignore_nulls:
        edge = torch.empty(n, dtype=torch.int32, device=dev)
        tile_f = torch.empty(nt, dtype=torch.int32, device=dev)
        tile_r = torch.empty(nt, dtype=torch.int32, device=dev)
    B.launch(WINDOW_LAUNCHES, lib, "k14_frame_pick", int(kind == "last"),
             int(ignore_nulls), B.ptr(vals), vals.element_size(), valid_p,
             B.ptr(order), B.ptr(row_mask), B.ptr(start), B.ptr(end), n,
             lo_v, up_v, flags, B.ptr(staged), B.ptr(fl), B.ptr(edge),
             B.ptr(tile_f), B.ptr(tile_r), B.ptr(out), B.ptr(out_valid), st,
             launched=5 if ignore_nulls else 2)
    return out, out_valid
