"""Equi-join kernels: K5 group ids + probe, K6 emit counts + pair
expansion, K7 null-side gather.

Counterpart of ``spark_rapids_tpu/ops/kernels/join.py``: a sort-merge
join with static shapes.

  1. group ids (K5, with K1's sort): both sides' key columns
     concatenated, one stable sort, segment ids at key changes (K2's
     rules, read through the sort's permutation); rows whose keys are
     equal (Spark's null, NaN and -0.0 rules) share an id across sides;
     left rows with a null key or padding get -1, right ones -2.
  2. probe (K5): the right rows in id order, placed by the same pass that
     writes the ids (no second sort), per left row the run
     ``[lo, lo + cnt)`` of its matches among them, and per right row
     whether it has a match.
  3. emit counts and expansion (K6, with K4's compaction ordering the
     unmatched right rows): rows emitted per left row by join type, the
     total (read once on the host to size the output), and per output
     slot its (left row, right row) pair; -1 marks a null side.
  4. gather (K7): both sides' columns by the slot's row indices, -1 →
     null, in one launch (``gather_pair``; ``gather_side`` is the
     one-sided call of the same kernel).

Each wrapper launches its ``csrc/`` kernels (``join_probe.cu``,
``join_expand.cu``, ``gather.cu``) for CUDA tensors and takes the plain
PyTorch version only for CPU tensors, unless ``kernels=`` names the
libraries to launch.  ``torch.searchsorted`` appears only in the plain
versions.  Nothing is left out of the reference module.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ...data.column import DeviceColumn
from . import _build as B
from . import gather as G
from . import segment as seg

#: CUDA kernels launched by K5, K6 and K7
JOIN_PROBE_LAUNCHES = B.LaunchCounter("join_probe")
JOIN_EXPAND_LAUNCHES = B.LaunchCounter("join_expand")
GATHER_SIDE_LAUNCHES = B.LaunchCounter("gather_side")
#: columns one K7 launch takes (K4's table, csrc/gather.cu); a wider
#: join output is split into as few launches as it needs
GATHER_TABLE_COLUMNS = G.TABLE_COLUMNS

JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti")


class Probe(NamedTuple):
    gl: torch.Tensor       # int32[Nl] left group ids (-1 = never matches)
    gr: torch.Tensor       # int32[Nr] right group ids (-2 = never matches)
    order_r: torch.Tensor  # int32[Nr] right rows sorted by group id
    lo: torch.Tensor       # int32[Nl] first match position in order_r
    cnt: torch.Tensor      # int32[Nl] number of right matches per left row
    #: bool[Nr] right row has a left match; None unless asked for
    #: (only right and full joins read it)
    has_r: Optional[torch.Tensor]


class Emit(NamedTuple):
    emit: torch.Tensor     # int32[Nl] output rows per left row
    #: bool[Nr] unmatched right rows emitted once; None where the join
    #: type emits none (inner, left, semi, anti)
    r_extra: Optional[torch.Tensor]
    total: torch.Tensor    # int64 scalar: output rows
    offs: torch.Tensor     # int64[Nl] inclusive prefix sum of emit
    #: int32[Nr] right rows with r_extra first (stable); None where the
    #: join type emits no unmatched right rows
    unmatched_order: Optional[torch.Tensor]


def _sides(how: str) -> Tuple[bool, bool]:
    if how not in JOIN_TYPES:
        raise ValueError(f"unknown join type {how!r}")
    return how in ("left", "full"), how in ("right", "full")


def _check_keys(l_keys, r_keys):
    if not l_keys or len(l_keys) != len(r_keys):
        raise ValueError("a join needs the same number (>= 1) of keys on "
                         "both sides")
    for a, b in zip(l_keys, r_keys):
        if a.dtype != b.dtype:
            raise TypeError(f"join key types differ: {a.dtype} vs "
                            f"{b.dtype}")


# ===========================================================================
# plain versions
# ===========================================================================
def _concat_key_cols(lc: DeviceColumn, rc: DeviceColumn) -> DeviceColumn:
    """Row-concat one key column from each side (strings pad to the
    wider byte matrix)."""
    if lc.dtype.is_string:
        w = max(lc.data.shape[1], rc.data.shape[1])

        def widen(d):
            return torch.nn.functional.pad(d, (0, w - d.shape[1])) \
                if d.shape[1] < w else d

        data = torch.cat([widen(lc.data), widen(rc.data)])
        lengths = torch.cat([lc.lengths, rc.lengths])
    else:
        data = torch.cat([lc.data, rc.data])
        lengths = None
    return DeviceColumn(lc.dtype, data, torch.cat([lc.validity,
                                                   rc.validity]), lengths)


def group_ids_plain(l_keys, r_keys, l_ok, r_ok):
    _check_keys(l_keys, r_keys)
    nl = l_ok.shape[0]
    combined = [_concat_key_cols(a, b) for a, b in zip(l_keys, r_keys)]
    ok = torch.cat([l_ok, r_ok])
    for c in combined:
        ok = ok & c.validity
    order = seg.lexsort_plain(combined, pad_valid=ok).to(torch.int64)
    sorted_cols = [DeviceColumn(c.dtype, c.data[order],
                                c.validity[order] & ok[order],
                                c.lengths[order]
                                if c.lengths is not None else None)
                   for c in combined]
    ids_sorted = seg.segment_ids_plain(sorted_cols, pad_valid=ok[order])
    ids = torch.zeros(ok.shape[0], dtype=torch.int32, device=ok.device)
    ids[order] = ids_sorted
    minus = torch.ones((), dtype=torch.int32, device=ok.device)
    gl = torch.where(ok[:nl], ids[:nl], -minus)
    gr = torch.where(ok[nl:], ids[nl:], -2 * minus)
    return gl, gr


def probe_plain(l_keys, r_keys, l_ok, r_ok, with_has_r: bool = True
                ) -> Probe:
    gl, gr = group_ids_plain(l_keys, r_keys, l_ok, r_ok)
    order_r = torch.sort(gr, stable=True).indices.to(torch.int32)
    sorted_gr = gr[order_r.to(torch.int64)]
    lo = torch.searchsorted(sorted_gr, gl, side="left").to(torch.int32)
    hi = torch.searchsorted(sorted_gr, gl, side="right").to(torch.int32)
    has_r = None
    if with_has_r:
        sorted_gl = torch.sort(gl).values
        rlo = torch.searchsorted(sorted_gl, gr, side="left")
        rhi = torch.searchsorted(sorted_gl, gr, side="right")
        has_r = (rhi > rlo) & (gr >= 0)
    return Probe(gl, gr, order_r, lo, hi - lo, has_r)


def _need_has_r(p: Probe, rightish: bool) -> None:
    if rightish and p.has_r is None:
        raise ValueError("right and full joins need a probe with has_r")


def emit_counts_plain(p: Probe, how: str, l_rm, r_rm) -> Emit:
    leftish, rightish = _sides(how)
    _need_has_r(p, rightish)
    cnt = torch.where(l_rm, p.cnt, torch.zeros_like(p.cnt))
    emit = torch.where(l_rm, torch.clamp(cnt, min=1), torch.zeros_like(cnt)) \
        if leftish else cnt
    total = emit.sum(dtype=torch.int64)
    offs = torch.cumsum(emit, 0, dtype=torch.int64)
    r_extra = unmatched = None
    if rightish:
        r_extra = r_rm & ~p.has_r
        total = total + r_extra.sum(dtype=torch.int64)
        unmatched = G.compact_order_plain(r_extra)[0]
    return Emit(emit, r_extra, total, offs, unmatched)


def expand_pairs_plain(p: Probe, e: Emit, c_out: int):
    nl, nr = e.emit.shape[0], p.gr.shape[0]
    dev = e.emit.device
    offs = e.offs
    m_left = offs[-1] if nl else torch.zeros((), dtype=torch.int64,
                                              device=dev)
    t = torch.arange(c_out, dtype=torch.int64, device=dev)
    li = torch.searchsorted(offs, t, side="right")
    li_safe = torch.clamp(li, 0, nl - 1)
    prev = offs[li_safe] - e.emit[li_safe]
    k = (t - prev).to(torch.int32)
    in_left = t < m_left
    matched = p.cnt[li_safe] > 0
    ri_pos = torch.clamp(p.lo[li_safe] + k, 0, nr - 1).to(torch.int64)
    neg = torch.full((), -1, dtype=torch.int32, device=dev)
    ridx = torch.where(matched, p.order_r[ri_pos], neg)
    lidx = torch.where(in_left, li_safe.to(torch.int32), neg)
    ridx = torch.where(in_left, ridx, neg)
    # unmatched right rows fill slots [m_left, total)
    if e.unmatched_order is not None:
        s = torch.clamp(t - m_left, 0, nr - 1)
        ridx = torch.where(~in_left, e.unmatched_order[s], ridx)
    slot_valid = t < e.total
    return (torch.where(slot_valid, lidx, neg),
            torch.where(slot_valid, ridx, neg), slot_valid)


def gather_side_plain(columns: Sequence[DeviceColumn], idx, slot_valid
                      ) -> List[DeviceColumn]:
    out = []
    for c in columns:
        safe = torch.clamp(idx, 0, c.data.shape[0] - 1).to(torch.int64)
        validity = c.validity[safe] & (idx >= 0) & slot_valid
        lengths = c.lengths[safe] if c.lengths is not None else None
        out.append(DeviceColumn(c.dtype, c.data[safe], validity, lengths))
    return out


def gather_pair_plain(left_columns: Sequence[DeviceColumn], lidx,
                      right_columns: Sequence[DeviceColumn], ridx,
                      slot_valid) -> List[DeviceColumn]:
    return gather_side_plain(left_columns, lidx, slot_valid) + \
        gather_side_plain(right_columns, ridx, slot_valid)


# ===========================================================================
# kernels
# ===========================================================================
def _row_bytes(t: torch.Tensor) -> int:
    return t.element_size() * (t.shape[1] if t.dim() == 2 else 1)


def _group_ids_cuda(l_keys, r_keys, l_ok, r_ok, kernels: B.Kernels,
                    with_order_r: bool):
    """(gl, gr, order_r, sorted_gr): the rows' group ids and, with
    ``with_order_r``, the right rows in id order and their ids (else
    None, None).  The combined key columns carry the eligibility ``ok``
    as their validity: an eligible row's keys are all valid, and
    ineligible rows sort after every eligible one (the padding pass), in
    row order, so the ids of eligible rows — the only ones kept — are the
    reference's."""
    _check_keys(l_keys, r_keys)
    lib = kernels.library("join_probe")
    nl, nr = l_ok.shape[0], r_ok.shape[0]
    n = nl + nr
    dev = l_ok.device
    st = kernels.stream(l_ok)
    ok = torch.empty(n, dtype=torch.bool, device=dev)

    def concat(x, y, shape, dtype):
        out = torch.empty(shape, dtype=dtype, device=dev)
        x, y = x.contiguous(), y.contiguous()
        B.launch(JOIN_PROBE_LAUNCHES, lib, "k5_concat", B.ptr(x), nl,
                 _row_bytes(x), B.ptr(y), nr, _row_bytes(y),
                 _row_bytes(out), B.ptr(out), st)
        return out

    # the concatenations first: the card starts while the host builds the
    # tables below
    combined = []
    for a, b in zip(l_keys, r_keys):
        if a.dtype.is_string:
            w = max(a.data.shape[1], b.data.shape[1])
            data = concat(a.data, b.data, (n, w), torch.uint8)
            lengths = concat(a.lengths.to(torch.int32),
                             b.lengths.to(torch.int32), (n,), torch.int32)
        else:
            data = concat(a.data, b.data.to(a.data.dtype), (n,),
                          a.data.dtype)
            lengths = None
        combined.append(DeviceColumn(a.dtype, data, ok, lengths))
    # one table: each key's validity addresses (left, right) for k5_ok,
    # then k5_ids' 4 words a combined column
    valid = [c.validity.contiguous() for pair in zip(l_keys, r_keys)
             for c in pair]
    table = B.device_table([B.ptr(v) for v in valid] + [
        x for c in combined for x in (
            B.ptr(c.data), B.DTYPE_CODES[c.data.dtype],
            c.data.shape[1] if c.data.dim() == 2 else 0,
            B.ptr(c.lengths) or 0)], dev)
    # scratch, zeroed once: the ineligible rows of each side (two uint32
    # in word 0), k5_ids' tile counter and its look-back words (three
    # counters a tile)
    ntiles = B.tiles(n)
    scratch = torch.zeros(2 + 3 * ntiles, dtype=torch.int64, device=dev)
    B.launch(JOIN_PROBE_LAUNCHES, lib, "k5_ok", B.ptr(l_ok.contiguous()), nl,
             B.ptr(r_ok.contiguous()), nr, B.ptr(table), len(l_keys),
             B.ptr(ok), B.ptr(scratch[0]), st)
    gl = torch.empty(nl, dtype=torch.int32, device=dev)
    gr = torch.empty(nr, dtype=torch.int32, device=dev)
    order_r = sorted_gr = None
    if with_order_r:
        order_r = torch.empty(nr, dtype=torch.int32, device=dev)
        sorted_gr = torch.empty(nr, dtype=torch.int32, device=dev)
    # the sorted packed key, where K1 made one, replaces the key columns
    # read through the permutation
    order, key = seg.lexsort_with_key(combined, ok, kernels)
    if n:
        B.launch(JOIN_PROBE_LAUNCHES, lib, "k5_ids", B.ptr(order), B.ptr(key),
                 n, nl, B.ptr(table[len(valid):]), len(combined),
                 B.ptr(scratch[0]), B.ptr(scratch[2:]), B.ptr(scratch[1]),
                 B.ptr(gl), B.ptr(gr), B.ptr(order_r), B.ptr(sorted_gr), st)
    return gl, gr, order_r, sorted_gr


def group_ids(l_keys, r_keys, l_ok, r_ok,
              kernels: Optional[B.Kernels] = None):
    """K5 (with K1): per-row join group ids, ``(gl, gr)``; rows on either
    side with equal, fully non-null keys share an id; ineligible left
    rows get -1, right rows -2."""
    kernels = B.kernels_for(l_ok, kernels)
    if kernels is None:
        return group_ids_plain(l_keys, r_keys, l_ok, r_ok)
    gl, gr, _o, _s = _group_ids_cuda(l_keys, r_keys, l_ok, r_ok, kernels,
                                     with_order_r=False)
    return gl, gr


def probe(l_keys, r_keys, l_ok, r_ok, with_has_r: bool = True,
          kernels: Optional[B.Kernels] = None) -> Probe:
    """K5 (with K1's one sort): group ids, the right rows in id order,
    each left row's match run and, with ``with_has_r``, each right row's
    match flag (the reference always computes it; only right and full
    joins read it)."""
    kernels = B.kernels_for(l_ok, kernels)
    if kernels is None:
        return probe_plain(l_keys, r_keys, l_ok, r_ok, with_has_r)
    lib = kernels.library("join_probe")
    st = kernels.stream(l_ok)
    gl, gr, order_r, sorted_gr = _group_ids_cuda(
        l_keys, r_keys, l_ok, r_ok, kernels, with_order_r=True)
    nl, nr = gl.shape[0], gr.shape[0]
    dev = gl.device
    lo = torch.empty(nl, dtype=torch.int32, device=dev)
    cnt = torch.empty(nl, dtype=torch.int32, device=dev)
    B.launch(JOIN_PROBE_LAUNCHES, lib, "k5_search", B.ptr(gl), nl,
             B.ptr(sorted_gr), nr, B.ptr(lo), B.ptr(cnt), st)
    has_r = None
    if with_has_r:
        seen = torch.empty(nl + nr, dtype=torch.uint8, device=dev)
        has_r = torch.empty(nr, dtype=torch.bool, device=dev)
        B.launch(JOIN_PROBE_LAUNCHES, lib, "k5_has_r", B.ptr(gl), nl,
                 B.ptr(gr), nr, B.ptr(seen), B.ptr(has_r), st)
    return Probe(gl, gr, order_r, lo, cnt, has_r)


def emit_counts(p: Probe, how: str, l_rm, r_rm,
                kernels: Optional[B.Kernels] = None) -> Emit:
    """K6 (with K4 for the unmatched right rows): rows emitted per left
    row by join type (inner/semi: its matches; left/full: at least one on
    logical rows), the unmatched right rows that right/full joins emit
    once, the emit prefix sums and the total as a device scalar."""
    kernels = B.kernels_for(p.gl, kernels)
    if kernels is None:
        return emit_counts_plain(p, how, l_rm, r_rm)
    leftish, rightish = _sides(how)
    _need_has_r(p, rightish)
    lib = kernels.library("join_expand")
    st = kernels.stream(p.gl)
    nl, nr = p.gl.shape[0], p.gr.shape[0]
    dev = p.gl.device
    emit = torch.empty(nl, dtype=torch.int32, device=dev)
    r_extra = torch.empty(nr, dtype=torch.bool, device=dev) \
        if rightish else None
    B.launch(JOIN_EXPAND_LAUNCHES, lib, "k6_emit", B.ptr(p.cnt),
             B.ptr(l_rm.contiguous()), nl,
             B.ptr(p.has_r if rightish else None),
             B.ptr(r_rm.contiguous() if rightish else None), nr,
             int(leftish), int(rightish), B.ptr(emit), B.ptr(r_extra), st)
    unmatched = extra = None
    if rightish:
        unmatched, extra = G.compact_order(r_extra, kernels)
    offs = torch.empty(nl, dtype=torch.int64, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    tile_sums = torch.empty(B.tiles(nl), dtype=torch.int64, device=dev)
    B.launch(JOIN_EXPAND_LAUNCHES, lib, "k6_scan", B.ptr(emit), nl,
             B.ptr(tile_sums), B.ptr(extra), B.ptr(offs), B.ptr(total), st)
    return Emit(emit, r_extra, total, offs, unmatched)


def expand_pairs(p: Probe, e: Emit, c_out: int,
                 kernels: Optional[B.Kernels] = None):
    """K6: output slot t in [0, c_out) → (lidx, ridx, slot_valid); -1
    marks the null-extended side and every slot past the total."""
    kernels = B.kernels_for(p.gl, kernels)
    if kernels is None:
        return expand_pairs_plain(p, e, c_out)
    dev = p.gl.device
    lidx = torch.empty(c_out, dtype=torch.int32, device=dev)
    ridx = torch.empty(c_out, dtype=torch.int32, device=dev)
    slot_valid = torch.empty(c_out, dtype=torch.bool, device=dev)
    B.launch(JOIN_EXPAND_LAUNCHES, kernels.library("join_expand"),
             "k6_expand", B.ptr(e.offs), B.ptr(e.emit), e.emit.shape[0],
             B.ptr(p.cnt), B.ptr(p.lo), B.ptr(p.order_r), p.gr.shape[0],
             B.ptr(e.unmatched_order), B.ptr(e.total), c_out, B.ptr(lidx),
             B.ptr(ridx), B.ptr(slot_valid), kernels.stream(p.gl))
    return lidx, ridx, slot_valid


def _gather_cuda(sides, slot_valid, kernels: B.Kernels
                 ) -> List[DeviceColumn]:
    """K7 over ``sides`` = [(columns, idx)] (side 0 the left indices, 1
    the right ones): K4's table of columns (``gather.move``), one launch a
    ``GATHER_TABLE_COLUMNS`` columns."""
    idx = [i.to(torch.int32).contiguous() for _c, i in sides]
    slot_valid = slot_valid.contiguous()
    n_out = slot_valid.shape[0]
    ridx = idx[1].data_ptr() if len(idx) > 1 else None
    return G.move(GATHER_SIDE_LAUNCHES, kernels.library("gather"),
                  "k7_gather", [cols for cols, _i in sides], n_out,
                  slot_valid.device,
                  (idx[0].data_ptr(), ridx, slot_valid.data_ptr(), n_out,
                   kernels.stream(slot_valid)))


def gather_side(columns: Sequence[DeviceColumn], idx, slot_valid,
                kernels: Optional[B.Kernels] = None) -> List[DeviceColumn]:
    """K7: one side's columns gathered by row index; idx -1 → a null row,
    and slots past the output's rows are null (one launch a
    ``GATHER_TABLE_COLUMNS`` columns)."""
    kernels = B.kernels_for(idx, kernels)
    if kernels is None:
        return gather_side_plain(columns, idx, slot_valid)
    return _gather_cuda([(columns, idx)], slot_valid, kernels)


def gather_pair(left_columns: Sequence[DeviceColumn], lidx,
                right_columns: Sequence[DeviceColumn], ridx, slot_valid,
                kernels: Optional[B.Kernels] = None) -> List[DeviceColumn]:
    """K7: a join output, the left columns by ``lidx`` and the right ones
    by ``ridx`` (-1 → a null row; slots past the output's rows null), in
    one launch where the two sides have at most
    ``GATHER_TABLE_COLUMNS`` columns together."""
    kernels = B.kernels_for(lidx, kernels)
    if kernels is None:
        return gather_pair_plain(left_columns, lidx, right_columns, ridx,
                                 slot_valid)
    return _gather_cuda([(left_columns, lidx), (right_columns, ridx)],
                        slot_valid, kernels)
