"""K8 — string comparison, K13 — string search, K15 — substring and K18 —
concat, over the fixed-width byte-matrix encoding.

Counterpart of ``spark_rapids_tpu/ops/kernels/stringkernels.py``:
``equals`` (58) and ``compare`` (36) with the padding rule of ``_pad_to``
(18) and ``_masked`` (28) as K8 (``csrc/strings.cu``); ``_find`` (134),
``contains`` (156), ``startswith`` (160), ``endswith`` (174) and
``locate_from`` (190) as K13 (``csrc/string_search.cu``), with the needle
in the launch's parameters (at most ``MAX_NEEDLE_BYTES``); ``substring``
(93) as K15 and ``concat`` (113) as K18 (both ``csrc/string_transform.cu``).  A string is
``(uint8[n, w] bytes, int32[n] lengths)``; either side of K8 may hold one
row (a literal), which is read with a row stride of 0 instead of being
copied ``n`` times.  The wrappers launch the kernels for CUDA tensors and
take the plain PyTorch version only for CPU tensors, unless ``kernels=``
names the libraries to launch.

Left out, for later slices (ROADMAP B.20): ``upper``, ``lower``,
``length``, ``locate`` (with a scalar start),
``substring_index``, ``replace`` and ``trim``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build as B

#: CUDA kernels launched by K8, K13, K15 and K18
STRING_COMPARE_LAUNCHES = B.LaunchCounter("string_compare")
STRING_SEARCH_LAUNCHES = B.LaunchCounter("string_search")
STRING_TRANSFORM_LAUNCHES = B.LaunchCounter("string_transform")
STRING_CONCAT_LAUNCHES = B.LaunchCounter("string_concat")

#: the longest needle K13 takes in its launch parameters
#: (``csrc/string_search.cu:NEEDLE_MAX``)
MAX_NEEDLE_BYTES = 1024
#: the most parts one K18 launch takes (``csrc/string_transform.cu``)
MAX_CONCAT_PARTS = 64


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def _widened(bm: torch.Tensor, lengths: torch.Tensor, n: int, w: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad to width ``w``, zero bytes at or past the length, and broadcast
    a one-row side to ``n`` rows."""
    if bm.shape[1] < w:
        bm = torch.nn.functional.pad(bm, (0, w - bm.shape[1]))
    pos = torch.arange(w, dtype=torch.int32, device=bm.device)[None, :]
    m = torch.where(pos < lengths[:, None], bm, torch.zeros_like(bm))
    return m.expand(n, w), lengths.expand(n)


def _rows(lbm, rbm) -> int:
    return max(lbm.shape[0], rbm.shape[0])


def equals_plain(lbm, llen, rbm, rlen) -> torch.Tensor:
    n, w = _rows(lbm, rbm), max(lbm.shape[1], rbm.shape[1])
    l, ln = _widened(lbm, llen, n, w)
    r, rn = _widened(rbm, rlen, n, w)
    return (ln == rn) & (l == r).all(dim=1)


def compare_plain(lbm, llen, rbm, rlen) -> torch.Tensor:
    n, w = _rows(lbm, rbm), max(lbm.shape[1], rbm.shape[1])
    l, ln = _widened(lbm, llen, n, w)
    r, rn = _widened(rbm, rlen, n, w)
    pos = torch.arange(w, dtype=torch.int32, device=l.device)[None, :]
    both = (pos < ln[:, None]) & (pos < rn[:, None])
    diff = torch.where(both, l.to(torch.int32) - r.to(torch.int32),
                       torch.zeros((), dtype=torch.int32, device=l.device))
    nz = diff != 0
    first = torch.where(nz.any(dim=1), nz.to(torch.int8).argmax(dim=1),
                        torch.full((n,), w, dtype=torch.int64,
                                   device=l.device))
    d = torch.gather(diff, 1, first.clamp(0, w - 1)[:, None])[:, 0]
    byte_cmp = torch.sign(d)
    len_cmp = torch.sign(ln - rn)
    return torch.where(first < torch.minimum(ln, rn), byte_cmp,
                       len_cmp).to(torch.int32)


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------
def _side(bm: torch.Tensor, lengths: torch.Tensor):
    """(bytes, lengths, width, row stride) of one side; a one-row or
    stride-0 (broadcast) side is read at stride 0."""
    if bm.shape[0] == 1 or bm.stride(0) == 0:
        return bm[:1].contiguous(), \
            lengths[:1].to(torch.int32).contiguous(), bm.shape[1], 0
    return bm.contiguous(), lengths.to(torch.int32).contiguous(), \
        bm.shape[1], 1


def _launch(lbm, llen, rbm, rlen, mode: int,
            kernels: B.Kernels) -> torch.Tensor:
    n = _rows(lbm, rbm)
    out = torch.empty(n, dtype=torch.bool if mode == 0 else torch.int32,
                      device=lbm.device)
    lb, ll, lw, ls = _side(lbm, llen)
    rb, rl, rw, rs = _side(rbm, rlen)
    B.launch(STRING_COMPARE_LAUNCHES, kernels.library("strings"),
             "k8_string_compare", B.ptr(lb), B.ptr(ll), lw, ls, B.ptr(rb),
             B.ptr(rl), rw, rs, n, mode, B.ptr(out), kernels.stream(lbm))
    return out


def equals(lbm, llen, rbm, rlen,
           kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K8: bool[n], row-wise string equality (either side may be one
    row)."""
    kernels = B.kernels_for(lbm, kernels)
    if kernels is None:
        return equals_plain(lbm, llen, rbm, rlen)
    return _launch(lbm, llen, rbm, rlen, 0, kernels)


def compare(lbm, llen, rbm, rlen,
            kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K8: int32[n] in {-1, 0, 1}, lexicographic byte order then length
    (Spark's UTF-8 binary collation; either side may be one row)."""
    kernels = B.kernels_for(lbm, kernels)
    if kernels is None:
        return compare_plain(lbm, llen, rbm, rlen)
    return _launch(lbm, llen, rbm, rlen, 1, kernels)


# ---------------------------------------------------------------------------
# K13: search — plain versions
# ---------------------------------------------------------------------------
def _masked(bm: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    pos = torch.arange(bm.shape[1], dtype=torch.int32,
                       device=bm.device)[None, :]
    return torch.where(pos < lengths[:, None], bm, torch.zeros_like(bm))


def find_plain(bm, lengths, needle: bytes) -> torch.Tensor:
    """bool[n, w]: the needle matches at each byte position."""
    n, w = bm.shape
    k = len(needle)
    if k == 0:
        return torch.ones((n, w), dtype=torch.bool, device=bm.device)
    if k > w:
        return torch.zeros((n, w), dtype=torch.bool, device=bm.device)
    m = _masked(bm, lengths)
    match = torch.ones((n, w), dtype=torch.bool, device=bm.device)
    for j, byte in enumerate(needle):
        # m shifted left by j, zeros past the width
        shifted = torch.nn.functional.pad(m[:, j:], (0, j))
        match &= shifted == byte
    pos = torch.arange(w, dtype=torch.int32, device=bm.device)[None, :]
    return match & (pos + k <= lengths[:, None])


def contains_plain(bm, lengths, needle: bytes) -> torch.Tensor:
    return find_plain(bm, lengths, needle).any(dim=1)


def startswith_plain(bm, lengths, needle: bytes) -> torch.Tensor:
    n, w = bm.shape
    k = len(needle)
    if k == 0:
        return torch.ones(n, dtype=torch.bool, device=bm.device)
    if k > w:
        return torch.zeros(n, dtype=torch.bool, device=bm.device)
    m = _masked(bm, lengths)
    ok = lengths >= k
    for j, byte in enumerate(needle):
        ok = ok & (m[:, j] == byte)
    return ok


def endswith_plain(bm, lengths, needle: bytes) -> torch.Tensor:
    n, w = bm.shape
    k = len(needle)
    if k == 0:
        return torch.ones(n, dtype=torch.bool, device=bm.device)
    if k > w:
        return torch.zeros(n, dtype=torch.bool, device=bm.device)
    m = _masked(bm, lengths)
    ok = lengths >= k
    for j, byte in enumerate(needle):
        idx = torch.clamp(lengths.to(torch.int64) - k + j, 0, w - 1)
        ok = ok & (torch.gather(m, 1, idx[:, None])[:, 0] == byte)
    return ok


def locate_from_plain(bm, lengths, needle: bytes,
                      start: torch.Tensor) -> torch.Tensor:
    w = bm.shape[1]
    match = find_plain(bm, lengths, needle)
    pos = torch.arange(w, dtype=torch.int32, device=bm.device)[None, :]
    match = match & (pos >= start[:, None])
    first = match.to(torch.int8).argmax(dim=1).to(torch.int32)
    return torch.where(match.any(dim=1), first + 1,
                       torch.zeros_like(first))


# ---------------------------------------------------------------------------
# K13: search — kernel
# ---------------------------------------------------------------------------
_SEARCH_MODES = {"contains": 0, "startswith": 1, "endswith": 2,
                 "locate_from": 3}


def _search(bm, lengths, needle: bytes, mode: str,
            kernels: B.Kernels, start=None) -> torch.Tensor:
    if len(needle) > MAX_NEEDLE_BYTES:
        raise ValueError(f"K13 takes needles of at most {MAX_NEEDLE_BYTES} "
                         f"bytes, not {len(needle)}")
    n, w = bm.shape
    bm = bm.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty(n, dtype=torch.int32 if mode == "locate_from"
                      else torch.bool, device=bm.device)
    if start is not None:
        start = start.to(torch.int32).contiguous()
    buf = ctypes.create_string_buffer(needle, max(1, len(needle)))
    B.launch(STRING_SEARCH_LAUNCHES, kernels.library("string_search"),
             "k13_search", B.ptr(bm), B.ptr(lengths), w, n, buf,
             len(needle), _SEARCH_MODES[mode], B.ptr(start), B.ptr(out),
             kernels.stream(bm))
    return out


def contains(bm, lengths, needle: bytes,
             kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K13: bool[n], the needle occurs in the row."""
    kernels = B.kernels_for(bm, kernels)
    if kernels is None:
        return contains_plain(bm, lengths, needle)
    return _search(bm, lengths, needle, "contains", kernels)


def startswith(bm, lengths, needle: bytes,
               kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K13: bool[n], the row starts with the needle."""
    kernels = B.kernels_for(bm, kernels)
    if kernels is None:
        return startswith_plain(bm, lengths, needle)
    return _search(bm, lengths, needle, "startswith", kernels)


def endswith(bm, lengths, needle: bytes,
             kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K13: bool[n], the row ends with the needle."""
    kernels = B.kernels_for(bm, kernels)
    if kernels is None:
        return endswith_plain(bm, lengths, needle)
    return _search(bm, lengths, needle, "endswith", kernels)


def locate_from(bm, lengths, needle: bytes, start: torch.Tensor,
                kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K13: int32[n], the 1-based position of the needle's first match at
    a 0-based offset >= ``start`` (int32[n]); 0 if absent."""
    kernels = B.kernels_for(bm, kernels)
    if kernels is None:
        return locate_from_plain(bm, lengths, needle, start)
    return _search(bm, lengths, needle, "locate_from", kernels, start)


# ---------------------------------------------------------------------------
# K15: substring
# ---------------------------------------------------------------------------
def _substring_args(w: int, start: int, sub_len: int, out_w: int):
    """``start`` and ``sub_len`` clamped into [-w - 1, w] and [0, w]
    (the same result: a start past either end clamps to it, and no
    substring outlasts the row), so both fit a 32-bit int."""
    if out_w < 1:
        raise ValueError(f"substring's out_w must be at least 1, not "
                         f"{out_w}")
    return max(-w - 1, min(int(start), w)), max(0, min(int(sub_len), w))


def substring_plain(bm, lengths, start: int, sub_len: int, out_w: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``take_along_axis`` formulation: the 0-based start
    ``s`` (negative ``start`` counts from the end), ``e = min(s +
    sub_len, len)``, bytes ``[s, e)`` into ``out_w`` columns, zero past
    ``e - s``."""
    n, w = bm.shape
    start, sub_len = _substring_args(w, start, sub_len, out_w)
    lengths = lengths.to(torch.int32)
    if start < 0:
        s = torch.clamp(lengths + start, min=0)
    else:
        s = torch.clamp(lengths, max=start)
    e = torch.minimum(s + sub_len, lengths)
    new_len = (e - s).to(torch.int32)
    pos = torch.arange(out_w, dtype=torch.int32, device=bm.device)[None, :]
    src = torch.clamp(s[:, None] + pos, 0, w - 1).to(torch.int64)
    gathered = torch.gather(bm, 1, src)
    out = torch.where(pos < new_len[:, None], gathered,
                      torch.zeros((), dtype=torch.uint8, device=bm.device))
    return out.to(torch.uint8), new_len


def substring(bm, lengths, start: int, sub_len: int, out_w: int,
              kernels: Optional[B.Kernels] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K15: (uint8[n, out_w], int32[n]), each row's bytes from the
    0-based ``start`` (negative: from the end) for ``sub_len`` bytes,
    zero padded, and the new lengths."""
    kernels = B.kernels_for(bm, kernels)
    if kernels is None:
        return substring_plain(bm, lengths, start, sub_len, out_w)
    n, w = bm.shape
    start, sub_len = _substring_args(w, start, sub_len, out_w)
    bm = bm.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((n, out_w), dtype=torch.uint8, device=bm.device)
    new_len = torch.empty(n, dtype=torch.int32, device=bm.device)
    B.launch(STRING_TRANSFORM_LAUNCHES, kernels.library("string_transform"),
             "k15_substring", B.ptr(bm), B.ptr(lengths), w, n, start,
             sub_len, out_w, B.ptr(out), B.ptr(new_len), kernels.stream(bm))
    return out, new_len


# ---------------------------------------------------------------------------
# K18: concat
# ---------------------------------------------------------------------------
def concat_plain(parts) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's formulation: for each part in turn, the output
    bytes from the running length for the part's length come from the
    part (its column clipped into its width), the rest stay zero; the
    output is the sum of the widths wide and its lengths the sum of the
    lengths.  A part may be one row (a literal), broadcast."""
    n = max(bm.shape[0] for bm, _ln in parts)
    total_w = sum(bm.shape[1] for bm, _ln in parts)
    dev = parts[0][0].device
    out = torch.zeros((n, total_w), dtype=torch.uint8, device=dev)
    out_len = torch.zeros(n, dtype=torch.int32, device=dev)
    pos = torch.arange(total_w, dtype=torch.int32, device=dev)[None, :]
    for bm, ln in parts:
        w = bm.shape[1]
        bm = bm.expand(n, w)
        ln = ln.to(torch.int32).expand(n)
        src = pos - out_len[:, None]
        g = torch.gather(bm, 1, torch.clamp(src, 0, w - 1).to(torch.int64))
        out = torch.where((src >= 0) & (src < ln[:, None]), g, out)
        out_len = out_len + ln
    return out, out_len


def concat(parts, kernels: Optional[B.Kernels] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K18: (uint8[n, sum of the widths], int32[n]), the parts
    ``[(bytes, lengths), ...]`` side by side in each row (a part may be
    one row, a literal)."""
    kernels = B.kernels_for(parts[0][0], kernels)
    if kernels is None:
        return concat_plain(parts)
    if len(parts) > MAX_CONCAT_PARTS:
        head = concat(parts[:MAX_CONCAT_PARTS], kernels)
        return concat([head] + list(parts[MAX_CONCAT_PARTS:]), kernels)
    n = max(bm.shape[0] for bm, _ln in parts)
    for bm, ln in parts:
        if bm.dtype != torch.uint8 or bm.dim() != 2 or bm.shape[1] < 1 \
                or bm.shape[0] not in (1, n) or ln.shape[0] != bm.shape[0]:
            raise ValueError(f"a concat part is uint8[{n} or 1, w >= 1] "
                             f"with a length a row, not {bm.dtype} "
                             f"{tuple(bm.shape)} and {tuple(ln.shape)}")
    sides = [_side(bm, ln) for bm, ln in parts]
    out_w = sum(w for _b, _l, w, _s in sides)
    dev = parts[0][0].device
    out = torch.empty((n, out_w), dtype=torch.uint8, device=dev)
    out_len = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        k = len(sides)
        B.launch(STRING_CONCAT_LAUNCHES, kernels.library("string_transform"),
                 "k18_concat",
                 (ctypes.c_void_p * k)(*[B.ptr(b) for b, _l, _w, _s in sides]),
                 (ctypes.c_void_p * k)(*[B.ptr(l) for _b, l, _w, _s in sides]),
                 (ctypes.c_int * k)(*[w for _b, _l, w, _s in sides]),
                 (ctypes.c_int * k)(*[s for _b, _l, _w, s in sides]),
                 k, n, out_w, B.ptr(out), B.ptr(out_len),
                 kernels.stream(parts[0][0]))
    return out, out_len
