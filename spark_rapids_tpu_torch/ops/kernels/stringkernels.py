"""K8 — string comparison, K13 — string search, K15 — substring, K18 —
concat, K19 — case maps and length, K20 — trim and substring_index, and
K21 — replace, over the fixed-width byte-matrix encoding.

Counterpart of ``spark_rapids_tpu/ops/kernels/stringkernels.py``:
``equals`` (58) and ``compare`` (36) with the padding rule of ``_pad_to``
(18) and ``_masked`` (28) as K8 (``csrc/strings.cu``); ``_find`` (134),
``contains`` (156), ``startswith`` (160), ``endswith`` (174) and
``locate_from`` (190) as K13 (``csrc/string_search.cu``), with the needle
in the launch's parameters (at most ``MAX_NEEDLE_BYTES``), and ``locate``
(204) as K13 with one start for every row; ``substring``
(93) as K15 and ``concat`` (113) as K18 (both ``csrc/string_transform.cu``);
``_case_map`` (66) with ``upper`` (73) and ``lower`` (79), and
``length`` (83) as K19 (``csrc/string_case.cu``); ``trim_ws`` (279) and
``substring_index`` (216) as K20 (``csrc/string_transform.cu``, beside
K15); ``replace_single`` (250) as K21 (``csrc/string_replace.cu``).  A string is
``(uint8[n, w] bytes, int32[n] lengths)``; either side of K8 may hold one
row (a literal), which is read with a row stride of 0 instead of being
copied ``n`` times.  The wrappers launch the kernels for CUDA tensors and
take the plain PyTorch version only for CPU tensors, unless ``kernels=``
names the libraries to launch.

Every output keeps the encoding's rule: bytes at or past a row's length
are zero.  ``trim_ws`` removes spaces (0x20) only; ``substring_index``
and ``replace_single`` take a single-byte delimiter or search byte (the
expressions tag longer ones off the device, as the reference does);
``length`` counts the bytes below the length that do not continue a
UTF-8 sequence, NUL bytes included.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build as B

#: CUDA kernels launched by K8, K13, K15, K18, K19, K20 and K21
STRING_COMPARE_LAUNCHES = B.LaunchCounter("string_compare")
STRING_SEARCH_LAUNCHES = B.LaunchCounter("string_search")
STRING_TRANSFORM_LAUNCHES = B.LaunchCounter("string_transform")
STRING_CONCAT_LAUNCHES = B.LaunchCounter("string_concat")
STRING_CASE_LAUNCHES = B.LaunchCounter("string_case")
STRING_TRIM_LAUNCHES = B.LaunchCounter("string_trim")
STRING_REPLACE_LAUNCHES = B.LaunchCounter("string_replace")

#: the longest needle K13 takes in its launch parameters
#: (``csrc/string_search.cu:NEEDLE_MAX``)
MAX_NEEDLE_BYTES = 1024
#: the most parts one K18 launch takes (``csrc/string_transform.cu``)
MAX_CONCAT_PARTS = 64
#: the longest replacement K21 takes in its launch parameters
#: (``csrc/string_replace.cu:REPL_MAX``)
MAX_REPLACE_BYTES = 1024


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
                 "locate_from": 3, "locate": 4}


def _search(bm, lengths, needle: bytes, mode: str,
            kernels: B.Kernels, start=None) -> torch.Tensor:
    if len(needle) > MAX_NEEDLE_BYTES:
        raise ValueError(f"K13 takes needles of at most {MAX_NEEDLE_BYTES} "
                         f"bytes, not {len(needle)}")
    n, w = bm.shape
    bm = bm.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty(n, dtype=torch.int32 if mode.startswith("locate")
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


def locate_plain(bm, lengths, needle: bytes, start_pos: int = 1
                 ) -> torch.Tensor:
    """The reference's ``locate``: the first match at a 0-based offset
    >= ``start_pos - 1`` (every offset when that is negative)."""
    start = torch.full((bm.shape[0],), _start0(start_pos),
                       dtype=torch.int32, device=bm.device)
    return locate_from_plain(bm, lengths, needle, start)


def _start0(start_pos: int) -> int:
    """``start_pos - 1`` clamped into the int range (a start before the
    row searches it all, one past the width finds nothing)."""
    return max(-1, min(int(start_pos) - 1, 2 ** 31 - 1))


def locate(bm, lengths, needle: bytes, start_pos: int = 1,
           kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K13: int32[n], the 1-based position of the needle's first match
    at or after the 1-based ``start_pos`` (one start for every row, in
    K13's scalar mode); 0 if absent."""
    kernels = B.kernels_for(bm, kernels)
    if kernels is None:
        return locate_plain(bm, lengths, needle, start_pos)
    start = torch.full((1,), _start0(start_pos), dtype=torch.int32,
                       device=bm.device)
    return _search(bm, lengths, needle, "locate", kernels, start)


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


# ---------------------------------------------------------------------------
# K19: case maps and length
# ---------------------------------------------------------------------------
_CASE = {"upper": (ord("a"), ord("z"), -32), "lower": (ord("A"), ord("Z"), 32)}


def case_map_plain(bm, lengths, which: str) -> torch.Tensor:
    """The reference's ``_case_map``: the row masked by its length, each
    ASCII letter of the other case moved by 32."""
    lo, hi, delta = _CASE[which]
    m = _masked(bm, lengths)
    mapped = (m.to(torch.int16) + delta).to(torch.uint8)
    return torch.where((m >= lo) & (m <= hi), mapped, m)


def length_plain(bm, lengths) -> torch.Tensor:
    """The reference's ``length``: the bytes below the length that are not
    UTF-8 continuation bytes (``b & 0xC0 == 0x80``)."""
    m = _masked(bm, lengths)
    cont = (m & 0xC0) == 0x80
    pos = torch.arange(bm.shape[1], dtype=torch.int32,
                       device=bm.device)[None, :]
    return ((pos < lengths[:, None]) & ~cont).sum(dim=1).to(torch.int32)


def _case_map(bm, lengths, which: str, kernels: Optional[B.Kernels]):
    kernels = B.kernels_for(bm, kernels)
    if kernels is None:
        return case_map_plain(bm, lengths, which), lengths
    n, w = bm.shape
    bm = bm.contiguous()
    out = torch.empty((n, w), dtype=torch.uint8, device=bm.device)
    B.launch(STRING_CASE_LAUNCHES, kernels.library("string_case"),
             "k19_case_map", B.ptr(bm),
             B.ptr(lengths.to(torch.int32).contiguous()), w, n,
             0 if which == "upper" else 1, B.ptr(out), kernels.stream(bm))
    return out, lengths


def upper(bm, lengths, kernels: Optional[B.Kernels] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K19: (uint8[n, w], the lengths): ASCII a-z raised, every other
    byte kept, zeros past the length."""
    return _case_map(bm, lengths, "upper", kernels)


def lower(bm, lengths, kernels: Optional[B.Kernels] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K19: (uint8[n, w], the lengths): ASCII A-Z lowered, every other
    byte kept, zeros past the length."""
    return _case_map(bm, lengths, "lower", kernels)


def length(bm, lengths, kernels: Optional[B.Kernels] = None
           ) -> torch.Tensor:
    """K19: int32[n], the characters of each row (UTF-8 lead and ASCII
    bytes below the length)."""
    kernels = B.kernels_for(bm, kernels)
    if kernels is None:
        return length_plain(bm, lengths)
    n, w = bm.shape
    bm = bm.contiguous()
    out = torch.empty(n, dtype=torch.int32, device=bm.device)
    B.launch(STRING_CASE_LAUNCHES, kernels.library("string_case"),
             "k19_length", B.ptr(bm),
             B.ptr(lengths.to(torch.int32).contiguous()), w, n, B.ptr(out),
             kernels.stream(bm))
    return out


# ---------------------------------------------------------------------------
# K20: trim and substring_index
# ---------------------------------------------------------------------------
def _first_true(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int8).argmax(dim=1).to(torch.int32)


def trim_ws_plain(bm, lengths, out_w: int, left: bool = True,
                  right: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``trim_ws``: leading and trailing spaces (0x20)
    counted with the positions past the length as spaces, the rest
    gathered from the first kept byte into ``out_w`` columns."""
    n, w = bm.shape
    dev = bm.device
    lengths = lengths.to(torch.int32)
    m = _masked(bm, lengths)
    pos = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    is_sp = (m == 0x20) | (pos >= lengths[:, None])
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    lead = torch.where((~is_sp).any(dim=1), _first_true(~is_sp), lengths) \
        if left else zeros
    if right:
        rev = (~is_sp).flip(1)
        from_end = torch.where(rev.any(dim=1), _first_true(rev),
                               torch.full_like(lengths, w))
        trail = torch.clamp(from_end - (w - lengths), min=0)
    else:
        trail = zeros
    new_len = torch.clamp(lengths - lead - trail, min=0).to(torch.int32)
    opos = torch.arange(out_w, dtype=torch.int32, device=dev)[None, :]
    src = torch.clamp(lead[:, None] + opos, 0, w - 1).to(torch.int64)
    out = torch.gather(m, 1, src)
    return torch.where(opos < new_len[:, None], out,
                       torch.zeros_like(out)), new_len


def substring_index_plain(bm, lengths, delim: bytes, count: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``substring_index`` for a one-byte delimiter:
    count > 0 keeps the bytes before the count-th delimiter, count < 0
    those after the |count|-th from the right, too few delimiters keep
    the row, count 0 gives ""."""
    n, w = bm.shape
    dev = bm.device
    lengths = lengths.to(torch.int32)
    if count == 0:
        return torch.zeros_like(bm), torch.zeros_like(lengths)
    match = find_plain(bm, lengths, delim)
    cum = torch.cumsum(match.to(torch.int32), dim=1)
    total = cum[:, -1]
    if count > 0:
        hit = (cum == count) & match
        new_len = torch.where(total >= count, _first_true(hit), lengths)
        return _masked(bm, new_len), new_len
    k = -count
    target = total - k + 1
    hit = (cum == target[:, None]) & match
    start = torch.where(total >= k, _first_true(hit) + len(delim),
                        torch.zeros_like(lengths))
    new_len = (lengths - start).to(torch.int32)
    pos = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    src = torch.clamp(start[:, None] + pos, 0, max(w - 1, 0)
                      ).to(torch.int64)
    g = torch.gather(bm, 1, src)
    return torch.where(pos < new_len[:, None], g, torch.zeros_like(g)), \
        new_len


def _span_launch(fn: str, bm, lengths, out_w: int, args,
                 kernels: B.Kernels) -> Tuple[torch.Tensor, torch.Tensor]:
    n, w = bm.shape
    if out_w < 1:
        raise ValueError(f"K20's out_w must be at least 1, not {out_w}")
    bm = bm.contiguous()
    dev = bm.device
    starts = torch.empty(n, dtype=torch.int32, device=dev)
    out = torch.empty((n, out_w), dtype=torch.uint8, device=dev)
    new_len = torch.empty(n, dtype=torch.int32, device=dev)
    B.launch(STRING_TRIM_LAUNCHES, kernels.library("string_transform"), fn,
             B.ptr(bm), B.ptr(lengths.to(torch.int32).contiguous()), w, n,
             *args, out_w, B.ptr(starts), B.ptr(out), B.ptr(new_len),
             kernels.stream(bm))
    return out, new_len


def trim_ws(bm, lengths, out_w: int, left: bool = True, right: bool = True,
            kernels: Optional[B.Kernels] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K20: (uint8[n, out_w], int32[n]), each row without its leading
    (``left``) and trailing (``right``) spaces, copied to the front."""
    kernels = B.kernels_for(bm, kernels)
    if kernels is None:
        return trim_ws_plain(bm, lengths, out_w, left, right)
    return _span_launch("k20_trim", bm, lengths, out_w,
                        (int(left), int(right)), kernels)


def _count_arg(count: int, w: int) -> int:
    """``count`` clamped into [-w - 1, w + 1]: a row of width w holds at
    most w delimiters, so the result is the same and fits an int."""
    return max(-w - 1, min(int(count), w + 1))


def substring_index(bm, lengths, delim: bytes, count: int,
                    kernels: Optional[B.Kernels] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K20: (uint8[n, w], int32[n]), Spark's ``substring_index`` with a
    one-byte delimiter (see ``substring_index_plain``)."""
    if len(delim) != 1:
        raise ValueError(f"K20's substring_index takes a one-byte "
                         f"delimiter, not {delim!r}")
    kernels = B.kernels_for(bm, kernels)
    if kernels is None:
        return substring_index_plain(bm, lengths, delim, count)
    w = bm.shape[1]
    return _span_launch("k20_substring_index", bm, lengths, w,
                        (delim[0], _count_arg(count, w)), kernels)


# ---------------------------------------------------------------------------
# K21: replace
# ---------------------------------------------------------------------------
def replace_width(w: int, k: int) -> int:
    """The output width of a replacement of k bytes over a w-wide matrix
    (the reference's ``max(w * max(k, 1), 1)``)."""
    return max(w * max(k, 1), 1)


def replace_single_plain(bm, lengths, search: bytes, replace: bytes
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``replace_single``: byte j of the row moves to
    ``j + (k - 1) * (matches before j)``; a match writes the k bytes of
    the replacement there.  Built by scatters into a dump column."""
    n, w = bm.shape
    dev = bm.device
    k = len(replace)
    lengths = lengths.to(torch.int32)
    m = _masked(bm, lengths)
    pos = torch.arange(w, dtype=torch.int64, device=dev)[None, :]
    in_str = pos < lengths[:, None]
    match = (m == search[0]) & in_str
    mi = match.to(torch.int64)
    o = pos + (k - 1) * (torch.cumsum(mi, dim=1) - mi)
    out_w = replace_width(w, k)
    out = torch.zeros((n, out_w + 1), dtype=torch.uint8, device=dev)
    keep = in_str & ~match
    dump = torch.full_like(o, out_w)
    out.scatter_(1, torch.where(keep, o, dump),
                 torch.where(keep, m, torch.zeros_like(m)))
    for t in range(k):
        out.scatter_(1, torch.where(match, o + t, dump),
                     torch.full_like(m, replace[t]))
    new_len = (lengths + (k - 1) * mi.sum(dim=1)).to(torch.int32)
    return out[:, :out_w].contiguous(), new_len


def replace_single(bm, lengths, search: bytes, replace: bytes,
                   kernels: Optional[B.Kernels] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K21: (uint8[n, replace_width(w, k)], int32[n]), every occurrence
    of the one ``search`` byte replaced by the k bytes of ``replace``
    (none: deleted)."""
    if len(search) != 1:
        raise ValueError(f"K21 replaces one search byte, not {search!r}")
    if len(replace) > MAX_REPLACE_BYTES:
        raise ValueError(f"K21 takes replacements of at most "
                         f"{MAX_REPLACE_BYTES} bytes, not {len(replace)}")
    kernels = B.kernels_for(bm, kernels)
    if kernels is None:
        return replace_single_plain(bm, lengths, search, replace)
    n, w = bm.shape
    bm = bm.contiguous()
    out_w = replace_width(w, len(replace))
    out = torch.empty((n, out_w), dtype=torch.uint8, device=bm.device)
    new_len = torch.empty(n, dtype=torch.int32, device=bm.device)
    buf = ctypes.create_string_buffer(replace, max(1, len(replace)))
    B.launch(STRING_REPLACE_LAUNCHES, kernels.library("string_replace"),
             "k21_replace", B.ptr(bm),
             B.ptr(lengths.to(torch.int32).contiguous()), w, n, search[0],
             buf, len(replace), out_w, B.ptr(out), B.ptr(new_len),
             kernels.stream(bm))
    return out, new_len
