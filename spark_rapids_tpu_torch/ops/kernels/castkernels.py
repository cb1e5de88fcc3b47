"""K16 — string parses and K17 — formats, the string directions of Cast.

Counterpart of ``spark_rapids_tpu/ops/kernels/castkernels.py``:
``trim_aligned`` (35), ``parse_int`` (61), ``parse_bool`` (101),
``parse_float`` (124), ``parse_date`` (285) and ``parse_timestamp`` (295)
as K16 (``csrc/cast_parse.cu``); ``format_int`` (359), ``format_bool``
(390), ``format_date`` (407) and ``format_timestamp`` (426) as K17
(``csrc/cast_format.cu``); their helpers ``_days_from_civil`` (200),
``_civil_from_days`` (212), ``_read_digits`` (228) and ``_parse_ymd``
(256) in both forms.  The row functions are ``csrc/strings.cuh``'s, which
K12 inlines when a Cast sits in a fused segment.

A string is ``(uint8[n, w] bytes, int32[n] lengths)``.  Every parse
trims ASCII whitespace first (as the reference does) and returns
``(data, valid)``: invalid input gives an invalid row, whose data is
whatever the accumulation left, as in the reference.  Every format
returns ``(uint8[n, width], int32[n])`` with the width of the type (20,
5, 10, 26) and zero bytes past each length; a null row is all zeros with
length 0, where the reference leaves its digits (ROADMAP C.7).

``parse_float`` accumulates ``mant * 10 + d`` in float64, then multiplies
by ``10^e``.  The reference takes ``10^e`` from XLA's ``pow``; both forms
here take it from ``POW10``, the correctly rounded powers of ten, which
equal XLA's for ``|e| <= 22`` (XLA's differ by an ULP at 1e23 and 1e210
and flush 1e-308 and below to zero).

The wrappers launch the kernels for CUDA tensors and take the plain
PyTorch version only for CPU tensors, unless ``kernels=`` names the
libraries to launch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build as B

#: CUDA kernels launched by K16 and K17
CAST_PARSE_LAUNCHES = B.LaunchCounter("cast_parse")
CAST_FORMAT_LAUNCHES = B.LaunchCounter("cast_format")

INT64_MIN = -(2 ** 63)
MICROS_PER_DAY = 86_400_000_000

#: the exponents POW10 covers; 10^e is 0 below and inf above
POW10_MIN_EXP = -323
POW10_MAX_EXP = 308
#: 10^e, correctly rounded (Python parses decimal literals exactly)
POW10 = [float(f"1e{k}") for k in range(POW10_MIN_EXP, POW10_MAX_EXP + 1)]

#: output widths of the formats
FORMAT_WIDTHS = {"int": 20, "bool": 5, "date": 10, "timestamp": 26}


def pow10_header() -> str:
    """The text of ``csrc/pow10.cuh``: ``POW10`` as hex literals."""
    rows = []
    for i in range(0, len(POW10), 3):
        rows.append("    " + ", ".join(v.hex() for v in POW10[i:i + 3])
                    + ",")
    return (
        "// 10^e for e in [POW10_MIN_EXP, POW10_MAX_EXP], correctly "
        "rounded, as\n"
        "// exact hex literals.  Generated by\n"
        "// spark_rapids_tpu_torch/ops/kernels/castkernels.py:"
        "pow10_header, whose\n"
        "// POW10 the plain parse uses (a test holds the two equal).\n"
        "#pragma once\n\n"
        "namespace srt {\n\n"
        f"constexpr int POW10_MIN_EXP = {POW10_MIN_EXP};\n"
        f"constexpr int POW10_MAX_EXP = {POW10_MAX_EXP};\n\n"
        f"__constant__ double POW10[{len(POW10)}] = {{\n"
        + "\n".join(rows) + "\n};\n\n}  // namespace srt\n")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _is_space(ch: torch.Tensor) -> torch.Tensor:
    return (ch == 32) | ((ch >= 9) & (ch <= 13))


def _cum_and(x: torch.Tensor) -> torch.Tensor:
    """Running AND along the rows' bytes."""
    return torch.cummin(x.to(torch.int32), dim=1).values.bool()


def trim_aligned_plain(bm: torch.Tensor, lengths: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The token without leading or trailing ASCII whitespace,
    left-aligned and zero padded, and its length."""
    n, w = bm.shape
    lengths = lengths.to(torch.int32)
    pos = torch.arange(w, dtype=torch.int32, device=bm.device)[None, :]
    in_len = pos < lengths[:, None]
    space = _is_space(bm) & in_len
    lead = _cum_and(torch.where(in_len, space, True))
    n_lead = (lead & in_len).sum(dim=1).to(torch.int32)
    trail = _cum_and(torch.flip(space | ~in_len, dims=[1]))
    n_trail = torch.clamp(trail.sum(dim=1).to(torch.int32) - (w - lengths),
                          min=0)
    new_len = torch.clamp(lengths - n_lead - n_trail, min=0)
    idx = torch.clamp(n_lead[:, None] + pos, 0, w - 1).to(torch.int64)
    aligned = torch.gather(bm, 1, idx)
    out = torch.where(pos < new_len[:, None], aligned,
                      torch.zeros((), dtype=torch.uint8, device=bm.device))
    return out, new_len


def _col(b: torch.Tensor, j: int) -> torch.Tensor:
    """Byte column ``j`` as int32, zeros past the matrix."""
    n, w = b.shape
    if 0 <= j < w:
        return b[:, j].to(torch.int32)
    return torch.zeros(n, dtype=torch.int32, device=b.device)


def _col_at(b: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The byte at a per-row position, clipped into the row."""
    w = b.shape[1]
    idx = torch.clamp(pos, 0, w - 1).to(torch.int64)[:, None]
    return torch.gather(b, 1, idx)[:, 0].to(torch.int32)


def _lower(b: torch.Tensor) -> torch.Tensor:
    up = (b >= 65) & (b <= 90)
    return torch.where(up, b + 32, b)


def _false(n, device) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.bool, device=device)


def parse_int_plain(bm, lengths, validity) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """[+-]?digits[.digits] -> (int64, valid): the integer part exact
    (accumulated in negative space, INT64_MIN included), fraction digits
    only validate."""
    b, L = trim_aligned_plain(bm, lengths)
    n, w = b.shape
    dev = b.device
    c0 = _col(b, 0)
    neg = c0 == ord("-")
    start = (neg | (c0 == ord("+"))).to(torch.int32)
    val = torch.zeros(n, dtype=torch.int64, device=dev)
    ovf, seen_digit, seen_dot, bad = (_false(n, dev) for _ in range(4))
    for j in range(w):
        ch = _col(b, j)
        active = (j < L) & (j >= start)
        is_digit = (ch >= 48) & (ch <= 57)
        is_dot = ch == 46
        # the reference's uint8 subtraction wraps
        d = ((ch - 48) & 0xFF).to(torch.int64)
        acc = active & is_digit & ~seen_dot
        lim = torch.div(INT64_MIN + d + 9, 10, rounding_mode="floor")
        ovf = ovf | (acc & (val < lim))
        val = torch.where(acc & ~ovf, val * 10 - d, val)
        seen_digit = seen_digit | (active & is_digit)
        bad = bad | (active & ~(is_digit | (is_dot & ~seen_dot)))
        seen_dot = seen_dot | (active & is_dot)
    ovf = ovf | (~neg & (val == INT64_MIN))
    out = torch.where(neg, val, -val)
    return out, validity & seen_digit & ~bad & ~ovf


def _token_is(low, L, start, lit: str) -> torch.Tensor:
    """The token from ``start`` (per row) equals ``lit``."""
    m = (L - start) == len(lit)
    for j, chl in enumerate(lit):
        m = m & (_col_at(low, start + j) == ord(chl))
    return m


def parse_bool_plain(bm, lengths, validity):
    """t/true/y/yes/1 -> True, f/false/n/no/0 -> False (case-folded),
    everything else invalid."""
    b, L = trim_aligned_plain(bm, lengths)
    n, w = b.shape
    low = _lower(b)
    zero = torch.zeros(n, dtype=torch.int32, device=b.device)

    def eq(lit: str):
        if len(lit) > w:
            return _false(n, b.device)
        return _token_is(low, L, zero, lit)

    true_m = eq("t") | eq("true") | eq("y") | eq("yes") | eq("1")
    false_m = eq("f") | eq("false") | eq("n") | eq("no") | eq("0")
    return true_m, validity & (true_m | false_m)


_POW10_TABLES = {}


def _pow10_plain(e: torch.Tensor) -> torch.Tensor:
    """``POW10[e]``: 0 below the table, inf above it."""
    table = _POW10_TABLES.get(e.device)
    if table is None:
        table = _POW10_TABLES[e.device] = torch.tensor(
            POW10 + [0.0, float("inf")], dtype=torch.float64,
            device=e.device)
    idx = (e - POW10_MIN_EXP).to(torch.int64)
    idx = torch.where(e < POW10_MIN_EXP, len(POW10), idx)
    idx = torch.where(e > POW10_MAX_EXP, len(POW10) + 1, idx)
    return table[idx]


def parse_float_plain(bm, lengths, validity):
    """[+-]?digits[.digits][(e|E)[+-]digits] | inf | infinity | nan ->
    (float64, valid): Horner accumulation times ``POW10[e]``."""
    b, L = trim_aligned_plain(bm, lengths)
    n, w = b.shape
    dev = b.device
    low = _lower(b)
    c0 = _col(low, 0)
    neg = c0 == ord("-")
    start = (neg | (c0 == ord("+"))).to(torch.int32)
    inf_m = _token_is(low, L, start, "inf") | \
        _token_is(low, L, start, "infinity")
    nan_m = _token_is(low, L, start, "nan")
    mant = torch.zeros(n, dtype=torch.float64, device=dev)
    frac = torch.zeros(n, dtype=torch.int32, device=dev)
    exp_val = torch.zeros(n, dtype=torch.int32, device=dev)
    (exp_neg, seen_digit, seen_dot, seen_exp, exp_seen_digit,
     bad) = (_false(n, dev) for _ in range(6))
    for j in range(w):
        ch = _col(low, j)
        active = (j < L) & (j >= start)
        is_digit = (ch >= 48) & (ch <= 57)
        is_dot = ch == 46
        is_e = ch == ord("e")
        is_sign = (ch == ord("+")) | (ch == ord("-"))
        prev_was_e = (_col(low, j - 1) == ord("e")) if j > 0 \
            else _false(n, dev)
        d = (ch - 48) & 0xFF  # the reference's uint8 subtraction wraps
        m_acc = active & is_digit & ~seen_exp
        mant = torch.where(m_acc, mant * 10.0 + d.to(torch.float64), mant)
        frac = frac + (m_acc & seen_dot).to(torch.int32)
        seen_digit = seen_digit | m_acc
        e_acc = active & is_digit & seen_exp
        exp_val = torch.where(e_acc, torch.clamp(exp_val * 10 + d, max=9999),
                              exp_val)
        exp_seen_digit = exp_seen_digit | e_acc
        ok_dot = is_dot & ~seen_dot & ~seen_exp
        ok_e = is_e & seen_digit & ~seen_exp
        ok_sign = is_sign & seen_exp & prev_was_e & ~exp_seen_digit
        bad = bad | (active & ~(is_digit | ok_dot | ok_e | ok_sign))
        exp_neg = exp_neg | (active & (ch == ord("-")) & ok_sign)
        seen_dot = seen_dot | (active & ok_dot)
        seen_exp = seen_exp | (active & ok_e)
    bad = bad | (seen_exp & ~exp_seen_digit) | ~seen_digit
    e = torch.where(exp_neg, -exp_val, exp_val) - frac
    value = mant * _pow10_plain(e)
    value = torch.where(inf_m, float("inf"), value)
    value = torch.where(nan_m, float("nan"), value)
    value = torch.where(neg, -value, value)
    return value, validity & (inf_m | nan_m | ~bad)


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def days_from_civil_plain(y, m, d) -> torch.Tensor:
    """int64 days since 1970-01-01 of a proleptic Gregorian date."""
    y = y - (m <= 2).to(y.dtype)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def civil_from_days_plain(z) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(year, month, day) of int64 days since 1970-01-01."""
    z = z + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = y + (m <= 2).to(y.dtype)
    return y, m, d


def read_digits_plain(b, start: int, count: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``count`` digits at ``start``: (value int32, all digits)."""
    n = b.shape[0]
    val = torch.zeros(n, dtype=torch.int32, device=b.device)
    ok = torch.ones(n, dtype=torch.bool, device=b.device)
    for k in range(count):
        ch = _col(b, start + k)
        is_digit = (ch >= 48) & (ch <= 57)
        ok = ok & is_digit
        val = val * 10 + torch.where(is_digit, ch - 48, 0)
    return val, ok


_DAYS_IN_MONTH = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]


def parse_ymd_plain(b, L):
    """The ISO date prefix YYYY[-MM[-DD]]: (int64 days, ok)."""
    yv, y_ok = read_digits_plain(b, 0, 4)
    full = L >= 10
    ym = (L == 7) | (L >= 10)
    mv, m_ok = read_digits_plain(b, 5, 2)
    dv, d_ok = read_digits_plain(b, 8, 2)
    sep1 = _col(b, 4) == ord("-")
    sep2 = _col(b, 7) == ord("-")
    m = torch.where(ym, mv, 1)
    d = torch.where(full, dv, 1)
    ok = y_ok & ((L == 4) | ((L == 7) & sep1 & m_ok)
                 | (full & sep1 & sep2 & m_ok & d_ok))
    leap = ((yv % 4 == 0) & (yv % 100 != 0)) | (yv % 400 == 0)
    dim = torch.tensor(_DAYS_IN_MONTH, dtype=torch.int32, device=b.device)
    md = dim[torch.clamp(m - 1, 0, 11).to(torch.int64)] + \
        ((m == 2) & leap).to(torch.int32)
    ok = ok & (m >= 1) & (m <= 12) & (d >= 1) & (d <= md)
    days = days_from_civil_plain(yv.to(torch.int64), m.to(torch.int64),
                                 d.to(torch.int64))
    return days, ok


def parse_date_plain(bm, lengths, validity):
    """ISO 'YYYY[-MM[-DD]]' -> (int32 days, valid)."""
    b, L = trim_aligned_plain(bm, lengths)
    days, ok = parse_ymd_plain(b, L)
    ok = ok & ((L == 4) | (L == 7) | (L == 10))
    return days.to(torch.int32), validity & ok


def parse_timestamp_plain(bm, lengths, validity):
    """ISO 'date[ T]HH[:MM[:SS[.f{1,6}]]]' (UTC) -> (int64 microseconds,
    valid)."""
    b, L = trim_aligned_plain(bm, lengths)
    n = b.shape[0]
    days, date_ok = parse_ymd_plain(b, L)
    date_only = (L == 4) | (L == 7) | (L == 10)
    has_time = L >= 13
    sep = _col(b, 10)
    sep_ok = (sep == ord(" ")) | (sep == ord("T"))
    hv, h_ok = read_digits_plain(b, 11, 2)
    has_min = L >= 16
    c13 = _col(b, 13) == ord(":")
    mv, m_ok = read_digits_plain(b, 14, 2)
    has_sec = L >= 19
    c16 = _col(b, 16) == ord(":")
    sv, s_ok = read_digits_plain(b, 17, 2)
    has_frac = L >= 21
    c19 = _col(b, 19) == ord(".")
    fdig = torch.clamp(L - 20, 0, 6)
    micros = torch.zeros(n, dtype=torch.int32, device=b.device)
    f_ok = torch.ones(n, dtype=torch.bool, device=b.device)
    for k in range(6):
        ch = _col(b, 20 + k)
        used = has_frac & (k < fdig)
        is_digit = (ch >= 48) & (ch <= 57)
        f_ok = f_ok & (~used | is_digit)
        micros = micros * 10 + torch.where(used & is_digit, ch - 48, 0)
    len_ok = date_only | (
        sep_ok & ((L == 13) | ((L == 16) & c13) | ((L == 19) & c13 & c16)
                  | (has_frac & (L <= 26) & c13 & c16 & c19)))
    time_ok = ~has_time | (
        h_ok & (hv < 24) & (~has_min | (m_ok & (mv < 60)))
        & (~has_sec | (s_ok & (sv < 60))) & (~has_frac | f_ok))
    hv = torch.where(has_time, hv, 0).to(torch.int64)
    mv = torch.where(has_min, mv, 0).to(torch.int64)
    sv = torch.where(has_sec, sv, 0).to(torch.int64)
    micros = torch.where(has_frac, micros, 0).to(torch.int64)
    us = (days * MICROS_PER_DAY + hv * 3_600_000_000 + mv * 60_000_000
          + sv * 1_000_000 + micros)
    return us, validity & date_ok & len_ok & time_ok


def _stack(cols, validity) -> torch.Tensor:
    """uint8[n, k] of int32 byte columns, all zero on null rows."""
    bm = torch.stack([c.to(torch.uint8) for c in cols], dim=1)
    return torch.where(validity[:, None], bm,
                       torch.zeros((), dtype=torch.uint8, device=bm.device))


def format_int_plain(values, validity) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 -> left-aligned decimal bytes (Python's ``str(int)``)."""
    v = values.to(torch.int64)
    n = v.shape[0]
    negm = v < 0
    # the magnitude's negation: -|v| is an int64 for every v
    nmag = torch.where(negm, v, -v)
    ndig = torch.ones(n, dtype=torch.int32, device=v.device)
    for k in range(1, 19):
        ndig = ndig + (nmag <= -(10 ** k)).to(torch.int32)
    # digits from the units up, of the non-positive -|v|
    digit = []
    q = nmag
    for _p in range(19):
        digit.append(-torch.fmod(q, 10).to(torch.int32))
        q = torch.div(q, 10, rounding_mode="trunc")
    digits = torch.stack(digit, dim=1)
    sign_off = negm.to(torch.int32)
    length = ndig + sign_off
    cols = []
    for j in range(20):
        p = ndig - 1 - (j - sign_off)
        dj = torch.gather(digits, 1, torch.clamp(p, 0, 18).to(
            torch.int64)[:, None])[:, 0]
        ch = torch.where(negm & (j == sign_off - 1), ord("-"), 48 + dj)
        keep = (j < length) & ((p >= 0) | (negm & (j == 0)))
        cols.append(torch.where(keep, ch, 0))
    return _stack(cols, validity), torch.where(validity, length, 0)


def format_bool_plain(values, validity):
    t = torch.tensor(list(b"true\x00"), dtype=torch.uint8,
                     device=values.device)
    f = torch.tensor(list(b"false"), dtype=torch.uint8, device=values.device)
    v = values.to(torch.bool)
    bm = torch.where(v[:, None], t[None, :], f[None, :])
    bm = torch.where(validity[:, None], bm,
                     torch.zeros((), dtype=torch.uint8, device=bm.device))
    lengths = torch.where(v, 4, 5).to(torch.int32)
    return bm, torch.where(validity, lengths, 0)


def _two(v):
    return [48 + v // 10, 48 + v % 10]


def _ymd_cols(days) -> list:
    y, m, d = civil_from_days_plain(days.to(torch.int64))
    y = torch.clamp(y, 0, 9999).to(torch.int32)
    m = m.to(torch.int32)
    d = d.to(torch.int32)
    dash = torch.full_like(y, ord("-"))
    return ([48 + (y // 1000) % 10, 48 + (y // 100) % 10,
             48 + (y // 10) % 10, 48 + y % 10, dash]
            + _two(m) + [dash] + _two(d))


def format_date_plain(values, validity):
    """date32 -> 'YYYY-MM-DD' (the year clamped to 0..9999)."""
    lengths = torch.where(validity, 10, 0).to(torch.int32)
    return _stack(_ymd_cols(values), validity), lengths


def format_timestamp_plain(values, validity):
    """timestamp(us) -> 'YYYY-MM-DD HH:MM:SS.ffffff' (UTC)."""
    us = values.to(torch.int64)
    days = _fdiv(us, MICROS_PER_DAY)
    rem = us - days * MICROS_PER_DAY
    h = (rem // 3_600_000_000).to(torch.int32)
    mi = ((rem // 60_000_000) % 60).to(torch.int32)
    s = ((rem // 1_000_000) % 60).to(torch.int32)
    f = (rem % 1_000_000).to(torch.int32)
    space = torch.full_like(h, ord(" "))
    colon = torch.full_like(h, ord(":"))
    cols = (_ymd_cols(days) + [space] + _two(h) + [colon] + _two(mi)
            + [colon] + _two(s) + [torch.full_like(h, ord("."))]
            + [48 + (f // k) % 10
               for k in (100000, 10000, 1000, 100, 10, 1)])
    lengths = torch.where(validity, 26, 0).to(torch.int32)
    return _stack(cols, validity), lengths


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------
_PARSE_OUT = {"int": torch.int64, "bool": torch.bool,
              "float": torch.float64, "date": torch.int32,
              "timestamp": torch.int64}
_PARSE_PLAIN = {"int": parse_int_plain, "bool": parse_bool_plain,
                "float": parse_float_plain, "date": parse_date_plain,
                "timestamp": parse_timestamp_plain}


def _string_args(bm, lengths):
    """(bytes, int32 lengths, rows, width), checked and contiguous."""
    if bm.dtype != torch.uint8 or bm.dim() != 2:
        raise TypeError(f"a string matrix is uint8[n, w], not {bm.dtype} "
                        f"{tuple(bm.shape)}")
    n, w = bm.shape
    if w < 1 or tuple(lengths.shape) != (n,):
        raise ValueError(f"a string matrix of {tuple(bm.shape)} needs a "
                         f"width of at least 1 and {n} lengths")
    return bm.contiguous(), lengths.to(torch.int32).contiguous(), n, w


def _parse(kind: str, bm, lengths, validity,
           kernels: Optional[B.Kernels]):
    kernels = B.kernels_for(bm, kernels)
    if kernels is None:
        return _PARSE_PLAIN[kind](bm, lengths, validity)
    bm, lengths, n, w = _string_args(bm, lengths)
    if tuple(validity.shape) != (n,):
        raise ValueError(f"{n} rows need {n} validity flags, not "
                         f"{tuple(validity.shape)}")
    validity = validity.to(torch.bool).contiguous()
    out = torch.empty(n, dtype=_PARSE_OUT[kind], device=bm.device)
    ok = torch.empty(n, dtype=torch.bool, device=bm.device)
    if n:
        B.launch(CAST_PARSE_LAUNCHES, kernels.library("cast_parse"),
                 f"k16_parse_{kind}", B.ptr(bm), B.ptr(lengths),
                 B.ptr(validity), w, n, B.ptr(out), B.ptr(ok),
                 kernels.stream(bm))
    return out, ok


def trim_aligned(bm, lengths, kernels: Optional[B.Kernels] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K16: the trimmed tokens, left-aligned and zero padded, and their
    lengths (the parses trim in place instead)."""
    kernels = B.kernels_for(bm, kernels)
    if kernels is None:
        return trim_aligned_plain(bm, lengths)
    bm, lengths, n, w = _string_args(bm, lengths)
    out = torch.empty((n, w), dtype=torch.uint8, device=bm.device)
    new_len = torch.empty(n, dtype=torch.int32, device=bm.device)
    if n:
        B.launch(CAST_PARSE_LAUNCHES, kernels.library("cast_parse"),
                 "k16_trim", B.ptr(bm), B.ptr(lengths), w, n, B.ptr(out),
                 B.ptr(new_len), kernels.stream(bm))
    return out, new_len


def parse_int(bm, lengths, validity, kernels=None):
    """K16: (int64[n], bool[n] valid) of [+-]?digits[.digits]."""
    return _parse("int", bm, lengths, validity, kernels)


def parse_bool(bm, lengths, validity, kernels=None):
    """K16: (bool[n], bool[n] valid) of the accepted spellings."""
    return _parse("bool", bm, lengths, validity, kernels)


def parse_float(bm, lengths, validity, kernels=None):
    """K16: (float64[n], bool[n] valid)."""
    return _parse("float", bm, lengths, validity, kernels)


def parse_date(bm, lengths, validity, kernels=None):
    """K16: (int32[n] days, bool[n] valid)."""
    return _parse("date", bm, lengths, validity, kernels)


def parse_timestamp(bm, lengths, validity, kernels=None):
    """K16: (int64[n] microseconds, bool[n] valid)."""
    return _parse("timestamp", bm, lengths, validity, kernels)


_FORMAT_IN = {"int": torch.int64, "bool": torch.bool, "date": torch.int32,
              "timestamp": torch.int64}
_FORMAT_PLAIN = {"int": format_int_plain, "bool": format_bool_plain,
                 "date": format_date_plain,
                 "timestamp": format_timestamp_plain}


def _format(kind: str, values, validity, kernels: Optional[B.Kernels]):
    kernels = B.kernels_for(values, kernels)
    if kernels is None:
        return _FORMAT_PLAIN[kind](values, validity)
    if values.dim() != 1 or validity.shape != values.shape:
        raise ValueError(f"format takes a column and its validity, not "
                         f"{tuple(values.shape)} and "
                         f"{tuple(validity.shape)}")
    values = values.to(_FORMAT_IN[kind]).contiguous()
    validity = validity.to(torch.bool).contiguous()
    n = values.shape[0]
    out = torch.empty((n, FORMAT_WIDTHS[kind]), dtype=torch.uint8,
                      device=values.device)
    lengths = torch.empty(n, dtype=torch.int32, device=values.device)
    if n:
        B.launch(CAST_FORMAT_LAUNCHES, kernels.library("cast_format"),
                 f"k17_format_{kind}", B.ptr(values), B.ptr(validity), n,
                 B.ptr(out), B.ptr(lengths), kernels.stream(values))
    return out, lengths


def format_int(values, validity, kernels=None):
    """K17: (uint8[n, 20], int32[n]) — any integer type, as int64."""
    return _format("int", values, validity, kernels)


def format_bool(values, validity, kernels=None):
    """K17: (uint8[n, 5], int32[n]) — 'true' / 'false'."""
    return _format("bool", values, validity, kernels)


def format_date(values, validity, kernels=None):
    """K17: (uint8[n, 10], int32[n]) — 'YYYY-MM-DD'."""
    return _format("date", values, validity, kernels)


def format_timestamp(values, validity, kernels=None):
    """K17: (uint8[n, 26], int32[n]) — 'YYYY-MM-DD HH:MM:SS.ffffff'."""
    return _format("timestamp", values, validity, kernels)
