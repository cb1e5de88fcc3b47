// Device forms of the string functions over the byte-matrix encoding.
//
// A string row is (row bytes, the matrix width w, the row's length len);
// bytes at or past either read as 0, the padding rule of
// spark_rapids_tpu/ops/kernels/stringkernels.py:_pad_to (18) and _masked
// (28).  K8 (strings.cu), K13 (string_search.cu) and every generated K12
// segment (ops/kernels/fused.py) call these, so a string predicate inside
// a fused segment and outside it run the same code.
//
//   str_equals / str_compare      stringkernels.py:equals (58), compare (36)
//   str_locate_from               stringkernels.py:_find (134), locate_from (190)
//   str_contains                  stringkernels.py:contains (156)
//   str_startswith / str_endswith stringkernels.py:startswith (160),
//                                 endswith (174)
//   str_substring                 stringkernels.py:substring (93)
//   case_map / str_length         stringkernels.py:_case_map (66), length (83)
//   str_trim_ws                   stringkernels.py:trim_ws (279)
//   str_substring_index           stringkernels.py:substring_index (216)
//   str_replace                   stringkernels.py:replace_single (250)
//
// and the row functions of the casts (castkernels.py), which K16
// (cast_parse.cu), K17 (cast_format.cu) and K12 share:
//
//   str_trim                      castkernels.py:trim_aligned (35), in place
//   parse_int / parse_bool / parse_float        :61 / :101 / :124
//   parse_date / parse_timestamp  :285 / :295, with read_digits (:228) and
//                                 parse_ymd (:256)
//   format_int / format_bool / format_date / format_timestamp
//                                 :359 / :390 / :407 / :426
//   days_from_civil / civil_from_days           :200 / :212
//
// The parses read a trimmed token (its first byte and length), bytes past
// the length as 0, as trim_aligned's zero padding does; every division
// that can see a negative operand floors (fdiv), as numpy's does.  A
// format writes its whole output row: the text, then zeros; a null row is
// all zeros with length 0 (the reference leaves digits there).
//
// Semantics are the reference's: an empty needle matches (locate_from
// then returns the start position, 1-based, while it lies inside the
// matrix), a needle wider than the matrix never matches, a match must
// end at or before the row's length, positions are byte positions.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "pow10.cuh"

namespace srt {

__device__ __forceinline__ int str_byte(const uint8_t* __restrict__ row,
                                        int w, int len, int pos) {
  return (pos < w && pos < len) ? (int)row[pos] : 0;
}

__device__ __forceinline__ bool str_equals(const uint8_t* __restrict__ l,
                                           int lw, int ln,
                                           const uint8_t* __restrict__ r,
                                           int rw, int rn) {
  const int w = lw > rw ? lw : rw;
  bool eq = ln == rn;
  for (int p = 0; eq && p < w; ++p)
    eq = str_byte(l, lw, ln, p) == str_byte(r, rw, rn, p);
  return eq;
}

// -1, 0 or 1: the first differing byte among the positions both rows
// cover decides (unsigned, i.e. UTF-8 binary order), else the lengths do
__device__ __forceinline__ int str_compare(const uint8_t* __restrict__ l,
                                           int lw, int ln,
                                           const uint8_t* __restrict__ r,
                                           int rw, int rn) {
  const int w = lw > rw ? lw : rw;
  const int both = ln < rn ? ln : rn;
  int d = 0;
  int first = w;
  for (int p = 0; p < w && p < both; ++p) {
    d = str_byte(l, lw, ln, p) - str_byte(r, rw, rn, p);
    if (d != 0) { first = p; break; }
  }
  if (first < both) return d < 0 ? -1 : 1;
  // lengths past the matrix width: the reference reads the (zero)
  // difference at the last column, so the result is 0
  if (w < both) return 0;
  return ln < rn ? -1 : (ln > rn ? 1 : 0);
}

// the k needle bytes equal the row's bytes at pos, and end by its length
__device__ __forceinline__ bool str_match_at(const uint8_t* __restrict__ row,
                                             int w, int len,
                                             const uint8_t* __restrict__ nd,
                                             int k, int pos) {
  if (pos + k > len) return false;
  for (int j = 0; j < k; ++j)
    if (str_byte(row, w, len, pos + j) != (int)nd[j]) return false;
  return true;
}

// 1-based position of the first match at a 0-based offset >= start, 0 if
// none
__device__ __forceinline__ int str_locate_from(
    const uint8_t* __restrict__ row, int w, int len,
    const uint8_t* __restrict__ nd, int k, int start) {
  if (k > w) return 0;
  const int p0 = start < 0 ? 0 : start;
  if (k == 0) return p0 < w ? p0 + 1 : 0;
  const int last = len - k < w - 1 ? len - k : w - 1;
  for (int p = p0; p <= last; ++p)
    if (str_match_at(row, w, len, nd, k, p)) return p + 1;
  return 0;
}

__device__ __forceinline__ bool str_contains(const uint8_t* __restrict__ row,
                                             int w, int len,
                                             const uint8_t* __restrict__ nd,
                                             int k) {
  return str_locate_from(row, w, len, nd, k, 0) > 0;
}

__device__ __forceinline__ bool str_startswith(
    const uint8_t* __restrict__ row, int w, int len,
    const uint8_t* __restrict__ nd, int k) {
  if (k == 0) return true;
  if (k > w) return false;
  return str_match_at(row, w, len, nd, k, 0);
}

__device__ __forceinline__ bool str_endswith(const uint8_t* __restrict__ row,
                                             int w, int len,
                                             const uint8_t* __restrict__ nd,
                                             int k) {
  if (k == 0) return true;
  if (k > w || len < k) return false;
  for (int j = 0; j < k; ++j) {
    int idx = len - k + j;  // the reference clips the index into the row
    idx = idx < 0 ? 0 : (idx > w - 1 ? w - 1 : idx);
    if (str_byte(row, w, len, idx) != (int)nd[j]) return false;
  }
  return true;
}

// substring(start, sub_len) of a row of length len: returns the new
// length e - s and stores the 0-based first byte s, where s = start >= 0 ?
// min(start, len) : max(len + start, 0) and e = min(s + max(sub_len, 0),
// len) (the reference's substring, stringkernels.py:93).  The bytes are
// row[s, e); K15 (string_transform.cu) copies them, K12 reads them in
// place.
__device__ __forceinline__ int str_substring(int len, int start, int sub_len,
                                             int* s) {
  int first;
  if (start >= 0) {
    first = start < len ? start : len;
  } else {
    const long long from_end = (long long)len + start;
    first = from_end > 0 ? (int)from_end : 0;
  }
  const long long want = (long long)first + (sub_len > 0 ? sub_len : 0);
  const int e = want < len ? (int)want : len;
  *s = first;
  return e - first;
}

// the output width of substring with sub_len bytes over a w-wide matrix:
// min(max(sub_len, 1), w) (ops/stringexprs.py:Substring.out_width)
__device__ __forceinline__ int substring_width(int sub_len, int w) {
  const int k = sub_len < 1 ? 1 : sub_len;
  return k < w ? k : w;
}

// ---------------------------------------------------------------------------
// transforms (K19 string_case.cu, K20 string_transform.cu, K21
// string_replace.cu, and K12)
// ---------------------------------------------------------------------------

enum CaseMode { CASE_UPPER = 0, CASE_LOWER = 1 };

// one byte of _case_map: an ASCII letter of the other case moved by 32
__device__ __forceinline__ uint8_t case_map(int b, int mode) {
  if (mode == CASE_UPPER) return (uint8_t)((b >= 'a' && b <= 'z') ? b - 32 : b);
  return (uint8_t)((b >= 'A' && b <= 'Z') ? b + 32 : b);
}

// the characters of a row: its bytes below min(len, w) that do not
// continue a UTF-8 sequence (b & 0xC0 != 0x80), NUL bytes included
__device__ __forceinline__ int str_length(const uint8_t* __restrict__ row,
                                          int w, int len) {
  const int n = len < w ? len : w;
  int count = 0;
  for (int p = 0; p < n; ++p) count += (row[p] & 0xC0) != 0x80;
  return count;
}

// trim_ws without the copy: the kept bytes are row[*s, *s + new length);
// spaces (0x20) only, from the front when `left`, from the back when
// `right`; an all-space row keeps nothing
__device__ __forceinline__ int str_trim_ws(const uint8_t* __restrict__ row,
                                           int w, int len, bool left,
                                           bool right, int* s) {
  const int n = len < 0 ? 0 : (len < w ? len : w);
  int lo = 0;
  if (left)
    while (lo < n && row[lo] == ' ') ++lo;
  int hi = n;
  if (right)
    while (hi > lo && row[hi - 1] == ' ') --hi;
  *s = lo;
  return hi - lo;
}

// substring_index with a one-byte delimiter, without the copy: count > 0
// keeps the bytes before the count-th delimiter (*s = 0), count < 0 those
// after the |count|-th delimiter from the right, too few delimiters keep
// the row, count 0 keeps nothing.  A delimiter counts where it lies below
// the length.
__device__ __forceinline__ int str_substring_index(
    const uint8_t* __restrict__ row, int w, int len, int delim, int count,
    int* s) {
  *s = 0;
  if (count == 0) return 0;
  const int n = len < 0 ? 0 : (len < w ? len : w);
  if (count > 0) {
    int seen = 0;
    for (int p = 0; p < n; ++p)
      if (row[p] == delim && ++seen == count) return p;
    return len;
  }
  int seen = 0;
  for (int p = n - 1; p >= 0; --p)
    if (row[p] == delim && ++seen == -count) {
      *s = p + 1;
      return len - (p + 1);
    }
  return len;
}

// replace_single of one row into out (out_w bytes, zeros past the new
// length): every byte below the length equal to `search` becomes the k
// bytes of repl; returns the new length, len + (k - 1) * matches
__device__ __forceinline__ int str_replace(const uint8_t* __restrict__ row,
                                           int w, int len, int search,
                                           const uint8_t* __restrict__ repl,
                                           int k, uint8_t* __restrict__ out,
                                           int out_w) {
  const int n = len < 0 ? 0 : (len < w ? len : w);
  int o = 0;
  for (int p = 0; p < n; ++p) {
    const uint8_t b = row[p];
    if (b == search) {
      for (int t = 0; t < k; ++t, ++o)
        if (o < out_w) out[o] = repl[t];
    } else {
      if (o < out_w) out[o] = b;
      ++o;
    }
  }
  for (int q = o; q < out_w; ++q) out[q] = 0;
  return len + o - n;
}

// ---------------------------------------------------------------------------
// casts
// ---------------------------------------------------------------------------

// a division that rounds toward negative infinity (C++ `/` truncates)
__device__ __forceinline__ long long fdiv(long long a, long long b) {
  const long long q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// x * m with two's-complement wrapping, as torch's and numpy's int64 do
__device__ __forceinline__ long long wrap_mul(long long x, long long m) {
  return (long long)((unsigned long long)x * (unsigned long long)m);
}

// a float to an integer type the way XLA converts: toward zero, NaN to 0,
// saturating at the type's range
template <class T>
__device__ __forceinline__ T f2i_sat(double x, double lo, double hi_excl,
                                     T tmin, T tmax) {
  if (x != x) return (T)0;
  if (x >= hi_excl) return tmax;
  if (x < lo) return tmin;
  return (T)x;
}

__device__ __forceinline__ bool is_space(int ch) {
  return ch == 32 || (ch >= 9 && ch <= 13);
}

__device__ __forceinline__ int lower_ascii(int ch) {
  return (ch >= 65 && ch <= 90) ? ch + 32 : ch;
}

// trim_aligned without the copy: the token is row[*start, *start + n),
// n returned; ASCII whitespace only, as the reference
__device__ __forceinline__ int str_trim(const uint8_t* __restrict__ row,
                                        int w, int len, int* start) {
  const int n = len < w ? len : w;
  int lo = 0;
  while (lo < n && is_space(row[lo])) ++lo;
  int hi = n;
  while (hi > lo && is_space(row[hi - 1])) --hi;
  *start = lo;
  return hi - lo;
}

// the byte at j of a token of length L, 0 past it
__device__ __forceinline__ int tok_byte(const uint8_t* __restrict__ t, int L,
                                        int j) {
  return (j >= 0 && j < L) ? (int)t[j] : 0;
}

// [+-]?digits[.digits] -> int64; the integer part accumulates in negative
// space (INT64_MIN included), fraction digits only validate.  Returns
// whether the token is valid; *out is written for every token.
__device__ __forceinline__ bool parse_int(const uint8_t* __restrict__ t,
                                          int L, long long* out) {
  const int c0 = tok_byte(t, L, 0);
  const bool neg = c0 == '-';
  const int start = (neg || c0 == '+') ? 1 : 0;
  long long val = 0;
  bool ovf = false, seen_digit = false, seen_dot = false, bad = false;
  for (int j = start; j < L; ++j) {
    const int ch = t[j];
    const bool is_digit = ch >= '0' && ch <= '9';
    const bool is_dot = ch == '.';
    if (is_digit && !seen_dot) {
      const long long d = ch - '0';
      // val * 10 - d stays >= INT64_MIN iff val >= floor((MIN + d + 9) / 10)
      if (val < fdiv(INT64_MIN + d + 9, 10)) ovf = true;
      if (!ovf) val = val * 10 - d;
    }
    seen_digit = seen_digit || is_digit;
    bad = bad || !(is_digit || (is_dot && !seen_dot));
    seen_dot = seen_dot || is_dot;
  }
  if (!neg && val == INT64_MIN) ovf = true;  // -INT64_MIN overflows
  *out = neg ? val : (long long)(0ULL - (unsigned long long)val);
  return seen_digit && !bad && !ovf;
}

// the token (case-folded) equals the k bytes of lit
__device__ __forceinline__ bool tok_is(const uint8_t* __restrict__ t, int L,
                                       int from, const char* lit, int k) {
  if (L - from != k) return false;
  for (int j = 0; j < k; ++j)
    if (lower_ascii(tok_byte(t, L, from + j)) != lit[j]) return false;
  return true;
}

// t/true/y/yes/1 -> true, f/false/n/no/0 -> false (case-folded); returns
// whether it is one of them
__device__ __forceinline__ bool parse_bool(const uint8_t* __restrict__ t,
                                           int L, bool* out) {
  const bool yes = tok_is(t, L, 0, "t", 1) || tok_is(t, L, 0, "true", 4) ||
                   tok_is(t, L, 0, "y", 1) || tok_is(t, L, 0, "yes", 3) ||
                   tok_is(t, L, 0, "1", 1);
  const bool no = tok_is(t, L, 0, "f", 1) || tok_is(t, L, 0, "false", 5) ||
                  tok_is(t, L, 0, "n", 1) || tok_is(t, L, 0, "no", 2) ||
                  tok_is(t, L, 0, "0", 1);
  *out = yes;
  return yes || no;
}

// 10^e, correctly rounded (pow10.cuh); 0 below 1e-323, inf above 1e308
__device__ __forceinline__ double pow10_of(int e) {
  if (e < POW10_MIN_EXP) return 0.0;
  if (e > POW10_MAX_EXP) return __longlong_as_double(0x7ff0000000000000LL);
  return POW10[e - POW10_MIN_EXP];
}

// [+-]?digits[.digits][(e|E)[+-]digits] | inf | infinity | nan -> double:
// the reference's Horner accumulation (mant * 10 + d, two roundings: the
// build passes -fmad=false) times 10^e from the table
__device__ __forceinline__ bool parse_float(const uint8_t* __restrict__ t,
                                            int L, double* out) {
  const int c0 = lower_ascii(tok_byte(t, L, 0));
  const bool neg = c0 == '-';
  const int start = (neg || c0 == '+') ? 1 : 0;
  const bool inf_m = tok_is(t, L, start, "inf", 3) ||
                     tok_is(t, L, start, "infinity", 8);
  const bool nan_m = tok_is(t, L, start, "nan", 3);
  double mant = 0.0;
  int frac = 0, exp_val = 0;
  bool exp_neg = false, seen_digit = false, seen_dot = false;
  bool seen_exp = false, exp_seen_digit = false, bad = false;
  for (int j = start; j < L; ++j) {
    const int ch = lower_ascii(t[j]);
    const bool is_digit = ch >= '0' && ch <= '9';
    const bool is_dot = ch == '.';
    const bool is_e = ch == 'e';
    const bool is_sign = ch == '+' || ch == '-';
    const bool prev_was_e = j > 0 && lower_ascii(t[j - 1]) == 'e';
    const int d = ch - '0';
    const bool m_acc = is_digit && !seen_exp;
    if (m_acc) {
      mant = mant * 10.0;
      mant = mant + (double)d;
      if (seen_dot) ++frac;
    }
    seen_digit = seen_digit || m_acc;
    const bool e_acc = is_digit && seen_exp;
    if (e_acc) {
      const int x = exp_val * 10 + d;
      exp_val = x < 9999 ? x : 9999;
    }
    exp_seen_digit = exp_seen_digit || e_acc;
    const bool ok_dot = is_dot && !seen_dot && !seen_exp;
    const bool ok_e = is_e && seen_digit && !seen_exp;
    const bool ok_sign = is_sign && seen_exp && prev_was_e && !exp_seen_digit;
    bad = bad || !(is_digit || ok_dot || ok_e || ok_sign);
    exp_neg = exp_neg || (ch == '-' && ok_sign);
    seen_dot = seen_dot || ok_dot;
    seen_exp = seen_exp || ok_e;
  }
  bad = bad || (seen_exp && !exp_seen_digit) || !seen_digit;
  const int e = (exp_neg ? -exp_val : exp_val) - frac;
  double value = mant * pow10_of(e);
  if (inf_m) value = __longlong_as_double(0x7ff0000000000000LL);
  if (nan_m) value = __longlong_as_double(0x7ff8000000000000LL);
  *out = neg ? -value : value;
  return inf_m || nan_m || !bad;
}

// days since 1970-01-01 of a proleptic Gregorian date (Hinnant)
__device__ __forceinline__ long long days_from_civil(long long y, long long m,
                                                     long long d) {
  y -= m <= 2 ? 1 : 0;
  const long long era = fdiv(y, 400);
  const long long yoe = y - era * 400;
  const long long mp = m > 2 ? m - 3 : m + 9;
  const long long doy = fdiv(153 * mp + 2, 5) + d - 1;
  const long long doe = yoe * 365 + fdiv(yoe, 4) - fdiv(yoe, 100) + doy;
  return era * 146097 + doe - 719468;
}

__device__ __forceinline__ void civil_from_days(long long z, long long* y,
                                                int* m, int* d) {
  z += 719468;
  const long long era = fdiv(z, 146097);
  const long long doe = z - era * 146097;
  const long long yoe =
      fdiv(doe - fdiv(doe, 1460) + fdiv(doe, 36524) - fdiv(doe, 146096), 365);
  const long long doy = doe - (365 * yoe + fdiv(yoe, 4) - fdiv(yoe, 100));
  const long long mp = fdiv(5 * doy + 2, 153);
  *d = (int)(doy - fdiv(153 * mp + 2, 5) + 1);
  *m = (int)(mp < 10 ? mp + 3 : mp - 9);
  *y = yoe + era * 400 + (*m <= 2 ? 1 : 0);
}

// `count` digits at `pos`: their value (non-digits count 0) and whether
// all are digits
__device__ __forceinline__ int read_digits(const uint8_t* __restrict__ t,
                                           int L, int pos, int count,
                                           bool* ok) {
  int val = 0;
  bool all = true;
  for (int k = 0; k < count; ++k) {
    const int ch = tok_byte(t, L, pos + k);
    const bool dig = ch >= '0' && ch <= '9';
    all = all && dig;
    val = val * 10 + (dig ? ch - '0' : 0);
  }
  *ok = all;
  return val;
}

// the ISO date prefix YYYY[-MM[-DD]]: days since the epoch and whether
// it is a valid calendar date
__device__ __forceinline__ long long parse_ymd(const uint8_t* __restrict__ t,
                                               int L, bool* ok) {
  bool y_ok, m_ok, d_ok;
  const int yv = read_digits(t, L, 0, 4, &y_ok);
  const int mv = read_digits(t, L, 5, 2, &m_ok);
  const int dv = read_digits(t, L, 8, 2, &d_ok);
  const bool full = L >= 10;
  const bool ym = L == 7 || L >= 10;
  const bool sep1 = tok_byte(t, L, 4) == '-';
  const bool sep2 = tok_byte(t, L, 7) == '-';
  const int m = ym ? mv : 1;
  const int d = full ? dv : 1;
  bool good = y_ok && (L == 4 || (L == 7 && sep1 && m_ok) ||
                       (full && sep1 && sep2 && m_ok && d_ok));
  const bool leap = (yv % 4 == 0 && yv % 100 != 0) || yv % 400 == 0;
  const int mi = m - 1 < 0 ? 0 : (m - 1 > 11 ? 11 : m - 1);
  const int dim = (mi == 1 ? 28 : (mi == 3 || mi == 5 || mi == 8 ||
                                   mi == 10) ? 30 : 31) +
                  ((m == 2 && leap) ? 1 : 0);
  good = good && m >= 1 && m <= 12 && d >= 1 && d <= dim;
  *ok = good;
  return days_from_civil(yv, m, d);
}

// ISO 'YYYY[-MM[-DD]]' -> int32 days
__device__ __forceinline__ bool parse_date(const uint8_t* __restrict__ t,
                                           int L, int* out) {
  bool ok;
  *out = (int)parse_ymd(t, L, &ok);
  return ok && (L == 4 || L == 7 || L == 10);
}

// ISO 'date[ T]HH[:MM[:SS[.f{1,6}]]]' (UTC) -> int64 microseconds
__device__ __forceinline__ bool parse_timestamp(const uint8_t* __restrict__ t,
                                                int L, long long* out) {
  bool date_ok, h_ok, m_ok, s_ok;
  const long long days = parse_ymd(t, L, &date_ok);
  const bool date_only = L == 4 || L == 7 || L == 10;
  const bool has_time = L >= 13;
  const int sep = tok_byte(t, L, 10);
  const bool sep_ok = sep == ' ' || sep == 'T';
  int hv = read_digits(t, L, 11, 2, &h_ok);
  const bool has_min = L >= 16;
  const bool c13 = tok_byte(t, L, 13) == ':';
  int mv = read_digits(t, L, 14, 2, &m_ok);
  const bool has_sec = L >= 19;
  const bool c16 = tok_byte(t, L, 16) == ':';
  int sv = read_digits(t, L, 17, 2, &s_ok);
  const bool has_frac = L >= 21;
  const bool c19 = tok_byte(t, L, 19) == '.';
  const int fdig = L - 20 < 0 ? 0 : (L - 20 > 6 ? 6 : L - 20);
  int micros = 0;
  bool f_ok = true;
  // shifting by 10 on every place right-pads the fraction to 6 digits
  for (int k = 0; k < 6; ++k) {
    const int ch = tok_byte(t, L, 20 + k);
    const bool used = has_frac && k < fdig;
    const bool dig = ch >= '0' && ch <= '9';
    f_ok = f_ok && (!used || dig);
    micros = micros * 10 + ((used && dig) ? ch - '0' : 0);
  }
  const bool len_ok =
      date_only ||
      (sep_ok && (L == 13 || (L == 16 && c13) || (L == 19 && c13 && c16) ||
                  (has_frac && L <= 26 && c13 && c16 && c19)));
  const bool time_ok =
      !has_time || (h_ok && hv < 24 && (!has_min || (m_ok && mv < 60)) &&
                    (!has_sec || (s_ok && sv < 60)) && (!has_frac || f_ok));
  if (!has_time) hv = 0;
  if (!has_min) mv = 0;
  if (!has_sec) sv = 0;
  if (!has_frac) micros = 0;
  *out = days * 86400000000LL + (long long)hv * 3600000000LL +
         (long long)mv * 60000000LL + (long long)sv * 1000000LL + micros;
  return date_ok && len_ok && time_ok;
}

constexpr int FORMAT_INT_WIDTH = 20;
constexpr int FORMAT_BOOL_WIDTH = 5;
constexpr int FORMAT_DATE_WIDTH = 10;
constexpr int FORMAT_TIMESTAMP_WIDTH = 26;

// int64 -> left-aligned decimal in 20 bytes; returns the length
__device__ __forceinline__ int format_int(long long v, bool valid,
                                          uint8_t* __restrict__ out) {
  int n = 0;
  if (valid) {
    const bool neg = v < 0;
    unsigned long long mag =
        neg ? 0ULL - (unsigned long long)v : (unsigned long long)v;
    int ndig = 1;
    for (unsigned long long p = 10; ndig < 19 && mag >= p; p *= 10) ++ndig;
    n = ndig + (neg ? 1 : 0);
    for (int q = n - 1; q >= (neg ? 1 : 0); --q) {
      out[q] = (uint8_t)('0' + mag % 10);
      mag /= 10;
    }
    if (neg) out[0] = '-';
  }
  for (int q = n; q < FORMAT_INT_WIDTH; ++q) out[q] = 0;
  return n;
}

__device__ __forceinline__ int format_bool(bool v, bool valid,
                                           uint8_t* __restrict__ out) {
  const char* s = v ? "true" : "false";
  const int n = valid ? (v ? 4 : 5) : 0;
  for (int q = 0; q < FORMAT_BOOL_WIDTH; ++q)
    out[q] = q < n ? (uint8_t)s[q] : (uint8_t)0;
  return n;
}

__device__ __forceinline__ void put2(uint8_t* __restrict__ out, int v) {
  out[0] = (uint8_t)('0' + v / 10);
  out[1] = (uint8_t)('0' + v % 10);
}

// 'YYYY-MM-DD', the year clamped to 0..9999 as the reference does
__device__ __forceinline__ void put_ymd(uint8_t* __restrict__ out,
                                        long long days) {
  long long y;
  int m, d;
  civil_from_days(days, &y, &m, &d);
  const int yy = (int)(y < 0 ? 0 : (y > 9999 ? 9999 : y));
  put2(out, yy / 100);
  put2(out + 2, yy % 100);
  out[4] = '-';
  put2(out + 5, m);
  out[7] = '-';
  put2(out + 8, d);
}

__device__ __forceinline__ int format_date(int days, bool valid,
                                           uint8_t* __restrict__ out) {
  if (!valid) {
    for (int q = 0; q < FORMAT_DATE_WIDTH; ++q) out[q] = 0;
    return 0;
  }
  put_ymd(out, days);
  return FORMAT_DATE_WIDTH;
}

// 'YYYY-MM-DD HH:MM:SS.ffffff' of microseconds since the epoch (UTC)
__device__ __forceinline__ int format_timestamp(long long us, bool valid,
                                                uint8_t* __restrict__ out) {
  if (!valid) {
    for (int q = 0; q < FORMAT_TIMESTAMP_WIDTH; ++q) out[q] = 0;
    return 0;
  }
  const long long days = fdiv(us, 86400000000LL);
  // wraps where days * 86400000000 leaves the int64 range, as numpy does;
  // the difference is the exact remainder in [0, 86400000000)
  const long long rem = (long long)((unsigned long long)us -
                                    (unsigned long long)days *
                                        86400000000ULL);
  put_ymd(out, days);
  out[10] = ' ';
  put2(out + 11, (int)(rem / 3600000000LL));
  out[13] = ':';
  put2(out + 14, (int)(rem / 60000000LL % 60));
  out[16] = ':';
  put2(out + 17, (int)(rem / 1000000LL % 60));
  out[19] = '.';
  int f = (int)(rem % 1000000LL);
  for (int q = 25; q >= 20; --q) {
    out[q] = (uint8_t)('0' + f % 10);
    f /= 10;
  }
  return FORMAT_TIMESTAMP_WIDTH;
}

}  // namespace srt
