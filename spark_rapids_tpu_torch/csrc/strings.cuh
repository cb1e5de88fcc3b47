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
//
// Semantics are the reference's: an empty needle matches (locate_from
// then returns the start position, 1-based, while it lies inside the
// matrix), a needle wider than the matrix never matches, a match must
// end at or before the row's length, positions are byte positions.
#pragma once

#include <stdint.h>

#include "common.cuh"

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

}  // namespace srt
