// Row rules of key equality, shared by K2 (segment_ids.cu: neighbours in
// sorted order) and K5 (join_probe.cu: k5_ids, neighbours in sorted order
// read through the sort permutation).  Spark's rules: NaN equals NaN,
// -0.0 equals 0.0, strings compare their bytes and their lengths.  Null
// rows are the caller's: a value difference counts only where both rows
// are valid.
#pragma once

#include "common.cuh"

namespace srt {

template <typename T>
__device__ __forceinline__ bool differs(T a, T b) {
  return a != b;
}
template <>
__device__ __forceinline__ bool differs<float>(float a, float b) {
  return !(a == b) && !(a != a && b != b);
}
template <>
__device__ __forceinline__ bool differs<double>(double a, double b) {
  return !(a == b) && !(a != a && b != b);
}

// rows a and b of a byte matrix of width w (zero-padded) with lengths
__device__ __forceinline__ bool bytes_differ(const uint8_t* __restrict__ bytes,
                                             const int* __restrict__ lengths,
                                             int w, long long a,
                                             long long b) {
  if (lengths[a] != lengths[b]) return true;
  const uint8_t* x = bytes + a * (long long)w;
  const uint8_t* y = bytes + b * (long long)w;
  for (int j = 0; j < w; ++j)
    if (x[j] != y[j]) return true;
  return false;
}

// rows a and b of one key column: a byte matrix where w > 0, else an
// array of the dtype code's type (common.cuh)
__device__ __forceinline__ bool column_differs(const void* data, int dtype,
                                               int w, const int* lengths,
                                               long long a, long long b) {
  if (w > 0) return bytes_differ((const uint8_t*)data, lengths, w, a, b);
  switch (dtype) {
    case DT_I16:
      return differs(((const int16_t*)data)[a], ((const int16_t*)data)[b]);
    case DT_I32:
      return differs(((const int32_t*)data)[a], ((const int32_t*)data)[b]);
    case DT_I64:
      return differs(((const long long*)data)[a],
                     ((const long long*)data)[b]);
    case DT_F32:
      return differs(((const float*)data)[a], ((const float*)data)[b]);
    case DT_F64:
      return differs(((const double*)data)[a], ((const double*)data)[b]);
    default:  // DT_BOOL, DT_I8, DT_U8
      return differs(((const uint8_t*)data)[a], ((const uint8_t*)data)[b]);
  }
}

}  // namespace srt
