// Typed loads, stores and conversions between the dtype codes of
// common.cuh, as torch's Tensor.to converts: integers wrap (two's
// complement truncation), an integer or bool to a float rounds once, a
// float to an integer truncates toward zero, anything to bool is != 0.
// K22 (generate.cu) and K23 (expand.cu) convert element and expand
// columns to their field's type with these.
#pragma once

#include "common.cuh"

namespace srt {

__device__ __forceinline__ bool is_float_code(int code) {
  return code == DT_F32 || code == DT_F64;
}

__device__ __forceinline__ int code_bytes(int code) {
  switch (code) {
    case DT_I16: return 2;
    case DT_I32: case DT_F32: return 4;
    case DT_I64: case DT_F64: return 8;
    default: return 1;  // bool, int8, uint8
  }
}

__device__ __forceinline__ long long load_int(const uint8_t* p, int code) {
  switch (code) {
    case DT_BOOL: return *(const bool*)p ? 1 : 0;
    case DT_I8: return *(const int8_t*)p;
    case DT_I16: return *(const int16_t*)p;
    case DT_I32: return *(const int32_t*)p;
    case DT_U8: return *(const uint8_t*)p;
    default: return *(const long long*)p;
  }
}

__device__ __forceinline__ double load_double(const uint8_t* p, int code) {
  return code == DT_F32 ? (double)*(const float*)p : *(const double*)p;
}

// the value at `src` (type `sc`) written at `dst` as type `dc`
__device__ __forceinline__ void convert_value(const uint8_t* src, int sc,
                                              uint8_t* dst, int dc) {
  if (sc == dc) {
    switch (code_bytes(dc)) {
      case 8: *(long long*)dst = *(const long long*)src; return;
      case 4: *(int32_t*)dst = *(const int32_t*)src; return;
      case 2: *(int16_t*)dst = *(const int16_t*)src; return;
      default: *dst = *src; return;
    }
  }
  const bool sf = is_float_code(sc);
  switch (dc) {
    case DT_F64:
      *(double*)dst = sf ? load_double(src, sc) : (double)load_int(src, sc);
      return;
    case DT_F32:
      *(float*)dst = sf ? (float)load_double(src, sc)
                        : (float)load_int(src, sc);
      return;
    case DT_BOOL:
      *(bool*)dst = sf ? load_double(src, sc) != 0.0 : load_int(src, sc) != 0;
      return;
    default: {
      const long long v = sf ? (long long)load_double(src, sc)
                             : load_int(src, sc);
      switch (dc) {
        case DT_I8: *(int8_t*)dst = (int8_t)v; return;
        case DT_U8: *(uint8_t*)dst = (uint8_t)v; return;
        case DT_I16: *(int16_t*)dst = (int16_t)v; return;
        case DT_I32: *(int32_t*)dst = (int32_t)v; return;
        default: *(long long*)dst = v; return;
      }
    }
  }
}

}  // namespace srt
