// K17 — formats into a byte matrix: the integer / boolean / date /
// timestamp -> string directions of Cast.
//
// Replaces spark_rapids_tpu/ops/kernels/castkernels.py:format_int (359),
// format_bool (390), format_date (407) and format_timestamp (426), which
// ops/cast.py:_device_cast_to_string runs: each row's value becomes its
// text (Python's str(int); 'true'/'false'; 'YYYY-MM-DD' with the year
// clamped to 0..9999; 'YYYY-MM-DD HH:MM:SS.ffffff') in a uint8[n, 20 / 5
// / 10 / 26] matrix, left-aligned, with its length.  Every row is written
// whole: the text, then zero bytes; a null row is all zeros with length 0
// (the reference leaves the digits there behind a length of 0).  The row
// functions are strings.cuh's, which K12 inlines when a Cast sits in a
// fused segment.
//
// Bound on this card: bytes.  For TPC-H lineitem's l_orderkey (int64) at
// 8,388,608 padded rows the function reads 8 + 1 and writes 20 + 4 bytes
// a row: ~277 MB, ~83 us at 3.35 TB/s.  Design: one thread per row,
// grid-strided, writing its row's bytes in order (strided across the
// warp); the digits come from 64-bit division by 10, the calendar from
// the civil-from-days integer arithmetic with flooring divisions.  No
// shared memory.
#include "strings.cuh"

namespace {

using srt::BLOCK;

constexpr unsigned MAX_BLOCKS = 65535;

unsigned grid_for(long long items) {
  const long long b = (items + BLOCK - 1) / BLOCK;
  return (unsigned)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

enum Kind { INT = 0, BOOL = 1, DATE = 2, TIMESTAMP = 3 };

template <int K, class T, int W>
__global__ void format_rows(const T* __restrict__ values,
                            const bool* __restrict__ validity, long long n,
                            uint8_t* __restrict__ out,
                            int* __restrict__ out_len) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    uint8_t* o = out + row * (long long)W;
    const bool valid = validity[row];
    int len;
    if constexpr (K == INT) len = srt::format_int(values[row], valid, o);
    else if constexpr (K == BOOL) len = srt::format_bool(values[row], valid, o);
    else if constexpr (K == DATE) len = srt::format_date(values[row], valid, o);
    else len = srt::format_timestamp(values[row], valid, o);
    out_len[row] = len;
  }
}

template <int K, class T, int W>
int launch(const void* values, const void* validity, long long n, void* out,
           void* out_len, void* stream) {
  format_rows<K, T, W><<<grid_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const T*)values, (const bool*)validity, n, (uint8_t*)out,
      (int*)out_len);
  return (int)cudaGetLastError();
}

}  // namespace

// each: values[n] (int64 / bool / int32 days / int64 us), validity
// bool[n] -> out uint8[n, 20 / 5 / 10 / 26], out_len int32[n]
SRT_API int k17_format_int(const void* values, const void* validity,
                           long long n, void* out, void* out_len,
                           void* stream) {
  return launch<INT, long long, srt::FORMAT_INT_WIDTH>(values, validity, n,
                                                       out, out_len, stream);
}

SRT_API int k17_format_bool(const void* values, const void* validity,
                            long long n, void* out, void* out_len,
                            void* stream) {
  return launch<BOOL, bool, srt::FORMAT_BOOL_WIDTH>(values, validity, n, out,
                                                    out_len, stream);
}

SRT_API int k17_format_date(const void* values, const void* validity,
                            long long n, void* out, void* out_len,
                            void* stream) {
  return launch<DATE, int, srt::FORMAT_DATE_WIDTH>(values, validity, n, out,
                                                   out_len, stream);
}

SRT_API int k17_format_timestamp(const void* values, const void* validity,
                                 long long n, void* out, void* out_len,
                                 void* stream) {
  return launch<TIMESTAMP, long long, srt::FORMAT_TIMESTAMP_WIDTH>(
      values, validity, n, out, out_len, stream);
}
