// K16 — string parses of a byte matrix: the string -> number / boolean /
// date / timestamp directions of Cast.
//
// Replaces spark_rapids_tpu/ops/kernels/castkernels.py:trim_aligned (35),
// parse_int (61), parse_bool (101), parse_float (124), parse_date (285)
// and parse_timestamp (295), which ops/cast.py:_device_cast_from_string
// runs: each row of (uint8[n, w] bytes, int32[n] lengths, bool[n]
// validity) is trimmed of ASCII whitespace and parsed; the data and
// validity (input valid and the token well formed) are written.  The
// reference unrolls a static loop over the w byte columns for every row;
// here a thread walks its own token and stops at its end.  The row
// functions are strings.cuh's, which K12 inlines when a Cast sits in a
// fused segment.
//
// Bound on this card: bytes.  At TPC-H lineitem's text columns (6,000,000
// rows; 7 to 10 bytes wide) a parse reads w + 4 + 1 bytes and writes 9 or
// 5 a row: l_extendedprice (9 bytes) ~138 MB at two partitions' padded
// 8,388,608 rows, ~41 us at 3.35 TB/s.  Design: one thread per row,
// grid-strided; the token is trimmed in place (a start and a length, no
// copy); a thread reads its row's bytes one by one (strided across the
// warp, as K8 and K13 read theirs).  No shared memory.  The float parse's
// 10^e comes from the table of pow10.cuh, not from pow (documented error
// up to 2 ULP), so the kernel and its plain version agree bit for bit.
#include "strings.cuh"

namespace {

using srt::BLOCK;

constexpr unsigned MAX_BLOCKS = 65535;

unsigned grid_for(long long items) {
  const long long b = (items + BLOCK - 1) / BLOCK;
  return (unsigned)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

enum Kind { INT = 0, BOOL = 1, FLOAT = 2, DATE = 3, TIMESTAMP = 4 };

template <int K, class T>
__global__ void parse_rows(const uint8_t* __restrict__ bm,
                           const int* __restrict__ lengths,
                           const bool* __restrict__ validity, int w,
                           long long n, T* __restrict__ out,
                           bool* __restrict__ ok) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    const uint8_t* r = bm + row * (long long)w;
    int start;
    const int len = srt::str_trim(r, w, lengths[row], &start);
    const uint8_t* t = r + start;
    T v;
    bool good;
    if constexpr (K == INT) good = srt::parse_int(t, len, &v);
    else if constexpr (K == BOOL) good = srt::parse_bool(t, len, &v);
    else if constexpr (K == FLOAT) good = srt::parse_float(t, len, &v);
    else if constexpr (K == DATE) good = srt::parse_date(t, len, &v);
    else good = srt::parse_timestamp(t, len, &v);
    out[row] = v;
    ok[row] = validity[row] && good;
  }
}

// the trimmed token, left-aligned, zeros past its length
__global__ void trim_rows(const uint8_t* __restrict__ bm,
                          const int* __restrict__ lengths, int w,
                          long long n, uint8_t* __restrict__ out,
                          int* __restrict__ out_len) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    const uint8_t* r = bm + row * (long long)w;
    uint8_t* o = out + row * (long long)w;
    int start;
    const int len = srt::str_trim(r, w, lengths[row], &start);
    for (int q = 0; q < w; ++q) o[q] = q < len ? r[start + q] : (uint8_t)0;
    out_len[row] = len;
  }
}

template <int K, class T>
int launch(const void* bm, const void* lengths, const void* validity, int w,
           long long n, void* out, void* ok, void* stream) {
  if (w < 1) return (int)cudaErrorInvalidValue;
  parse_rows<K, T><<<grid_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bm, (const int*)lengths, (const bool*)validity, w, n,
      (T*)out, (bool*)ok);
  return (int)cudaGetLastError();
}

}  // namespace

// each: bm uint8[n, w], lengths int32[n], validity bool[n] -> out[n] (the
// type of the name), ok bool[n]
SRT_API int k16_parse_int(const void* bm, const void* lengths,
                          const void* validity, int w, long long n, void* out,
                          void* ok, void* stream) {
  return launch<INT, long long>(bm, lengths, validity, w, n, out, ok, stream);
}

SRT_API int k16_parse_bool(const void* bm, const void* lengths,
                           const void* validity, int w, long long n,
                           void* out, void* ok, void* stream) {
  return launch<BOOL, bool>(bm, lengths, validity, w, n, out, ok, stream);
}

SRT_API int k16_parse_float(const void* bm, const void* lengths,
                            const void* validity, int w, long long n,
                            void* out, void* ok, void* stream) {
  return launch<FLOAT, double>(bm, lengths, validity, w, n, out, ok, stream);
}

SRT_API int k16_parse_date(const void* bm, const void* lengths,
                           const void* validity, int w, long long n,
                           void* out, void* ok, void* stream) {
  return launch<DATE, int>(bm, lengths, validity, w, n, out, ok, stream);
}

SRT_API int k16_parse_timestamp(const void* bm, const void* lengths,
                                const void* validity, int w, long long n,
                                void* out, void* ok, void* stream) {
  return launch<TIMESTAMP, long long>(bm, lengths, validity, w, n, out, ok,
                                      stream);
}

// bm uint8[n, w], lengths int32[n] -> out uint8[n, w], out_len int32[n]
SRT_API int k16_trim(const void* bm, const void* lengths, int w, long long n,
                     void* out, void* out_len, void* stream) {
  if (w < 1) return (int)cudaErrorInvalidValue;
  trim_rows<<<grid_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bm, (const int*)lengths, w, n, (uint8_t*)out,
      (int*)out_len);
  return (int)cudaGetLastError();
}
