// K19 — ASCII case maps and character length over byte matrices.
//
// Replaces spark_rapids_tpu/ops/kernels/stringkernels.py:_case_map (66),
// upper (73) and lower (79), which ops/stringexprs.py's Upper and Lower
// run, and length (83), which Length runs.  A row is (uint8[n, w] bytes,
// int32 lengths).  The case map writes each byte below the length with
// an ASCII letter of the other case moved by 32 and every byte at or past
// the length as 0 (the reference masks the row first); the lengths are
// unchanged.  Length counts the bytes below the length that do not
// continue a UTF-8 sequence ((b & 0xC0) != 0x80), NUL bytes included.
// The row arithmetic is strings.cuh's case_map and str_length, which K12
// inlines when Upper, Lower or Length sit in a fused segment.
//
// Bound on this card: bytes.  The case map reads each row's bytes and
// length and writes the bytes: for orders' comment key (1,500,000 padded
// to 2,097,152 rows of ~100 bytes) ~0.42 GB, ~0.13 ms at 3.35 TB/s.
// Length reads the bytes and writes 4 bytes a row.  Design: the case
// map runs one thread per byte, grid-strided, so neighbouring threads
// read and write neighbouring bytes (coalesced); length runs one thread a
// row (a row's count is a serial sum; the reads are strided, as K13's).
#include "strings.cuh"

namespace {

using srt::BLOCK;

constexpr unsigned MAX_BLOCKS = 65535;

unsigned grid_for(long long items) {
  const long long b = (items + BLOCK - 1) / BLOCK;
  return (unsigned)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

// one thread per byte
__global__ void case_map_bytes(const uint8_t* __restrict__ bm,
                               const int* __restrict__ lengths, int w,
                               long long n, int mode,
                               uint8_t* __restrict__ out) {
  const long long total = n * (long long)w;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / w;
    const int q = (int)(i - row * w);
    out[i] = q < lengths[row] ? srt::case_map(bm[i], mode) : (uint8_t)0;
  }
}

// one thread per row
__global__ void length_rows(const uint8_t* __restrict__ bm,
                            const int* __restrict__ lengths, int w,
                            long long n, int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride)
    out[row] = srt::str_length(bm + row * (long long)w, w, lengths[row]);
}

}  // namespace

// mode 0 upper, 1 lower: out uint8[n, w]
SRT_API int k19_case_map(const void* bm, const void* lengths, int w,
                         long long n, int mode, void* out, void* stream) {
  if (w < 1 || (mode != srt::CASE_UPPER && mode != srt::CASE_LOWER))
    return (int)cudaErrorInvalidValue;
  case_map_bytes<<<grid_for(n * (long long)w), BLOCK, 0,
                   (cudaStream_t)stream>>>(
      (const uint8_t*)bm, (const int*)lengths, w, n, mode, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// out int32[n]: the characters of each row
SRT_API int k19_length(const void* bm, const void* lengths, int w,
                       long long n, void* out, void* stream) {
  if (w < 1) return (int)cudaErrorInvalidValue;
  length_rows<<<grid_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bm, (const int*)lengths, w, n, (int*)out);
  return (int)cudaGetLastError();
}
