// K15 — substring of a byte matrix.
//
// Replaces spark_rapids_tpu/ops/kernels/stringkernels.py:substring (93),
// which ops/stringexprs.py:Substring (156-197) runs: for each row of
// (uint8[n, w] bytes, int32[n] lengths), with a 0-based start (negative:
// from the end) and a byte count, the row's bytes [s, e) go to an out_w
// wide row, zero past e - s (the zero bytes later K8 and K1 passes read),
// and e - s to the new lengths.  The row arithmetic is strings.cuh's
// str_substring, which K12 inlines when a Substring sits in a fused
// segment.
//
// Bound on this card: bytes.  Each row reads its length and at most out_w
// bytes of its row, and writes out_w bytes and a length: at Q22's
// customer table (262,144 padded rows, c_phone 15 bytes wide, out_w 2)
// at most (4 + 15) + (2 + 4) bytes a row, ~6.6 MB, ~2 us at 3.35 TB/s,
// far below a launch.  Design: one thread per output byte, grid-strided,
// so neighbouring threads write neighbouring bytes and read neighbouring
// bytes of a row; when out_w is at most 4 one thread writes a whole row
// (a thread per byte would recompute the row's bounds out_w times for
// one or two bytes).  No shared memory, no fallback.
#include "strings.cuh"

namespace {

using srt::BLOCK;

constexpr unsigned MAX_BLOCKS = 65535;

// one thread per output byte
__global__ void substring_bytes(const uint8_t* __restrict__ bm,
                                const int* __restrict__ lengths, int w,
                                long long n, int start, int sub_len,
                                int out_w, uint8_t* __restrict__ out,
                                int* __restrict__ out_len) {
  const long long total = n * (long long)out_w;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / out_w;
    const int q = (int)(i - row * out_w);
    int s;
    const int nl = srt::str_substring(lengths[row], start, sub_len, &s);
    out[i] = q < nl ? bm[row * (long long)w + s + q] : (uint8_t)0;
    if (q == 0) out_len[row] = nl;
  }
}

// one thread per row (out_w <= 4)
__global__ void substring_rows(const uint8_t* __restrict__ bm,
                               const int* __restrict__ lengths, int w,
                               long long n, int start, int sub_len,
                               int out_w, uint8_t* __restrict__ out,
                               int* __restrict__ out_len) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    int s;
    const int nl = srt::str_substring(lengths[row], start, sub_len, &s);
    const uint8_t* src = bm + row * (long long)w + s;
    uint8_t* dst = out + row * (long long)out_w;
    for (int q = 0; q < out_w; ++q) dst[q] = q < nl ? src[q] : (uint8_t)0;
    out_len[row] = nl;
  }
}

unsigned grid_for(long long items) {
  const long long b = (items + BLOCK - 1) / BLOCK;
  return (unsigned)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

}  // namespace

// start: 0-based (negative counts from the end), sub_len >= 0 bytes,
// out_w >= 1 columns of out; out_len gets the new lengths
SRT_API int k15_substring(const void* bm, const void* lengths, int w,
                          long long n, int start, int sub_len, int out_w,
                          void* out, void* out_len, void* stream) {
  if (out_w < 1 || w < 1) return (int)cudaErrorInvalidValue;
  if (out_w <= 4)
    substring_rows<<<grid_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)bm, (const int*)lengths, w, n, start, sub_len,
        out_w, (uint8_t*)out, (int*)out_len);
  else
    substring_bytes<<<grid_for(n * (long long)out_w), BLOCK, 0,
                      (cudaStream_t)stream>>>(
        (const uint8_t*)bm, (const int*)lengths, w, n, start, sub_len,
        out_w, (uint8_t*)out, (int*)out_len);
  return (int)cudaGetLastError();
}
