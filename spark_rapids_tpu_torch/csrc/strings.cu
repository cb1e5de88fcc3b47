// K8 — string comparison of byte matrices.
//
// Replaces spark_rapids_tpu/ops/kernels/stringkernels.py:equals (58) and
// compare (36), with the padding rule of _pad_to (18) and _masked (28):
// bytes at or past a row's length count as 0, and the narrower matrix is
// padded with zeros to the wider width.  equals gives bool; compare gives
// int32 in {-1, 0, 1}: the first differing byte among the positions both
// rows cover decides (unsigned, i.e. UTF-8 binary order), else the
// lengths do.  Either side may be a one-row literal, read with a row
// stride of 0, so a literal is never copied n times.
//
// Bound on this card: bytes.  For Q3's customer filter (150,000 rows of
// a 10-byte c_mktsegment matrix against an 8-byte literal) the function
// reads 10 + 4 bytes and writes 1 byte a row: 2.25 MB, 0.7 us at
// 3.35 TB/s — far below a launch, so the kernel is launch-bound.  Design:
// one thread per row, a byte loop over the row (rows are at most tens of
// bytes wide on this path), loads through the read-only cache, no shared
// memory.  A warp-per-row variant for wide matrices is left for later.
#include "common.cuh"

namespace {

using srt::BLOCK;

__device__ __forceinline__ int byte_at(const uint8_t* __restrict__ bm,
                                       long long row_off, int w, int len,
                                       int pos) {
  return (pos < w && pos < len) ? (int)bm[row_off + pos] : 0;
}

// mode 0: equals -> bool out; mode 1: compare -> int32 out
__global__ void str_cmp(const uint8_t* __restrict__ lbm,
                        const int* __restrict__ llen, int lw, int lstride,
                        const uint8_t* __restrict__ rbm,
                        const int* __restrict__ rlen, int rw, int rstride,
                        long long n, int mode, void* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long lrow = lstride ? i : 0;
  const long long rrow = rstride ? i : 0;
  const int ln = llen[lrow];
  const int rn = rlen[rrow];
  const long long lo = lrow * (long long)lw;
  const long long ro = rrow * (long long)rw;
  const int w = lw > rw ? lw : rw;
  if (mode == 0) {
    bool eq = ln == rn;
    for (int p = 0; eq && p < w; ++p)
      eq = byte_at(lbm, lo, lw, ln, p) == byte_at(rbm, ro, rw, rn, p);
    ((bool*)out)[i] = eq;
    return;
  }
  const int both = ln < rn ? ln : rn;
  int d = 0;
  int first = w;
  for (int p = 0; p < w && p < both; ++p) {
    d = byte_at(lbm, lo, lw, ln, p) - byte_at(rbm, ro, rw, rn, p);
    if (d != 0) { first = p; break; }
  }
  int r;
  if (first < both) {
    r = d < 0 ? -1 : 1;
  } else if (w < both) {
    // lengths past the matrix width: the reference reads the (zero)
    // difference at the last column, so the result is 0
    r = 0;
  } else {
    r = ln < rn ? -1 : (ln > rn ? 1 : 0);
  }
  ((int*)out)[i] = r;
}

}  // namespace

// lstride / rstride: 1 for a matrix with one row per output row, 0 for a
// one-row literal; mode 0 = equals (bool out), 1 = compare (int32 out)
SRT_API int k8_string_compare(const void* lbm, const void* llen, int lw,
                              int lstride, const void* rbm, const void* rlen,
                              int rw, int rstride, long long n, int mode,
                              void* out, void* stream) {
  str_cmp<<<srt::blocks_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)lbm, (const int*)llen, lw, lstride,
      (const uint8_t*)rbm, (const int*)rlen, rw, rstride, n, mode, out);
  return (int)cudaGetLastError();
}
