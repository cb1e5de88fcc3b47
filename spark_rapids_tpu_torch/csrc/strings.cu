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
// The row functions are strings.cuh's, shared with K12 and K13.
#include "strings.cuh"

namespace {

using srt::BLOCK;

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
  const uint8_t* l = lbm + lrow * (long long)lw;
  const uint8_t* r = rbm + rrow * (long long)rw;
  if (mode == 0)
    ((bool*)out)[i] = srt::str_equals(l, lw, llen[lrow], r, rw, rlen[rrow]);
  else
    ((int*)out)[i] = srt::str_compare(l, lw, llen[lrow], r, rw, rlen[rrow]);
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
