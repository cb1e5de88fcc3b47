// K5 — join group ids and probe.
//
// Replaces spark_rapids_tpu/ops/kernels/join.py:group_ids (53, with
// _concat_key_cols at 32) and probe (89).  The stable sort of the
// concatenated keys, the sort of the right ids, and the segment ids are
// K1 and K2 (ops/kernels/segment.py); this file holds the rest:
//
//   k5_ok          row eligibility: side row mask AND every key's validity
//                  (rows with a null key or padding never join)
//   k5_concat      row-concatenation of one key array of both sides (byte
//                  matrices widen to the wider side with zero bytes)
//   k5_scatter_ids segment ids in sorted order back to row order, with the
//                  sentinels -1 (left) / -2 (right) on ineligible rows
//   k5_search      per left row, lower and upper bound of its id in the
//                  sorted right ids: lo and cnt = hi - lo
//   k5_has_r       per right row, whether any left row has its id (only
//                  right and full joins ask for it)
//
// has_r: the reference searches the sorted left ids; here each left id
// marks its group in a flag array and each right row reads its group's
// flag.  Ids are dense in [0, nl + nr), so the flags need no hashing and
// no sort of the left ids, and the result is the same boolean.
//
// Bound on this card: bytes.  At Q3's second join (262,144 left and
// 4,194,304 right padded rows, int64 keys) the functions of this file
// read the keys, masks and ids and write the ids, lo, cnt and has_r:
// about (8 + 1 + 1) B a row for the concatenation, 4 + 4 + 1 B for the
// scatter, 4 + 8 B a left row and 4 + 1 + 1 B a right row for the probe
// and the flags — some 100 MB in all, ~30 us at 3.35 TB/s.  Design: one
// thread per row in every kernel; the binary searches touch log2(nr) ~ 22
// ids a left row, which stay in the 50 MB L2; the scatter writes through
// the sort permutation (random 4-byte stores), which is the cost to beat.
#include "common.cuh"

namespace {

using srt::BLOCK;

__global__ void row_ok(const bool* __restrict__ l_ok,
                       const bool* __restrict__ l_valid, long long nl,
                       const bool* __restrict__ r_ok,
                       const bool* __restrict__ r_valid, long long nr,
                       int first, bool* __restrict__ ok) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nl + nr) return;
  const bool v = i < nl ? l_valid[i] : r_valid[i - nl];
  if (first) {
    ok[i] = v && (i < nl ? l_ok[i] : r_ok[i - nl]);
  } else {
    ok[i] = ok[i] && v;
  }
}

template <typename E>
__global__ void concat_elems(const E* __restrict__ l, long long nl,
                             const E* __restrict__ r, long long nr,
                             E* __restrict__ dst) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nl + nr) return;
  dst[i] = i < nl ? l[i] : r[i - nl];
}

__global__ void concat_bytes(const uint8_t* __restrict__ l, long long nl,
                             int lw, const uint8_t* __restrict__ r,
                             long long nr, int rw, int w,
                             uint8_t* __restrict__ dst) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nl + nr) return;
  const bool left = i < nl;
  const int sw = left ? lw : rw;
  const uint8_t* s = left ? l + i * (long long)lw : r + (i - nl) * (long long)rw;
  uint8_t* d = dst + i * (long long)w;
  for (int j = 0; j < w; ++j) d[j] = j < sw ? s[j] : 0;
}

__global__ void scatter_ids(const int* __restrict__ order,
                            const int* __restrict__ ids_sorted,
                            const bool* __restrict__ ok, long long n,
                            long long nl, int* __restrict__ gl,
                            int* __restrict__ gr) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const long long row = order[p];
  const bool good = ok[row];
  if (row < nl) {
    gl[row] = good ? ids_sorted[p] : -1;
  } else {
    gr[row - nl] = good ? ids_sorted[p] : -2;
  }
}

__global__ void search_left(const int* __restrict__ gl, long long nl,
                            const int* __restrict__ sorted_gr, long long nr,
                            int* __restrict__ lo, int* __restrict__ cnt) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nl) return;
  const int g = gl[i];
  const long long a = srt::lower_bound(sorted_gr, nr, g);
  const long long b = srt::upper_bound(sorted_gr, nr, g);
  lo[i] = (int)a;
  cnt[i] = (int)(b - a);
}

__global__ void zero_flags(uint8_t* __restrict__ f, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) f[i] = 0;
}

__global__ void mark_left(const int* __restrict__ gl, long long nl,
                          uint8_t* __restrict__ seen) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nl) return;
  const int g = gl[i];
  if (g >= 0) seen[g] = 1;  // every writer stores the same value
}

__global__ void right_has_left(const int* __restrict__ gr, long long nr,
                               const uint8_t* __restrict__ seen,
                               bool* __restrict__ has_r) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nr) return;
  const int g = gr[j];
  has_r[j] = g >= 0 && seen[g] != 0;
}

}  // namespace

// first != 0: ok = side mask AND this key's validity; else ok &= validity
SRT_API int k5_ok(const void* l_ok, const void* l_valid, long long nl,
                  const void* r_ok, const void* r_valid, long long nr,
                  int first, void* ok, void* stream) {
  row_ok<<<srt::blocks_for(nl + nr, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
      (const bool*)l_ok, (const bool*)l_valid, nl, (const bool*)r_ok,
      (const bool*)r_valid, nr, first, (bool*)ok);
  return (int)cudaGetLastError();
}

// lw / rw: bytes a row of each side (element size, or matrix width);
// w: bytes a row of dst (>= both; equal to them for 1-D arrays)
SRT_API int k5_concat(const void* l, long long nl, int lw, const void* r,
                      long long nr, int rw, int w, void* dst, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = srt::blocks_for(nl + nr, BLOCK);
  if (lw == w && rw == w && (w == 1 || w == 2 || w == 4 || w == 8)) {
    switch (w) {
      case 1:
        concat_elems<uint8_t><<<g, BLOCK, 0, st>>>(
            (const uint8_t*)l, nl, (const uint8_t*)r, nr, (uint8_t*)dst);
        break;
      case 2:
        concat_elems<uint16_t><<<g, BLOCK, 0, st>>>(
            (const uint16_t*)l, nl, (const uint16_t*)r, nr, (uint16_t*)dst);
        break;
      case 4:
        concat_elems<uint32_t><<<g, BLOCK, 0, st>>>(
            (const uint32_t*)l, nl, (const uint32_t*)r, nr, (uint32_t*)dst);
        break;
      default:
        concat_elems<unsigned long long><<<g, BLOCK, 0, st>>>(
            (const unsigned long long*)l, nl, (const unsigned long long*)r,
            nr, (unsigned long long*)dst);
    }
  } else {
    concat_bytes<<<g, BLOCK, 0, st>>>((const uint8_t*)l, nl, lw,
                                      (const uint8_t*)r, nr, rw, w,
                                      (uint8_t*)dst);
  }
  return (int)cudaGetLastError();
}

// order: the sort permutation of the n = nl + nr concatenated rows;
// ids_sorted: their segment ids in sorted order; ok: eligibility by row
SRT_API int k5_scatter_ids(const void* order, const void* ids_sorted,
                           const void* ok, long long n, long long nl,
                           void* gl, void* gr, void* stream) {
  scatter_ids<<<srt::blocks_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)order, (const int*)ids_sorted, (const bool*)ok, n, nl,
      (int*)gl, (int*)gr);
  return (int)cudaGetLastError();
}

SRT_API int k5_search(const void* gl, long long nl, const void* sorted_gr,
                      long long nr, void* lo, void* cnt, void* stream) {
  search_left<<<srt::blocks_for(nl, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)gl, nl, (const int*)sorted_gr, nr, (int*)lo, (int*)cnt);
  return (int)cudaGetLastError();
}

// seen: scratch uint8[nl + nr] (group ids are below nl + nr)
SRT_API int k5_has_r(const void* gl, long long nl, const void* gr,
                     long long nr, void* seen, void* has_r, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  zero_flags<<<srt::blocks_for(nl + nr, BLOCK), BLOCK, 0, st>>>(
      (uint8_t*)seen, nl + nr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mark_left<<<srt::blocks_for(nl, BLOCK), BLOCK, 0, st>>>((const int*)gl, nl,
                                                          (uint8_t*)seen);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  right_has_left<<<srt::blocks_for(nr, BLOCK), BLOCK, 0, st>>>(
      (const int*)gr, nr, (const uint8_t*)seen, (bool*)has_r);
  return (int)cudaGetLastError();
}
