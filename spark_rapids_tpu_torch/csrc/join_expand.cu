// K6 — join emit counts and pair expansion.
//
// Replaces spark_rapids_tpu/ops/kernels/join.py:emit_counts (105) and
// expand_pairs (126):
//
//   k6_emit   per left row the rows it emits (inner/semi: its match count;
//             left/full: at least 1 on logical rows; 0 on padding), and
//             for right/full only, the mask of logical right rows without a
//             match (other join types neither read has_r nor write a mask)
//   k6_scan   the int64 inclusive prefix sum of the emit counts (three
//             launches: tile sums, one-block scan of the tile sums, per-row
//             finish), and the total: the last prefix plus the number of
//             unmatched right rows (counted by K4's compaction)
//   k6_expand one thread per output slot t: the left row li that owns t is
//             the upper bound of t in the prefix sums, k = t - (prefix of
//             li), the right row is order_r[lo[li] + k] (or -1 when li has
//             no match); slots past the left part take the unmatched right
//             rows in K4's compaction order; slots past the total are
//             invalid and carry -1 on both sides.
//
// Searching per slot, not writing per left row, keeps the work flat when
// match counts are skewed (Q3's first join: ~146 k slots over ~730 k left
// rows, most of which emit nothing).
//
// Bound on this card: bytes.  At Q3's second join, an inner join (262,144
// left padded rows; 30,086 output rows in a bucket of 32,768 slots), the
// counts and row mask are read (4 + 1 B a left row), the emit counts and
// 8-byte prefixes written (4 + 8 B a left row), lo read at the matched
// left rows and order_r at the matched slots, and 4 + 4 + 1 B written a
// slot: ~4.9 MB, ~1.5 us at 3.35 TB/s (chip_smoke.py's k6_bytes), so the
// launches, not the bytes, set the time.  Right and full joins add the
// right side's has_r, row mask, unmatched mask and K4 order (7 B a right
// row).  The searches read log2(nl) ~ 18 prefixes a slot from L2.
#include "common.cuh"

namespace {

using srt::BLOCK;
using srt::ITEMS;
using srt::TILE;

__global__ void emit(const int* __restrict__ cnt,
                     const bool* __restrict__ l_rm, long long nl,
                     const bool* __restrict__ has_r,
                     const bool* __restrict__ r_rm, long long nr,
                     int leftish, int rightish, int* __restrict__ emit_out,
                     bool* __restrict__ r_extra) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nl) {
    int e = l_rm[i] ? cnt[i] : 0;
    if (leftish && l_rm[i] && e < 1) e = 1;
    emit_out[i] = e;
  }
  if (rightish && i < nr) r_extra[i] = r_rm[i] && !has_r[i];
}

__global__ void tile_sums64(const int* __restrict__ v, long long n,
                            long long* __restrict__ sums) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  long long s = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i < n) s += v[i];
  }
  long long total;
  srt::block_excl_scan64(s, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void tile_offsets64(long long* __restrict__ sums, int ntiles) {
  long long carry = 0;
  for (int start = 0; start < ntiles; start += blockDim.x) {
    const int t = start + threadIdx.x;
    const long long v = t < ntiles ? sums[t] : 0;
    long long total;
    const long long ex = srt::block_excl_scan64(v, &total);
    if (t < ntiles) sums[t] = carry + ex;
    carry += total;
  }
}

// inclusive prefix per row; the thread holding row n - 1 writes the total
__global__ void finish_scan64(const int* __restrict__ v, long long n,
                              const long long* __restrict__ tile_offsets,
                              const int* __restrict__ extra_count,
                              long long* __restrict__ offs,
                              long long* __restrict__ total) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  long long x[ITEMS];
  long long s = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    x[j] = i < n ? v[i] : 0;
    s += x[j];
  }
  long long tile_total;
  long long run = tile_offsets[blockIdx.x] + srt::block_excl_scan64(s, &tile_total);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    run += x[j];
    if (i < n) offs[i] = run;
  }
  const long long extra = extra_count != nullptr ? *extra_count : 0;
  if (n == 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *total = extra;
  } else if (base <= n - 1 && n - 1 < base + ITEMS) {
    *total = offs[n - 1] + extra;
  }
}

__global__ void expand(const long long* __restrict__ offs,
                       const int* __restrict__ emit_in, long long nl,
                       const int* __restrict__ cnt,
                       const int* __restrict__ lo,
                       const int* __restrict__ order_r, long long nr,
                       const int* __restrict__ unmatched_order,
                       const long long* __restrict__ total, long long c_out,
                       int* __restrict__ lidx, int* __restrict__ ridx,
                       bool* __restrict__ slot_valid) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= c_out) return;
  const long long m_left = nl > 0 ? offs[nl - 1] : 0;
  const bool valid = t < *total;
  int l = -1, r = -1;
  if (valid) {
    if (t < m_left) {
      long long li = srt::upper_bound(offs, nl, t);
      if (li > nl - 1) li = nl - 1;
      const long long k = t - (offs[li] - emit_in[li]);
      l = (int)li;
      if (cnt[li] > 0) {
        long long pos = (long long)lo[li] + k;
        if (pos > nr - 1) pos = nr - 1;
        if (pos < 0) pos = 0;
        r = order_r[pos];
      }
    } else {
      long long s = t - m_left;
      if (s > nr - 1) s = nr - 1;
      r = unmatched_order[s];
    }
  }
  lidx[t] = l;
  ridx[t] = r;
  slot_valid[t] = valid;
}

}  // namespace

// leftish: left/full; rightish: right/full.  has_r, r_rm and r_extra are
// read or written only when rightish (they may be NULL otherwise)
SRT_API int k6_emit(const void* cnt, const void* l_rm, long long nl,
                    const void* has_r, const void* r_rm, long long nr,
                    int leftish, int rightish, void* emit_out, void* r_extra,
                    void* stream) {
  const long long n = rightish && nr > nl ? nr : nl;
  emit<<<srt::blocks_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)cnt, (const bool*)l_rm, nl, (const bool*)has_r,
      (const bool*)r_rm, nr, leftish, rightish, (int*)emit_out,
      (bool*)r_extra);
  return (int)cudaGetLastError();
}

// tile_sums: scratch int64[ceil(nl / 2048)]; offs: int64[nl];
// extra_count: int32 scalar or NULL; total: int64 scalar
SRT_API int k6_scan(const void* emit_in, long long nl, void* tile_sums,
                    const void* extra_count, void* offs, void* total,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = srt::tiles_for(nl) > 0 ? srt::tiles_for(nl) : 1;
  tile_sums64<<<ntiles, BLOCK, 0, st>>>((const int*)emit_in, nl,
                                        (long long*)tile_sums);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tile_offsets64<<<1, srt::scan_threads(ntiles), 0, st>>>(
      (long long*)tile_sums, ntiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finish_scan64<<<ntiles, BLOCK, 0, st>>>(
      (const int*)emit_in, nl, (const long long*)tile_sums,
      (const int*)extra_count, (long long*)offs, (long long*)total);
  return (int)cudaGetLastError();
}

// unmatched_order: int32[nr] (K4's compaction order of r_extra) or NULL
// when the join type emits no unmatched right rows
SRT_API int k6_expand(const void* offs, const void* emit_in, long long nl,
                      const void* cnt, const void* lo, const void* order_r,
                      long long nr, const void* unmatched_order,
                      const void* total, long long c_out, void* lidx,
                      void* ridx, void* slot_valid, void* stream) {
  expand<<<srt::blocks_for(c_out, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
      (const long long*)offs, (const int*)emit_in, nl, (const int*)cnt,
      (const int*)lo, (const int*)order_r, nr, (const int*)unmatched_order,
      (const long long*)total, c_out, (int*)lidx, (int*)ridx,
      (bool*)slot_valid);
  return (int)cudaGetLastError();
}
