// K10 — the packed partition build and slice of the device exchange.
//
// Replaces spark_rapids_tpu/shuffle/device_shuffle.py:packed_build (96)
// and packed_slice (118).  The build groups a batch's rows by destination
// partition, stably: rows at or past num_rows get the sentinel bucket
// n_out, so every real row lands in front of the padding, and the
// permutation equals the reference's stable argsort of
// where(row_mask, pids, n_out); counts[p] and starts[p] delimit
// partition p's contiguous range (the reference's searchsorted bounds).
// K4's gather then moves the batch into that order.  The slice copies one
// partition's range [start, start + count) of every column to the front
// of an output of the block's padded size, with the reference's clipped
// index (lanes past the range carry the clipped row's data) and validity
// AND lane < count.
//
// Bound on this card: bytes.  The build reads the 4-byte pids twice
// (histogram, scatter) and writes the 4-byte order once; at 3.35 TB/s
// Q3's 4,194,304-row lineitem batch is ~50 MB, about 15 us.  The slice
// reads and writes each column's padded rows once.  Design:
//   * build, three launches: k10 tile_hist counts the n_out + 1 buckets of
//     each 2,048-row tile in shared memory (warp-aggregated atomics on
//     counts, which are order-free); scan_buckets, one block, turns the
//     bucket-major [bucket][tile] counts into global offsets with one
//     flat exclusive scan and writes counts and starts on the card; the
//     scatter ranks each row within its bucket with K1's warp-ranking
//     round (srt::ranked_position), so the order is stable without
//     atomics.  One thread owns one bucket there, so this route takes at
//     most 255 partitions.
//   * a wider fan-out (only repartition(n) with a large n) counts the
//     buckets with global atomics (hist_wide) and scans them with the same
//     scan_buckets over one tile; the wrapper takes the order from K1's
//     radix sort of the bucket ids.
//   * slice: one launch for up to 32 columns (blockIdx.y picks the
//     column from a table passed as a kernel parameter), copying data,
//     validity and lengths of a row in one pass with 1/2/4/8-byte element
//     copies or a byte loop for string matrices.  The index is computed in
//     the kernel; no index tensor is built.
//
// K24 — the distributed exchange's tiles.
//
// Replaces spark_rapids_tpu/parallel/exchange.py:bucket_rows (47) and
// _gather_tiles (74).  From K10's stable build of a shard's rows by
// destination (order, starts, counts) it writes every column's
// [n_parts * capacity] tile: lane l of destination d carries row
// order[clip(starts[d] + l, 0, n - 1)] with validity AND l < counts[d],
// and the lane mask itself (l < counts[d]) once.  A lane past counts[d]
// carries the clipped row's data, as the reference's; rows past the
// capacity are dropped, as there.  A string tile is written at the width
// given for it (the widest of every shard's), the bytes past the source
// width zero.
//
// Bound on this card: bytes.  Each row that some lane reads is read once
// (its 4-byte order entry and each column's data, validity and lengths):
// a lane past counts[d] reads a row of destination d + 1, so only the
// last destination's clipped lanes add rows.  Every lane writes its tile
// entries and the mask (device_shuffle.py:exchange_tiles_bytes;
// chip_smoke.py computes it at Q3's and Q18's hash exchanges on four
// shards).  Design: one launch for up to 32
// columns (K10's column table, blockIdx.y the column), one thread a lane
// computing its row from order/starts/counts (no rows tensor is built),
// 1/2/4/8-byte element copies or a byte loop for string rows.
#include "common.cuh"

namespace {

using srt::BLOCK;
using srt::ITEMS;
using srt::TILE;

constexpr int MAX_SLICE_COLS = 32;

__device__ __forceinline__ int bucket_of(const int* __restrict__ pids,
                                         long long i, long long nr,
                                         int n_out) {
  return i < nr ? pids[i] : n_out;
}

// counts[b][tile] for b in [0, n_out]
__global__ void tile_hist(const int* __restrict__ pids,
                          const int* __restrict__ num_rows, long long n,
                          int n_out, int ntiles,
                          unsigned* __restrict__ counts) {
  __shared__ unsigned h[256];
  const int lane = threadIdx.x & 31;
  h[threadIdx.x] = 0u;
  __syncthreads();
  const long long nr = *num_rows;
  const long long base = (long long)blockIdx.x * TILE;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const long long i = base + r * BLOCK + threadIdx.x;
    const bool in = i < n;
    const int b = in ? bucket_of(pids, i, nr, n_out) : 256;
    const unsigned peers = __match_any_sync(srt::FULL_MASK, b);
    if (in && lane == __ffs(peers) - 1)
      atomicAdd(&h[b], (unsigned)__popc(peers));
  }
  __syncthreads();
  if (threadIdx.x <= n_out)
    counts[(long long)threadIdx.x * ntiles + blockIdx.x] = h[threadIdx.x];
}

// global bucket counts for a fan-out past the shared histogram
__global__ void hist_wide(const int* __restrict__ pids,
                          const int* __restrict__ num_rows, long long n,
                          int n_out, unsigned* __restrict__ counts) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  atomicAdd(&counts[bucket_of(pids, i, *num_rows, n_out)], 1u);
}

// one block: bucket-major [nb][ntiles] counts -> exclusive offsets in
// place (one flat scan), then counts_out/starts_out of buckets < n_out
__global__ void scan_buckets(unsigned* __restrict__ counts, int nb,
                             int ntiles, int n_out,
                             int* __restrict__ counts_out,
                             int* __restrict__ starts_out) {
  const long long total = (long long)nb * ntiles;
  int carry = 0;
  for (long long start = 0; start < total; start += blockDim.x) {
    const long long t = start + threadIdx.x;
    const int v = t < total ? (int)counts[t] : 0;
    int sum;
    const int ex = srt::block_excl_scan(v, &sum);
    if (t < total) counts[t] = (unsigned)(carry + ex);
    carry += sum;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_out; b += blockDim.x) {
    const int s = (int)counts[(long long)b * ntiles];
    const int e = b + 1 < nb ? (int)counts[(long long)(b + 1) * ntiles]
                             : carry;
    starts_out[b] = s;
    counts_out[b] = e - s;
  }
}

// order[pos] = row, rows grouped by bucket, stable within a bucket
__global__ void scatter_rows(const int* __restrict__ pids,
                             const int* __restrict__ num_rows, long long n,
                             int n_out, int ntiles,
                             const unsigned* __restrict__ offsets,
                             int* __restrict__ order) {
  __shared__ unsigned s_base[256];
  __shared__ unsigned s_cnt[srt::WARPS][256];
  __shared__ unsigned s_off[srt::WARPS][256];
  const int tid = threadIdx.x;
  s_base[tid] =
      tid <= n_out ? offsets[(long long)tid * ntiles + blockIdx.x] : 0u;
#pragma unroll
  for (int ww = 0; ww < srt::WARPS; ++ww) s_cnt[ww][tid] = 0u;
  __syncthreads();
  const long long nr = *num_rows;
  const long long base = (long long)blockIdx.x * TILE;
  for (int r = 0; r < ITEMS; ++r) {
    const long long i = base + r * BLOCK + tid;
    const bool in = i < n;
    const int b = in ? bucket_of(pids, i, nr, n_out) : 256;
    const unsigned pos = srt::ranked_position(b, in, s_base, s_cnt, s_off);
    if (in) order[pos] = (int)i;
  }
}

struct SliceCol {
  const uint8_t* src;
  uint8_t* dst;
  const bool* src_valid;
  bool* dst_valid;
  const int* src_len;  // strings only, else NULL
  int* dst_len;
  int row_bytes;
  int dst_row_bytes;  // K24's string tiles may be wider than the source
};

struct SliceCols {
  SliceCol c[MAX_SLICE_COLS];
};

template <typename E>
__device__ __forceinline__ void copy_elem(const uint8_t* src, uint8_t* dst,
                                          long long from, long long to) {
  ((E*)dst)[to] = ((const E*)src)[from];
}

__global__ void slice_cols(SliceCols cols, long long padded, long long start,
                           long long count) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= padded) return;
  const SliceCol& c = cols.c[blockIdx.y];
  long long k = start + lane;
  if (k < 0) k = 0;
  if (k > padded - 1) k = padded - 1;
  switch (c.row_bytes) {
    case 1: copy_elem<uint8_t>(c.src, c.dst, k, lane); break;
    case 2: copy_elem<uint16_t>(c.src, c.dst, k, lane); break;
    case 4: copy_elem<uint32_t>(c.src, c.dst, k, lane); break;
    case 8: copy_elem<unsigned long long>(c.src, c.dst, k, lane); break;
    default: {
      const uint8_t* s = c.src + k * c.row_bytes;
      uint8_t* d = c.dst + lane * c.row_bytes;
      for (int j = 0; j < c.row_bytes; ++j) d[j] = s[j];
    }
  }
  c.dst_valid[lane] = c.src_valid[k] && lane < count;
  if (c.src_len != nullptr) c.dst_len[lane] = c.src_len[k];
}

// K24: lane t of the [n_parts * cap] tiles; blockIdx.y picks the column
// (y == 0 also writes the lane mask; ncols == 0 writes only the mask)
__global__ void exchange_tiles(SliceCols cols, int ncols,
                               const int* __restrict__ order,
                               const int* __restrict__ starts,
                               const int* __restrict__ counts, long long n,
                               long long cap, long long total,
                               bool* __restrict__ lane_valid) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long d = t / cap;
  const long long lane = t - d * cap;
  long long k = (long long)starts[d] + lane;
  if (k > n - 1) k = n - 1;
  if (k < 0) k = 0;
  const long long row = order[k];
  const bool in = lane < (long long)counts[d];
  if (blockIdx.y == 0 && lane_valid != nullptr) lane_valid[t] = in;
  if ((int)blockIdx.y >= ncols) return;
  const SliceCol& c = cols.c[blockIdx.y];
  if (c.row_bytes == c.dst_row_bytes) {
    switch (c.row_bytes) {
      case 1: copy_elem<uint8_t>(c.src, c.dst, row, t); break;
      case 2: copy_elem<uint16_t>(c.src, c.dst, row, t); break;
      case 4: copy_elem<uint32_t>(c.src, c.dst, row, t); break;
      case 8: copy_elem<unsigned long long>(c.src, c.dst, row, t); break;
      default: {
        const uint8_t* s = c.src + row * c.row_bytes;
        uint8_t* o = c.dst + t * c.row_bytes;
        for (int j = 0; j < c.row_bytes; ++j) o[j] = s[j];
      }
    }
  } else {
    const uint8_t* s = c.src + row * c.row_bytes;
    uint8_t* o = c.dst + t * c.dst_row_bytes;
    int j = 0;
    for (; j < c.row_bytes; ++j) o[j] = s[j];
    for (; j < c.dst_row_bytes; ++j) o[j] = 0;
  }
  c.dst_valid[t] = c.src_valid[row] && in;
  if (c.src_len != nullptr) c.dst_len[t] = c.src_len[row];
}

}  // namespace

// Stable grouping of n rows by pid (rows at or past *num_rows get the
// sentinel n_out), n_out + 1 <= 256.  scratch: uint32[(n_out + 1) *
// tiles]; counts, starts: int32[n_out]; order: int32[n].
SRT_API int k10_build(const void* pids, const void* num_rows, long long n,
                      int n_out, void* scratch, void* counts, void* starts,
                      void* order, void* stream) {
  if (n_out < 1 || n_out + 1 > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = srt::tiles_for(n < 1 ? 1 : n);
  tile_hist<<<ntiles, BLOCK, 0, st>>>((const int*)pids,
                                      (const int*)num_rows, n, n_out,
                                      ntiles, (unsigned*)scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_buckets<<<1, srt::scan_threads((n_out + 1) * ntiles), 0, st>>>(
      (unsigned*)scratch, n_out + 1, ntiles, n_out, (int*)counts,
      (int*)starts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scatter_rows<<<ntiles, BLOCK, 0, st>>>(
      (const int*)pids, (const int*)num_rows, n, n_out, ntiles,
      (const unsigned*)scratch, (int*)order);
  return (int)cudaGetLastError();
}

// Counts and starts only, for any fan-out: scratch is a zeroed
// uint32[n_out + 1].
SRT_API int k10_counts_wide(const void* pids, const void* num_rows,
                            long long n, int n_out, void* scratch,
                            void* counts, void* starts, void* stream) {
  if (n_out < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  hist_wide<<<srt::blocks_for(n, BLOCK), BLOCK, 0, st>>>(
      (const int*)pids, (const int*)num_rows, n, n_out,
      (unsigned*)scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_buckets<<<1, srt::scan_threads(n_out + 1), 0, st>>>(
      (unsigned*)scratch, n_out + 1, 1, n_out, (int*)counts, (int*)starts);
  return (int)cudaGetLastError();
}

// table: per column seven int64 (src data, dst data, src validity, dst
// validity, src lengths or 0, dst lengths or 0, bytes a row); every array
// has `padded` rows.
SRT_API int k10_slice(const long long* table, int ncols, long long padded,
                      long long start, long long count, void* stream) {
  if (ncols < 1 || ncols > MAX_SLICE_COLS) return (int)cudaErrorInvalidValue;
  SliceCols cols;
  for (int c = 0; c < ncols; ++c) {
    const long long* d = table + 7 * c;
    cols.c[c].src = (const uint8_t*)d[0];
    cols.c[c].dst = (uint8_t*)d[1];
    cols.c[c].src_valid = (const bool*)d[2];
    cols.c[c].dst_valid = (bool*)d[3];
    cols.c[c].src_len = (const int*)d[4];
    cols.c[c].dst_len = (int*)d[5];
    cols.c[c].row_bytes = (int)d[6];
    cols.c[c].dst_row_bytes = (int)d[6];
  }
  if (padded <= 0) return (int)cudaSuccess;
  dim3 grid(srt::blocks_for(padded, BLOCK), (unsigned)ncols);
  slice_cols<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(cols, padded, start,
                                                       count);
  return (int)cudaGetLastError();
}

// K24.  table: per column eight int64 (src data, dst tile, src validity,
// dst validity, src lengths or 0, dst lengths or 0, source bytes a row,
// tile bytes a row); sources have n >= 1 rows, tiles n_parts * capacity.
// order: int32[n], starts, counts: int32[n_parts] (K10's build);
// lane_valid: bool[n_parts * capacity] or NULL (not written).
SRT_API int k24_tiles(const long long* table, int ncols, long long n,
                      const void* order, const void* starts,
                      const void* counts, int n_parts, long long capacity,
                      void* lane_valid, void* stream) {
  if (ncols < 0 || ncols > MAX_SLICE_COLS || n < 1 || n_parts < 1 ||
      capacity < 1)
    return (int)cudaErrorInvalidValue;
  SliceCols cols;
  for (int c = 0; c < ncols; ++c) {
    const long long* d = table + 8 * c;
    cols.c[c].src = (const uint8_t*)d[0];
    cols.c[c].dst = (uint8_t*)d[1];
    cols.c[c].src_valid = (const bool*)d[2];
    cols.c[c].dst_valid = (bool*)d[3];
    cols.c[c].src_len = (const int*)d[4];
    cols.c[c].dst_len = (int*)d[5];
    cols.c[c].row_bytes = (int)d[6];
    cols.c[c].dst_row_bytes = (int)d[7];
  }
  const long long total = (long long)n_parts * capacity;
  dim3 grid(srt::blocks_for(total, BLOCK), (unsigned)(ncols > 0 ? ncols : 1));
  exchange_tiles<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      cols, ncols, (const int*)order, (const int*)starts,
      (const int*)counts, n, capacity, total, (bool*)lane_valid);
  return (int)cudaGetLastError();
}
