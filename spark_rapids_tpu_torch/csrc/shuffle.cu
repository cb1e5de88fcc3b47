// K10 — the partition build of the device exchange.
//
// Replaces spark_rapids_tpu/shuffle/device_shuffle.py:packed_build (96)
// up to its gather.  The build groups a batch's rows by destination
// partition, stably: rows at or past num_rows get the sentinel bucket
// n_out, so every real row lands in front of the padding, and the
// permutation equals the reference's stable argsort of
// where(row_mask, pids, n_out); counts[p] and starts[p] delimit
// partition p's contiguous range (the reference's searchsorted bounds).
// The exchange then reads the counts back once a chunk of batches and
// writes every non-empty partition straight from the batch through this
// order in one launch (K10's split, csrc/gather.cu k10_split); the
// reference's block and its per-partition slices are not written.
//
// Bound on this card: bytes.  The build reads the real rows' 4-byte
// pids twice (histogram, scatter) and writes the 4-byte order once; at
// 3.35 TB/s Q3's 4,194,304-row lineitem batch is ~50 MB, about 15 us.
// Design, two launches in the style of K1's onesweep (csrc/sort.cu):
//   * k10 bucket_hist counts each 2,048-row tile's buckets in shared
//     memory (warp-aggregated atomics: counts are order-free), adds them
//     to a global histogram and publishes them as the tile's look-back
//     status words (common.cuh; an epoch in each word, so one buffer
//     serves every call with no memset);
//   * scatter_rows walks back over those words a warp a bucket, 32 tiles
//     a round trip (srt::lookback_warp; every count is there before the
//     launch, so no block waits on another's start), publishes its
//     inclusive prefix so later tiles stop early, adds the bucket's start
//     (the exclusive scan of the global histogram), then ranks each row
//     within its bucket as K1's onesweep does (warp ranks over a warp's
//     256 rows, one block scan of the warps' counts), so the order is
//     stable without atomics.
//     Padding rows (at or past num_rows) go last in row order, so row i
//     of them sits at position i: a tile of padding alone writes i and
//     takes no part in the look-back.  Tile 0's block writes counts and
//     starts and zeroes the other half of the two-buffer histogram for
//     the next call.  One thread owns one bucket in the ranking, so this
//     route takes at most 255 partitions.  (A one-block scan of the
//     [bucket][tile] counts between a histogram and a scatter took
//     12-13% of the build at every recorded shape:
//     tools/k10_k2_split.py.)
//   * a wider fan-out (only repartition(n) with a large n) counts the
//     buckets with global atomics (hist_wide) and scans them with the same
//     scan_buckets over one tile; the wrapper takes the order from K1's
//     radix sort of the bucket ids.
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
// shards).  Design: one launch for up to 32 columns (a column table in
// the kernel parameters, blockIdx.y the column), one thread a lane
// computing its row from order/starts/counts (no rows tensor is built),
// 1/2/4/8-byte element copies or a byte loop for string rows.
#include "common.cuh"

namespace {

using srt::BLOCK;
using srt::ITEMS;
using srt::TILE;

constexpr int MAX_TILE_COLS = 32;
// fan-outs whose buckets the build counts and ranks by one ballot a
// bucket (a lane a bucket) instead of __match_any_sync
constexpr int SMALL_FANOUT = 8;

__device__ __forceinline__ int bucket_of(const int* __restrict__ pids,
                                         long long i, long long nr,
                                         int n_out) {
  return i < nr ? pids[i] : n_out;
}

// the rows of buckets [0, n_out) of tile t added to hist and published
// as its look-back counts, status[t * n_out + b] (tiles of padding alone
// count nothing and publish nothing)
__global__ void bucket_hist(const int* __restrict__ pids,
                            const int* __restrict__ num_rows, long long n,
                            int n_out, unsigned* __restrict__ hist,
                            unsigned long long* __restrict__ status,
                            unsigned epoch) {
  __shared__ unsigned h[256];
  const int lane = threadIdx.x & 31;
  const long long nr = *num_rows;
  const long long base = (long long)blockIdx.x * TILE;
  if (base >= nr) return;
  h[threadIdx.x] = 0u;
  __syncthreads();
  int b[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const long long i = base + r * BLOCK + threadIdx.x;
    b[r] = i < n && i < nr ? pids[i] : 256;
  }
  if (n_out <= SMALL_FANOUT) {
    // lane q counts bucket q's rows of the warp by ballots
    unsigned c = 0u;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r)
      for (int q = 0; q < n_out; ++q) {
        const unsigned m = __ballot_sync(srt::FULL_MASK, b[r] == q);
        if (lane == q) c += (unsigned)__popc(m);
      }
    if (lane < n_out && c != 0u) atomicAdd(&h[lane], c);
  } else {
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const unsigned peers = __match_any_sync(srt::FULL_MASK, b[r]);
      if (b[r] < 256 && lane == __ffs(peers) - 1)
        atomicAdd(&h[b[r]], (unsigned)__popc(peers));
    }
  }
  __syncthreads();
  if (threadIdx.x < n_out) {
    const unsigned c = h[threadIdx.x];
    if (c != 0u) atomicAdd(&hist[threadIdx.x], c);
    srt::lookback_publish(status + threadIdx.x, n_out, (int)blockIdx.x,
                          epoch, c);
  }
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

// A row's rank among the rows of its warp's rounds so far that share its
// bucket (256: a lane without a row); cnt is the warp's own row of counts,
// left advanced past the round (K1's warp_rank, csrc/sort.cu).  For at
// most SMALL_FANOUT buckets, warp_rank_small: lane q keeps bucket q's
// count in a register, and a ballot a bucket ranks the round.
__device__ __forceinline__ unsigned warp_rank_small(int b, int n_out,
                                                    unsigned* c) {
  const int lane = threadIdx.x & 31;
  unsigned rank = 0u;
  for (int q = 0; q < n_out; ++q) {
    const unsigned m = __ballot_sync(srt::FULL_MASK, b == q);
    const unsigned before = __shfl_sync(srt::FULL_MASK, *c, q);
    if (b == q) rank = before + (unsigned)__popc(m & ((1u << lane) - 1u));
    if (lane == q) *c += (unsigned)__popc(m);
  }
  return rank;
}

__device__ __forceinline__ unsigned warp_rank(int b, unsigned* cnt) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(srt::FULL_MASK, b);
  const unsigned below = (unsigned)__popc(peers & ((1u << lane) - 1u));
  const unsigned before = b < 256 ? cnt[b] : 0u;
  __syncwarp();
  if (b < 256 && below == 0u) cnt[b] = before + (unsigned)__popc(peers);
  __syncwarp();
  return before + below;
}

// order[pos] = row, rows grouped by bucket, stable within a bucket; the
// look-back words of bucket b and tile t at status[t * n_out + b], every
// real tile's count published by bucket_hist.  Warp w holds rows [256 w,
// 256 w + 256) of the tile, round j the 32 from 256 w + 32 j, so rows
// rank in (warp, round, lane) order, which is row order.
__global__ void __launch_bounds__(BLOCK) scatter_rows(
    const int* __restrict__ pids, const int* __restrict__ num_rows,
    long long n, int n_out, const unsigned* __restrict__ hist,
    unsigned* __restrict__ next_hist, unsigned long long* __restrict__ status,
    unsigned epoch, int* __restrict__ counts_out,
    int* __restrict__ starts_out, int* __restrict__ order) {
  __shared__ unsigned s_base[256];
  __shared__ unsigned s_start[256];
  __shared__ unsigned s_wcnt[srt::WARPS][256];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int tile = (int)blockIdx.x;
#pragma unroll
  for (int ww = 0; ww < srt::WARPS; ++ww) s_wcnt[ww][tid] = 0u;
  // each bucket's start: the rows of the buckets below it
  const unsigned c = tid < n_out ? hist[tid] : 0u;
  int total;
  const int start = srt::block_excl_scan((int)c, &total);
  s_start[tid] = (unsigned)start;
  if (tile == 0) {
    if (tid < n_out) {
      counts_out[tid] = (int)c;
      starts_out[tid] = start;
    }
    next_hist[tid] = 0u;
  }
  const long long nr = *num_rows;
  const long long base = (long long)tile * TILE + w * (32 * ITEMS);
  if ((long long)tile * TILE >= nr) {
    // padding alone: row i at position i
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = base + j * 32 + lane;
      if (i < n) order[i] = (int)i;
    }
    return;
  }
  int b[ITEMS];
  unsigned rank[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j * 32 + lane;
    b[j] = i < n && i < nr ? pids[i] : 256;
  }
  if (n_out <= SMALL_FANOUT) {
    unsigned c = 0u;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) rank[j] = warp_rank_small(b[j], n_out, &c);
    if (lane < n_out) s_wcnt[w][lane] = c;
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) rank[j] = warp_rank(b[j], s_wcnt[w]);
  }
  __syncthreads();
  // thread tid owns bucket tid: each warp's start inside the tile's run
  unsigned run = 0u;
#pragma unroll
  for (int ww = 0; ww < srt::WARPS; ++ww) {
    const unsigned v = s_wcnt[ww][tid];
    s_wcnt[ww][tid] = run;
    run += v;
  }
  // each bucket's rows in the tiles before: warp w walks back for buckets
  // w, w + 8, ..., then publishes the tile's inclusive prefix
  for (int k = w; k < n_out; k += srt::WARPS) {
    const unsigned long long before =
        srt::lookback_warp(status + k, n_out, tile, epoch);
    if (lane == 0) {
      unsigned long long* word = status + (long long)tile * n_out + k;
      if (tile > 0)
        srt::lb_store(word, epoch, srt::LB_PREFIX,
                      before + (*(volatile unsigned long long*)word &
                                srt::LB_VALUE));
      s_base[k] = s_start[k] + (unsigned)before;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j * 32 + lane;
    if (i >= n) continue;
    order[b[j] < 256 ? (long long)(s_base[b[j]] + s_wcnt[w][b[j]] + rank[j])
                     : i] = (int)i;
  }
}

struct TileCol {
  const uint8_t* src;
  uint8_t* dst;
  const bool* src_valid;
  bool* dst_valid;
  const int* src_len;  // strings only, else NULL
  int* dst_len;
  int row_bytes;
  int dst_row_bytes;  // K24's string tiles may be wider than the source
};

struct TileCols {
  TileCol c[MAX_TILE_COLS];
};

template <typename E>
__device__ __forceinline__ void copy_elem(const uint8_t* src, uint8_t* dst,
                                          long long from, long long to) {
  ((E*)dst)[to] = ((const E*)src)[from];
}

// K24: lane t of the [n_parts * cap] tiles; blockIdx.y picks the column
// (y == 0 also writes the lane mask; ncols == 0 writes only the mask)
__global__ void exchange_tiles(TileCols cols, int ncols,
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
  const TileCol& c = cols.c[blockIdx.y];
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
// sentinel n_out), n_out + 1 <= 256.  hist: uint32[256], zero on entry;
// next_hist: uint32[256], zeroed here (the next call's hist); status:
// uint64[status_words] whose epochs differ from `epoch` (1..65535), at
// least n_out * tiles (fewer is an error, not a look-back that waits on
// a word no tile writes); counts, starts: int32[n_out]; order: int32[n].
// Two launches.
SRT_API int k10_build(const void* pids, const void* num_rows, long long n,
                      int n_out, void* hist, void* next_hist, void* status,
                      long long status_words, int epoch, void* counts,
                      void* starts, void* order, void* stream) {
  if (n_out < 1 || n_out + 1 > 256 || epoch < 1 || epoch > 0xffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = srt::tiles_for(n < 1 ? 1 : n);
  if ((long long)n_out * ntiles > status_words)
    return (int)cudaErrorInvalidValue;
  bucket_hist<<<ntiles, BLOCK, 0, st>>>(
      (const int*)pids, (const int*)num_rows, n, n_out, (unsigned*)hist,
      (unsigned long long*)status, (unsigned)epoch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scatter_rows<<<ntiles, BLOCK, 0, st>>>(
      (const int*)pids, (const int*)num_rows, n, n_out,
      (const unsigned*)hist, (unsigned*)next_hist,
      (unsigned long long*)status, (unsigned)epoch, (int*)counts,
      (int*)starts, (int*)order);
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

// K24.  table: per column eight int64 (src data, dst tile, src validity,
// dst validity, src lengths or 0, dst lengths or 0, source bytes a row,
// tile bytes a row); sources have n >= 1 rows, tiles n_parts * capacity.
// order: int32[n], starts, counts: int32[n_parts] (K10's build);
// lane_valid: bool[n_parts * capacity] or NULL (not written).
SRT_API int k24_tiles(const long long* table, int ncols, long long n,
                      const void* order, const void* starts,
                      const void* counts, int n_parts, long long capacity,
                      void* lane_valid, void* stream) {
  if (ncols < 0 || ncols > MAX_TILE_COLS || n < 1 || n_parts < 1 ||
      capacity < 1)
    return (int)cudaErrorInvalidValue;
  TileCols cols;
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
