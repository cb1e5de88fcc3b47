// Shared helpers of the engine's hand-written kernels (sm_90a).
//
// Every exported function has a plain C interface (loaded with ctypes),
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#ifdef SRT_EMULATED
#include <stdio.h>
#include <stdlib.h>
#endif

#define SRT_API extern "C" __attribute__((visibility("default")))

namespace srt {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int BLOCK = 256;           // threads of the tile kernels
constexpr int ITEMS = 8;             // consecutive rows per thread
constexpr int TILE = BLOCK * ITEMS;  // rows per tile (one block)

// dtype codes shared with the Python wrappers (ops/kernels/_build.py)
enum DtypeCode {
  DT_BOOL = 0, DT_I8 = 1, DT_I16 = 2, DT_I32 = 3, DT_I64 = 4,
  DT_F32 = 5, DT_F64 = 6, DT_U8 = 7
};

// 16 bytes that load and store as one 128-bit access
struct alignas(16) Bytes16 {
  unsigned long long lo, hi;
};

inline unsigned blocks_for(long long n, int per_block) {
  long long b = (n + per_block - 1) / per_block;
  return (unsigned)(b < 1 ? 1 : b);
}

inline int tiles_for(long long n) { return (int)((n + TILE - 1) / TILE); }

// threads of a one-block scan over `count` entries: a warp multiple,
// at most 1024 (small inputs do not pay for idle warps)
inline int scan_threads(int count) {
  int t = ((count + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(FULL_MASK, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Exclusive prefix sum of one int per thread over the block (any block
// size that is a multiple of 32, up to 1024).  *total receives the block
// sum.  Ends with a barrier, so it may be called again in the same kernel.
__device__ __forceinline__ int block_excl_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  __shared__ int s_total;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int incl = warp_incl_scan(v);
  if (lane == 31) warp_sums[w] = incl;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? warp_sums[lane] : 0;
    int si = warp_incl_scan(s);
    if (lane < nw) warp_sums[lane] = si - s;
    if (lane == 31) s_total = si;
  }
  __syncthreads();
  const int r = warp_sums[w] + incl - v;
  *total = s_total;
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------------
// Multi-block scan of 0/1 flags (uint8), three launches:
//   scan_tile_sums    : per-tile sum of the flags
//   scan_tile_offsets : one block turns the tile sums into exclusive
//                       offsets in place and writes the grand total
//   (finish)          : each user writes its own per-row output from the
//                       tile offset plus the in-tile prefix
// ---------------------------------------------------------------------
static __global__ void scan_tile_sums(const uint8_t* __restrict__ flags,
                                      long long n, int* __restrict__ sums) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  int s = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i < n) s += flags[i] ? 1 : 0;
  }
  int total;
  block_excl_scan(s, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

static __global__ void scan_tile_offsets(int* __restrict__ sums, int ntiles,
                                         int* __restrict__ total_out) {
  int carry = 0;
  for (int start = 0; start < ntiles; start += blockDim.x) {
    const int t = start + threadIdx.x;
    const int v = t < ntiles ? sums[t] : 0;
    int total;
    const int ex = block_excl_scan(v, &total);
    if (t < ntiles) sums[t] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0 && total_out != nullptr) *total_out = carry;
}

// In-tile exclusive prefix of this thread's first row, given the flags of
// its ITEMS rows (loaded by the caller).
__device__ __forceinline__ int thread_prefix(const int* f, int* tile_total) {
  int s = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) s += f[j];
  return block_excl_scan(s, tile_total);
}

// 64-bit forms of the block scan, for sums that can pass 2**31 (the join's
// output slot counts)
__device__ __forceinline__ long long warp_incl_scan64(long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    long long t = __shfl_up_sync(FULL_MASK, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ long long block_excl_scan64(long long v,
                                                       long long* total) {
  __shared__ long long warp_sums64[32];
  __shared__ long long s_total64;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const long long incl = warp_incl_scan64(v);
  if (lane == 31) warp_sums64[w] = incl;
  __syncthreads();
  if (w == 0) {
    long long s = lane < nw ? warp_sums64[lane] : 0;
    long long si = warp_incl_scan64(s);
    if (lane < nw) warp_sums64[lane] = si - s;
    if (lane == 31) s_total64 = si;
  }
  __syncthreads();
  const long long r = warp_sums64[w] + incl - v;
  *total = s_total64;
  __syncthreads();
  return r;
}

constexpr int WARPS = BLOCK / 32;

// ---------------------------------------------------------------------
// Decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back") over integer counts, for kernels whose
// tiles take their index from a global atomic counter (so a tile waits
// only on tiles whose blocks already run, and no wait can deadlock).
// Each counter has one 64-bit status word a tile: bits 0-39 a count, bits
// 40-41 its state (1: the tile's own count, 2: the inclusive prefix
// through the tile), bits 48-63 an epoch.  A word of another epoch reads
// as unset, so several launches (one epoch each) reuse one zeroed buffer
// with no memset between them.  The value and its flag are one word, so
// a reader that sees the flag sees the value.  Counts are integers: the
// prefix is exact and the same on every run.
// ---------------------------------------------------------------------
constexpr unsigned long long LB_VALUE = (1ull << 40) - 1ull;
constexpr unsigned LB_AGGREGATE = 1u;
constexpr unsigned LB_PREFIX = 2u;

__device__ __forceinline__ void lb_store(unsigned long long* word,
                                         unsigned epoch, unsigned state,
                                         unsigned long long value) {
  *(volatile unsigned long long*)word =
      ((unsigned long long)epoch << 48) |
      ((unsigned long long)state << 40) | (value & LB_VALUE);
}

// spins until `word` holds a value of this epoch; returns the word
__device__ __forceinline__ unsigned long long lb_wait(
    const unsigned long long* word, unsigned epoch) {
  for (;;) {
    const unsigned long long w = *(const volatile unsigned long long*)word;
    if ((unsigned)(w >> 48) == epoch && ((w >> 40) & 3ull) != 0ull)
      return w;
#ifdef SRT_EMULATED
    // blocks run in index order here, so an unset predecessor is a fault
    // of the caller, and spinning would hang the run
    fprintf(stderr, "emulator: a look-back waits on an unset status word "
            "(epoch %u)\n", epoch);
    abort();
#endif
  }
}

// Publishes tile `tile`'s own count (its prefix, for tile 0).  Slot j of
// the counter is words[j * stride].
__device__ __forceinline__ void lookback_publish(unsigned long long* words,
                                                 long long stride, int tile,
                                                 unsigned epoch,
                                                 unsigned long long count) {
  lb_store(words + (long long)tile * stride, epoch,
           tile == 0 ? LB_PREFIX : LB_AGGREGATE, count);
}

// After lookback_publish: the sum of the counts of tiles [0, tile),
// walking back over the predecessors' words until one holds its prefix
// (LB_WINDOW words read at once, so the walk pays one load latency a
// window); then publishes this tile's inclusive prefix.
constexpr int LB_WINDOW = 8;

__device__ __forceinline__ unsigned long long lookback_prefix(
    unsigned long long* words, long long stride, int tile, unsigned epoch,
    unsigned long long count) {
  unsigned long long excl = 0ull;
  int j = tile - 1;
  bool done = j < 0;
  while (!done) {
    unsigned long long w[LB_WINDOW];
#pragma unroll
    for (int q = 0; q < LB_WINDOW; ++q)
      w[q] = j - q >= 0
          ? *(const volatile unsigned long long*)(words +
                                                  (long long)(j - q) * stride)
          : 0ull;
#pragma unroll
    for (int q = 0; q < LB_WINDOW; ++q) {
      if (done || j - q < 0) continue;
      if ((unsigned)(w[q] >> 48) != epoch || ((w[q] >> 40) & 3ull) == 0ull)
        w[q] = lb_wait(words + (long long)(j - q) * stride, epoch);
      excl += w[q] & LB_VALUE;
      done = ((w[q] >> 40) & 3ull) == LB_PREFIX;
    }
    j -= LB_WINDOW;
    done = done || j < 0;
  }
  if (tile > 0)
    lb_store(words + (long long)tile * stride, epoch, LB_PREFIX,
             excl + count);
  return excl;
}

// The sum of the counts of tiles [0, tile) for one warp, where every
// tile below has published at least its own count (a word of another
// epoch is waited on): lane l reads the word of tile j - l, 32
// predecessors a round trip, and the walk ends at the nearest word that
// holds its inclusive prefix (there is always tile 0's).  Every lane
// returns the sum; the caller publishes the tile's prefix.
__device__ __forceinline__ unsigned long long lookback_warp(
    const unsigned long long* words, long long stride, int tile,
    unsigned epoch) {
  const int lane = threadIdx.x & 31;
  unsigned long long excl = 0ull;
  for (int j = tile - 1; j >= 0; j -= 32) {
    const int k = j - lane;
    unsigned long long w = 0ull;
    bool prefix = k < 0;
    if (k >= 0) {
      w = *(const volatile unsigned long long*)(words + (long long)k * stride);
      if ((unsigned)(w >> 48) != epoch || ((w >> 40) & 3ull) == 0ull)
        w = lb_wait(words + (long long)k * stride, epoch);
      prefix = ((w >> 40) & 3ull) == LB_PREFIX;
    }
    const unsigned m = __ballot_sync(FULL_MASK, prefix);
    const int first = m ? __ffs(m) - 1 : 32;
    unsigned long long v = k >= 0 && lane <= first ? (w & LB_VALUE) : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    excl += v;
    if (m) break;
  }
  return excl;
}

// lookback_warp for a whole block (every thread calls it, blockDim.x a
// multiple of 32): thread i reads the word of tile j - i, blockDim.x
// predecessors a round trip, so a wave of blocks that look back together
// resolves blockDim.x tiles a round trip instead of 32.  Every thread
// returns the sum.
__device__ __forceinline__ unsigned long long lookback_block(
    const unsigned long long* words, long long stride, int tile,
    unsigned epoch) {
  __shared__ unsigned s_mask[32];
  __shared__ unsigned long long s_sum[32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned long long excl = 0ull;
  for (int j = tile - 1; j >= 0; j -= (int)blockDim.x) {
    const int k = j - (int)threadIdx.x;
    unsigned long long wd = 0ull;
    bool prefix = k < 0;
    if (k >= 0) {
      wd = *(const volatile unsigned long long*)(words + (long long)k * stride);
      if ((unsigned)(wd >> 48) != epoch || ((wd >> 40) & 3ull) == 0ull)
        wd = lb_wait(words + (long long)k * stride, epoch);
      prefix = ((wd >> 40) & 3ull) == LB_PREFIX;
    }
    const unsigned m = __ballot_sync(FULL_MASK, prefix);
    if (lane == 0) s_mask[w] = m;
    __syncthreads();
    // the nearest word holding its prefix: the lowest warp with one, its
    // lowest lane; it and every word nearer count
    int fw = nw, fl = 32;
    for (int q = 0; q < nw; ++q)
      if (s_mask[q] != 0u) {
        fw = q;
        fl = __ffs(s_mask[q]) - 1;
        break;
      }
    unsigned long long v =
        k >= 0 && (w < fw || (w == fw && lane <= fl)) ? (wd & LB_VALUE)
                                                      : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    if (lane == 0) s_sum[w] = v;
    __syncthreads();
    for (int q = 0; q < nw; ++q) excl += s_sum[q];
    __syncthreads();
    if (fw < nw) break;
  }
  return excl;
}

// lower_bound / upper_bound over a nondecreasing array
template <typename T>
__device__ __forceinline__ long long lower_bound(const T* __restrict__ a,
                                                 long long n, T v) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__device__ __forceinline__ long long upper_bound(const T* __restrict__ a,
                                                 long long n, T v) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

}  // namespace srt
