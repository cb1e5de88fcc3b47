// K14 — the window kernel: segment bounds, ranks and frame aggregates over
// rows in window order, written back to row order.
//
// Replaces spark_rapids_tpu/exec/window.py: _seg_scan (63), the segment
// start/end and rank arithmetic of _one_window (111) and _frame_agg (179).
// The caller sorts the rows by (partition keys, order keys) with K1 and
// takes the sorted segment ids from K2; `order` maps sorted position i to
// its row.  Results go to out[order[i]] with validity ANDed with the row
// mask (data 0 where null).
//
//   * k14_bounds       : forward max-scan and reverse min-scan of index
//                        candidates: segment start/end from the ids (and,
//                        inside k14_frame_pick, the previous/next valid
//                        row for first/last with ignore_nulls);
//   * k14_rank         : row_number, rank, dense_rank;
//   * k14_frame_halo   : count, integer sum and avg, min, max, first and
//                        last of a bounded frame within HALO rows of the
//                        row: ONE launch;
//   * k14_frame_sums   : count / sum / avg of any other frame, and every
//                        float sum: P[hi] - P[lo] over prefix arrays;
//   * k14_frame_minmax : min/max of unbounded, running and reverse frames
//                        (a segment-reset scan) and of bounded frames wider
//                        than the halo (a sparse table);
//   * k14_frame_pick   : first/last of any frame beyond the halo.
//
// Frames are [lo, hi) = [i + lower, i + upper + 1) clamped to the segment,
// hi >= lo, as the reference formulates them.  min/max follow
// jnp.minimum/jnp.maximum: NaN propagates and -0.0 is below 0.0.
//
// Bound on this card: bytes, and the random accesses through `order`.
// Design: every frame aggregate reads values, validity and the row mask
// through `order` in ONE launch, its first, which reads `order` itself
// coalesced (the reference's `vals = c.data[order]`), and writes its result
// and validity through `order` once, in its last: 3 random reads and 2
// random writes a row (count: 2 and 2).  Every pass between reads and
// writes contiguous sorted arrays.
//   * The halo path (k14_frame_halo: bounded frames with |lower| and
//     |upper| at most HALO, except float sums) is that one pass: a block
//     gathers its HALO_ROWS rows and HALO rows on each side into shared
//     memory (values, a flags byte of validity and row mask, the segment
//     ids read coalesced), takes each row's frame edges from the ids in
//     the window, reduces the frame there (count and integer sums exactly
//     in any order; min/max exact in any order; first/last from the edge
//     rows) and scatters: no prefix array, sparse table or second pass.
//   * Otherwise the first launch stages the sorted copy (the values in
//     window order, nulls masked, and the flags byte) and reduces each
//     tile to its totals (count and sum, or count and the segment-reset
//     min/max carry); one block scans the tile totals in a fixed order; a
//     finish pass rescans each tile from the sorted copy with its carry and
//     writes the n + 1 prefix counts and sums, or the segment-reset scan in
//     place over the sorted copy (the sparse table's levels follow from it
//     for wide bounded min/max); the last pass reads those at the frame's
//     edges and scatters.  Unbounded, running, reverse and wide frames
//     need values far from the row, so they keep the prefix arrays (16 B a
//     row, written and read back); float sums keep them for every frame.
//   * first/last beyond the halo: the staging pass (values' bits and
//     flags), with ignore_nulls the next/previous valid row by k14_bounds'
//     scans over the flags, then the pick pass.
// The block scans are Hillis-Steele scans in shared memory, trees fixed
// by positions alone, with no atomics and no look-back: a float prefix sum
// gives the same bits every run, and the same bits as before the staging
// (the association is unchanged: a thread's rows in order, the block
// tree, the tile totals in order).
#include <limits.h>

#include "common.cuh"

namespace {

using srt::BLOCK;
using srt::ITEMS;
using srt::TILE;

enum { LOWER_UNBOUNDED = 1, UPPER_UNBOUNDED = 2 };
enum { MODE_UNBOUNDED = 0, MODE_RUNNING = 1, MODE_REVERSE = 2,
       MODE_BOUNDED = 3 };
// frame kinds of k14_frame_halo (count, sum, avg as k14_frame_sums)
enum { K_COUNT = 0, K_SUM = 1, K_AVG = 2, K_MIN = 3, K_MAX = 4,
       K_FIRST = 5, K_LAST = 6 };
// the staged flags byte of a sorted row
enum { F_VALID = 1, F_ROW = 2 };
// rows a halo block reads on each side of its tile: frames within
// [i - HALO, i + HALO] take the one-launch path
constexpr int HALO = 32;
// rows a halo block owns, four a thread.  On the card 1,024 ran 2% ahead
// of 512, 8% ahead of 2,048 and 2-13% ahead of a tile of 128 rows a warp
// synchronised by warp alone: more blocks in flight hide the random
// reads, a smaller tile pays more halo
constexpr int HALO_ROWS = 1024;

// ---------------------------------------------------------------------------
// exclusive block scan over BLOCK threads in shared memory; `p` is this
// thread's position in scan order (a permutation of 0..BLOCK-1), *total
// the whole block's aggregate.  Ends with a barrier, so it may be called
// again in the same kernel.
// ---------------------------------------------------------------------------
template <typename V, typename Op>
__device__ V block_scan(V v, int p, V* total) {
  __shared__ V buf[2][BLOCK];
  buf[0][p] = v;
  __syncthreads();
  int cur = 0;
  for (int o = 1; o < BLOCK; o <<= 1) {
    V x = buf[cur][p];
    if (p >= o) x = Op::apply(buf[cur][p - o], x);
    buf[cur ^ 1][p] = x;
    __syncthreads();
    cur ^= 1;
  }
  const V ex = p > 0 ? buf[cur][p - 1] : Op::ident();
  *total = buf[cur][BLOCK - 1];
  __syncthreads();
  return ex;
}

struct MaxOp {
  __device__ static int ident() { return -1; }
  __device__ static int apply(int a, int b) { return a > b ? a : b; }
};
struct MinOp {
  __device__ static int ident() { return INT_MAX; }
  __device__ static int apply(int a, int b) { return a < b ? a : b; }
};

template <typename A> struct SumOp;
template <> struct SumOp<long long> {
  static constexpr int is_float = 0;
  // int64 sums wrap, as the reference's jnp.cumsum does
  __device__ static long long ident() { return 0; }
  __device__ static long long apply(long long a, long long b) {
    return (long long)((unsigned long long)a + (unsigned long long)b);
  }
};
template <> struct SumOp<double> {
  static constexpr int is_float = 1;
  __device__ static double ident() { return 0.0; }
  __device__ static double apply(double a, double b) { return a + b; }
};

// ---------------------------------------------------------------------------
// min/max with jnp's semantics and the identities of the reference
// ---------------------------------------------------------------------------
template <typename T> struct Lim;
template <> struct Lim<double> {
  __device__ static double hi() { return __longlong_as_double(0x7ff0000000000000ll); }
  __device__ static double lo() { return -hi(); }
};
template <> struct Lim<float> {
  __device__ static float hi() { return __int_as_float(0x7f800000); }
  __device__ static float lo() { return -hi(); }
};
template <> struct Lim<long long> {
  __device__ static long long hi() { return LLONG_MAX; }
  __device__ static long long lo() { return LLONG_MIN; }
};
template <> struct Lim<int> {
  __device__ static int hi() { return INT_MAX; }
  __device__ static int lo() { return INT_MIN; }
};
template <> struct Lim<short> {
  __device__ static short hi() { return SHRT_MAX; }
  __device__ static short lo() { return SHRT_MIN; }
};
template <> struct Lim<signed char> {
  __device__ static signed char hi() { return SCHAR_MAX; }
  __device__ static signed char lo() { return SCHAR_MIN; }
};

template <typename T> __device__ __forceinline__ bool is_nan(T) { return false; }
template <> __device__ __forceinline__ bool is_nan<double>(double v) { return v != v; }
template <> __device__ __forceinline__ bool is_nan<float>(float v) { return v != v; }

template <typename T> __device__ __forceinline__ bool sign_bit(T) { return false; }
template <> __device__ __forceinline__ bool sign_bit<double>(double v) {
  return __double_as_longlong(v) < 0;
}
template <> __device__ __forceinline__ bool sign_bit<float>(float v) {
  return __float_as_int(v) < 0;
}

template <typename T, bool MIN>
__device__ __forceinline__ T minmax_ident() {
  return MIN ? Lim<T>::hi() : Lim<T>::lo();
}

// written out: CUDA's fmin/fmax drop NaN, jnp.minimum/maximum keep it
template <typename T, bool MIN>
__device__ __forceinline__ T comb(T a, T b) {
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  if (MIN) {
    if (a < b) return a;
    if (b < a) return b;
    return sign_bit(a) ? a : b;  // equal: -0.0 is the min
  }
  if (a > b) return a;
  if (b > a) return b;
  return sign_bit(a) ? b : a;    // equal: 0.0 is the max
}

template <typename T> struct SegV {
  int f;  // a segment starts here (in scan order)
  T acc;  // min/max since the last segment start
};

template <typename T, bool MIN> struct SegOp {
  __device__ static SegV<T> ident() {
    SegV<T> z;
    z.f = 0;
    z.acc = minmax_ident<T, MIN>();
    return z;
  }
  __device__ static SegV<T> apply(SegV<T> l, SegV<T> r) {
    SegV<T> o;
    o.f = l.f | r.f;
    o.acc = r.f ? r.acc : comb<T, MIN>(l.acc, r.acc);
    return o;
  }
};


__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ void frame_edges(long long i, long long s,
                                            long long e, long long lower,
                                            long long upper, int flags,
                                            long long* lo, long long* hi) {
  const long long l =
      (flags & LOWER_UNBOUNDED) ? s : clampll(i + lower, s, e);
  long long h = (flags & UPPER_UNBOUNDED) ? e : clampll(i + upper + 1, s, e);
  *lo = l;
  *hi = h < l ? l : h;
}

// both loads issued at once (no short circuit: a load that waits on the
// other would double the latency of a random read)
__device__ __forceinline__ unsigned char row_flags(const bool* rm,
                                                   const bool* valid, int o) {
  const bool r = rm[o];
  const bool v = valid == nullptr ? true : valid[o];
  return (unsigned char)((r ? F_ROW : 0) | (r && v ? F_VALID : 0));
}

// ---------------------------------------------------------------------------
// k14_bounds: forward max-scan (fwd) and reverse min-scan (rev) of index
// candidates.  With ids: fwd candidate i at a segment's first row, rev
// candidate i + 1 at its last row (segment start, exclusive end).  With
// the staged flags instead: i at a valid row (fwd: the previous valid row,
// else -1; rev: the next valid row, else n).
// ---------------------------------------------------------------------------
struct BoundsIn {
  const int* ids;
  const unsigned char* fl;
  long long n;
};

__device__ __forceinline__ void candidates(const BoundsIn& in, long long i,
                                           int* f, int* r) {
  if (in.ids != nullptr) {
    const int s = in.ids[i];
    *f = (i == 0 || in.ids[i - 1] != s) ? (int)i : -1;
    *r = (i == in.n - 1 || in.ids[i + 1] != s) ? (int)(i + 1) : INT_MAX;
  } else {
    const bool v = (in.fl[i] & F_VALID) != 0;
    *f = v ? (int)i : -1;
    *r = v ? (int)i : (int)in.n;
  }
}

__device__ __forceinline__ void thread_bounds(const BoundsIn& in,
                                              long long base, int* f,
                                              int* r) {
  int mf = MaxOp::ident(), mr = MinOp::ident();
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i >= in.n) break;
    int cf, cr;
    candidates(in, i, &cf, &cr);
    mf = MaxOp::apply(mf, cf);
    mr = MinOp::apply(mr, cr);
  }
  *f = mf;
  *r = mr;
}

__global__ void bounds_tiles(BoundsIn in, int* __restrict__ tile_f,
                             int* __restrict__ tile_r) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  int f, r, tf, tr;
  thread_bounds(in, base, &f, &r);
  block_scan<int, MaxOp>(f, threadIdx.x, &tf);
  block_scan<int, MinOp>(r, threadIdx.x, &tr);
  if (threadIdx.x == 0) {
    tile_f[blockIdx.x] = tf;
    tile_r[blockIdx.x] = tr;
  }
}

// tile totals -> exclusive carries in place: fwd from the first tile, rev
// from the last (one block)
__global__ void bounds_tile_scan(int* __restrict__ tile_f,
                                 int* __restrict__ tile_r, int ntiles) {
  int carry_f = MaxOp::ident(), carry_r = MinOp::ident();
  for (int start = 0; start < ntiles; start += BLOCK) {
    const int q = start + threadIdx.x;
    const int tr = ntiles - 1 - q;
    int tot_f, tot_r;
    const int ef = block_scan<int, MaxOp>(q < ntiles ? tile_f[q]
                                                     : MaxOp::ident(),
                                          threadIdx.x, &tot_f);
    const int er = block_scan<int, MinOp>(q < ntiles ? tile_r[tr]
                                                     : MinOp::ident(),
                                          threadIdx.x, &tot_r);
    if (q < ntiles) {
      tile_f[q] = MaxOp::apply(carry_f, ef);
      tile_r[tr] = MinOp::apply(carry_r, er);
    }
    carry_f = MaxOp::apply(carry_f, tot_f);
    carry_r = MinOp::apply(carry_r, tot_r);
  }
}

__global__ void bounds_finish(BoundsIn in, const int* __restrict__ tile_f,
                              const int* __restrict__ tile_r,
                              int* __restrict__ fwd, int* __restrict__ rev) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  int f, r, tf, tr;
  thread_bounds(in, base, &f, &r);
  const int ef = block_scan<int, MaxOp>(f, threadIdx.x, &tf);
  const int er = block_scan<int, MinOp>(r, BLOCK - 1 - threadIdx.x, &tr);
  int cf[ITEMS], cr[ITEMS];
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i < in.n) candidates(in, i, &cf[j], &cr[j]);
  }
  int run = MaxOp::apply(tile_f[blockIdx.x], ef);
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i >= in.n) break;
    run = MaxOp::apply(run, cf[j]);
    if (fwd != nullptr) fwd[i] = run;
  }
  run = MinOp::apply(tile_r[blockIdx.x], er);
  for (int j = ITEMS - 1; j >= 0; --j) {
    const long long i = base + j;
    if (i >= in.n) continue;
    run = MinOp::apply(run, cr[j]);
    if (rev != nullptr) rev[i] = run;
  }
}

inline int tiles_of(long long n) {
  const int nt = srt::tiles_for(n);
  return nt < 1 ? 1 : nt;
}

cudaError_t bounds_run(BoundsIn in, int* fwd, int* rev, int* tile_f,
                       int* tile_r, cudaStream_t st) {
  const int nt = tiles_of(in.n);
  bounds_tiles<<<nt, BLOCK, 0, st>>>(in, tile_f, tile_r);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bounds_tile_scan<<<1, BLOCK, 0, st>>>(tile_f, tile_r, nt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bounds_finish<<<nt, BLOCK, 0, st>>>(in, tile_f, tile_r, fwd, rev);
  return cudaGetLastError();
}

__global__ void rank_kernel(int kind, const int* __restrict__ order,
                            const bool* __restrict__ rm,
                            const int* __restrict__ start,
                            const int* __restrict__ ok_ids,
                            const int* __restrict__ ok_start, long long n,
                            int* __restrict__ out, bool* __restrict__ out_valid) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long s = start[i];
  long long v;
  if (kind == 0) {
    v = i - s + 1;
  } else if (kind == 1) {
    v = (long long)ok_start[i] - s + 1;
  } else {
    v = (long long)ok_ids[i] - ok_ids[clampll(s, 0, n - 1)] + 1;
  }
  const int o = order[i];
  const bool ok = rm[o];
  out[o] = ok ? (int)v : 0;
  out_valid[o] = ok;
}

// ---------------------------------------------------------------------------
// k14_frame_halo: one launch.  A block gathers sorted rows
// [ts - back, ts + HALO_ROWS + ahead) through `order` into shared memory
// (back, ahead: how far the frame reaches, at most HALO and HALO + 1), then
// each row of its tile reduces its frame there and writes out[order[i]].
// A row's segment edges come from the ids in the window: walking from the
// row while the id holds, as far as the frame reaches (at most HALO back
// and HALO + 1 ahead), gives max(s, i - reach) and min(e, i + reach),
// which clamp i + lower and i + upper + 1 as s and e would.
// ---------------------------------------------------------------------------
template <typename T, int KIND>
__global__ void __launch_bounds__(BLOCK)
    frame_halo(int ignore_nulls, const T* __restrict__ values,
               const bool* __restrict__ valid, const int* __restrict__ order,
               const bool* __restrict__ rm, const int* __restrict__ seg,
               long long n, int lower, int upper, void* __restrict__ out,
               bool* __restrict__ out_valid) {
  constexpr int ROWS = HALO_ROWS;
  constexpr int WIN = ROWS + 2 * HALO + 1;
  __shared__ T sv[WIN];
  __shared__ unsigned char sf[WIN];
  __shared__ int sid[WIN];
  __shared__ int so[ROWS];
  // how far a frame reaches behind and ahead of its row: the window is
  // [ts - back, ts + ROWS + ahead)
  const int up1 = upper + 1;
  int back = -lower > -up1 ? -lower : -up1;
  back = back > 0 ? back : 0;
  int ahead = lower > up1 ? lower : up1;
  ahead = ahead > 0 ? ahead : 0;
  const long long ts = (long long)blockIdx.x * ROWS;
  const long long ws = ts - back;
  const int win = ROWS + back + ahead;
  // every position's order entry first (coalesced, independent), then the
  // random reads through it, so a thread has them all in flight at once
  constexpr int LOADS = (WIN + BLOCK - 1) / BLOCK;
  int ord[LOADS];
#pragma unroll
  for (int q = 0; q < LOADS; ++q) {
    const int k = threadIdx.x + q * BLOCK;
    const long long p = ws + k;
    ord[q] = (k < win && p >= 0 && p < n) ? order[p] : -1;
  }
#pragma unroll
  for (int q = 0; q < LOADS; ++q) {
    const int k = threadIdx.x + q * BLOCK;
    const int o = ord[q];
    if (o < 0) continue;
    sf[k] = row_flags(rm, valid, o);
    if constexpr (KIND != K_COUNT) sv[k] = values[o];
    sid[k] = seg[ws + k];
    if (k >= back && k < back + ROWS) so[k - back] = o;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < ROWS; k += BLOCK) {
    const long long i = ts + k;
    if (i >= n) break;
    const int w0 = k + back;
    const int my = sid[w0];
    long long s = i, e = i + 1;
    while (s > i - back && s > 0 && sid[s - 1 - ws] == my) --s;
    while (e < i + ahead && e < n && sid[e - ws] == my) ++e;
    const long long lo = clampll(i + lower, s, e);
    long long hi = clampll(i + up1, s, e);
    if (hi < lo) hi = lo;
    const int wl = (int)(lo - ws), wh = (int)(hi - ws);
    const bool row_ok = (sf[w0] & F_ROW) != 0;
    const int o = so[k];
    if constexpr (KIND == K_COUNT) {
      long long cnt = 0;
      for (int w = wl; w < wh; ++w) cnt += sf[w] & F_VALID;
      ((long long*)out)[o] = row_ok ? cnt : 0;
      out_valid[o] = row_ok;
    } else if constexpr (KIND == K_SUM || KIND == K_AVG) {
      // int64 sums wrap, as P[hi] - P[lo] of the reference's cumsum does
      unsigned long long acc = 0ull;
      long long cnt = 0;
      for (int w = wl; w < wh; ++w)
        if (sf[w] & F_VALID) {
          acc += (unsigned long long)(long long)sv[w];
          ++cnt;
        }
      const bool ok = cnt > 0 && row_ok;
      if (KIND == K_SUM)
        ((long long*)out)[o] = ok ? (long long)acc : 0;
      else
        ((double*)out)[o] =
            ok ? (double)(long long)acc / (double)(cnt > 1 ? cnt : 1) : 0.0;
      out_valid[o] = ok;
    } else if constexpr (KIND == K_MIN || KIND == K_MAX) {
      // exact in any order: NaN propagates and -0.0 is below 0.0
      T acc = minmax_ident<T, KIND == K_MIN>();
      bool any = false;
      for (int w = wl; w < wh; ++w)
        if (sf[w] & F_VALID) {
          acc = comb<T, KIND == K_MIN>(acc, sv[w]);
          any = true;
        }
      const bool ok = any && row_ok;
      ((T*)out)[o] = ok ? acc : (T)0;
      out_valid[o] = ok;
    } else {
      int j = -1;
      if (KIND == K_FIRST) {
        if (ignore_nulls) {
          for (int w = wl; w < wh && j < 0; ++w)
            if (sf[w] & F_VALID) j = w;
        } else if (wl < wh && (sf[wl] & F_VALID)) {
          j = wl;
        }
      } else {
        if (ignore_nulls) {
          for (int w = wh - 1; w >= wl && j < 0; --w)
            if (sf[w] & F_VALID) j = w;
        } else if (wl < wh && (sf[wh - 1] & F_VALID)) {
          j = wh - 1;
        }
      }
      const bool ok = j >= 0 && row_ok;
      ((T*)out)[o] = ok ? sv[j] : (T)0;
      out_valid[o] = ok;
    }
  }
}

// ---------------------------------------------------------------------------
// k14_frame_sums: the staging pass (values in window order, 0 where null,
// the flags byte, each tile's count and sum), the tile scan, the finish
// pass (n + 1 exclusive prefix counts and sums from the sorted copy), the
// frame pass (P[hi] - P[lo], scattered)
// ---------------------------------------------------------------------------
template <typename A> struct CountSum {
  long long c;  // valid rows
  A s;          // the sum of their values
};

template <typename A> struct CountSumOp {
  __device__ static CountSum<A> ident() {
    CountSum<A> z;
    z.c = 0;
    z.s = SumOp<A>::ident();
    return z;
  }
  __device__ static CountSum<A> apply(CountSum<A> a, CountSum<A> b) {
    CountSum<A> o;
    o.c = a.c + b.c;
    o.s = SumOp<A>::apply(a.s, b.s);
    return o;
  }
};

template <typename T, typename A>
__global__ void stage_sums(const T* __restrict__ values,
                           const bool* __restrict__ valid,
                           const int* __restrict__ order,
                           const bool* __restrict__ rm, long long n,
                           A* __restrict__ vs, unsigned char* __restrict__ fl,
                           CountSum<A>* __restrict__ tiles) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  int ord[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    ord[j] = base + j < n ? order[base + j] : -1;
  CountSum<A> s = CountSumOp<A>::ident();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    const int o = ord[j];
    if (o < 0) continue;
    const unsigned char f = row_flags(rm, valid, o);
    fl[i] = f;
    CountSum<A> e = CountSumOp<A>::ident();
    if (f & F_VALID) {
      e.c = 1;
      if (values != nullptr) e.s = (A)values[o];
    }
    if (vs != nullptr) vs[i] = e.s;
    s = CountSumOp<A>::apply(s, e);
  }
  CountSum<A> total;
  block_scan<CountSum<A>, CountSumOp<A>>(s, threadIdx.x, &total);
  if (threadIdx.x == 0) tiles[blockIdx.x] = total;
}

template <typename A>
__global__ void sums_tile_scan(CountSum<A>* __restrict__ tiles, int ntiles) {
  CountSum<A> carry = CountSumOp<A>::ident();
  for (int start = 0; start < ntiles; start += BLOCK) {
    const int q = start + threadIdx.x;
    CountSum<A> total;
    const CountSum<A> ex = block_scan<CountSum<A>, CountSumOp<A>>(
        q < ntiles ? tiles[q] : CountSumOp<A>::ident(), threadIdx.x, &total);
    if (q < ntiles) tiles[q] = CountSumOp<A>::apply(carry, ex);
    carry = CountSumOp<A>::apply(carry, total);
  }
}

template <typename A>
__device__ __forceinline__ CountSum<A> staged_sum(const A* vs,
                                                  const unsigned char* fl,
                                                  long long i) {
  CountSum<A> e = CountSumOp<A>::ident();
  if (fl[i] & F_VALID) {
    e.c = 1;
    if (vs != nullptr) e.s = vs[i];
  }
  return e;
}

template <typename A>
__global__ void sums_finish(const A* __restrict__ vs,
                            const unsigned char* __restrict__ fl, long long n,
                            const CountSum<A>* __restrict__ tiles,
                            long long* __restrict__ counts,
                            A* __restrict__ sums) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  CountSum<A> s = CountSumOp<A>::ident();
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i >= n) break;
    s = CountSumOp<A>::apply(s, staged_sum<A>(vs, fl, i));
  }
  CountSum<A> total;
  const CountSum<A> ex =
      block_scan<CountSum<A>, CountSumOp<A>>(s, threadIdx.x, &total);
  CountSum<A> run = CountSumOp<A>::apply(tiles[blockIdx.x], ex);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    counts[0] = 0;
    if (sums != nullptr) sums[0] = SumOp<A>::ident();
  }
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i >= n) break;
    run = CountSumOp<A>::apply(run, staged_sum<A>(vs, fl, i));
    counts[i + 1] = run.c;
    if (sums != nullptr) sums[i + 1] = run.s;
  }
}

__global__ void frame_sum_kernel(int kind, const long long* __restrict__ cnt_p,
                                 const void* __restrict__ sum_p,
                                 int sum_is_float,
                                 const int* __restrict__ order,
                                 const unsigned char* __restrict__ fl,
                                 const int* __restrict__ start,
                                 const int* __restrict__ end, long long n,
                                 long long lower, long long upper, int flags,
                                 void* __restrict__ out,
                                 bool* __restrict__ out_valid) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long lo, hi;
  frame_edges(i, start[i], end[i], lower, upper, flags, &lo, &hi);
  const long long cnt = cnt_p[hi] - cnt_p[lo];
  const int o = order[i];
  const bool row_ok = (fl[i] & F_ROW) != 0;
  if (kind == K_COUNT) {  // valid on every real row
    ((long long*)out)[o] = row_ok ? cnt : 0;
    out_valid[o] = row_ok;
    return;
  }
  const bool ok = cnt > 0 && row_ok;
  out_valid[o] = ok;
  if (sum_is_float) {
    const double* p = (const double*)sum_p;
    double s = p[hi] - p[lo];
    if (kind == K_AVG) s = s / (double)(cnt > 1 ? cnt : 1);
    ((double*)out)[o] = ok ? s : 0.0;
  } else {
    const long long* p = (const long long*)sum_p;
    const long long s =
        (long long)((unsigned long long)p[hi] - (unsigned long long)p[lo]);
    if (kind == K_AVG)
      ((double*)out)[o] = ok ? (double)s / (double)(cnt > 1 ? cnt : 1) : 0.0;
    else
      ((long long*)out)[o] = ok ? s : 0;
  }
}

template <typename T, typename A>
cudaError_t sums_run(int kind, const void* values, const bool* valid,
                     const int* order, const bool* rm, const int* start,
                     const int* end, long long n, long long lower,
                     long long upper, int flags, void* staged,
                     unsigned char* fl, void* tiles, long long* counts,
                     void* sums, void* out, bool* out_valid,
                     cudaStream_t st) {
  const int nt = tiles_of(n);
  stage_sums<T, A><<<nt, BLOCK, 0, st>>>((const T*)values, valid, order, rm,
                                         n, (A*)staged, fl,
                                         (CountSum<A>*)tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sums_tile_scan<A><<<1, BLOCK, 0, st>>>((CountSum<A>*)tiles, nt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sums_finish<A><<<nt, BLOCK, 0, st>>>((const A*)staged, fl, n,
                                       (const CountSum<A>*)tiles, counts,
                                       (A*)sums);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  frame_sum_kernel<<<srt::blocks_for(n, BLOCK), BLOCK, 0, st>>>(
      kind, counts, sums, SumOp<A>::is_float, order, fl,
      start, end, n, lower, upper, flags, out, out_valid);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// k14_frame_minmax: the staging pass (values in window order, the
// identity where null, the flags byte, each tile's count and, for the
// scans, its segment-reset carry), the tile scan, the finish pass (n + 1
// prefix counts; the segment-reset scan in place over the sorted copy),
// the sparse table's levels for wide bounded frames, the frame pass
// ---------------------------------------------------------------------------
template <typename T, bool MIN>
__device__ __forceinline__ SegV<T> staged_seg(const T* vm, const int* seg,
                                              long long n, bool reverse,
                                              long long i) {
  SegV<T> e;
  const int s = seg[i];
  e.f = reverse ? (i == n - 1 || seg[i + 1] != s)
                : (i == 0 || seg[i - 1] != s);
  e.acc = vm[i];
  return e;
}

// this thread's ITEMS rows reduced in scan order
template <typename T, bool MIN>
__device__ __forceinline__ SegV<T> thread_seg(const T* vm, const int* seg,
                                              long long n, bool reverse,
                                              long long base) {
  SegV<T> a = SegOp<T, MIN>::ident();
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + (reverse ? ITEMS - 1 - k : k);
    if (i >= n) continue;
    a = SegOp<T, MIN>::apply(a, staged_seg<T, MIN>(vm, seg, n, reverse, i));
  }
  return a;
}

template <typename T, bool MIN>
__global__ void stage_minmax(const T* __restrict__ values,
                             const bool* __restrict__ valid,
                             const int* __restrict__ order,
                             const bool* __restrict__ rm,
                             const int* __restrict__ seg, long long n,
                             int reverse, T* __restrict__ vm,
                             unsigned char* __restrict__ fl,
                             long long* __restrict__ tile_c,
                             int* __restrict__ tile_f,
                             T* __restrict__ tile_acc) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  int ord[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    ord[j] = base + j < n ? order[base + j] : -1;
  long long c = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    const int o = ord[j];
    if (o < 0) continue;
    const unsigned char f = row_flags(rm, valid, o);
    fl[i] = f;
    vm[i] = (f & F_VALID) ? values[o] : minmax_ident<T, MIN>();
    c += f & F_VALID;
  }
  long long tc;
  block_scan<long long, SumOp<long long>>(c, threadIdx.x, &tc);
  if (threadIdx.x == 0) tile_c[blockIdx.x] = tc;
  if (seg == nullptr) return;
  // this thread's own rows, just written: read back from its own stores
  const int p = reverse ? BLOCK - 1 - threadIdx.x : threadIdx.x;
  SegV<T> total;
  block_scan<SegV<T>, SegOp<T, MIN>>(
      thread_seg<T, MIN>(vm, seg, n, reverse, base), p, &total);
  if (threadIdx.x == 0) {
    tile_f[blockIdx.x] = total.f;
    tile_acc[blockIdx.x] = total.acc;
  }
}

// tile counts -> exclusive prefix counts; the segment-reset carries (when
// tile_f is set) -> exclusive carry-in per tile, in scan order (one block)
template <typename T, bool MIN>
__global__ void minmax_tile_scan(long long* __restrict__ tile_c,
                                 int* __restrict__ tile_f,
                                 T* __restrict__ tile_acc, int ntiles,
                                 int reverse) {
  long long carry_c = 0;
  SegV<T> carry = SegOp<T, MIN>::ident();
  for (int start = 0; start < ntiles; start += BLOCK) {
    const int q = start + threadIdx.x;
    long long tot_c;
    const long long ex_c = block_scan<long long, SumOp<long long>>(
        q < ntiles ? tile_c[q] : 0, threadIdx.x, &tot_c);
    if (q < ntiles) tile_c[q] = carry_c + ex_c;
    carry_c += tot_c;
    if (tile_f == nullptr) continue;
    const int t = reverse ? ntiles - 1 - q : q;
    SegV<T> v = SegOp<T, MIN>::ident();
    if (q < ntiles) {
      v.f = tile_f[t];
      v.acc = tile_acc[t];
    }
    SegV<T> total;
    const SegV<T> ex =
        block_scan<SegV<T>, SegOp<T, MIN>>(v, threadIdx.x, &total);
    if (q < ntiles) tile_acc[t] = SegOp<T, MIN>::apply(carry, ex).acc;
    carry = SegOp<T, MIN>::apply(carry, total);
  }
}

template <typename T, bool MIN>
__global__ void minmax_finish(T* __restrict__ vm,
                              const unsigned char* __restrict__ fl,
                              const int* __restrict__ seg, long long n,
                              int reverse,
                              const long long* __restrict__ tile_c,
                              const T* __restrict__ tile_acc,
                              long long* __restrict__ counts) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  long long c = 0;
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i >= n) break;
    c += fl[i] & F_VALID;
  }
  long long tc;
  long long run_c =
      tile_c[blockIdx.x] +
      block_scan<long long, SumOp<long long>>(c, threadIdx.x, &tc);
  if (blockIdx.x == 0 && threadIdx.x == 0) counts[0] = 0;
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i >= n) break;
    run_c += fl[i] & F_VALID;
    counts[i + 1] = run_c;
  }
  if (seg == nullptr) return;
  const int p = reverse ? BLOCK - 1 - threadIdx.x : threadIdx.x;
  SegV<T> total;
  const SegV<T> ex = block_scan<SegV<T>, SegOp<T, MIN>>(
      thread_seg<T, MIN>(vm, seg, n, reverse, base), p, &total);
  SegV<T> run;
  run.f = 0;
  run.acc = tile_acc[blockIdx.x];
  run = SegOp<T, MIN>::apply(run, ex);
  // in place: a thread reads and then writes only its own rows
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + (reverse ? ITEMS - 1 - k : k);
    if (i >= n) continue;
    run = SegOp<T, MIN>::apply(run,
                               staged_seg<T, MIN>(vm, seg, n, reverse, i));
    vm[i] = run.acc;
  }
}

template <typename T, bool MIN>
__global__ void sparse_level(const T* __restrict__ prev, T* __restrict__ next,
                             long long n, long long shift) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  next[i] = comb<T, MIN>(prev[i],
                         i + shift < n ? prev[i + shift] : minmax_ident<T, MIN>());
}

template <typename T, bool MIN>
__global__ void frame_minmax_kernel(int mode, const T* __restrict__ src,
                                    int n_levels,
                                    const long long* __restrict__ cnt_p,
                                    const int* __restrict__ order,
                                    const unsigned char* __restrict__ fl,
                                    const int* __restrict__ start,
                                    const int* __restrict__ end, long long n,
                                    long long lower, long long upper,
                                    int flags, T* __restrict__ out,
                                    bool* __restrict__ out_valid) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long lo, hi;
  frame_edges(i, start[i], end[i], lower, upper, flags, &lo, &hi);
  T v;
  if (mode == MODE_UNBOUNDED) {
    v = src[clampll((long long)end[i] - 1, 0, n - 1)];
  } else if (mode == MODE_RUNNING) {
    v = src[clampll(hi - 1, 0, n - 1)];
  } else if (mode == MODE_REVERSE) {
    v = src[clampll(lo, 0, n - 1)];
  } else {
    const long long ln = hi - lo;
    if (ln > 0) {
      // floor(log2(ln)), exact
      int lvl = 63 - __clzll(ln);
      if (lvl > n_levels - 1) lvl = n_levels - 1;
      const T* level = src + (long long)lvl * n;
      v = comb<T, MIN>(level[clampll(lo, 0, n - 1)],
                       level[clampll(hi - (1ll << lvl), 0, n - 1)]);
    } else {
      v = minmax_ident<T, MIN>();
    }
  }
  const int o = order[i];
  const bool ok = cnt_p[hi] - cnt_p[lo] > 0 && (fl[i] & F_ROW);
  out[o] = ok ? v : (T)0;
  out_valid[o] = ok;
}

template <typename T, bool MIN>
cudaError_t minmax_run(int mode, const void* values, const bool* valid,
                       const int* order, const bool* rm, const int* seg,
                       const int* start, const int* end, long long n,
                       long long lower, long long upper, int flags,
                       int n_levels, void* table, unsigned char* fl,
                       long long* tile_c, int* tile_f, void* tile_acc,
                       long long* counts, void* out, bool* out_valid,
                       cudaStream_t st) {
  const int nt = tiles_of(n);
  const bool scan = mode != MODE_BOUNDED;
  const int reverse = mode == MODE_REVERSE;
  T* vm = (T*)table;
  stage_minmax<T, MIN><<<nt, BLOCK, 0, st>>>(
      (const T*)values, valid, order, rm, scan ? seg : nullptr, n, reverse,
      vm, fl, tile_c, tile_f, (T*)tile_acc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  minmax_tile_scan<T, MIN><<<1, BLOCK, 0, st>>>(
      tile_c, scan ? tile_f : nullptr, (T*)tile_acc, nt, reverse);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  minmax_finish<T, MIN><<<nt, BLOCK, 0, st>>>(
      vm, fl, scan ? seg : nullptr, n, reverse, tile_c,
      (const T*)tile_acc, counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (!scan) {
    for (int k = 1; k < n_levels; ++k) {
      sparse_level<T, MIN><<<srt::blocks_for(n, BLOCK), BLOCK, 0, st>>>(
          vm + (long long)(k - 1) * n, vm + (long long)k * n, n,
          1ll << (k - 1));
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  frame_minmax_kernel<T, MIN><<<srt::blocks_for(n, BLOCK), BLOCK, 0, st>>>(
      mode, vm, scan ? 1 : n_levels, counts, order, fl, start, end, n,
      lower, upper, flags, (T*)out, out_valid);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// k14_frame_pick: the staging pass (the values' bits in window order and
// the flags byte), with ignore_nulls the next/previous valid sorted row
// (k14_bounds' scans over the flags), the pick pass
// ---------------------------------------------------------------------------
template <typename U>
__global__ void stage_pick(const U* __restrict__ values,
                           const bool* __restrict__ valid,
                           const int* __restrict__ order,
                           const bool* __restrict__ rm, long long n,
                           U* __restrict__ vp,
                           unsigned char* __restrict__ fl) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int o = order[i];
  fl[i] = row_flags(rm, valid, o);
  vp[i] = values[o];
}

template <typename U>
__global__ void frame_pick_kernel(int is_last, int ignore_nulls,
                                  const U* __restrict__ vp,
                                  const unsigned char* __restrict__ fl,
                                  const int* __restrict__ order,
                                  const int* __restrict__ edge,
                                  const int* __restrict__ start,
                                  const int* __restrict__ end, long long n,
                                  long long lower, long long upper, int flags,
                                  U* __restrict__ out,
                                  bool* __restrict__ out_valid) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long lo, hi;
  frame_edges(i, start[i], end[i], lower, upper, flags, &lo, &hi);
  const bool nonempty = lo < hi;
  long long j;
  bool ok;
  if (!is_last) {
    j = ignore_nulls ? (long long)edge[clampll(lo, 0, n - 1)] : lo;
    ok = nonempty && (!ignore_nulls || j < hi);
  } else {
    j = ignore_nulls ? (long long)edge[clampll(hi - 1, 0, n - 1)] : hi - 1;
    ok = nonempty && (!ignore_nulls || j >= lo);
  }
  const long long jc = clampll(j, 0, n - 1);
  if (!ignore_nulls) ok = ok && (fl[jc] & F_VALID);
  const int o = order[i];
  ok = ok && (fl[i] & F_ROW);
  out[o] = ok ? vp[jc] : (U)0;
  out_valid[o] = ok;
}

template <typename U>
cudaError_t pick_run(int is_last, int ignore_nulls, const void* values,
                     const bool* valid, const int* order, const bool* rm,
                     const int* start, const int* end, long long n,
                     long long lower, long long upper, int flags,
                     void* staged, unsigned char* fl, int* edge, int* tile_f,
                     int* tile_r, void* out, bool* out_valid,
                     cudaStream_t st) {
  const unsigned g = srt::blocks_for(n, BLOCK);
  stage_pick<U><<<g, BLOCK, 0, st>>>((const U*)values, valid, order, rm, n,
                                     (U*)staged, fl);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (ignore_nulls) {
    BoundsIn in{nullptr, fl, n};
    e = bounds_run(in, is_last ? edge : nullptr, is_last ? nullptr : edge,
                   tile_f, tile_r, st);
    if (e != cudaSuccess) return e;
  }
  frame_pick_kernel<U><<<g, BLOCK, 0, st>>>(
      is_last, ignore_nulls, (const U*)staged, fl, order, edge, start, end,
      n, lower, upper, flags, (U*)out, out_valid);
  return cudaGetLastError();
}

// dtype dispatch of the min/max kernels
#define K14_MINMAX_TYPES(X)        \
  X(srt::DT_I8, signed char)       \
  X(srt::DT_I16, short)            \
  X(srt::DT_I32, int)              \
  X(srt::DT_I64, long long)        \
  X(srt::DT_F32, float)            \
  X(srt::DT_F64, double)

inline int elem_size(int dtype) {
  switch (dtype) {
    case srt::DT_BOOL: case srt::DT_U8: case srt::DT_I8: return 1;
    case srt::DT_I16: return 2;
    case srt::DT_I32: case srt::DT_F32: return 4;
    case srt::DT_I64: case srt::DT_F64: return 8;
    default: return 0;
  }
}

}  // namespace

// ids: nondecreasing segment ids; fwd = segment start, rev = segment end
// (exclusive); either may be NULL.  Scratch: two int32 arrays of one entry
// per 2048-row tile.
SRT_API int k14_bounds(const int* ids, long long n, int* fwd, int* rev,
                       int* tile_f, int* tile_r, void* stream) {
  BoundsIn in{ids, nullptr, n};
  return (int)bounds_run(in, fwd, rev, tile_f, tile_r, (cudaStream_t)stream);
}

// kind 0 row_number, 1 rank (needs ok_start), 2 dense_rank (needs ok_ids)
SRT_API int k14_rank(int kind, const int* order, const bool* row_mask,
                     const int* start, const int* ok_ids, const int* ok_start,
                     long long n, int* out, bool* out_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  rank_kernel<<<srt::blocks_for(n, srt::BLOCK), srt::BLOCK, 0, st>>>(
      kind, order, row_mask, start, ok_ids, ok_start, n, out, out_valid);
  return (int)cudaGetLastError();
}

// kind: K_COUNT..K_LAST; a bounded frame [i + lower, i + upper] with
// |lower|, |upper| <= HALO (else cudaErrorInvalidValue).  Output: count and
// sum int64, avg float64, the others the value dtype.  sum/avg of integer
// and bool values only (float sums go to k14_frame_sums); values NULL for
// count.
SRT_API int k14_frame_halo(int kind, int dtype, int ignore_nulls,
                           const void* values, const bool* valid,
                           const int* order, const bool* row_mask,
                           const int* seg, long long n, int lower, int upper,
                           void* out, bool* out_valid, void* stream) {
  if (lower < -HALO || lower > HALO || upper < -HALO || upper > HALO)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = srt::blocks_for(n, HALO_ROWS);
#define K14_HALO(T, KIND)                                                  \
  frame_halo<T, KIND><<<g, BLOCK, 0, st>>>(ignore_nulls, (const T*)values, \
                                           valid, order, row_mask, seg, n, \
                                           lower, upper, out, out_valid);  \
  return (int)cudaGetLastError();
  if (kind == K_COUNT) {
    K14_HALO(unsigned char, K_COUNT)
  }
  if (kind == K_SUM || kind == K_AVG) {
#define K14_HALO_SUM(code, T)                                   \
  case code:                                                    \
    if (kind == K_SUM) {                                        \
      K14_HALO(T, K_SUM)                                        \
    }                                                           \
    K14_HALO(T, K_AVG)
    switch (dtype) {
      K14_HALO_SUM(srt::DT_BOOL, unsigned char)
      K14_HALO_SUM(srt::DT_U8, unsigned char)
      K14_HALO_SUM(srt::DT_I8, signed char)
      K14_HALO_SUM(srt::DT_I16, short)
      K14_HALO_SUM(srt::DT_I32, int)
      K14_HALO_SUM(srt::DT_I64, long long)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef K14_HALO_SUM
  }
  if (kind == K_MIN || kind == K_MAX) {
#define K14_HALO_MINMAX(code, T)                                \
  case code:                                                    \
    if (kind == K_MIN) {                                        \
      K14_HALO(T, K_MIN)                                        \
    }                                                           \
    K14_HALO(T, K_MAX)
    switch (dtype) {
      K14_MINMAX_TYPES(K14_HALO_MINMAX)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef K14_HALO_MINMAX
  }
  if (kind == K_FIRST || kind == K_LAST) {
#define K14_HALO_PICK(size, U)                                  \
  case size:                                                    \
    if (kind == K_FIRST) {                                      \
      K14_HALO(U, K_FIRST)                                      \
    }                                                           \
    K14_HALO(U, K_LAST)
    switch (elem_size(dtype)) {
      K14_HALO_PICK(1, unsigned char)
      K14_HALO_PICK(2, unsigned short)
      K14_HALO_PICK(4, unsigned int)
      K14_HALO_PICK(8, unsigned long long)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef K14_HALO_PICK
  }
#undef K14_HALO
  return (int)cudaErrorInvalidValue;
}

// kind 0 count (int64), 1 sum (int64, or float64 for float values), 2 avg
// (float64); values NULL for count.  lower/upper relative to the row unless
// flagged unbounded (1 lower, 2 upper).  Scratch: staged (int64 or float64
// [n], NULL for count), fl uint8[n], tiles 16 B a 2048-row tile, counts
// int64[n + 1], sums [n + 1] (NULL for count).  Four launches.
SRT_API int k14_frame_sums(int kind, const void* values, int dtype,
                           const bool* valid, const int* order,
                           const bool* row_mask, const int* start,
                           const int* end, long long n, long long lower,
                           long long upper, int flags, void* staged,
                           unsigned char* fl, void* tiles, long long* counts,
                           void* sums, void* out, bool* out_valid,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (values == nullptr)
    return (int)sums_run<long long, long long>(
        kind, nullptr, valid, order, row_mask, start, end, n, lower, upper,
        flags, nullptr, fl, tiles, counts, nullptr, out, out_valid, st);
  switch (dtype) {
#define K14_SUM(code, T, A)                                                \
  case code:                                                               \
    return (int)sums_run<T, A>(kind, values, valid, order, row_mask, start, \
                               end, n, lower, upper, flags, staged, fl,    \
                               tiles, counts, sums, out, out_valid, st);
    K14_SUM(srt::DT_BOOL, bool, long long)
    K14_SUM(srt::DT_U8, unsigned char, long long)
    K14_SUM(srt::DT_I8, signed char, long long)
    K14_SUM(srt::DT_I16, short, long long)
    K14_SUM(srt::DT_I32, int, long long)
    K14_SUM(srt::DT_I64, long long, long long)
    K14_SUM(srt::DT_F32, float, double)
    K14_SUM(srt::DT_F64, double, double)
#undef K14_SUM
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// mode 0 unbounded (the forward segment-reset scan read at the segment's
// last row), 1 running (the forward scan at hi - 1), 2 reverse running
// (the reverse scan at lo), 3 bounded (the [n_levels, n] sparse table, two
// lookups).  table: the value dtype, [n_levels, n] (n_levels 1 for the
// scans); fl uint8[n]; tile_c int64, tile_f int32 and tile_acc (value
// dtype) a 2048-row tile (tile_f and tile_acc unused for mode 3); counts
// int64[n + 1].  4 launches, and n_levels - 1 more for mode 3.
SRT_API int k14_frame_minmax(int mode, const void* values, int dtype,
                             int is_min, const bool* valid, const int* order,
                             const bool* row_mask, const int* seg,
                             const int* start, const int* end, long long n,
                             long long lower, long long upper, int flags,
                             int n_levels, void* table, unsigned char* fl,
                             long long* tile_c, int* tile_f, void* tile_acc,
                             long long* counts, void* out, bool* out_valid,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
#define K14_CASE(code, T)                                                   \
  case code:                                                                \
    return is_min                                                           \
        ? (int)minmax_run<T, true>(mode, values, valid, order, row_mask,    \
                                   seg, start, end, n, lower, upper, flags, \
                                   n_levels, table, fl, tile_c, tile_f,     \
                                   tile_acc, counts, out, out_valid, st)    \
        : (int)minmax_run<T, false>(mode, values, valid, order, row_mask,   \
                                    seg, start, end, n, lower, upper,       \
                                    flags, n_levels, table, fl, tile_c,     \
                                    tile_f, tile_acc, counts, out,          \
                                    out_valid, st);
    K14_MINMAX_TYPES(K14_CASE)
#undef K14_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// first (is_last 0) or last of the frame, values of any fixed width (1, 2,
// 4 or 8 bytes) copied as bits.  Scratch: staged (elem_size x n), fl
// uint8[n]; with ignore_nulls edge int32[n] and tile_f, tile_r int32 a
// 2048-row tile.  2 launches, 5 with ignore_nulls.
SRT_API int k14_frame_pick(int is_last, int ignore_nulls, const void* values,
                           int elem_size, const bool* valid, const int* order,
                           const bool* row_mask, const int* start,
                           const int* end, long long n, long long lower,
                           long long upper, int flags, void* staged,
                           unsigned char* fl, int* edge, int* tile_f,
                           int* tile_r, void* out, bool* out_valid,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (elem_size) {
#define K14_PICK(size, U)                                                  \
  case size:                                                               \
    return (int)pick_run<U>(is_last, ignore_nulls, values, valid, order,   \
                            row_mask, start, end, n, lower, upper, flags,  \
                            staged, fl, edge, tile_f, tile_r, out,         \
                            out_valid, st);
    K14_PICK(1, unsigned char)
    K14_PICK(2, unsigned short)
    K14_PICK(4, unsigned int)
    K14_PICK(8, unsigned long long)
#undef K14_PICK
    default:
      return (int)cudaErrorInvalidValue;
  }
}
