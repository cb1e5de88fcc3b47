// K14 — the window kernel: segment bounds, ranks and frame aggregates over
// rows in window order, written back to row order.
//
// Replaces spark_rapids_tpu/exec/window.py: _seg_scan (63), the segment
// start/end and rank arithmetic of _one_window (111) and _frame_agg (179).
// The caller sorts the rows by (partition keys, order keys) with K1 and
// takes the sorted segment ids from K2; `order` maps sorted position i to
// its row, so every kernel here reads a value as values[order[i]] and its
// validity as row_mask[order[i]] && valid[order[i]], and writes results to
// out[order[i]] with validity ANDed with the row mask (data 0 where null).
//
//   * k14_bounds      : forward max-scan and reverse min-scan of index
//                       candidates: segment start/end (from the ids) or
//                       the previous/next valid row (first/last with
//                       ignore_nulls);
//   * k14_rank        : row_number, rank, dense_rank;
//   * k14_prefix      : exclusive prefix counts (n + 1) of the valid rows
//                       and, in the same pass, prefix sums of the masked
//                       values (int64 wrapping, or float64);
//   * k14_frame_sum   : count / sum / avg as P[hi] - P[lo];
//   * k14_seg_scan    : segment-reset running min/max, forward or reverse;
//   * k14_masked, k14_sparse_level : the sparse table of bounded min/max,
//                       level k = min/max over [i, i + 2^k);
//   * k14_frame_minmax: min/max of the frame from a scan or the table;
//   * k14_frame_pick  : first/last by the frame's edge rows.
//
// Frames are [lo, hi) = [i + lower, i + upper + 1) clamped to the segment,
// hi >= lo, as the reference formulates them.  min/max follow
// jnp.minimum/jnp.maximum: NaN propagates and -0.0 is below 0.0.
//
// Bound on this card: bytes.  Every kernel is a pass or three over 4-8 B
// of index and value per row (the gathers through `order` are random
// reads); nothing is compute-heavy.  The scans use one design: a tile pass
// (2048 rows a block, 8 a thread) reduces each tile, one block scans the
// tile totals in order, and a finish pass rescans each tile with its
// carry.  The block scan is a Hillis-Steele scan in shared memory, a tree
// fixed by positions alone, with no atomics and no look-back: a float
// prefix sum gives the same bits every run.
#include <limits.h>

#include "common.cuh"

namespace {

using srt::BLOCK;
using srt::ITEMS;
using srt::TILE;

enum { LOWER_UNBOUNDED = 1, UPPER_UNBOUNDED = 2 };
enum { MODE_UNBOUNDED = 0, MODE_RUNNING = 1, MODE_REVERSE = 2,
       MODE_BOUNDED = 3 };

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
  // int64 sums wrap, as the reference's jnp.cumsum does
  __device__ static long long ident() { return 0; }
  __device__ static long long apply(long long a, long long b) {
    return (long long)((unsigned long long)a + (unsigned long long)b);
  }
};
template <> struct SumOp<double> {
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

// ---------------------------------------------------------------------------
// sorted row i's validity and the frame's edges
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool valid_at(const int* order, const bool* rm,
                                         const bool* valid, long long i) {
  const int o = order[i];
  return rm[o] && (valid == nullptr || valid[o]);
}

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

// ---------------------------------------------------------------------------
// k14_bounds: forward max-scan (fwd) and reverse min-scan (rev) of index
// candidates.  With ids: fwd candidate i at a segment's first row, rev
// candidate i + 1 at its last row (segment start, exclusive end).  Without:
// i at a valid row (fwd: the previous valid row, else -1; rev: the next
// valid row, else n).
// ---------------------------------------------------------------------------
struct BoundsIn {
  const int* ids;
  const bool* valid;
  const int* order;
  const bool* rm;
  long long n;
};

__device__ __forceinline__ void candidates(const BoundsIn& in, long long i,
                                           int* f, int* r) {
  if (in.ids != nullptr) {
    const int s = in.ids[i];
    *f = (i == 0 || in.ids[i - 1] != s) ? (int)i : -1;
    *r = (i == in.n - 1 || in.ids[i + 1] != s) ? (int)(i + 1) : INT_MAX;
  } else {
    const bool v = valid_at(in.order, in.rm, in.valid, i);
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

// ---------------------------------------------------------------------------
// k14_prefix: exclusive prefix counts of the valid sorted rows and, with
// values, prefix sums of the masked sorted values, in one pass
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
__device__ __forceinline__ CountSum<A> element_sum(const T* values,
                                                   const bool* valid,
                                                   const int* order,
                                                   const bool* rm,
                                                   long long i) {
  CountSum<A> e = CountSumOp<A>::ident();
  if (valid_at(order, rm, valid, i)) {
    e.c = 1;
    if (values != nullptr) e.s = (A)values[order[i]];
  }
  return e;
}

template <typename T, typename A>
__device__ __forceinline__ CountSum<A> thread_sum(const T* values,
                                                  const bool* valid,
                                                  const int* order,
                                                  const bool* rm, long long n,
                                                  long long base) {
  CountSum<A> s = CountSumOp<A>::ident();
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i >= n) break;
    s = CountSumOp<A>::apply(s,
                             element_sum<T, A>(values, valid, order, rm, i));
  }
  return s;
}

template <typename T, typename A>
__global__ void prefix_tiles(const T* __restrict__ values,
                             const bool* __restrict__ valid,
                             const int* __restrict__ order,
                             const bool* __restrict__ rm, long long n,
                             CountSum<A>* __restrict__ tiles) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  CountSum<A> total;
  block_scan<CountSum<A>, CountSumOp<A>>(
      thread_sum<T, A>(values, valid, order, rm, n, base), threadIdx.x,
      &total);
  if (threadIdx.x == 0) tiles[blockIdx.x] = total;
}

template <typename A>
__global__ void prefix_tile_scan(CountSum<A>* __restrict__ tiles,
                                 int ntiles) {
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

template <typename T, typename A>
__global__ void prefix_finish(const T* __restrict__ values,
                              const bool* __restrict__ valid,
                              const int* __restrict__ order,
                              const bool* __restrict__ rm, long long n,
                              const CountSum<A>* __restrict__ tiles,
                              long long* __restrict__ counts,
                              A* __restrict__ sums) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  CountSum<A> total;
  const CountSum<A> ex = block_scan<CountSum<A>, CountSumOp<A>>(
      thread_sum<T, A>(values, valid, order, rm, n, base), threadIdx.x,
      &total);
  CountSum<A> run = CountSumOp<A>::apply(tiles[blockIdx.x], ex);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    counts[0] = 0;
    if (sums != nullptr) sums[0] = SumOp<A>::ident();
  }
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i >= n) break;
    run = CountSumOp<A>::apply(
        run, element_sum<T, A>(values, valid, order, rm, i));
    counts[i + 1] = run.c;
    if (sums != nullptr) sums[i + 1] = run.s;
  }
}

template <typename T, typename A>
cudaError_t prefix_run(const void* values, const bool* valid,
                       const int* order, const bool* rm, long long n,
                       long long* counts, void* sums, void* tiles,
                       cudaStream_t st) {
  const int nt = srt::tiles_for(n);
  prefix_tiles<T, A><<<nt, BLOCK, 0, st>>>((const T*)values, valid, order,
                                           rm, n, (CountSum<A>*)tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  prefix_tile_scan<A><<<1, BLOCK, 0, st>>>((CountSum<A>*)tiles, nt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  prefix_finish<T, A><<<nt, BLOCK, 0, st>>>(
      (const T*)values, valid, order, rm, n, (const CountSum<A>*)tiles,
      counts, (A*)sums);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// k14_seg_scan: segment-reset running min/max in scan order (forward, or
// reverse from each segment's last row)
// ---------------------------------------------------------------------------
template <typename T, bool MIN>
__device__ __forceinline__ SegV<T> element_seg(const T* values,
                                               const bool* valid,
                                               const int* order,
                                               const bool* rm, const int* seg,
                                               long long n, bool reverse,
                                               long long i) {
  SegV<T> e;
  const int s = seg[i];
  e.f = reverse ? (i == n - 1 || seg[i + 1] != s)
                : (i == 0 || seg[i - 1] != s);
  e.acc = valid_at(order, rm, valid, i) ? values[order[i]]
                                        : minmax_ident<T, MIN>();
  return e;
}

// this thread's ITEMS rows reduced in scan order
template <typename T, bool MIN>
__device__ __forceinline__ SegV<T> thread_seg(const T* values,
                                              const bool* valid,
                                              const int* order,
                                              const bool* rm, const int* seg,
                                              long long n, bool reverse,
                                              long long base) {
  SegV<T> a = SegOp<T, MIN>::ident();
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + (reverse ? ITEMS - 1 - k : k);
    if (i >= n) continue;
    a = SegOp<T, MIN>::apply(
        a, element_seg<T, MIN>(values, valid, order, rm, seg, n, reverse, i));
  }
  return a;
}

template <typename T, bool MIN>
__global__ void segscan_tiles(const T* __restrict__ values,
                              const bool* __restrict__ valid,
                              const int* __restrict__ order,
                              const bool* __restrict__ rm,
                              const int* __restrict__ seg, long long n,
                              int reverse, int* __restrict__ tile_f,
                              T* __restrict__ tile_acc) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  const int p = reverse ? BLOCK - 1 - threadIdx.x : threadIdx.x;
  SegV<T> total;
  block_scan<SegV<T>, SegOp<T, MIN>>(
      thread_seg<T, MIN>(values, valid, order, rm, seg, n, reverse, base), p,
      &total);
  if (threadIdx.x == 0) {
    tile_f[blockIdx.x] = total.f;
    tile_acc[blockIdx.x] = total.acc;
  }
}

// tile aggregates -> exclusive carry-in per tile, in scan order (one block)
template <typename T, bool MIN>
__global__ void segscan_tile_scan(int* __restrict__ tile_f,
                                  T* __restrict__ tile_acc, int ntiles,
                                  int reverse) {
  SegV<T> carry = SegOp<T, MIN>::ident();
  for (int start = 0; start < ntiles; start += BLOCK) {
    const int q = start + threadIdx.x;
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
__global__ void segscan_finish(const T* __restrict__ values,
                               const bool* __restrict__ valid,
                               const int* __restrict__ order,
                               const bool* __restrict__ rm,
                               const int* __restrict__ seg, long long n,
                               int reverse, const T* __restrict__ tile_acc,
                               T* __restrict__ out) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  const int p = reverse ? BLOCK - 1 - threadIdx.x : threadIdx.x;
  SegV<T> total;
  const SegV<T> ex = block_scan<SegV<T>, SegOp<T, MIN>>(
      thread_seg<T, MIN>(values, valid, order, rm, seg, n, reverse, base), p,
      &total);
  SegV<T> run;
  run.f = 0;
  run.acc = tile_acc[blockIdx.x];
  run = SegOp<T, MIN>::apply(run, ex);
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + (reverse ? ITEMS - 1 - k : k);
    if (i >= n) continue;
    run = SegOp<T, MIN>::apply(
        run, element_seg<T, MIN>(values, valid, order, rm, seg, n, reverse, i));
    out[i] = run.acc;
  }
}

template <typename T, bool MIN>
cudaError_t segscan_run(const void* values, const bool* valid,
                        const int* order, const bool* rm, const int* seg,
                        long long n, int reverse, void* out, int* tile_f,
                        void* tile_acc, cudaStream_t st) {
  const int nt = srt::tiles_for(n);
  segscan_tiles<T, MIN><<<nt, BLOCK, 0, st>>>(
      (const T*)values, valid, order, rm, seg, n, reverse, tile_f,
      (T*)tile_acc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  segscan_tile_scan<T, MIN><<<1, BLOCK, 0, st>>>(tile_f, (T*)tile_acc, nt,
                                                 reverse);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  segscan_finish<T, MIN><<<nt, BLOCK, 0, st>>>(
      (const T*)values, valid, order, rm, seg, n, reverse,
      (const T*)tile_acc, (T*)out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the sparse table of bounded min/max
// ---------------------------------------------------------------------------
template <typename T, bool MIN>
__global__ void masked_values(const T* __restrict__ values,
                              const bool* __restrict__ valid,
                              const int* __restrict__ order,
                              const bool* __restrict__ rm, long long n,
                              T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = valid_at(order, rm, valid, i) ? values[order[i]]
                                         : minmax_ident<T, MIN>();
}

template <typename T, bool MIN>
__global__ void sparse_level(const T* __restrict__ prev, T* __restrict__ next,
                             long long n, long long shift) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  next[i] = comb<T, MIN>(prev[i],
                         i + shift < n ? prev[i + shift] : minmax_ident<T, MIN>());
}

// ---------------------------------------------------------------------------
// frame results, written to row order
// ---------------------------------------------------------------------------
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

__global__ void frame_sum_kernel(int kind, const long long* __restrict__ cnt_p,
                                 const void* __restrict__ sum_p,
                                 int sum_is_float,
                                 const int* __restrict__ order,
                                 const bool* __restrict__ rm,
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
  if (kind == 0) {  // count: valid on every real row
    const bool ok = rm[o];
    ((long long*)out)[o] = ok ? cnt : 0;
    out_valid[o] = ok;
    return;
  }
  const bool ok = cnt > 0 && rm[o];
  out_valid[o] = ok;
  if (sum_is_float) {
    const double* p = (const double*)sum_p;
    double s = p[hi] - p[lo];
    if (kind == 2) s = s / (double)(cnt > 1 ? cnt : 1);
    ((double*)out)[o] = ok ? s : 0.0;
  } else {
    const long long* p = (const long long*)sum_p;
    const long long s =
        (long long)((unsigned long long)p[hi] - (unsigned long long)p[lo]);
    if (kind == 2)
      ((double*)out)[o] = ok ? (double)s / (double)(cnt > 1 ? cnt : 1) : 0.0;
    else
      ((long long*)out)[o] = ok ? s : 0;
  }
}

template <typename T, bool MIN>
__global__ void frame_minmax_kernel(int mode, const T* __restrict__ src,
                                    int n_levels,
                                    const long long* __restrict__ cnt_p,
                                    const int* __restrict__ order,
                                    const bool* __restrict__ rm,
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
  const bool ok = cnt_p[hi] - cnt_p[lo] > 0 && rm[o];
  out[o] = ok ? v : (T)0;
  out_valid[o] = ok;
}

template <typename U>
__global__ void frame_pick_kernel(int is_last, int ignore_nulls,
                                  const U* __restrict__ values,
                                  const bool* __restrict__ valid,
                                  const int* __restrict__ order,
                                  const bool* __restrict__ rm,
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
  if (!ignore_nulls) ok = ok && valid_at(order, rm, valid, jc);
  const int o = order[i];
  ok = ok && rm[o];
  out[o] = ok ? values[order[jc]] : (U)0;
  out_valid[o] = ok;
}

// dtype dispatch of the min/max kernels
#define K14_MINMAX_TYPES(X)        \
  X(srt::DT_I8, signed char)       \
  X(srt::DT_I16, short)            \
  X(srt::DT_I32, int)              \
  X(srt::DT_I64, long long)        \
  X(srt::DT_F32, float)            \
  X(srt::DT_F64, double)

}  // namespace

// ids != NULL: fwd = segment start, rev = segment end (exclusive) of the
// nondecreasing ids.  ids == NULL: fwd = previous valid sorted row (-1 if
// none), rev = next valid sorted row (n if none), validity read through
// order and row_mask (valid == NULL: every real row).  fwd or rev may be
// NULL.  Scratch: two int32 arrays of one entry per 2048-row tile.
SRT_API int k14_bounds(const int* ids, const bool* valid, const int* order,
                       const bool* row_mask, long long n, int* fwd, int* rev,
                       int* tile_f, int* tile_r, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  BoundsIn in{ids, valid, order, row_mask, n};
  const int nt = srt::tiles_for(n);
  bounds_tiles<<<nt, srt::BLOCK, 0, st>>>(in, tile_f, tile_r);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bounds_tile_scan<<<1, srt::BLOCK, 0, st>>>(tile_f, tile_r, nt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bounds_finish<<<nt, srt::BLOCK, 0, st>>>(in, tile_f, tile_r, fwd, rev);
  return (int)cudaGetLastError();
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

// counts: n + 1 exclusive prefix counts of the valid sorted rows; with
// values, sums: n + 1 exclusive prefix sums of the sorted masked values
// from the same pass, int64 (wrapping) for integer and bool inputs,
// float64 for floats.  Scratch: 16 bytes a 2048-row tile.
SRT_API int k14_prefix(const void* values, int dtype, const bool* valid,
                       const int* order, const bool* row_mask, long long n,
                       long long* counts, void* sums, void* tiles,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (values == nullptr)
    return (int)prefix_run<long long, long long>(
        nullptr, valid, order, row_mask, n, counts, nullptr, tiles, st);
  switch (dtype) {
#define K14_SUM(code, T, A)                                              \
  case code:                                                             \
    return (int)prefix_run<T, A>(values, valid, order, row_mask, n,      \
                                 counts, sums, tiles, st);
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

// kind 0 count (int64), 1 sum (int64 or float64, as the prefix sums),
// 2 avg (float64); lower/upper relative to the row unless flagged
// unbounded (1 lower, 2 upper)
SRT_API int k14_frame_sum(int kind, const long long* counts, const void* sums,
                          int sums_are_float, const int* order,
                          const bool* row_mask, const int* start,
                          const int* end, long long n, long long lower,
                          long long upper, int flags, void* out,
                          bool* out_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  frame_sum_kernel<<<srt::blocks_for(n, srt::BLOCK), srt::BLOCK, 0, st>>>(
      kind, counts, sums, sums_are_float, order, row_mask, start, end, n,
      lower, upper, flags, out, out_valid);
  return (int)cudaGetLastError();
}

// segment-reset running min (is_min) or max of the sorted masked values,
// from each segment's first row (or, reverse, from its last).  Scratch:
// tile_f int32 and tile_acc (value type) per tile.
SRT_API int k14_seg_scan(const void* values, int dtype, const bool* valid,
                         const int* order, const bool* row_mask,
                         const int* seg, long long n, int is_min,
                         int reverse, void* out, int* tile_f, void* tile_acc,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
#define K14_CASE(code, T)                                                   \
  case code:                                                                \
    return is_min ? (int)segscan_run<T, true>(values, valid, order,        \
                                               row_mask, seg, n, reverse,  \
                                               out, tile_f, tile_acc, st)  \
                  : (int)segscan_run<T, false>(values, valid, order,       \
                                                row_mask, seg, n, reverse, \
                                                out, tile_f, tile_acc, st);
    K14_MINMAX_TYPES(K14_CASE)
#undef K14_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// level 0 of the sparse table: the sorted values, identity where null
SRT_API int k14_masked(const void* values, int dtype, const bool* valid,
                       const int* order, const bool* row_mask, long long n,
                       int is_min, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = srt::blocks_for(n, srt::BLOCK);
  switch (dtype) {
#define K14_CASE(code, T)                                                  \
  case code:                                                               \
    if (is_min)                                                            \
      masked_values<T, true><<<g, srt::BLOCK, 0, st>>>(                         \
          (const T*)values, valid, order, row_mask, n, (T*)out);           \
    else                                                                   \
      masked_values<T, false><<<g, srt::BLOCK, 0, st>>>(                        \
          (const T*)values, valid, order, row_mask, n, (T*)out);           \
    return (int)cudaGetLastError();
    K14_MINMAX_TYPES(K14_CASE)
#undef K14_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// next[i] = min/max(prev[i], prev[i + shift]) (identity past the end)
SRT_API int k14_sparse_level(const void* prev, void* next, int dtype,
                             long long n, long long shift, int is_min,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = srt::blocks_for(n, srt::BLOCK);
  switch (dtype) {
#define K14_CASE(code, T)                                                  \
  case code:                                                               \
    if (is_min)                                                            \
      sparse_level<T, true><<<g, srt::BLOCK, 0, st>>>((const T*)prev, (T*)next, \
                                                 n, shift);                \
    else                                                                   \
      sparse_level<T, false><<<g, srt::BLOCK, 0, st>>>((const T*)prev,         \
                                                  (T*)next, n, shift);     \
    return (int)cudaGetLastError();
    K14_MINMAX_TYPES(K14_CASE)
#undef K14_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// mode 0 unbounded (src = forward scan, read at the segment's last row),
// 1 running (forward scan at hi - 1), 2 reverse running (reverse scan at
// lo), 3 bounded (src = the [n_levels, n] sparse table, two lookups)
SRT_API int k14_frame_minmax(int mode, const void* src, int n_levels,
                             int dtype, int is_min, const long long* counts,
                             const int* order, const bool* row_mask,
                             const int* start, const int* end, long long n,
                             long long lower, long long upper, int flags,
                             void* out, bool* out_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = srt::blocks_for(n, srt::BLOCK);
  switch (dtype) {
#define K14_CASE(code, T)                                                  \
  case code:                                                               \
    if (is_min)                                                            \
      frame_minmax_kernel<T, true><<<g, srt::BLOCK, 0, st>>>(                   \
          mode, (const T*)src, n_levels, counts, order, row_mask, start,   \
          end, n, lower, upper, flags, (T*)out, out_valid);                \
    else                                                                   \
      frame_minmax_kernel<T, false><<<g, srt::BLOCK, 0, st>>>(                  \
          mode, (const T*)src, n_levels, counts, order, row_mask, start,   \
          end, n, lower, upper, flags, (T*)out, out_valid);                \
    return (int)cudaGetLastError();
    K14_MINMAX_TYPES(K14_CASE)
#undef K14_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// first (is_last 0) or last of the frame; with ignore_nulls, `edge` holds
// the next (first) or previous (last) valid sorted row from k14_bounds.
// Values of any fixed width (1, 2, 4 or 8 bytes) are copied as bits.
SRT_API int k14_frame_pick(int is_last, int ignore_nulls, const void* values,
                           int elem_size, const bool* valid, const int* order,
                           const bool* row_mask, const int* edge,
                           const int* start, const int* end, long long n,
                           long long lower, long long upper, int flags,
                           void* out, bool* out_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = srt::blocks_for(n, srt::BLOCK);
  switch (elem_size) {
#define K14_PICK(size, U)                                                 \
  case size:                                                              \
    frame_pick_kernel<U><<<g, srt::BLOCK, 0, st>>>(                            \
        is_last, ignore_nulls, (const U*)values, valid, order, row_mask,  \
        edge, start, end, n, lower, upper, flags, (U*)out, out_valid);    \
    return (int)cudaGetLastError();
    K14_PICK(1, unsigned char)
    K14_PICK(2, unsigned short)
    K14_PICK(4, unsigned int)
    K14_PICK(8, unsigned long long)
#undef K14_PICK
    default:
      return (int)cudaErrorInvalidValue;
  }
}
