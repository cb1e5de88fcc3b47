// K3 — segmented reduction over contiguous runs of sorted rows.
//
// Replaces spark_rapids_tpu/ops/kernels/segment.py:segment_reduce_device
// (397) and segment_pick_device (378), and the jax.ops.segment_min of row
// indices behind the aggregate's segment starts
// (spark_rapids_tpu/exec/aggregate.py:180).  Per segment it returns the
// sum / min / max of the valid rows (identity where none) and the count
// of valid rows; the "index" input reduces the row index itself, which
// gives the first/last picks and the segment starts.
//
// Precondition: segment ids are nondecreasing, so every segment is one
// contiguous run (true of ids from K2 and of the no-key aggregate's
// `where(row_mask, 0, row + 1)`).
//
// Bound on this card: bytes.  Values (8 B), validity (1 B) and ids (4 B)
// are read once and n_segments accumulators + counts written once: about
// 13 + 16 = 29 B/row, ~73 us over 8,388,608 rows at 3.35 TB/s.  Q1 has a
// handful of runs of ~1.5M rows each, and its final aggregate one run per
// padding row, so the design must not depend on run length: it is an
// inclusive segmented scan (flag = run start) whose value at each run's
// last row is the run's total.
//   * fill: every segment starts at the identity with count 0;
//   * tile pass: each block reduces 2048 rows (8 per thread, then warp
//     shuffles, then the warps) to one segmented aggregate per tile;
//   * one block scans the tile aggregates (exclusive) in order;
//   * finish pass: each block rescans its tile with the carry-in and the
//     thread owning a run's last row writes the run's total.
// No float atomics: the reduction tree is fixed by positions alone, so two
// runs give the same bits.
#include <limits.h>

#include "common.cuh"

namespace {

using srt::BLOCK;
using srt::FULL_MASK;
using srt::ITEMS;
using srt::TILE;

enum Op { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };

template <typename A> struct Lim;
template <> struct Lim<double> {
  __device__ static double hi() { return __longlong_as_double(0x7ff0000000000000ll); }
  __device__ static double lo() { return -hi(); }
};
template <> struct Lim<float> {
  __device__ static float hi() { return __int_as_float(0x7f800000); }
  __device__ static float lo() { return -hi(); }
};
template <> struct Lim<long long> {
  __device__ static long long lo() { return LLONG_MIN; }
  __device__ static long long hi() { return LLONG_MAX; }
};
template <> struct Lim<int> {
  __device__ static int lo() { return INT_MIN; }
  __device__ static int hi() { return INT_MAX; }
};
template <> struct Lim<short> {
  __device__ static short lo() { return SHRT_MIN; }
  __device__ static short hi() { return SHRT_MAX; }
};
template <> struct Lim<signed char> {
  __device__ static signed char lo() { return SCHAR_MIN; }
  __device__ static signed char hi() { return SCHAR_MAX; }
};

template <typename A> __device__ __forceinline__ bool is_nan(A) { return false; }
template <> __device__ __forceinline__ bool is_nan<double>(double v) { return v != v; }
template <> __device__ __forceinline__ bool is_nan<float>(float v) { return v != v; }

template <typename A, int OP> struct Red {
  __device__ static A identity() {
    if (OP == OP_SUM) return (A)0;
    return OP == OP_MIN ? Lim<A>::hi() : Lim<A>::lo();
  }
  // NaN propagates through min/max, as in XLA's segment_min/max
  __device__ static A apply(A a, A b) {
    if (OP == OP_SUM) return a + b;
    if (is_nan(a)) return a;
    if (is_nan(b)) return b;
    if (OP == OP_MIN) return b < a ? b : a;
    return b > a ? b : a;
  }
};

template <typename A> struct Agg {
  int f;         // a run starts inside the span
  A acc;         // reduction since the last run start
  long long cnt; // valid rows since the last run start
};

template <typename A, int OP>
__device__ __forceinline__ Agg<A> combine(const Agg<A>& l, const Agg<A>& r) {
  Agg<A> o;
  o.f = l.f | r.f;
  o.acc = r.f ? r.acc : Red<A, OP>::apply(l.acc, r.acc);
  o.cnt = r.f ? r.cnt : l.cnt + r.cnt;
  return o;
}

template <typename A>
__device__ __forceinline__ A shfl_up(A v, int o) {
  return __shfl_up_sync(FULL_MASK, v, o);
}
template <>
__device__ __forceinline__ short shfl_up<short>(short v, int o) {
  return (short)__shfl_up_sync(FULL_MASK, (int)v, o);
}
template <>
__device__ __forceinline__ signed char shfl_up<signed char>(signed char v, int o) {
  return (signed char)__shfl_up_sync(FULL_MASK, (int)v, o);
}

template <typename A, int OP>
__device__ __forceinline__ Agg<A> neutral() {
  Agg<A> z;
  z.f = 0;
  z.acc = Red<A, OP>::identity();
  z.cnt = 0;
  return z;
}

// exclusive segmented scan of one Agg per thread over the block;
// *total receives the block's inclusive aggregate
template <typename A, int OP>
__device__ Agg<A> block_seg_scan(Agg<A> v, Agg<A>* total) {
  __shared__ int s_f[32];
  __shared__ A s_acc[32];
  __shared__ long long s_cnt[32];
  __shared__ int t_f;
  __shared__ A t_acc;
  __shared__ long long t_cnt;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  Agg<A> incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    Agg<A> p;
    p.f = __shfl_up_sync(FULL_MASK, incl.f, o);
    p.acc = shfl_up<A>(incl.acc, o);
    p.cnt = __shfl_up_sync(FULL_MASK, incl.cnt, o);
    if (lane >= o) incl = combine<A, OP>(p, incl);
  }
  Agg<A> excl;
  excl.f = __shfl_up_sync(FULL_MASK, incl.f, 1);
  excl.acc = shfl_up<A>(incl.acc, 1);
  excl.cnt = __shfl_up_sync(FULL_MASK, incl.cnt, 1);
  if (lane == 0) excl = neutral<A, OP>();
  if (lane == 31) {
    s_f[w] = incl.f;
    s_acc[w] = incl.acc;
    s_cnt[w] = incl.cnt;
  }
  __syncthreads();
  if (w == 0) {
    Agg<A> a = neutral<A, OP>();
    if (lane < nw) {
      a.f = s_f[lane];
      a.acc = s_acc[lane];
      a.cnt = s_cnt[lane];
    }
    Agg<A> wi = a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      Agg<A> p;
      p.f = __shfl_up_sync(FULL_MASK, wi.f, o);
      p.acc = shfl_up<A>(wi.acc, o);
      p.cnt = __shfl_up_sync(FULL_MASK, wi.cnt, o);
      if (lane >= o) wi = combine<A, OP>(p, wi);
    }
    Agg<A> we;
    we.f = __shfl_up_sync(FULL_MASK, wi.f, 1);
    we.acc = shfl_up<A>(wi.acc, 1);
    we.cnt = __shfl_up_sync(FULL_MASK, wi.cnt, 1);
    if (lane == 0) we = neutral<A, OP>();
    if (lane < nw) {
      s_f[lane] = we.f;
      s_acc[lane] = we.acc;
      s_cnt[lane] = we.cnt;
    }
    if (lane == 31) {
      t_f = wi.f;
      t_acc = wi.acc;
      t_cnt = wi.cnt;
    }
  }
  __syncthreads();
  Agg<A> wp;
  wp.f = s_f[w];
  wp.acc = s_acc[w];
  wp.cnt = s_cnt[w];
  const Agg<A> r = combine<A, OP>(wp, excl);
  total->f = t_f;
  total->acc = t_acc;
  total->cnt = t_cnt;
  __syncthreads();
  return r;
}

// row i's element: (run-start flag, value or identity, valid count)
template <typename T, typename A, int OP>
__device__ __forceinline__ Agg<A> element(const T* values, const bool* valid,
                                          const int* seg, long long i) {
  Agg<A> e;
  e.f = (i == 0 || seg[i] != seg[i - 1]) ? 1 : 0;
  const bool v = valid == nullptr ? true : valid[i];
  const A x = values == nullptr ? (A)i : (A)values[i];
  e.acc = v ? x : Red<A, OP>::identity();
  e.cnt = v ? 1 : 0;
  return e;
}

template <typename A, int OP>
__global__ void fill(A* __restrict__ out, long long* __restrict__ cnt,
                     long long n_segments) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_segments) return;
  out[s] = Red<A, OP>::identity();
  cnt[s] = 0;
}

template <typename T, typename A, int OP>
__global__ void tile_pass(const T* __restrict__ values,
                          const bool* __restrict__ valid,
                          const int* __restrict__ seg, long long n,
                          int* __restrict__ tile_f, A* __restrict__ tile_acc,
                          long long* __restrict__ tile_cnt) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  Agg<A> t = neutral<A, OP>();
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i < n) t = combine<A, OP>(t, element<T, A, OP>(values, valid, seg, i));
  }
  Agg<A> total;
  block_seg_scan<A, OP>(t, &total);
  if (threadIdx.x == 0) {
    tile_f[blockIdx.x] = total.f;
    tile_acc[blockIdx.x] = total.acc;
    tile_cnt[blockIdx.x] = total.cnt;
  }
}

// tile aggregates -> exclusive carry-in per tile, in place (one block)
template <typename A, int OP>
__global__ void tile_scan(int* __restrict__ tile_f, A* __restrict__ tile_acc,
                          long long* __restrict__ tile_cnt, int ntiles) {
  Agg<A> carry = neutral<A, OP>();
  for (int start = 0; start < ntiles; start += blockDim.x) {
    const int t = start + threadIdx.x;
    Agg<A> v = neutral<A, OP>();
    if (t < ntiles) {
      v.f = tile_f[t];
      v.acc = tile_acc[t];
      v.cnt = tile_cnt[t];
    }
    Agg<A> total;
    const Agg<A> ex = block_seg_scan<A, OP>(v, &total);
    const Agg<A> r = combine<A, OP>(carry, ex);
    if (t < ntiles) {
      tile_acc[t] = r.acc;
      tile_cnt[t] = r.cnt;
    }
    carry = combine<A, OP>(carry, total);
  }
}

template <typename T, typename A, int OP>
__global__ void finish_pass(const T* __restrict__ values,
                            const bool* __restrict__ valid,
                            const int* __restrict__ seg, long long n,
                            const A* __restrict__ carry_acc,
                            const long long* __restrict__ carry_cnt,
                            long long n_segments, A* __restrict__ out,
                            long long* __restrict__ out_cnt) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  Agg<A> t = neutral<A, OP>();
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i < n) t = combine<A, OP>(t, element<T, A, OP>(values, valid, seg, i));
  }
  Agg<A> total;
  const Agg<A> prefix = block_seg_scan<A, OP>(t, &total);
  Agg<A> run;
  run.f = 0;
  run.acc = carry_acc[blockIdx.x];
  run.cnt = carry_cnt[blockIdx.x];
  run = combine<A, OP>(run, prefix);
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i >= n) break;
    run = combine<A, OP>(run, element<T, A, OP>(values, valid, seg, i));
    const int s = seg[i];
    const bool last = (i == n - 1) || seg[i + 1] != s;
    if (last && s >= 0 && (long long)s < n_segments) {
      out[s] = run.acc;
      out_cnt[s] = run.cnt;
    }
  }
}

template <typename T, typename A, int OP>
cudaError_t run(const void* values, const void* valid, const void* seg,
                long long n, long long n_segments, void* out, void* out_cnt,
                void* tile_f, void* tile_acc, void* tile_cnt,
                cudaStream_t st) {
  fill<A, OP><<<srt::blocks_for(n_segments, BLOCK), BLOCK, 0, st>>>(
      (A*)out, (long long*)out_cnt, n_segments);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n == 0) return e;
  const int ntiles = srt::tiles_for(n);
  tile_pass<T, A, OP><<<ntiles, BLOCK, 0, st>>>(
      (const T*)values, (const bool*)valid, (const int*)seg, n,
      (int*)tile_f, (A*)tile_acc, (long long*)tile_cnt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  tile_scan<A, OP><<<1, srt::scan_threads(ntiles), 0, st>>>((int*)tile_f, (A*)tile_acc,
                                       (long long*)tile_cnt, ntiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  finish_pass<T, A, OP><<<ntiles, BLOCK, 0, st>>>(
      (const T*)values, (const bool*)valid, (const int*)seg, n,
      (const A*)tile_acc, (const long long*)tile_cnt, n_segments, (A*)out,
      (long long*)out_cnt);
  return cudaGetLastError();
}

template <typename T, typename A>
cudaError_t run_op(int op, const void* values, const void* valid,
                   const void* seg, long long n, long long n_segments,
                   void* out, void* out_cnt, void* tf, void* ta, void* tc,
                   cudaStream_t st) {
  switch (op) {
    case OP_SUM:
      return run<T, A, OP_SUM>(values, valid, seg, n, n_segments, out,
                               out_cnt, tf, ta, tc, st);
    case OP_MIN:
      return run<T, A, OP_MIN>(values, valid, seg, n, n_segments, out,
                               out_cnt, tf, ta, tc, st);
    case OP_MAX:
      return run<T, A, OP_MAX>(values, valid, seg, n, n_segments, out,
                               out_cnt, tf, ta, tc, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// values == NULL reduces the row index (int64).  Accumulator types: sums
// take float64 for float inputs and int64 otherwise; min/max keep the
// input type.  valid == NULL treats every row as valid.  Scratch, per
// tile of 2048 rows: tile_f int32, tile_acc (accumulator type), tile_cnt
// int64.
SRT_API int k3_segment_reduce(const void* values, int in_dtype,
                              const void* valid, const void* seg_ids,
                              long long n, long long n_segments, int op,
                              void* out, void* out_cnt, void* tile_f,
                              void* tile_acc, void* tile_cnt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaErrorInvalidValue;
  const bool sum = op == OP_SUM;
  if (values == nullptr) {
    e = run_op<long long, long long>(op, nullptr, valid, seg_ids, n,
                                     n_segments, out, out_cnt, tile_f,
                                     tile_acc, tile_cnt, st);
    return (int)e;
  }
  switch (in_dtype) {
    case srt::DT_BOOL:
      if (sum)
        e = run_op<bool, long long>(op, values, valid, seg_ids, n,
                                    n_segments, out, out_cnt, tile_f,
                                    tile_acc, tile_cnt, st);
      break;
    case srt::DT_I8:
      e = sum ? run_op<signed char, long long>(op, values, valid, seg_ids, n,
                                               n_segments, out, out_cnt,
                                               tile_f, tile_acc, tile_cnt, st)
              : run_op<signed char, signed char>(op, values, valid, seg_ids,
                                                 n, n_segments, out, out_cnt,
                                                 tile_f, tile_acc, tile_cnt,
                                                 st);
      break;
    case srt::DT_I16:
      e = sum ? run_op<short, long long>(op, values, valid, seg_ids, n,
                                         n_segments, out, out_cnt, tile_f,
                                         tile_acc, tile_cnt, st)
              : run_op<short, short>(op, values, valid, seg_ids, n,
                                     n_segments, out, out_cnt, tile_f,
                                     tile_acc, tile_cnt, st);
      break;
    case srt::DT_I32:
      e = sum ? run_op<int, long long>(op, values, valid, seg_ids, n,
                                       n_segments, out, out_cnt, tile_f,
                                       tile_acc, tile_cnt, st)
              : run_op<int, int>(op, values, valid, seg_ids, n, n_segments,
                                 out, out_cnt, tile_f, tile_acc, tile_cnt,
                                 st);
      break;
    case srt::DT_I64:
      e = run_op<long long, long long>(op, values, valid, seg_ids, n,
                                       n_segments, out, out_cnt, tile_f,
                                       tile_acc, tile_cnt, st);
      break;
    case srt::DT_F32:
      e = sum ? run_op<float, double>(op, values, valid, seg_ids, n,
                                      n_segments, out, out_cnt, tile_f,
                                      tile_acc, tile_cnt, st)
              : run_op<float, float>(op, values, valid, seg_ids, n,
                                     n_segments, out, out_cnt, tile_f,
                                     tile_acc, tile_cnt, st);
      break;
    case srt::DT_F64:
      e = run_op<double, double>(op, values, valid, seg_ids, n, n_segments,
                                 out, out_cnt, tile_f, tile_acc, tile_cnt,
                                 st);
      break;
    default:
      break;
  }
  return (int)e;
}
