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
// `where(row_mask, 0, 1)`).
//
// Bound on this card: bytes.  The ids (4 B a row) are read once, each
// buffer's values (up to 8 B) and validity (1 B) once, and each buffer's
// n_segments results and counts written once: for one float64 sum over
// 8,388,608 rows about 13 + 16 = 29 B a row, ~73 us at 3.35 TB/s.  Q1
// has a handful of runs of ~1.5M rows each, and its final aggregate one
// run per padding row, so the design must not depend on run length.
//
// Design: one data pass for every buffer of an aggregate node.  The
// buffers travel as a descriptor table in the kernel parameters (a
// __grid_constant__ struct of K3_BUFS buffers, ~1.3 KB), so the node's
// buffers and its segment starts reduce against one read of the ids.
//   * reduce_tiles (one block a tile of 2,048 rows, 8 consecutive rows a
//     thread): the thread loads its rows' ids once and marks run starts
//     and ends; then, buffer by buffer, it reads the values and validity
//     of its rows once, the block takes an exclusive segmented scan of
//     the threads' aggregates (warp shuffles, then the warps), and the
//     thread owning a run's last row writes the run's result where the
//     run starts inside the tile.  A run that comes into the tile from an
//     earlier one and ends here leaves its in-tile part (the "head") in
//     a small scratch array, beside the tile's own aggregate.
//   * finish_runs (one small launch): a block a buffer scans the tiles'
//     aggregates in tile order (each thread a fixed span of tiles, then
//     one block scan) and writes each open head's result as its carry
//     combined with the head; further blocks write the identity into the
//     slots past the last id, the only slots no row reaches (an id gap
//     inside the rows is filled in reduce_tiles by the thread at the
//     next run's start).
// Each slot is written once; nothing fills all n_segments slots first.
// No float atomics: every combination is fixed by positions alone, so
// two runs give the same bits.
#include <limits.h>
#include <string.h>

#include "common.cuh"

namespace {

using srt::BLOCK;
using srt::FULL_MASK;
using srt::ITEMS;
using srt::TILE;

enum Op { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2, OP_COUNT = 3 };

constexpr int K3_BUFS = 32;     // buffers a launch (the wrapper's table)
constexpr int PART_WORDS = 5;   // scratch words a tile and buffer
constexpr int SCAN_WORDS = 3 * 32 + 3;
constexpr int MAX_FILL_BLOCKS = 1024;

struct RedBuf {
  const void* values;   // the values (unread with index)
  const bool* valid;    // NULL: every row
  void* out;            // NULL: no results (a count)
  void* out_cnt;        // NULL: no counts; int64, or bool with has
  int in_dtype;         // srt::DtypeCode of values
  int op;
  int has;              // write count > 0 (a bool) instead of the count
  int index;            // reduce the row index instead of values
};

__device__ __forceinline__ void put_count(const RedBuf& b, long long s,
                                          long long c) {
  if (b.out_cnt == nullptr) return;
  if (b.has)
    ((bool*)b.out_cnt)[s] = c > 0;
  else
    ((long long*)b.out_cnt)[s] = c;
}

struct RedTable {
  int n;
  RedBuf buf[K3_BUFS];
};

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
  int f;          // a run starts inside the span
  A acc;          // reduction since the last run start
  long long cnt;  // valid rows since the last run start
};

template <typename A, int OP>
__device__ __forceinline__ Agg<A> combine(const Agg<A>& l, const Agg<A>& r) {
  Agg<A> o;
  o.f = l.f | r.f;
  o.acc = r.f ? r.acc : Red<A, OP>::apply(l.acc, r.acc);
  o.cnt = r.f ? r.cnt : l.cnt + r.cnt;
  return o;
}

template <typename A, int OP>
__device__ __forceinline__ Agg<A> neutral() {
  Agg<A> z;
  z.f = 0;
  z.acc = Red<A, OP>::identity();
  z.cnt = 0;
  return z;
}

// an accumulator in a 64-bit scratch word and back
template <typename A>
__device__ __forceinline__ unsigned long long to_word(A v) {
  unsigned long long w = 0;
  memcpy(&w, &v, sizeof(A));
  return w;
}
template <typename A>
__device__ __forceinline__ A from_word(unsigned long long w) {
  A v;
  memcpy(&v, &w, sizeof(A));
  return v;
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

// a thread's `rows` consecutive elements from p[i0]: 16-byte (or, for
// one-byte elements, 8-byte) loads where the run is whole and aligned
template <typename T>
__device__ __forceinline__ void load_items(const T* p, long long i0,
                                           int rows, T* out) {
  constexpr int BYTES = (int)sizeof(T) * ITEMS;
  const uintptr_t at = (uintptr_t)(p + i0);
  if (rows == ITEMS && BYTES % 16 == 0 && (at & 15) == 0) {
    srt::Bytes16 w[BYTES / 16 > 0 ? BYTES / 16 : 1];
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k) w[k] = ((const srt::Bytes16*)at)[k];
    memcpy(out, w, BYTES);
  } else if (rows == ITEMS && BYTES == 8 && (at & 7) == 0) {
    const unsigned long long w = *(const unsigned long long*)at;
    memcpy(out, &w, BYTES);
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) out[j] = j < rows ? p[i0 + j] : T();
  }
}

template <typename A, int OP>
__device__ __forceinline__ Agg<A> shfl_agg(const Agg<A>& v, int o) {
  Agg<A> p;
  p.f = __shfl_up_sync(FULL_MASK, v.f, o);
  p.acc = shfl_up<A>(v.acc, o);
  p.cnt = __shfl_up_sync(FULL_MASK, v.cnt, o);
  return p;
}

template <typename A, int OP>
__device__ __forceinline__ Agg<A> warp_incl(Agg<A> v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Agg<A> p = shfl_agg<A, OP>(v, o);
    if (lane >= o) v = combine<A, OP>(p, v);
  }
  return v;
}

// Exclusive segmented scan of one Agg per thread over the block (a warp
// multiple of threads); *total receives the block's inclusive aggregate.
// `sh` holds SCAN_WORDS shared words; ends with a barrier, so it may be
// called again.
template <typename A, int OP>
__device__ Agg<A> block_seg_scan(Agg<A> v, Agg<A>* total,
                                 unsigned long long* sh) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const Agg<A> incl = warp_incl<A, OP>(v);
  Agg<A> excl = shfl_agg<A, OP>(incl, 1);
  if (lane == 0) excl = neutral<A, OP>();
  if (lane == 31) {
    sh[w] = (unsigned long long)incl.f;
    sh[32 + w] = to_word<A>(incl.acc);
    sh[64 + w] = (unsigned long long)incl.cnt;
  }
  __syncthreads();
  if (w == 0) {
    Agg<A> a = neutral<A, OP>();
    if (lane < nw) {
      a.f = (int)sh[lane];
      a.acc = from_word<A>(sh[32 + lane]);
      a.cnt = (long long)sh[64 + lane];
    }
    const Agg<A> wi = warp_incl<A, OP>(a);
    Agg<A> we = shfl_agg<A, OP>(wi, 1);
    if (lane == 0) we = neutral<A, OP>();
    if (lane < nw) {
      sh[lane] = (unsigned long long)we.f;
      sh[32 + lane] = to_word<A>(we.acc);
      sh[64 + lane] = (unsigned long long)we.cnt;
    }
    if (lane == 31) {
      sh[96] = (unsigned long long)wi.f;
      sh[97] = to_word<A>(wi.acc);
      sh[98] = (unsigned long long)wi.cnt;
    }
  }
  __syncthreads();
  Agg<A> wp;
  wp.f = (int)sh[w];
  wp.acc = from_word<A>(sh[32 + w]);
  wp.cnt = (long long)sh[64 + w];
  const Agg<A> r = combine<A, OP>(wp, excl);
  total->f = (int)sh[96];
  total->acc = from_word<A>(sh[97]);
  total->cnt = (long long)sh[98];
  __syncthreads();
  return r;
}

// Calls fn.run<T, A, OP>() for a buffer's value type T, accumulator type
// A (sums: int64 or float64; min/max: the value type) and op; a count
// reduces nothing but the counts.
template <int OP, typename Fn>
__device__ __forceinline__ void with_minmax(const RedBuf& b, Fn& fn) {
  if (b.index) {
    fn.template run<long long, long long, OP>();
    return;
  }
  switch (b.in_dtype) {
    case srt::DT_I8: fn.template run<signed char, signed char, OP>(); break;
    case srt::DT_I16: fn.template run<short, short, OP>(); break;
    case srt::DT_I32: fn.template run<int, int, OP>(); break;
    case srt::DT_I64: fn.template run<long long, long long, OP>(); break;
    case srt::DT_F32: fn.template run<float, float, OP>(); break;
    default: fn.template run<double, double, OP>();
  }
}

template <typename Fn>
__device__ __forceinline__ void with_types(const RedBuf& b, Fn& fn) {
  if (b.op == OP_MIN) {
    with_minmax<OP_MIN>(b, fn);
  } else if (b.op == OP_MAX) {
    with_minmax<OP_MAX>(b, fn);
  } else if (b.op == OP_COUNT || b.index) {
    fn.template run<long long, long long, OP_SUM>();
  } else {
    switch (b.in_dtype) {
      case srt::DT_BOOL: fn.template run<bool, long long, OP_SUM>(); break;
      case srt::DT_I8: fn.template run<signed char, long long, OP_SUM>(); break;
      case srt::DT_I16: fn.template run<short, long long, OP_SUM>(); break;
      case srt::DT_I32: fn.template run<int, long long, OP_SUM>(); break;
      case srt::DT_I64: fn.template run<long long, long long, OP_SUM>(); break;
      case srt::DT_F32: fn.template run<float, double, OP_SUM>(); break;
      default: fn.template run<double, double, OP_SUM>();
    }
  }
}

// slot s of a buffer that no row reaches: the identity and a count of 0
struct WriteIdentity {
  const RedBuf& b;
  long long s;
  template <typename T, typename A, int OP>
  __device__ void run() {
    if (b.out != nullptr) ((A*)b.out)[s] = Red<A, OP>::identity();
    put_count(b, s, 0);
  }
};

// a thread's ITEMS rows of the ids: run starts and ends as bit masks
struct Rows {
  long long i0;  // the first row
  int rows;      // rows of the thread below n (0..ITEMS)
  int id[ITEMS];
  int prev;      // id of row i0 - 1 (-1 before row 0)
  unsigned starts, ends;
};

// The tile's results, staged in shared memory so that they are written
// row by row across the threads (coalesced where runs are short): row r's
// run result where a run that started in the tile ends at r.
struct Staged {
  int id[TILE];                  // the tile's ids
  unsigned long long acc[TILE];  // the result's bits
  int cnt[TILE];                 // its count (a run inside one tile)
  bool w[TILE];                  // row r ends a run that started here
};

// one buffer over the tile: runs that start in the tile are written where
// they end; the tile's aggregate and its open head go to `part`
struct TileBuffer {
  const RedBuf& b;
  const Rows& r;
  unsigned long long* part;
  unsigned long long* sh;
  Staged& st;
  int tile_rows;
  long long n_segments;
  template <typename T, typename A, int OP>
  __device__ void run() {
    const bool index = b.index || b.op == OP_COUNT;
    T in[ITEMS];
    bool ok[ITEMS];
    if (!index) load_items<T>((const T*)b.values, r.i0, r.rows, in);
    if (b.valid != nullptr) load_items<bool>(b.valid, r.i0, r.rows, ok);
    A x[ITEMS];
    unsigned vm = 0;
    Agg<A> agg = neutral<A, OP>();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      x[j] = Red<A, OP>::identity();
      if (j < r.rows) {
        const bool v = b.valid == nullptr || ok[j];
        if (v) {
          x[j] = index ? (A)(r.i0 + j) : (A)in[j];
          vm |= 1u << j;
        }
        Agg<A> e;
        e.f = (r.starts >> j) & 1u;
        e.acc = x[j];
        e.cnt = v ? 1 : 0;
        agg = combine<A, OP>(agg, e);
      }
    }
    Agg<A> total;
    Agg<A> run = block_seg_scan<A, OP>(agg, &total, sh);
    const int r0 = (int)threadIdx.x * ITEMS;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (j >= r.rows) break;
      Agg<A> e;
      e.f = (r.starts >> j) & 1u;
      e.acc = x[j];
      e.cnt = (vm >> j) & 1u;
      run = combine<A, OP>(run, e);
      const bool end = (r.ends >> j) & 1u;
      st.w[r0 + j] = end && run.f;
      if (end && run.f) {
        st.acc[r0 + j] = to_word<A>(run.acc);
        st.cnt[r0 + j] = (int)run.cnt;
      } else if (end) {  // the run came in from an earlier tile
        part[3] = to_word<A>(run.acc);
        part[4] = (unsigned long long)run.cnt;
      }
    }
    if (threadIdx.x == 0) {
      part[0] = (unsigned long long)total.f;
      part[1] = to_word<A>(total.acc);
      part[2] = (unsigned long long)total.cnt;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < tile_rows; q += BLOCK) {
      if (!st.w[q]) continue;
      const long long s = st.id[q];
      if (s < 0 || s >= n_segments) continue;
      if (b.out != nullptr) ((A*)b.out)[s] = from_word<A>(st.acc[q]);
      put_count(b, s, st.cnt[q]);
    }
  }
};

__global__ void __launch_bounds__(BLOCK)
    reduce_tiles(__grid_constant__ const RedTable t,
                 const int* __restrict__ seg, long long n,
                 long long n_segments, unsigned long long* __restrict__ part,
                 int* __restrict__ edge, int ntiles) {
  __shared__ unsigned long long sh[SCAN_WORDS];
  __shared__ Staged st;
  const long long base = (long long)blockIdx.x * TILE;
  Rows r;
  r.i0 = base + (long long)threadIdx.x * ITEMS;
  const long long left = n - r.i0;
  r.rows = left <= 0 ? 0 : (left < ITEMS ? (int)left : ITEMS);
  r.prev = r.i0 > 0 && r.i0 <= n ? seg[r.i0 - 1] : -1;
  const int next = r.i0 + ITEMS < n ? seg[r.i0 + ITEMS] : 0;
  r.starts = r.ends = 0;
  load_items<int>(seg, r.i0, r.rows, r.id);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) st.id[threadIdx.x * ITEMS + j] = r.id[j];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (j >= r.rows) break;
    const long long i = r.i0 + j;
    const int before = j == 0 ? r.prev : r.id[j - 1];
    if (i == 0 || before != r.id[j]) r.starts |= 1u << j;
    const bool last = i == n - 1 ||
                      (j + 1 < ITEMS ? r.id[j + 1] : next) != r.id[j];
    if (last) r.ends |= 1u << j;
  }
  // the tile's edges, for finish_runs: its first row starts a run, its
  // last row ends one
  const long long tile_rows = n - base < TILE ? n - base : TILE;
  if (threadIdx.x == 0) edge[2 * blockIdx.x] = (int)(r.starts & 1u);
  if (r.rows > 0 && tile_rows - 1 >= r.i0 - base &&
      tile_rows - 1 < r.i0 - base + r.rows)
    edge[2 * blockIdx.x + 1] =
        (int)((r.ends >> (int)(tile_rows - 1 - (r.i0 - base))) & 1u);
  // ids that no row takes below a run's id: the identity (the thread at
  // the run's start; ids from K2 have no gaps)
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (!((r.starts >> j) & 1u)) continue;
    const long long before = j == 0 ? (r.i0 == 0 ? -1 : r.prev) : r.id[j - 1];
    const long long lo = before + 1 < 0 ? 0 : before + 1;
    const long long hi = r.id[j] < n_segments ? r.id[j] : n_segments;
    for (long long s = lo; s < hi; ++s)
      for (int b = 0; b < t.n; ++b) {
        WriteIdentity w{t.buf[b], s};
        with_types(t.buf[b], w);
      }
  }
  for (int b = 0; b < t.n; ++b) {
    TileBuffer tb{t.buf[b], r,
                  part + ((long long)b * ntiles + blockIdx.x) * PART_WORDS,
                  sh, st, (int)tile_rows, n_segments};
    with_types(t.buf[b], tb);
  }
}

// one buffer's runs that cross tiles: the tiles' aggregates scanned in
// tile order, each open head's result its carry combined with the head
struct FinishBuffer {
  const RedBuf& b;
  const unsigned long long* part;  // this buffer's tiles
  const int* edge;
  const int* seg;
  int ntiles;
  long long n_segments;
  unsigned long long* sh;
  template <typename T, typename A, int OP>
  __device__ void run() {
    const int per = (ntiles + (int)blockDim.x - 1) / (int)blockDim.x;
    const int t0 = (int)threadIdx.x * per;
    const int t1 = t0 + per < ntiles ? t0 + per : ntiles;
    Agg<A> agg = neutral<A, OP>();
    for (int k = t0; k < t1; ++k) agg = combine<A, OP>(agg, load<A>(k, 0));
    Agg<A> total;
    Agg<A> carry = block_seg_scan<A, OP>(agg, &total, sh);
    for (int k = t0; k < t1; ++k) {
      const Agg<A> a = load<A>(k, 0);
      if (k > 0 && !edge[2 * k] && (a.f || edge[2 * k + 1])) {
        const Agg<A> head = a.f ? load<A>(k, 3) : a;
        Agg<A> h = head;
        h.f = 0;
        const Agg<A> v = combine<A, OP>(carry, h);
        const long long s = seg[(long long)k * TILE];
        if (s >= 0 && s < n_segments) {
          if (b.out != nullptr) ((A*)b.out)[s] = v.acc;
          put_count(b, s, v.cnt);
        }
      }
      carry = combine<A, OP>(carry, a);
    }
  }
  template <typename A>
  __device__ Agg<A> load(int k, int at) const {
    const unsigned long long* p = part + (long long)k * PART_WORDS;
    Agg<A> a;
    a.f = at == 0 ? (int)p[0] : 0;
    a.acc = from_word<A>(p[at == 0 ? 1 : 3]);
    a.cnt = (long long)p[at == 0 ? 2 : 4];
    return a;
  }
};

__global__ void __launch_bounds__(BLOCK)
    finish_runs(__grid_constant__ const RedTable t,
                const int* __restrict__ seg, long long n,
                long long n_segments,
                const unsigned long long* __restrict__ part,
                const int* __restrict__ edge, int ntiles) {
  __shared__ unsigned long long sh[SCAN_WORDS];
  if ((int)blockIdx.x < t.n) {
    FinishBuffer fb{t.buf[blockIdx.x],
                    part + (long long)blockIdx.x * ntiles * PART_WORDS,
                    edge, seg, ntiles, n_segments, sh};
    with_types(t.buf[blockIdx.x], fb);
    return;
  }
  // the slots past the last id
  const long long last = n > 0 ? (long long)seg[n - 1] : -1;
  const long long stride = (long long)(gridDim.x - t.n) * blockDim.x;
  for (long long s = (last + 1 < 0 ? 0 : last + 1) +
                     (long long)(blockIdx.x - t.n) * blockDim.x +
                     threadIdx.x;
       s < n_segments; s += stride)
    for (int b = 0; b < t.n; ++b) {
      WriteIdentity w{t.buf[b], s};
      with_types(t.buf[b], w);
    }
}

}  // namespace

// Every buffer of `words` (host memory, 6 int64 words a buffer: values,
// validity (0: every row), results (0: none), counts (0: none), the
// values' dtype code, the op: 0 sum, 1 min, 2 max, 3 count, | 256 for
// counts written as count > 0 in bools, | 512 to reduce the row index
// instead of values) reduced over the runs of seg_ids in one data pass.
// Results: sums int64 (float64 for float inputs), min/max the input type,
// the row index int64; counts int64.  scratch: int64[ntiles * (5 * n_bufs + 1)],
// ntiles = ceil(n / 2048).  Two launches (one when n is 0).
SRT_API int k3_segment_reduce_many(const long long* words, int n_bufs,
                                   const void* seg_ids, long long n,
                                   long long n_segments, void* scratch,
                                   void* stream) {
  if (n_bufs < 1 || n_bufs > K3_BUFS) return (int)cudaErrorInvalidValue;
  RedTable t;
  t.n = n_bufs;
  for (int b = 0; b < n_bufs; ++b) {
    const long long* w = words + 6 * b;
    RedBuf& d = t.buf[b];
    d.values = (const void*)(uintptr_t)w[0];
    d.valid = (const bool*)(uintptr_t)w[1];
    d.out = (void*)(uintptr_t)w[2];
    d.out_cnt = (void*)(uintptr_t)w[3];
    d.in_dtype = (int)w[4];
    d.op = (int)(w[5] & 0xff);
    d.has = (int)(w[5] >> 8) & 1;
    d.index = (int)(w[5] >> 9) & 1;
    const bool minmax = d.op == OP_MIN || d.op == OP_MAX;
    if (d.op < OP_SUM || d.op > OP_COUNT ||
        (!d.index && d.op != OP_COUNT &&
         (d.in_dtype < srt::DT_BOOL || d.in_dtype > srt::DT_F64 ||
          (minmax && d.in_dtype == srt::DT_BOOL))))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = srt::tiles_for(n);
  unsigned long long* part = (unsigned long long*)scratch;
  int* edge = (int*)(part + (long long)ntiles * PART_WORDS * n_bufs);
  if (n > 0) {
    reduce_tiles<<<ntiles, BLOCK, 0, st>>>(t, (const int*)seg_ids, n,
                                           n_segments, part, edge, ntiles);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  unsigned fill = srt::blocks_for(n_segments, BLOCK);
  if (fill > MAX_FILL_BLOCKS) fill = MAX_FILL_BLOCKS;
  finish_runs<<<n_bufs + fill, BLOCK, 0, st>>>(t, (const int*)seg_ids, n,
                                               n_segments, part, edge,
                                               ntiles);
  return (int)cudaGetLastError();
}
