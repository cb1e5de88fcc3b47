// K5 — join group ids and probe.
//
// Replaces spark_rapids_tpu/ops/kernels/join.py:group_ids (53, with
// _concat_key_cols at 32) and probe (89).  The stable sort of the
// concatenated keys is K1 (ops/kernels/segment.py); this file holds the
// rest:
//
//   k5_ok      row eligibility: side row mask AND every key's validity
//              (rows with a null key or padding never join), one launch
//              for all keys; also counts the ineligible right rows
//   k5_concat  row-concatenation of one key array of both sides (byte
//              matrices widen to the wider side with zero bytes)
//   k5_ids     over the sorted positions: each row compared with its
//              neighbour by K1's sorted packed key where K1 made one (one
//              word held every live bit), else by its key columns read
//              through the permutation (K2's rules, keys.cuh); the change
//              flags scanned to group ids by decoupled look-back
//              (common.cuh), gl / gr written in row order with the
//              sentinels -1 (left) / -2 (right), and the right rows'
//              order by id (order_r, sorted_gr) placed in the same pass
//   k5_search  per left row, lower and upper bound of its id in the
//              sorted right ids: lo and cnt = hi - lo
//   k5_has_r   per right row, whether any left row has its id (only
//              right and full joins ask for it)
//
// order_r without a second sort: the sort is stable and left rows come
// before right rows, so the eligible right rows appear in sorted order
// exactly by (id, row); the ineligible ones (id -2, first in the stable
// sort of gr) sort last in row order.  An eligible right row's place is
// the count of ineligible right rows plus its rank among eligible right
// rows; an ineligible one's is its rank among ineligible right rows.
//
// has_r: the reference searches the sorted left ids; here each left id
// marks its group in a flag array and each right row reads its group's
// flag.  Ids are dense in [0, nl + nr), so the flags need no hashing and
// no sort of the left ids, and the result is the same boolean.
//
// Bound on this card: bytes.  At Q3's second join (262,144 left and
// 4,194,304 right padded rows, int64 keys) the functions of this file
// read the keys, masks and ids and write the ids, lo, cnt and has_r:
// about (8 + 1 + 1) B a row for the concatenation, 4 + 8 + 4 + 8 B a
// position for k5_ids (the order and the sorted key read; an id and the
// right order written), 4 + 8 B a left row and 4 + 1 + 1 B a right row
// for the probe and the flags — some 140 MB in all, ~42 us at 3.35 TB/s.
// Design: one thread a row or 8 positions a thread; k5_ids reads the
// order and the sorted key in order and writes gl / gr through the
// permutation (random 4-byte stores), its cost to beat; eligibility is a
// position below the eligible count (k5_ok's counts), so no flag is read
// through the permutation; the binary searches touch log2(nr) ~ 22 ids a
// left row, which stay in the 50 MB L2.
#include "keys.cuh"

namespace {

using srt::BLOCK;
using srt::FULL_MASK;
using srt::ITEMS;
using srt::TILE;

// valid: 2 * nkeys addresses, each key's left then right validity
__global__ void row_ok(const bool* __restrict__ l_ok, long long nl,
                       const bool* __restrict__ r_ok, long long nr,
                       const long long* __restrict__ valid, int nkeys,
                       bool* __restrict__ ok, unsigned* __restrict__ inelig) {
  __shared__ unsigned s_count[2];
  if (threadIdx.x < 2) s_count[threadIdx.x] = 0u;
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nl + nr) {
    const bool left = i < nl;
    const long long row = left ? i : i - nl;
    bool v = left ? l_ok[row] : r_ok[row];
    for (int c = 0; c < nkeys; ++c)
      v = v && ((const bool*)valid[2 * c + (left ? 0 : 1)])[row];
    ok[i] = v;
    if (!v) atomicAdd(&s_count[left ? 0 : 1], 1u);
  }
  __syncthreads();
  if (threadIdx.x < 2 && s_count[threadIdx.x] != 0u)
    atomicAdd(&inelig[threadIdx.x], s_count[threadIdx.x]);
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

// one key column of the combined rows (k5_ids' table: 4 words a column)
struct KeyCol {
  const void* data;
  int dtype;
  int width;  // bytes a row of a byte matrix, 0 for an array
  const int* lengths;
};

__device__ __forceinline__ KeyCol key_col(const long long* table, int c) {
  KeyCol k;
  k.data = (const void*)table[4 * c];
  k.dtype = (int)table[4 * c + 1];
  k.width = (int)table[4 * c + 2];
  k.lengths = (const int*)table[4 * c + 3];
  return k;
}

// counters of k5_ids, 21 bits each in one 64-bit word (a tile has 2,048
// positions): key changes, eligible right rows, ineligible right rows
constexpr int FIELD = 21;
constexpr unsigned long long FIELD_MASK = (1ull << FIELD) - 1ull;

constexpr int WARPS = BLOCK / 32;

__global__ void __launch_bounds__(BLOCK) group_ids(
    const int* __restrict__ order,
    const unsigned long long* __restrict__ sorted_key, long long n,
    long long nl, const long long* __restrict__ table, int ncols,
    const unsigned* __restrict__ inelig,
    unsigned long long* __restrict__ status, unsigned* __restrict__ counter,
    int* __restrict__ gl, int* __restrict__ gr, int* __restrict__ order_r,
    int* __restrict__ sorted_gr) {
  __shared__ int s_tile;
  __shared__ unsigned long long s_warp[WARPS];
  __shared__ unsigned long long s_before[3];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  if (tid == 0) s_tile = (int)atomicAdd(counter, 1u);
  __syncthreads();
  const int tile = s_tile;
  const int ntiles = (int)gridDim.x;
  // the eligible rows sort first: position p holds one iff p < n_ok
  const long long n_ok = n - (long long)inelig[0] - (long long)inelig[1];
  // warp w holds positions [base, base + 256), round j the 32 from
  // base + 32 j: loads and stores of a round are contiguous
  const long long base = (long long)tile * TILE + w * (32 * ITEMS);
  int row[ITEMS];
  unsigned long long f[ITEMS], run[ITEMS];
  unsigned long long carry = 0ull;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long p = base + j * 32 + lane;
    f[j] = 0ull;
    row[j] = -1;
    if (p < n) {
      const int r = order[p];
      const bool good = p < n_ok;
      // K2's rules: a new group at the first row, at every ineligible
      // row, and where the keys differ from the row before (both
      // eligible: p - 1 < p < n_ok)
      bool change = p == 0 || !good;
      if (!change && sorted_key != nullptr) {
        change = sorted_key[p] != sorted_key[p - 1];
      } else if (!change) {
        const int prev = order[p - 1];
        for (int c = 0; c < ncols && !change; ++c) {
          const KeyCol k = key_col(table, c);
          change = srt::column_differs(k.data, k.dtype, k.width, k.lengths,
                                       r, prev);
        }
      }
      const bool right = r >= nl;
      f[j] = (change ? 1ull : 0ull) |
             ((right && good ? 1ull : 0ull) << FIELD) |
             ((right && !good ? 1ull : 0ull) << (2 * FIELD));
      row[j] = r;
    }
    // the round's exclusive prefix within the warp, after the rounds
    // before it
    const unsigned long long incl =
        (unsigned long long)srt::warp_incl_scan64((long long)f[j]);
    run[j] = carry + incl - f[j];
    carry += __shfl_sync(FULL_MASK, incl, 31);
  }
  if (lane == 0) s_warp[w] = carry;
  __syncthreads();
  unsigned long long before_warp = 0ull, tile_total = 0ull;
#pragma unroll
  for (int ww = 0; ww < WARPS; ++ww) {
    const unsigned long long c = s_warp[ww];
    if (ww < w) before_warp += c;
    tile_total += c;
  }
  if (tid < 3) {
    const unsigned long long count = (tile_total >> (FIELD * tid)) &
                                     FIELD_MASK;
    srt::lookback_publish(status + (long long)tid * ntiles, 1, tile, 1u,
                          count);
    s_before[tid] = srt::lookback_prefix(status + (long long)tid * ntiles, 1,
                                         tile, 1u, count);
  }
  __syncthreads();
  const long long first_right = (long long)inelig[1];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (row[j] < 0) continue;
    const unsigned long long at = before_warp + run[j];
    const bool good = base + j * 32 + lane < n_ok;
    const long long changes = (long long)s_before[0] +
        (long long)((at & FIELD_MASK) + (f[j] & FIELD_MASK));
    const int id = (int)(changes - 1);
    const int r = row[j];
    if (r < nl) {
      gl[r] = good ? id : -1;
    } else {
      gr[r - nl] = good ? id : -2;
      if (order_r != nullptr) {
        const long long pos = good
            ? first_right + (long long)s_before[1] +
                  (long long)((at >> FIELD) & FIELD_MASK)
            : (long long)s_before[2] +
                  (long long)((at >> (2 * FIELD)) & FIELD_MASK);
        order_r[pos] = (int)(r - nl);
        sorted_gr[pos] = good ? id : -2;
      }
    }
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

// valid: int64[2 * nkeys] validity addresses (each key's left, right);
// inelig: zeroed uint32[2] that receive the ineligible left and right rows
SRT_API int k5_ok(const void* l_ok, long long nl, const void* r_ok,
                  long long nr, const void* valid, int nkeys, void* ok,
                  void* inelig, void* stream) {
  row_ok<<<srt::blocks_for(nl + nr, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
      (const bool*)l_ok, nl, (const bool*)r_ok, nr, (const long long*)valid,
      nkeys, (bool*)ok, (unsigned*)inelig);
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

// order: the sort permutation of the n = nl + nr >= 1 concatenated rows
// (eligible rows first); sorted_key: K1's packed key in sorted order
// (equal keys: equal rows), or NULL: then table, int64[4 * ncols] (data
// address, dtype code, byte-matrix width or 0, lengths address or 0) of
// the concatenated key columns, read through the order; inelig: k5_ok's
// counts; status: zeroed uint64[3 * ceil(n / 2048)]; counter: a zeroed
// uint32.  order_r NULL: gl and gr only.
SRT_API int k5_ids(const void* order, const void* sorted_key, long long n,
                   long long nl, const void* table, int ncols,
                   const void* inelig, void* status, void* counter,
                   void* gl, void* gr, void* order_r, void* sorted_gr,
                   void* stream) {
  group_ids<<<srt::tiles_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)order, (const unsigned long long*)sorted_key, n, nl,
      (const long long*)table, ncols, (const unsigned*)inelig,
      (unsigned long long*)status, (unsigned*)counter, (int*)gl, (int*)gr,
      (int*)order_r, (int*)sorted_gr);
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
