// K2 — segment ids of sorted keys.
//
// Replaces spark_rapids_tpu/ops/kernels/segment.py:segment_ids_device
// (335): a key-change flag per row over the sorted key columns (a value
// difference counts only where both rows are valid; NaN equals NaN and
// -0.0 equals 0.0; strings compare bytes and lengths: the rules of
// keys.cuh, shared with K5's k5_ids; a validity change is always a
// boundary), every padding row its own segment, then an inclusive scan to
// int32 ids.
//
// Bound on this card: bytes.  Each key column is read once (data +
// validity, and lengths for strings), the padding mask once, and the
// int32 ids written once; for Q1's two one-byte string keys over
// 8,388,608 rows that is about 143 MB, ~43 us at 3.35 TB/s.  Design: ONE
// launch for up to MAX_KEYS keys (the keys as a __grid_constant__ table
// in the kernel parameters, as K4's MoveTable).  A block takes its tile
// from a global atomic counter (the last tile handed out sets it back to
// 0 for the next launch), so the tiles it waits on below are already
// running.  A tile is 1, 2 or 8 rounds of 1,024 rows: the most rounds
// that still give the launch two blocks on each of the card's 132 SMs
// (rounds_for), so a large call pays few look-backs and a small one
// still spreads over the card (tools/k2_rounds.py on the H100, each of
// 1, 2 and 8 rounds forced at 1 to 33,554,432 rows: this rule picked the
// fastest or one within 4%; four blocks an SM took 2 rounds at
// 4,194,304 rows, 0.071 ms against 8 rounds' 0.052).  Each row's flag
// over every key lives in registers, as a bit: a lane holds 4
// consecutive rows a round and reads them with one vector load an array
// (a warp 128-512 contiguous bytes), so enough bytes are in flight (with
// one row a lane, one-byte loads left K2 at 3-4x its bytes:
// tools/k10_k2_split.py); a row's predecessor is
// the lane's previous row, or the neighbouring lane's last by a shuffle
// (lane 0 reads it from memory, a hit in L1).  Strings of one unit a row
// (16/8/4/2/1 bytes) read as an array of that unit, wider ones unit by
// unit.  The flags are counted by warp scans and a block sum; the tile's
// prefix comes by decoupled look-back, the block reading 256 earlier
// tiles' words a round trip (common.cuh lookback_block: the blocks of a
// wave look back together), over status words that carry an epoch, so
// one buffer serves every call with no memset between them.  No flag
// array, no one-block scan; the counts are integers, so the ids are the
// same bits on every run.
#include "keys.cuh"

namespace {

using srt::BLOCK;
using srt::Bytes16;
using srt::FULL_MASK;

constexpr int MAX_KEYS = 32;  // keys a launch (the wrapper chains more)
constexpr int KEY_WORDS = 5;  // int64 words a key in the host table
constexpr int WARPS = BLOCK / 32;

struct Key {
  const uint8_t* data;
  const bool* valid;    // NULL: every row valid
  const int* lengths;   // strings only
  int width;            // bytes a row of a byte matrix, 0 for an array
  int dtype;            // common.cuh DtypeCode of an array
};

struct KeyTable {
  int n;
  Key k[MAX_KEYS];
};

// A thread's rows: warp w holds rows [base_w, base_w + 128 ROUNDS) of
// the tile; in round j lane l holds the 4 consecutive rows r = base_w +
// 128 j + 4 l, ..., r + 3, which it reads with one vector load an array
// where the base allows (4 bools, 4 int32 lengths in 16 bytes, ...), so
// a warp's load is 128-512 contiguous bytes and many bytes are in flight.
// Row r + e's predecessor is the lane's row r + e - 1; row r's is lane l
// - 1's row r - 1, taken by a shuffle (lane 0 reads it from memory: the
// row lane 31 read a round before, a hit in L1).  Rows at or past n read
// row n - 1 and are masked by the caller.  The flags are bits (bit 4 j +
// e: row e of round j).
constexpr long long ROUND_ROWS = WARPS * 128;  // a block's rows a round
// blocks that fill the card: two on each of the H100's 132 SMs
constexpr long long FILL_BLOCKS = 2 * 132;

// rounds a tile for n rows: the most of 8, 2 and 1 whose tiles still
// fill the card
inline int rounds_for(long long n) {
  return n >= 8 * ROUND_ROWS * FILL_BLOCKS ? 8
       : n >= 2 * ROUND_ROWS * FILL_BLOCKS ? 2 : 1;
}

// rows r .. r + 3 of d (clamped into [0, n)), one vector load where they
// are all below n and their address is aligned to their size
template <typename T>
__device__ __forceinline__ void load4(const T* d, long long r, long long n,
                                      T* out) {
  const T* q = d + r;
  if (r + 3 < n && ((uintptr_t)q & (4 * sizeof(T) - 1)) == 0) {
    if constexpr (4 * sizeof(T) == 4) {
      const uint32_t v = *(const uint32_t*)q;
      memcpy(out, &v, 4);
    } else if constexpr (4 * sizeof(T) == 8) {
      const uint2 v = *(const uint2*)q;
      memcpy(out, &v, 8);
    } else if constexpr (4 * sizeof(T) == 16) {
      const uint4 v = *(const uint4*)q;
      memcpy(out, &v, 16);
    } else {
      const uint4* u = (const uint4*)q;
      uint4 v[4 * sizeof(T) / 16];
#pragma unroll
      for (int i = 0; i < (int)(4 * sizeof(T) / 16); ++i) v[i] = u[i];
      memcpy(out, v, 4 * sizeof(T));
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = d[r + e < n ? r + e : n - 1];
}

// the value lane - 1 holds (lane 0: `own`)
template <typename T>
__device__ __forceinline__ T from_left(T x, T own) {
  T y;
  if constexpr (sizeof(T) < 4) {
    y = (T)__shfl_up_sync(FULL_MASK, (int)x, 1);
  } else if constexpr (sizeof(T) == 16) {
    Bytes16 b;
    memcpy(&b, &x, 16);
    b.lo = __shfl_up_sync(FULL_MASK, b.lo, 1);
    b.hi = __shfl_up_sync(FULL_MASK, b.hi, 1);
    memcpy(&y, &b, 16);
  } else {
    y = __shfl_up_sync(FULL_MASK, x, 1);
  }
  return (threadIdx.x & 31) == 0 ? own : y;
}

__device__ __forceinline__ bool same(Bytes16 a, Bytes16 b) {
  return a.lo == b.lo && a.hi == b.hi;
}
template <typename E>
__device__ __forceinline__ bool same(E a, E b) {
  return a == b;
}

__device__ __forceinline__ long long clamp_row(long long r, long long n) {
  return r < 0 ? 0 : (r < n ? r : n - 1);
}

// x[0..4) the lane's values of an array and prev[0..4) their
// predecessors' (row r - 1 from lane - 1, or memory for lane 0)
template <typename T>
__device__ __forceinline__ void with_prev(const T* d, long long r,
                                          long long n, T* x, T* prev) {
  load4(d, r, n, x);
  const T own = (threadIdx.x & 31) == 0 ? d[clamp_row(r - 1, n)] : x[3];
  prev[0] = from_left(x[3], own);
#pragma unroll
  for (int e = 1; e < 4; ++e) prev[e] = x[e - 1];
}

// bit e: row r + e differs from its predecessor under the values (v1, v0:
// the rows' and the predecessors' validity; diff: the values differ)
__device__ __forceinline__ unsigned flags4(const bool* v1, const bool* v0,
                                           const bool* diff) {
  unsigned f = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (v1[e] != v0[e] || (v1[e] && diff[e])) f |= 1u << e;
  return f;
}

template <typename T>
__device__ __forceinline__ unsigned flags_num(const Key& k, long long r,
                                              long long n, const bool* v1,
                                              const bool* v0) {
  T x[4], p[4];
  with_prev((const T*)k.data, r, n, x, p);
  bool diff[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) diff[e] = srt::differs<T>(x[e], p[e]);
  return flags4(v1, v0, diff);
}

// a byte-matrix key (keys.cuh bytes_differ: the lengths, then the
// zero-padded bytes); rows of one unit E read as a 1-D array of E, wider
// rows unit by unit
template <typename E>
__device__ __forceinline__ unsigned flags_str(const Key& k, long long r,
                                              long long n, const bool* v1,
                                              const bool* v0) {
  int l[4], lp[4];
  with_prev(k.lengths, r, n, l, lp);
  bool diff[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) diff[e] = l[e] != lp[e];
  const int units = k.width / (int)sizeof(E);
  if (units == 1) {
    E x[4], p[4];
    with_prev((const E*)k.data, r, n, x, p);
#pragma unroll
    for (int e = 0; e < 4; ++e) diff[e] = diff[e] || !same(x[e], p[e]);
    return flags4(v1, v0, diff);
  }
  const long long w = k.width;
  for (int u = 0; u < units; ++u) {
    E x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = ((const E*)(k.data + clamp_row(r + e, n) * w))[u];
    const E own = (threadIdx.x & 31) == 0
        ? ((const E*)(k.data + clamp_row(r - 1, n) * w))[u] : x[3];
    const E p0 = from_left(x[3], own);
    diff[0] = diff[0] || !same(x[0], p0);
#pragma unroll
    for (int e = 1; e < 4; ++e) diff[e] = diff[e] || !same(x[e], x[e - 1]);
  }
  return flags4(v1, v0, diff);
}

// bit e: row r + e starts a segment under key k (a validity change, or
// both valid and their values differ); strings in the widest units (16,
// 8, 4, 2 or 1 bytes) the width and base allow
__device__ __forceinline__ unsigned key_flags(const Key& k, long long r,
                                              long long n) {
  bool v1[4] = {true, true, true, true}, v0[4] = {true, true, true, true};
  if (k.valid != nullptr) with_prev(k.valid, r, n, v1, v0);
  if (k.width > 0) {
    const unsigned long long al =
        (unsigned long long)(uintptr_t)k.data | (unsigned long long)k.width;
    if ((al & 15ull) == 0) return flags_str<Bytes16>(k, r, n, v1, v0);
    if ((al & 7ull) == 0)
      return flags_str<unsigned long long>(k, r, n, v1, v0);
    if ((al & 3ull) == 0) return flags_str<uint32_t>(k, r, n, v1, v0);
    if ((al & 1ull) == 0) return flags_str<uint16_t>(k, r, n, v1, v0);
    return flags_str<uint8_t>(k, r, n, v1, v0);
  }
  switch (k.dtype) {
    case srt::DT_I16: return flags_num<int16_t>(k, r, n, v1, v0);
    case srt::DT_I32: return flags_num<int32_t>(k, r, n, v1, v0);
    case srt::DT_I64: return flags_num<long long>(k, r, n, v1, v0);
    case srt::DT_F32: return flags_num<float>(k, r, n, v1, v0);
    case srt::DT_F64: return flags_num<double>(k, r, n, v1, v0);
    default: return flags_num<uint8_t>(k, r, n, v1, v0);  // bool, i8, u8
  }
}

// at most 64 registers a thread: four blocks an SM
template <int ROUNDS>
__global__ void __launch_bounds__(BLOCK, 4)
    segment_ids(__grid_constant__ const KeyTable t,
                const bool* __restrict__ pad_valid, long long n,
                unsigned long long* __restrict__ status,
                unsigned* __restrict__ counter, unsigned epoch,
                int* __restrict__ ids) {
  __shared__ int s_tile;
  __shared__ int s_warp[WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  if (tid == 0) {
    const unsigned tile = atomicAdd(counter, 1u);
    // every block has taken its tile once the last one is handed out
    if (tile == gridDim.x - 1) *counter = 0u;
    s_tile = (int)tile;
  }
  __syncthreads();
  const int tile = s_tile;
  const long long base = (long long)tile * (ROUND_ROWS * ROUNDS) +
                         w * (128 * ROUNDS) + 4 * lane;
  // bit 4 j + e: row e of round j starts a segment
  unsigned f = 0u;
  for (int k = 0; k < t.n; ++k) {
#pragma unroll 1
    for (int j = 0; j < ROUNDS; ++j)
      f |= key_flags(t.k[k], base + 128 * j, n) << (4 * j);
  }
#pragma unroll
  for (int j = 0; j < ROUNDS; ++j) {
    const long long r = base + 128 * j;
    bool pv[4] = {true, true, true, true};
    if (pad_valid != nullptr) load4(pad_valid, r, n, pv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned bit = 1u << (4 * j + e);
      if (r + e >= n) f &= ~bit;
      else if (r + e == 0 || !pv[e]) f |= bit;
    }
  }
  // the warp's flags, then the block's
  int in_warp = __popc(f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    in_warp += __shfl_xor_sync(FULL_MASK, in_warp, o);
  if (lane == 0) s_warp[w] = in_warp;
  __syncthreads();
  int warp_before = 0, tile_total = 0;
#pragma unroll
  for (int ww = 0; ww < WARPS; ++ww) {
    const int c = s_warp[ww];
    if (ww < w) warp_before += c;
    tile_total += c;
  }
  // publish the tile's count, then walk back block wide (256 tiles a
  // round trip) and publish the inclusive prefix
  if (tid == 0)
    srt::lookback_publish(status, 1, tile, epoch,
                          (unsigned long long)tile_total);
  const unsigned long long prior =
      srt::lookback_block(status, 1, tile, epoch);
  if (tid == 0 && tile > 0)
    srt::lb_store(status + tile, epoch, srt::LB_PREFIX,
                  prior + (unsigned long long)tile_total);
  long long run = (long long)prior + warp_before;
#pragma unroll
  for (int j = 0; j < ROUNDS; ++j) {
    const long long r = base + 128 * j;
    const unsigned bits = f >> (4 * j) & 15u;
    const int c = __popc(bits);
    const int incl = srt::warp_incl_scan(c);
    int id[4];
    int at = (int)(run + incl - c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      at += (int)(bits >> e & 1u);
      id[e] = at - 1;
    }
    int* q = ids + r;
    if (r + 3 < n && ((uintptr_t)q & 15u) == 0) {
      *(int4*)q = make_int4(id[0], id[1], id[2], id[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (r + e < n) q[e] = id[e];
    }
    run += __shfl_sync(FULL_MASK, incl, 31);
  }
}

}  // namespace

// keys: KEY_WORDS int64 a key in host memory (data, validity or 0,
// lengths or 0, bytes a row of a byte matrix or 0, dtype code), at most
// MAX_KEYS; pad_valid: bool[n] or NULL; status: uint64[status_words]
// whose epochs differ from `epoch` (1..65535), at least one a tile (n /
// 1,024 rounded up always suffices; fewer is an error, not a look-back
// that waits on a word no tile writes); counter: uint32, 0 on entry and
// left 0.  One launch; none for n == 0.
SRT_API int k2_segment_ids(const long long* keys, int nkeys,
                           const void* pad_valid, long long n, void* status,
                           long long status_words, void* counter, int epoch,
                           void* ids, void* stream) {
  if (nkeys < 0 || nkeys > MAX_KEYS || epoch < 1 || epoch > 0xffff)
    return (int)cudaErrorInvalidValue;
  KeyTable t;
  t.n = nkeys;
  for (int c = 0; c < nkeys; ++c) {
    const long long* w = keys + KEY_WORDS * c;
    Key& k = t.k[c];
    k.data = (const uint8_t*)(uintptr_t)w[0];
    k.valid = (const bool*)(uintptr_t)w[1];
    k.lengths = (const int*)(uintptr_t)w[2];
    k.width = (int)w[3];
    k.dtype = (int)w[4];
    if (k.width < 0 || (k.width > 0) != (k.lengths != nullptr))
      return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return (int)cudaSuccess;
  const int rounds = rounds_for(n);
  const long long tiles =
      (n + ROUND_ROWS * rounds - 1) / (ROUND_ROWS * rounds);
  if (tiles > status_words) return (int)cudaErrorInvalidValue;
  auto* kernel = rounds == 8 ? segment_ids<8>
               : rounds == 2 ? segment_ids<2> : segment_ids<1>;
  kernel<<<(unsigned)tiles, BLOCK, 0, (cudaStream_t)stream>>>(
      t, (const bool*)pad_valid, n, (unsigned long long*)status,
      (unsigned*)counter, (unsigned)epoch, (int*)ids);
  return (int)cudaGetLastError();
}
