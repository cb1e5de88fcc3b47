// K1 — key-pass encoding + stable LSD radix sort -> row permutation.
//
// Replaces spark_rapids_tpu/ops/kernels/segment.py:_sort_key_device (216),
// key_passes_device (257), lexsort_device (297) and sort_permutation (313):
// the order-preserving uint64 pass encoding of the sort keys and the one
// variadic stable lax.sort over all passes.
//
// A pass is described by 8 int64 words (ops/kernels/segment.py
// _pass_table): the padding rank, a column's null rank, a numeric value,
// 8 bytes of a string, or a string's lengths (the sort breaks ties of
// zero-padded bytes by length, ROADMAP C.6).  pass_key() computes a row's
// unsigned key of a pass from the columns themselves, so the sort never
// writes the passes out: each kernel reads the key columns (1 to 8 bytes
// a row and pass) where a pass array would cost 8 to write and 8 to read
// each time.  key_passes_device alone writes them (encode_passes), as
// int64 in "signed order" (the uint64 key with its top bit flipped, so a
// signed compare orders like the unsigned key).
//
// Bound on this card: bytes.  A digit step reads the 8-byte keys and
// 4-byte ids and writes both again (24 B/row); at 3.35 TB/s one step over
// 8,388,608 rows is about 60 us of traffic.  Most sorts of the engine are
// small, where launches and the host's waits cost more than the bytes.
// Two paths, chosen by the wrapper:
//
//   * small (n <= SMALL_ROWS): sort_small, one block, one launch, no host
//     read back.  Per pass, an OR and an AND of every key find its live
//     bytes (a byte is dead where every row holds the same value); each
//     live byte is one stable step: the rows' ids stay in shared memory,
//     each row's digit is read through its id, and rows are ranked
//     within their warp (__match_any_sync, warp-private counts) and
//     placed by a prefix over warps and digits.
//   * large: live_masks ORs and ANDs every pass's keys (one launch) and
//     the host reads the masks back once; pack_words copies the live BITS
//     of all passes, in significance order, into as few uint64 words as
//     they need (dropping a bit that every row shares keeps the order:
//     Q1's padding, null ranks and flag bytes hold 10 live bits, two
//     digits) and counts each packed byte's histogram; then LSD from the
//     least significant word, one gather_keys per further word, and ONE
//     onesweep launch per packed byte: a tile of 2,048 rows in registers,
//     ranked stably within each warp as above, the tile's 256 digit
//     counts published and its global offsets taken by decoupled
//     look-back over its predecessors (srt::lookback_* in common.cuh,
//     tile ids from a global atomic counter), the rows staged in shared
//     memory in their new order so that each digit's run is written
//     contiguously.  One zeroed status buffer serves every step of a sort
//     (an epoch a step).  The counts are integers, so the permutation is
//     exact and the same on every run.  Where one word holds every live
//     bit, the last step can write the sorted packed key too: equal keys
//     are equal rows, which K5 reads in place of its key columns.
#include "common.cuh"

namespace {

using srt::BLOCK;
using srt::FULL_MASK;
using srt::ITEMS;
using srt::TILE;

constexpr unsigned long long SIGN = 0x8000000000000000ull;
constexpr unsigned long long NAN_KEY = 0xFFFFFFFFFFFFFFFEull;

// ---- order-preserving uint64 encodings (segment.py:216-254) -------------
__device__ __forceinline__ unsigned long long order_bits(bool v) {
  return v ? 1ull : 0ull;
}
__device__ __forceinline__ unsigned long long order_bits(int8_t v) {
  return (unsigned long long)(long long)v ^ SIGN;
}
__device__ __forceinline__ unsigned long long order_bits(int16_t v) {
  return (unsigned long long)(long long)v ^ SIGN;
}
__device__ __forceinline__ unsigned long long order_bits(int32_t v) {
  return (unsigned long long)(long long)v ^ SIGN;
}
__device__ __forceinline__ unsigned long long order_bits(long long v) {
  return (unsigned long long)v ^ SIGN;
}
__device__ __forceinline__ unsigned long long order_bits(float v) {
  if (v != v) return NAN_KEY;
  const float d = (v == 0.0f) ? 0.0f : v;  // -0.0 -> 0.0
  const int32_t bits = __float_as_int(d);
  const int32_t flipped = bits < 0 ? ~bits : (int32_t)(bits ^ 0x80000000);
  return (unsigned long long)(uint32_t)flipped;
}
__device__ __forceinline__ unsigned long long order_bits(double v) {
  if (v != v) return NAN_KEY;
  const double d = (v == 0.0) ? 0.0 : v;
  const long long bits = __double_as_longlong(d);
  const long long flipped =
      bits < 0 ? ~bits : (long long)((unsigned long long)bits ^ SIGN);
  return (unsigned long long)flipped;
}


// ---- pass descriptors ----------------------------------------------------
enum PassKind {
  PASS_PAD = 0, PASS_NULL = 1, PASS_NUM = 2, PASS_STR = 3, PASS_LEN = 4
};

struct Pass {
  int kind, dtype, width, chunk, desc, nulls_first;
  const void* data;
  const bool* valid;
};

// table row p: kind, data, valid, dtype, width, chunk, desc, nulls_first
__device__ __forceinline__ Pass load_pass(const long long* table, int p) {
  const long long* t = table + 8 * p;
  Pass d;
  d.kind = (int)t[0];
  d.data = (const void*)t[1];
  d.valid = (const bool*)t[2];
  d.dtype = (int)t[3];
  d.width = (int)t[4];
  d.chunk = (int)t[5];
  d.desc = (int)t[6];
  d.nulls_first = (int)t[7];
  return d;
}

__device__ __forceinline__ unsigned long long num_bits(const void* data,
                                                       int dtype,
                                                       long long i) {
  switch (dtype) {
    case srt::DT_BOOL: return order_bits(((const bool*)data)[i]);
    case srt::DT_I8: return order_bits(((const int8_t*)data)[i]);
    case srt::DT_I16: return order_bits(((const int16_t*)data)[i]);
    case srt::DT_I32: return order_bits(((const int32_t*)data)[i]);
    case srt::DT_F32: return order_bits(((const float*)data)[i]);
    case srt::DT_F64: return order_bits(((const double*)data)[i]);
    default: return order_bits(((const long long*)data)[i]);  // DT_I64
  }
}

// row i's unsigned key of pass d (segment.py:key_passes, _rank_pass).
// PASS_LEN is a string's lengths (int32), the pass that orders strings
// whose zero-padded bytes tie (ROADMAP C.6): a null row's value is 0, and
// null rows do not count for its live bits (pass_counts), since the
// string's null pass already keeps them apart from every valid row.
__device__ __forceinline__ unsigned long long pass_key(const Pass& d,
                                                       long long i) {
  if (d.kind == PASS_PAD) return ((const bool*)d.data)[i] ? 0ull : 1ull;
  const bool v = d.valid[i];
  if (d.kind == PASS_NULL) return v == (d.nulls_first != 0) ? 1ull : 0ull;
  // the value is read whatever the validity (every row has one), so the
  // two loads are in flight together
  unsigned long long u;
  if (d.kind == PASS_STR) {  // 8 bytes, most significant first, zero-padded
    const uint8_t* row = (const uint8_t*)d.data + i * (long long)d.width;
    const int start = d.chunk * 8;
    const int cw = (d.width - start) < 8 ? (d.width - start) : 8;
    u = 0ull;
    for (int b = 0; b < cw; ++b)
      u = (u << 8) | (unsigned long long)row[start + b];
    u <<= 8 * (8 - cw);
  } else {
    u = num_bits(d.data, d.dtype, i);
  }
  return v ? (d.desc ? ~u : u) : 0ull;
}

// whether row i's key counts for the live bits of pass d
__device__ __forceinline__ bool pass_counts(const Pass& d, long long i) {
  return d.kind != PASS_LEN || d.valid[i];
}

// every pass as int64 in signed order: passes[p][i] (key_passes_device)
__global__ void encode_passes(const long long* __restrict__ table,
                              long long n, long long* __restrict__ passes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p = blockIdx.y;
  passes[(long long)p * n + i] = (long long)(pass_key(load_pass(table, p),
                                                      i) ^ SIGN);
}

// masks[2p] |= every key of pass p, masks[2p + 1] &= every key: the live
// bits of the pass are masks[2p] & ~masks[2p + 1] (0 where no row
// counts)
__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ unsigned long long warp_and(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v &= __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

constexpr int LIVE_ROWS = 8;  // rows in flight a thread

// ORs and ANDs key(j) over the rows of this thread's grid stride where
// key(j, counts) says the row counts; the pass's kind and type are
// resolved once, outside the loop
template <typename F>
__device__ __forceinline__ void or_and(long long n, F key,
                                       unsigned long long& uo,
                                       unsigned long long& ua) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += LIVE_ROWS * stride) {
#pragma unroll
    for (int r = 0; r < LIVE_ROWS; ++r) {
      const long long j = i + r * stride;
      if (j < n) {
        bool counts = true;
        const unsigned long long u = key(j, counts);
        if (counts) {
          uo |= u;
          ua &= u;
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void or_and_num(const Pass& d, long long n,
                                           unsigned long long& uo,
                                           unsigned long long& ua) {
  const T* data = (const T*)d.data;
  const bool* valid = d.valid;
  const unsigned long long flip = d.desc ? ~0ull : 0ull;
  const bool len = d.kind == PASS_LEN;
  or_and(n, [&](long long j, bool& counts) {
    const bool v = valid[j];
    counts = v || !len;
    return v ? order_bits(data[j]) ^ flip : 0ull;
  }, uo, ua);
}

__global__ void live_masks(const long long* __restrict__ table, long long n,
                           unsigned long long* __restrict__ masks) {
  __shared__ unsigned long long s_or, s_and;
  const int p = blockIdx.y;
  if (threadIdx.x == 0) {
    s_or = 0ull;
    s_and = ~0ull;
  }
  __syncthreads();
  const Pass d = load_pass(table, p);
  unsigned long long uo = 0ull, ua = ~0ull;
  if (d.kind == PASS_NUM || d.kind == PASS_LEN) {
    switch (d.dtype) {
      case srt::DT_BOOL: or_and_num<bool>(d, n, uo, ua); break;
      case srt::DT_I8: or_and_num<int8_t>(d, n, uo, ua); break;
      case srt::DT_I16: or_and_num<int16_t>(d, n, uo, ua); break;
      case srt::DT_I32: or_and_num<int32_t>(d, n, uo, ua); break;
      case srt::DT_F32: or_and_num<float>(d, n, uo, ua); break;
      case srt::DT_F64: or_and_num<double>(d, n, uo, ua); break;
      default: or_and_num<long long>(d, n, uo, ua);
    }
  } else {
    or_and(n, [&](long long j, bool& counts) { return pass_key(d, j); },
           uo, ua);
  }
  uo = warp_or(uo);
  ua = warp_and(ua);
  if ((threadIdx.x & 31) == 0) {
    atomicOr(&s_or, uo);
    atomicAnd(&s_and, ua);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicOr(&masks[2 * p], s_or);
    atomicAnd(&masks[2 * p + 1], s_and);
  }
}

// The live bits of all passes packed into words, from the last pass's
// low bit up, so that a row's packed key orders as its passes do (every
// dropped bit is the same in every row).  runs[r] = pass << 16 | start
// << 8 | bits: the live bits as runs of adjacent bits, least significant
// first.  Word w of a row holds its packed bits [64 w, 64 w + 64); every
// row's bits sit at the same places, so a warp completes each word
// together.  hist: zeroed uint32[nwords][8][256], each packed byte's
// histogram; words of a group of WORD_GROUP are packed, counted and
// written in one sweep over the rows.
constexpr int WORD_GROUP = 4;
// pass descriptors a block keeps in shared memory (the rest are read
// from the table)
constexpr int STAGED_PASSES = 64;

constexpr int PACK_ROWS = 4;  // rows a thread packs at once (loads in flight)

__global__ void pack_words(const long long* __restrict__ table, int k,
                           long long n, const long long* __restrict__ runs,
                           int nruns, int nwords,
                           unsigned long long* __restrict__ words,
                           unsigned* __restrict__ hist) {
  __shared__ unsigned s_h[WORD_GROUP * 8 * 256];
  __shared__ long long s_table[STAGED_PASSES * 8];
  const int lane = threadIdx.x & 31;
  const int staged = k < STAGED_PASSES ? k : STAGED_PASSES;
  for (int j = threadIdx.x; j < staged * 8; j += blockDim.x)
    s_table[j] = table[j];
  const long long stride = (long long)gridDim.x * blockDim.x * PACK_ROWS;
  for (int g0 = 0; g0 < nwords; g0 += WORD_GROUP) {
    for (int j = threadIdx.x; j < WORD_GROUP * 8 * 256; j += blockDim.x)
      s_h[j] = 0u;
    __syncthreads();
    for (long long base = (long long)blockIdx.x * blockDim.x * PACK_ROWS;
         base < n; base += stride) {
      long long i[PACK_ROWS];
      bool in[PACK_ROWS];
      unsigned long long acc[PACK_ROWS], key[PACK_ROWS];
#pragma unroll
      for (int r = 0; r < PACK_ROWS; ++r) {
        i[r] = base + r * blockDim.x + threadIdx.x;
        in[r] = i[r] < n;
        acc[r] = 0ull;
        key[r] = 0ull;
      }
      int fill = 0, w = 0;
      // a finished word of each row (the same bits in every row): stored
      // and counted where it is in this group
      auto emit = [&](int bits) {
        if (w >= g0 && w < g0 + WORD_GROUP) {
#pragma unroll
          for (int r = 0; r < PACK_ROWS; ++r)
            if (in[r]) words[(long long)w * n + i[r]] = acc[r];
          for (int b = 0; b * 8 < bits; ++b) {
#pragma unroll
            for (int r = 0; r < PACK_ROWS; ++r) {
              const int dig =
                  in[r] ? (int)((acc[r] >> (8 * b)) & 255ull) : 256;
              const unsigned peers = __match_any_sync(FULL_MASK, dig);
              if (in[r] && lane == __ffs(peers) - 1)
                atomicAdd(&s_h[((w - g0) * 8 + b) * 256 + dig],
                          (unsigned)__popc(peers));
            }
          }
        }
        ++w;
      };
      int cur = -1;
      for (int q = 0; q < nruns && w < g0 + WORD_GROUP; ++q) {
        const long long e = runs[q];
        const int p = (int)(e >> 16);
        const int start = (int)((e >> 8) & 255);
        const int nb = (int)(e & 255);
        if (p != cur) {
          cur = p;
          const Pass d = load_pass(p < STAGED_PASSES ? s_table : table, p);
#pragma unroll
          for (int r = 0; r < PACK_ROWS; ++r)
            key[r] = in[r] ? pass_key(d, i[r]) : 0ull;
        }
        const unsigned long long m = nb == 64 ? ~0ull : (1ull << nb) - 1ull;
        unsigned long long v[PACK_ROWS];
#pragma unroll
        for (int r = 0; r < PACK_ROWS; ++r) {
          v[r] = (key[r] >> start) & m;
          acc[r] |= v[r] << fill;
        }
        if (fill + nb >= 64) {
          emit(64);
#pragma unroll
          for (int r = 0; r < PACK_ROWS; ++r)
            acc[r] = fill + nb > 64 ? v[r] >> (64 - fill) : 0ull;
          fill = fill + nb - 64;
        } else {
          fill += nb;
        }
      }
      if (fill > 0) emit(fill);
    }
    __syncthreads();
    const int in_group = nwords - g0 < WORD_GROUP ? nwords - g0 : WORD_GROUP;
    for (int j = threadIdx.x; j < in_group * 8 * 256; j += blockDim.x)
      if (s_h[j]) atomicAdd(&hist[(long long)g0 * 8 * 256 + j], s_h[j]);
    __syncthreads();
  }
}

// one word's keys in the current order
__global__ void gather_keys(const unsigned long long* __restrict__ word,
                            const int* __restrict__ perm, long long n,
                            unsigned long long* __restrict__ keys) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = word[perm[i]];
}

// Ranks one round of 32 rows (one a lane) among the rows of its warp that
// came before it with the same digit (dig 256: a lane without a row).
// cnt is the warp's own row of counts; leaves them advanced past the round.
template <typename C>
__device__ __forceinline__ unsigned warp_rank(int dig, C* cnt) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(FULL_MASK, dig);
  const unsigned below = (unsigned)__popc(peers & ((1u << lane) - 1u));
  const unsigned before = dig < 256 ? (unsigned)cnt[dig] : 0u;
  __syncwarp();
  if (dig < 256 && below == 0u) cnt[dig] = (C)(before + __popc(peers));
  __syncwarp();
  return before + below;
}

constexpr int WARPS = BLOCK / 32;

// One stable LSD step by the byte at `shift`: (keys_in, ids_in) ->
// (keys_out, ids_out).  ids_in NULL: the identity; keys_out NULL: the
// keys are not needed after this step.  digit_hist: this byte's global
// histogram; status: zeroed words (256 a tile, this step's epoch);
// counter: this step's zeroed tile counter.
__global__ void __launch_bounds__(BLOCK) onesweep(
    const unsigned long long* __restrict__ keys_in,
    const int* __restrict__ ids_in, long long n, int shift,
    const unsigned* __restrict__ digit_hist,
    unsigned long long* __restrict__ status, unsigned* __restrict__ counter,
    unsigned epoch, unsigned long long* __restrict__ keys_out,
    int* __restrict__ ids_out) {
  __shared__ unsigned s_wcnt[WARPS][256];
  __shared__ unsigned s_start[256];
  __shared__ long long s_out[256];
  __shared__ unsigned long long s_keys[TILE];
  __shared__ int s_ids[TILE];
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  if (tid == 0) s_tile = (int)atomicAdd(counter, 1u);
#pragma unroll
  for (int ww = 0; ww < WARPS; ++ww) s_wcnt[ww][tid] = 0u;
  __syncthreads();
  const int tile = s_tile;
  const long long base = (long long)tile * TILE;
  // warp w holds rows [base + 256 w, base + 256 (w + 1)), round j the 32
  // rows from base + 256 w + 32 j: row order is (warp, round, lane)
  unsigned long long key[ITEMS];
  int id[ITEMS], dig[ITEMS];
  unsigned rank[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + w * (32 * ITEMS) + j * 32 + lane;
    const bool in = i < n;
    key[j] = in ? keys_in[i] : 0ull;
    id[j] = in ? (ids_in != nullptr ? ids_in[i] : (int)i) : 0;
    dig[j] = in ? (int)((key[j] >> shift) & 255ull) : 256;
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) rank[j] = warp_rank(dig[j], s_wcnt[w]);
  __syncthreads();
  // thread tid owns digit tid: its count in the tile, each warp's start
  // inside the digit's run, the run's start inside the tile
  unsigned c = 0u;
#pragma unroll
  for (int ww = 0; ww < WARPS; ++ww) {
    const unsigned v = s_wcnt[ww][tid];
    s_wcnt[ww][tid] = c;
    c += v;
  }
  srt::lookback_publish(status + tid, 256, tile, epoch, c);
  int total;
  const int start = srt::block_excl_scan((int)c, &total);
  s_start[tid] = (unsigned)start;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (dig[j] < 256) {
      const unsigned pos = s_start[dig[j]] + s_wcnt[w][dig[j]] + rank[j];
      s_keys[pos] = key[j];
      s_ids[pos] = id[j];
    }
  }
  // rows of smaller digits in the whole input, plus this digit's rows in
  // the tiles before this one
  const int below = srt::block_excl_scan((int)digit_hist[tid], &total);
  const unsigned long long before =
      srt::lookback_prefix(status + tid, 256, tile, epoch, c);
  s_out[tid] = (long long)below + (long long)before - (long long)start;
  __syncthreads();
  const long long left = n - base;
  const int rows = left < TILE ? (int)left : TILE;
  for (int i = tid; i < rows; i += BLOCK) {
    const unsigned long long k = s_keys[i];
    const long long g = s_out[(int)((k >> shift) & 255ull)] + i;
    if (keys_out != nullptr) keys_out[g] = k;
    ids_out[g] = s_ids[i];
  }
}

// ---- the one-block sort of small inputs ----------------------------------
constexpr int SMALL_ITEMS = 16;
constexpr int SMALL_WARPS = 16;
constexpr int SMALL_ROWS = SMALL_ITEMS * 32 * SMALL_WARPS;  // 8,192

// All k passes of n <= SMALL_ROWS rows, LSD, in one block of
// 32 * ceil(n / 512) threads; perm receives the permutation.
__global__ void __launch_bounds__(32 * SMALL_WARPS) sort_small(
    const long long* __restrict__ table, int k, long long n,
    int* __restrict__ perm) {
  __shared__ int s_ids[SMALL_ROWS];
  __shared__ unsigned short s_wcnt[SMALL_WARPS][256];
  __shared__ unsigned s_start[256];
  __shared__ unsigned long long s_or, s_and;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int nt = blockDim.x;
  const int nw = nt >> 5;
  const int rows = (int)n;
  for (int i = tid; i < rows; i += nt) s_ids[i] = i;
  for (int p = k - 1; p >= 0; --p) {
    const Pass d = load_pass(table, p);
    if (tid == 0) {
      s_or = 0ull;
      s_and = ~0ull;
    }
    __syncthreads();
    unsigned long long uo = 0ull, ua = ~0ull;
    for (int i = tid; i < rows; i += nt) {
      if (!pass_counts(d, i)) continue;
      const unsigned long long u = pass_key(d, i);
      uo |= u;
      ua &= u;
    }
    atomicOr(&s_or, uo);
    atomicAnd(&s_and, ua);
    __syncthreads();
    const unsigned long long live = s_or & ~s_and;
    __syncthreads();  // read by all before the next pass resets them
    for (int b = 0; b < 8; ++b) {
      if (((live >> (8 * b)) & 255ull) == 0ull) continue;  // block-uniform
      for (int j = tid; j < nw * 256; j += nt) s_wcnt[j >> 8][j & 255] = 0;
      __syncthreads();
      int id[SMALL_ITEMS], dig[SMALL_ITEMS];
      unsigned rank[SMALL_ITEMS];
#pragma unroll
      for (int j = 0; j < SMALL_ITEMS; ++j) {
        const int i = w * (32 * SMALL_ITEMS) + j * 32 + lane;
        const bool in = i < rows;
        id[j] = in ? s_ids[i] : 0;
        dig[j] = in ? (int)((pass_key(d, id[j]) >> (8 * b)) & 255ull) : 256;
      }
#pragma unroll
      for (int j = 0; j < SMALL_ITEMS; ++j)
        rank[j] = warp_rank(dig[j], s_wcnt[w]);
      __syncthreads();
      // per digit: each warp's start inside the digit's run; warp 0 then
      // scans the 256 run lengths (8 digits a lane)
      for (int t = tid; t < 256; t += nt) {
        unsigned c = 0u;
        for (int ww = 0; ww < nw; ++ww) {
          const unsigned v = s_wcnt[ww][t];
          s_wcnt[ww][t] = (unsigned short)c;
          c += v;
        }
        s_start[t] = c;
      }
      __syncthreads();
      if (w == 0) {
        unsigned c[8];
        int sum = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          c[q] = s_start[lane * 8 + q];
          sum += (int)c[q];
        }
        unsigned run = (unsigned)(srt::warp_incl_scan(sum) - sum);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          s_start[lane * 8 + q] = run;
          run += c[q];
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < SMALL_ITEMS; ++j)
        if (dig[j] < 256)
          s_ids[s_start[dig[j]] + s_wcnt[w][dig[j]] + rank[j]] = id[j];
      __syncthreads();
    }
  }
  for (int i = tid; i < rows; i += nt) perm[i] = s_ids[i];
}

}  // namespace

// table: int64[k * 8] pass descriptors; passes: int64[k, n]
SRT_API int k1_encode(const void* table, int k, long long n, void* passes,
                      void* stream) {
  dim3 grid(srt::blocks_for(n, BLOCK), (unsigned)k);
  encode_passes<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const long long*)table, n, (long long*)passes);
  return (int)cudaGetLastError();
}

// masks: uint64[k][2] set to {0, ~0} by the caller
SRT_API int k1_live(const void* table, int k, long long n, void* masks,
                    void* stream) {
  unsigned gx = srt::blocks_for(n, BLOCK);
  if (gx > 1024u) gx = 1024u;
  dim3 grid(gx, (unsigned)k);
  live_masks<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const long long*)table, n, (unsigned long long*)masks);
  return (int)cudaGetLastError();
}

// runs: int64[nruns] (pack_words); words: uint64[nwords, n] with nwords
// = ceil(total live bits / 64); hist: zeroed uint32[nwords][8][256]
SRT_API int k1_pack(const void* table, int k, long long n, const void* runs,
                    int nruns, int nwords, void* words, void* hist,
                    void* stream) {
  unsigned gx = srt::blocks_for(n, BLOCK);
  if (gx > 1024u) gx = 1024u;
  pack_words<<<gx, BLOCK, 0, (cudaStream_t)stream>>>(
      (const long long*)table, k, n, (const long long*)runs, nruns, nwords,
      (unsigned long long*)words, (unsigned*)hist);
  return (int)cudaGetLastError();
}

SRT_API int k1_gather_keys(const void* word, const void* perm, long long n,
                           void* keys, void* stream) {
  gather_keys<<<srt::blocks_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)word, (const int*)perm, n,
      (unsigned long long*)keys);
  return (int)cudaGetLastError();
}

// one stable digit step (n >= 1).  status: uint64[256 * ceil(n / 2048)]
// zeroed once for every step of the sort; counter: this step's zeroed
// uint32; epoch: this step's, from 1.
SRT_API int k1_onesweep(const void* keys_in, const void* ids_in, long long n,
                        int shift, const void* digit_hist, void* status,
                        void* counter, int epoch, void* keys_out,
                        void* ids_out, void* stream) {
  onesweep<<<srt::tiles_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)keys_in, (const int*)ids_in, n, shift,
      (const unsigned*)digit_hist, (unsigned long long*)status,
      (unsigned*)counter, (unsigned)epoch, (unsigned long long*)keys_out,
      (int*)ids_out);
  return (int)cudaGetLastError();
}

// 1 <= n <= SMALL_ROWS (segment.py:SMALL_SORT_ROWS): the whole sort in
// one block
SRT_API int k1_sort_small(const void* table, int k, long long n, void* perm,
                          void* stream) {
  if (n < 1 || n > SMALL_ROWS) return (int)cudaErrorInvalidValue;
  const int warps = (int)((n + 32 * SMALL_ITEMS - 1) / (32 * SMALL_ITEMS));
  sort_small<<<1, 32 * warps, 0, (cudaStream_t)stream>>>(
      (const long long*)table, k, n, (int*)perm);
  return (int)cudaGetLastError();
}
