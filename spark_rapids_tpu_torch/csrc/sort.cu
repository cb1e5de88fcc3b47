// K1 — key-pass encoding + stable LSD radix sort -> row permutation.
//
// Replaces spark_rapids_tpu/ops/kernels/segment.py:_sort_key_device (216),
// key_passes_device (257), lexsort_device (297) and sort_permutation (313):
// the order-preserving uint64 pass encoding of the sort keys and the one
// variadic stable lax.sort over all passes.
//
// Passes are stored as int64 in "signed order" (the uint64 key with its
// top bit flipped), so a signed compare of the stored value orders like
// the unsigned key; the kernels flip the bit back before taking digits.
//
// Bound on this card: bytes.  Each 8-bit digit step reads the 8-byte keys
// and 4-byte permutation and writes both again (24 B/row), plus a
// histogram read of the keys; at 3.35 TB/s one step over 8,388,608 rows
// is about 60 us of traffic.  Design against it:
//   * one global histogram pass over every (pass, digit) first; a digit
//     whose histogram has a single non-empty bucket moves no row and is
//     skipped.  Q1's padding, null-rank and one-byte string passes have
//     one or two live digits each, so 40 digit steps become 5.
//   * per live digit: a tile histogram (warp-aggregated shared atomics on
//     counts, which are order-free), a per-digit scan over tiles, and a
//     ranked scatter.  Stability inside a tile comes from ranks, never
//     from atomics: rows are taken in rounds of 256, ranked within their
//     warp with __match_any_sync, and the warps of a round are ordered by
//     a prefix over per-warp digit counts in shared memory
//     (srt::ranked_position in common.cuh, shared with K10).
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

template <typename T>
__global__ void encode_num(const T* __restrict__ data,
                           const bool* __restrict__ valid, long long n,
                           int desc, int nulls_first,
                           long long* __restrict__ null_pass,
                           long long* __restrict__ val_pass) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool v = valid[i];
  const unsigned long long null_rank = nulls_first ? 0ull : 1ull;
  null_pass[i] = (long long)((v ? 1ull - null_rank : null_rank) ^ SIGN);
  unsigned long long u = order_bits(data[i]);
  if (desc) u = ~u;
  if (!v) u = 0ull;
  val_pass[i] = (long long)(u ^ SIGN);
}

// one pass per 8 bytes, most significant byte first (segment.py:281-292)
__global__ void encode_str(const uint8_t* __restrict__ bytes,
                           const bool* __restrict__ valid, int w,
                           long long n, int desc, int nulls_first,
                           long long* __restrict__ null_pass,
                           long long* __restrict__ chunk_passes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool v = valid[i];
  const unsigned long long null_rank = nulls_first ? 0ull : 1ull;
  null_pass[i] = (long long)((v ? 1ull - null_rank : null_rank) ^ SIGN);
  const uint8_t* row = bytes + i * (long long)w;
  for (int c = 0; c * 8 < w; ++c) {
    const int start = c * 8;
    const int cw = (w - start) < 8 ? (w - start) : 8;
    unsigned long long k = 0ull;
    for (int b = 0; b < cw; ++b) k = (k << 8) | (unsigned long long)row[start + b];
    k <<= 8 * (8 - cw);
    if (desc) k = ~k;
    if (!v) k = 0ull;
    chunk_passes[(long long)c * n + i] = (long long)(k ^ SIGN);
  }
}

// padding rows sort last: 0 for real rows, 1 for padding
__global__ void encode_pad(const bool* __restrict__ pad_valid, long long n,
                           long long* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = (long long)((pad_valid[i] ? 0ull : 1ull) ^ SIGN);
}

// ---- histograms ----------------------------------------------------------
// hist[p][d][256] over every pass p and digit d (order-free counts)
__global__ void global_hist(const long long* __restrict__ passes, long long n,
                            unsigned* __restrict__ hist) {
  __shared__ unsigned h[8 * 256];
  const int p = blockIdx.y;
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < 8 * 256; j += blockDim.x) h[j] = 0u;
  __syncthreads();
  const long long* pass = passes + (long long)p * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    const bool in = i < n;
    const unsigned long long u =
        in ? ((unsigned long long)pass[i] ^ SIGN) : 0ull;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int dig = in ? (int)((u >> (8 * d)) & 255ull) : 256;
      const unsigned peers = __match_any_sync(FULL_MASK, dig);
      if (in && lane == __ffs(peers) - 1)
        atomicAdd(&h[d * 256 + dig], (unsigned)__popc(peers));
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 8 * 256; j += blockDim.x)
    if (h[j]) atomicAdd(&hist[(long long)p * 8 * 256 + j], h[j]);
}

// keys of one pass in the current order, as unsigned keys
__global__ void gather_keys(const long long* __restrict__ pass,
                            const int* __restrict__ perm, long long n,
                            unsigned long long* __restrict__ keys,
                            int* __restrict__ perm_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (perm == nullptr) {
    keys[i] = (unsigned long long)pass[i] ^ SIGN;
    perm_out[i] = (int)i;
  } else {
    keys[i] = (unsigned long long)pass[perm[i]] ^ SIGN;
  }
}

// counts[dig][tile] of one digit over each tile of TILE rows
__global__ void tile_hist(const unsigned long long* __restrict__ keys,
                          long long n, int shift, int ntiles,
                          unsigned* __restrict__ counts) {
  __shared__ unsigned h[256];
  const int lane = threadIdx.x & 31;
  h[threadIdx.x] = 0u;
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const long long i = base + r * BLOCK + threadIdx.x;
    const bool in = i < n;
    const int dig = in ? (int)((keys[i] >> shift) & 255ull) : 256;
    const unsigned peers = __match_any_sync(FULL_MASK, dig);
    if (in && lane == __ffs(peers) - 1)
      atomicAdd(&h[dig], (unsigned)__popc(peers));
  }
  __syncthreads();
  counts[(long long)threadIdx.x * ntiles + blockIdx.x] = h[threadIdx.x];
}

// counts -> global scatter offsets, in place: one block per digit scans
// its row of tiles and adds the rows of all smaller digits
__global__ void scan_offsets(unsigned* __restrict__ counts, int ntiles,
                             const unsigned* __restrict__ digit_hist) {
  __shared__ unsigned s_base;
  const int dig = blockIdx.x;
  if (threadIdx.x == 0) {
    unsigned s = 0u;
    for (int j = 0; j < dig; ++j) s += digit_hist[j];
    s_base = s;
  }
  __syncthreads();
  unsigned carry = s_base;
  unsigned* row = counts + (long long)dig * ntiles;
  for (int start = 0; start < ntiles; start += blockDim.x) {
    const int t = start + threadIdx.x;
    const int v = t < ntiles ? (int)row[t] : 0;
    int total;
    const int ex = srt::block_excl_scan(v, &total);
    if (t < ntiles) row[t] = carry + (unsigned)ex;
    carry += (unsigned)total;
  }
}

// stable ranked scatter of (key, row) by one digit
__global__ void scatter(const unsigned long long* __restrict__ keys_in,
                        const int* __restrict__ perm_in, long long n,
                        int shift, int ntiles,
                        const unsigned* __restrict__ offsets,
                        unsigned long long* __restrict__ keys_out,
                        int* __restrict__ perm_out) {
  __shared__ unsigned s_base[256];
  __shared__ unsigned s_cnt[srt::WARPS][256];
  __shared__ unsigned s_off[srt::WARPS][256];
  const int tid = threadIdx.x;
  s_base[tid] = offsets[(long long)tid * ntiles + blockIdx.x];
#pragma unroll
  for (int ww = 0; ww < srt::WARPS; ++ww) s_cnt[ww][tid] = 0u;
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE;
  for (int r = 0; r < ITEMS; ++r) {
    const long long i = base + r * BLOCK + tid;
    const bool in = i < n;
    const unsigned long long key = in ? keys_in[i] : 0ull;
    const int pv = in ? perm_in[i] : 0;
    const int dig = in ? (int)((key >> shift) & 255ull) : 256;
    const unsigned pos = srt::ranked_position(dig, in, s_base, s_cnt, s_off);
    if (in) {
      keys_out[pos] = key;
      perm_out[pos] = pv;
    }
  }
}

template <typename T>
cudaError_t launch_encode(const void* data, const void* valid, long long n,
                          int desc, int nf, void* null_pass, void* val_pass,
                          cudaStream_t st) {
  encode_num<T><<<srt::blocks_for(n, BLOCK), BLOCK, 0, st>>>(
      (const T*)data, (const bool*)valid, n, desc, nf,
      (long long*)null_pass, (long long*)val_pass);
  return cudaGetLastError();
}

}  // namespace

SRT_API int k1_encode_num(const void* data, const void* valid, int dtype,
                          long long n, int desc, int nulls_first,
                          void* null_pass, void* val_pass, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case srt::DT_BOOL:
      return (int)launch_encode<bool>(data, valid, n, desc, nulls_first,
                                      null_pass, val_pass, st);
    case srt::DT_I8:
      return (int)launch_encode<int8_t>(data, valid, n, desc, nulls_first,
                                        null_pass, val_pass, st);
    case srt::DT_I16:
      return (int)launch_encode<int16_t>(data, valid, n, desc, nulls_first,
                                         null_pass, val_pass, st);
    case srt::DT_I32:
      return (int)launch_encode<int32_t>(data, valid, n, desc, nulls_first,
                                         null_pass, val_pass, st);
    case srt::DT_I64:
      return (int)launch_encode<long long>(data, valid, n, desc,
                                           nulls_first, null_pass, val_pass,
                                           st);
    case srt::DT_F32:
      return (int)launch_encode<float>(data, valid, n, desc, nulls_first,
                                       null_pass, val_pass, st);
    case srt::DT_F64:
      return (int)launch_encode<double>(data, valid, n, desc, nulls_first,
                                        null_pass, val_pass, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

SRT_API int k1_encode_str(const void* bytes, const void* valid, int w,
                          long long n, int desc, int nulls_first,
                          void* null_pass, void* chunk_passes, void* stream) {
  encode_str<<<srt::blocks_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bytes, (const bool*)valid, w, n, desc, nulls_first,
      (long long*)null_pass, (long long*)chunk_passes);
  return (int)cudaGetLastError();
}

SRT_API int k1_encode_pad(const void* pad_valid, long long n, void* out,
                          void* stream) {
  encode_pad<<<srt::blocks_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
      (const bool*)pad_valid, n, (long long*)out);
  return (int)cudaGetLastError();
}

// hist: zeroed uint32[k][8][256]
SRT_API int k1_global_hist(const void* passes, int k, long long n,
                           void* hist, void* stream) {
  unsigned gx = srt::blocks_for(n, BLOCK);
  if (gx > 1024u) gx = 1024u;
  dim3 grid(gx, (unsigned)k);
  global_hist<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const long long*)passes, n, (unsigned*)hist);
  return (int)cudaGetLastError();
}

// perm == NULL: the identity order (perm_out receives the iota)
SRT_API int k1_gather_keys(const void* pass, const void* perm, long long n,
                           void* keys, void* perm_out, void* stream) {
  gather_keys<<<srt::blocks_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
      (const long long*)pass, (const int*)perm, n, (unsigned long long*)keys,
      (int*)perm_out);
  return (int)cudaGetLastError();
}

// one stable digit step: tile histogram, offsets, scatter.
// counts: scratch uint32[256 * ntiles]; digit_hist: this digit's
// uint32[256] global histogram (from k1_global_hist).
SRT_API int k1_digit_step(const void* keys_in, const void* perm_in,
                          long long n, int shift, void* counts,
                          const void* digit_hist, void* keys_out,
                          void* perm_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = srt::tiles_for(n);
  tile_hist<<<ntiles, BLOCK, 0, st>>>((const unsigned long long*)keys_in, n,
                                      shift, ntiles, (unsigned*)counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_offsets<<<256, srt::scan_threads(ntiles), 0, st>>>((unsigned*)counts, ntiles,
                                     (const unsigned*)digit_hist);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scatter<<<ntiles, BLOCK, 0, st>>>(
      (const unsigned long long*)keys_in, (const int*)perm_in, n, shift,
      ntiles, (const unsigned*)counts, (unsigned long long*)keys_out,
      (int*)perm_out);
  return (int)cudaGetLastError();
}
