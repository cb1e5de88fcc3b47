// K9 — Spark's Murmur3 (x86_32) of a batch's key columns from a seed (42
// for the exchanges, the grace join's per-level seeds for its buckets),
// and the hash partition id pmod(hash, n_out).
//
// Replaces spark_rapids_tpu/utils/hashing.py:hash_int_jnp (200),
// hash_long_jnp (207), hash_bytes_jnp (217), hash_device_column (242),
// hash_device_batch (269) and pmod (280), bit for bit: int8/int16/bool
// sign-extend to int32 and go through hashInt with int32 and date32;
// int64 and timestamp through hashLong; float32/float64 with -0.0 made
// 0.0 (NaN bits as they are) through hashInt/hashLong of their bits;
// strings as hashUnsafeBytes (length/4 little-endian words, then up to
// three sign-extended tail bytes, the length into fmix); a null row
// passes the running hash through.
//
// Bound on this card: bytes.  Each row reads its key bytes (8 B for
// Q3's int64 join key, 15 B + 4 B of length for Q4's priority string)
// and its validity, and writes a 4-byte pid; at 3.35 TB/s Q3's
// 4,194,304-row lineitem batch is ~55 MB, about 16 us.  Design: one
// thread per row folds h = 42 through every key column in order, so the
// running hash stays in a register and each key byte is read once; the
// column table (addresses, dtype, width) is a kernel parameter, so one
// launch covers every key column with no table upload.
#include "common.cuh"

namespace {

constexpr int MAX_COLS = 16;

struct HashCol {
  const void* data;
  const bool* valid;
  const int* lengths;
  int dtype;
  int width;
};

struct HashCols {
  HashCol c[MAX_COLS];
  int n;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  return rotl32(k1 * 0xCC9E2D51u, 15) * 0x1B873593u;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  return rotl32(h1 ^ k1, 13) * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h1, uint32_t length) {
  h1 ^= length;
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  h1 ^= h1 >> 16;
  return h1;
}

__device__ __forceinline__ uint32_t hash_int(uint32_t v, uint32_t h) {
  return fmix(mix_h1(h, mix_k1(v)), 4u);
}

__device__ __forceinline__ uint32_t hash_long(unsigned long long v,
                                              uint32_t h) {
  h = mix_h1(h, mix_k1((uint32_t)(v & 0xFFFFFFFFull)));
  h = mix_h1(h, mix_k1((uint32_t)(v >> 32)));
  return fmix(h, 8u);
}

__device__ __forceinline__ uint32_t hash_bytes(const uint8_t* row, int width,
                                               int length, uint32_t h) {
  // the reference pads the matrix to a multiple of 4 bytes with zeros
  // and clips the tail index into it
  const int padded = (width + 3) & ~3;
  const int aligned = length / 4;
  for (int k = 0; k < aligned && 4 * k < padded; ++k) {
    uint32_t word = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int at = 4 * k + b;
      word |= (uint32_t)(at < width ? row[at] : 0) << (8 * b);
    }
    h = mix_h1(h, mix_k1(word));
  }
  if (padded > 0) {
    for (int t = 0; t < 3; ++t) {
      int at = aligned * 4 + t;
      if (at >= length) break;
      if (at < 0) at = 0;
      if (at > padded - 1) at = padded - 1;
      const int8_t byte = (int8_t)(at < width ? row[at] : 0);
      h = mix_h1(h, mix_k1((uint32_t)(int32_t)byte));
    }
  }
  return fmix(h, (uint32_t)length);
}

__device__ __forceinline__ uint32_t fold(const HashCol& col, long long i,
                                         uint32_t h) {
  if (!col.valid[i]) return h;
  switch (col.dtype) {
    case srt::DT_BOOL:
      return hash_int(((const bool*)col.data)[i] ? 1u : 0u, h);
    case srt::DT_I8:
      return hash_int((uint32_t)(int32_t)((const int8_t*)col.data)[i], h);
    case srt::DT_I16:
      return hash_int((uint32_t)(int32_t)((const int16_t*)col.data)[i], h);
    case srt::DT_I32:
      return hash_int((uint32_t)((const int32_t*)col.data)[i], h);
    case srt::DT_I64:
      return hash_long((unsigned long long)((const long long*)col.data)[i],
                       h);
    case srt::DT_F32: {
      float v = ((const float*)col.data)[i];
      if (v == 0.0f) v = 0.0f;  // -0.0 -> 0.0
      return hash_int((uint32_t)__float_as_int(v), h);
    }
    case srt::DT_F64: {
      double v = ((const double*)col.data)[i];
      if (v == 0.0) v = 0.0;
      return hash_long((unsigned long long)__double_as_longlong(v), h);
    }
    default:  // DT_U8: a string's byte matrix
      return hash_bytes((const uint8_t*)col.data + i * (long long)col.width,
                        col.width, col.lengths[i], h);
  }
}

__global__ void murmur3(HashCols cols, long long n, uint32_t seed,
                        int n_out, int* __restrict__ hash_out,
                        int* __restrict__ pid_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t h = seed;
  for (int c = 0; c < cols.n; ++c) h = fold(cols.c[c], i, h);
  if (hash_out != nullptr) hash_out[i] = (int)h;
  if (pid_out != nullptr) {
    int r = (int)h % n_out;
    pid_out[i] = r < 0 ? r + n_out : r;
  }
}

}  // namespace

// table: per column five int64 (data, validity, lengths or 0, dtype
// code, string width); seed: the hash's starting value (its low 32
// bits); hash_out and/or pid_out may be NULL (pid_out needs n_out >= 1)
SRT_API int k9_murmur3(const long long* table, int ncols, long long n,
                       long long seed, int n_out, void* hash_out,
                       void* pid_out, void* stream) {
  if (ncols < 1 || ncols > MAX_COLS ||
      (pid_out != nullptr && n_out < 1))
    return (int)cudaErrorInvalidValue;
  HashCols cols;
  cols.n = ncols;
  for (int c = 0; c < ncols; ++c) {
    const long long* d = table + 5 * c;
    cols.c[c].data = (const void*)d[0];
    cols.c[c].valid = (const bool*)d[1];
    cols.c[c].lengths = (const int*)d[2];
    cols.c[c].dtype = (int)d[3];
    cols.c[c].width = (int)d[4];
    if (cols.c[c].dtype < srt::DT_BOOL || cols.c[c].dtype > srt::DT_U8 ||
        (cols.c[c].dtype == srt::DT_U8 && cols.c[c].lengths == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return (int)cudaSuccess;
  murmur3<<<srt::blocks_for(n, srt::BLOCK), srt::BLOCK, 0,
            (cudaStream_t)stream>>>(cols, n, (uint32_t)seed, n_out,
                                    (int*)hash_out, (int*)pid_out);
  return (int)cudaGetLastError();
}
