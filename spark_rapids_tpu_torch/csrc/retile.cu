// K27 — the multi-process runner's retile (B.28): the replicated maximum
// of the owned shards' statistics, and every buffer of every owned shard
// trimmed to the agreed bucket in one copy.
//
// Replaces spark_rapids_tpu/parallel/multiprocess.py:342
// MultiProcessRunner._retile: its jit at :348 (the max of every shard's
// row count, replicated to every controller by out_shardings=P()) and its
// jit at :358 (every column of the stacked stage output cut to
// bucket_rows(max) in new arrays, so the padded output is freed).
//
// k27_retile_max: one block.  Its table lists the statistics of the
// shards this process owns, each entry a device array of int32 or int64
// words (a shard's row count, K10's counts to every destination) or one
// word given in the table itself (a string column's width), each written
// at its own slot of a k-word vector: a shard's entries sit at slots of
// their own, so the element-wise max over the entries, and then over the
// processes (the wrapper's torch.distributed.all_reduce(MAX) of this
// output), gives every shard's statistics on every process.  Word k is
// bucket_rows(max of words [0, n_bucket), min_bucket), the formula of
// data/column.py:bucket_rows; the bucket of a max is the max of the
// buckets, so it is taken before the collective.  Every statistic is >= 0
// and a slot no entry covers is 0.  Bound: launch latency (a few hundred
// bytes read and written).
//
// k27_retile_trim: one launch over every buffer of every owned shard (data,
// validity, a string column's lengths): buffer blockIdx.y copies its first
// `bytes` bytes (need rows) into its place in one new allocation; 16-byte
// chunks where both addresses are 16-byte aligned, then the tail byte by
// byte; a byte loop otherwise.  Bound: bytes, 2 x the trimmed bytes over
// the card's memory rate (3.35 TB/s on an H100 SXM).
//
// Tables (int64 words):
//   retile_max, per entry (MAX_WORDS): source address or 0, element count
//     (or, for address 0, the value itself), element bytes (4 or 8), slot
//   retile_trim, per buffer (TRIM_WORDS): source address, destination
//     address, bytes to copy
#include "common.cuh"

namespace {

using srt::BLOCK;

constexpr int MAX_WORDS = 4;
constexpr int TRIM_WORDS = 3;
constexpr unsigned MAX_BLOCKS = 4096;

struct alignas(16) Chunk {
  unsigned long long lo, hi;
};

__global__ void retile_max_kernel(const long long* __restrict__ tab,
                                  int n_entries, int k, int n_bucket,
                                  long long min_bucket,
                                  long long* __restrict__ out) {
  __shared__ long long red[BLOCK];
  long long top = 0;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    long long m = 0;
    for (int e = 0; e < n_entries; ++e) {
      const long long* w = tab + (long long)e * MAX_WORDS;
      const long long at = j - w[3];
      if (w[0] == 0) {
        if (at == 0 && w[1] > m) m = w[1];
      } else if (at >= 0 && at < w[1]) {
        const long long v = w[2] == 4 ? (long long)((const int*)w[0])[at]
                                      : ((const long long*)w[0])[at];
        if (v > m) m = v;
      }
    }
    out[j] = m;
    if (j < n_bucket && m > top) top = m;
  }
  red[threadIdx.x] = top;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s && red[threadIdx.x + s] > red[threadIdx.x])
      red[threadIdx.x] = red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const long long need = red[0] > 1 ? red[0] : 1;
    long long b = min_bucket > 1 ? min_bucket : 1;
    while (b < need) b <<= 1;
    out[k] = b;
  }
}

__global__ void retile_trim_kernel(const long long* __restrict__ tab) {
  const long long* w = tab + (long long)blockIdx.y * TRIM_WORDS;
  const uint8_t* const src = (const uint8_t*)w[0];
  uint8_t* const dst = (uint8_t*)w[1];
  const long long bytes = w[2];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0) {
    const long long n16 = bytes / 16;
    for (long long i = first; i < n16; i += stride)
      ((Chunk*)dst)[i] = ((const Chunk*)src)[i];
    done = n16 * 16;
  }
  for (long long i = done + first; i < bytes; i += stride) dst[i] = src[i];
}

}  // namespace

// table: n_entries >= 1 entries as above, on the device; out: int64[k + 1]
// on the device; 1 <= n_bucket <= k.
SRT_API int k27_retile_max(const long long* table, int n_entries, int k,
                           int n_bucket, long long min_bucket, void* out,
                           void* stream) {
  if (n_entries < 1 || k < 1 || n_bucket < 1 || n_bucket > k)
    return (int)cudaErrorInvalidValue;
  retile_max_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(
      table, n_entries, k, n_bucket, min_bucket, (long long*)out);
  return (int)cudaGetLastError();
}

// table: n_buffers >= 1 buffers as above, on the device; max_bytes: the
// largest byte count among them (sizes the grid).
SRT_API int k27_retile_trim(const long long* table, int n_buffers,
                            long long max_bytes, void* stream) {
  if (n_buffers < 1 || n_buffers > 65535 || max_bytes < 1)
    return (int)cudaErrorInvalidValue;
  long long blocks = (max_bytes / 16 + BLOCK - 1) / BLOCK;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const dim3 grid((unsigned)blocks, (unsigned)n_buffers);
  retile_trim_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(table);
  return (int)cudaGetLastError();
}
