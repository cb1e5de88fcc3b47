// K25 — the grace join's bucket split: every column of a batch gathered
// into one dense batch per non-empty key-hash bucket.
//
// Replaces the per-bucket loop of spark_rapids_tpu/exec/joins.py:108
// _bucket_side (compact(b, pids == i) then slice_device_batch(., 0, cnt)
// for each of the m buckets).  K9 (seeded, pmod m) gives each row its
// bucket; K10's partition_order the stable order by bucket, the counts
// and the starts; the wrapper reads the counts back once and lays out
// one output a non-empty bucket at bucket_rows(count) rows.  Then one
// launch writes, for every column c and bucket b,
//
//   out[b].col[c][j] = src.col[c][order[starts[b] + j]]   for j < counts[b]
//
// (data, validity, and lengths for strings), and zero, invalid, length 0
// for j >= counts[b] (the bucket's padding rows: written here, so the
// outputs need no memset).  Rows keep their batch order inside a bucket,
// as the reference's compact keeps it.
//
// Bound on this card: bytes.  Each real row's bytes are read once and
// written once, plus its 4-byte order entry; every padding row is written
// once (shuffle/device_shuffle.py:bucket_split_bytes).  Design: the column
// and bucket descriptors are one table on the device, so one launch covers
// any schema and any m <= 64 (no per-bucket copy, no K10 slice of the
// block's whole padded size per bucket); blockIdx.y is the column, x
// strides over the concatenated output lanes of all buckets; each block
// keeps the bucket table in shared memory and finds a lane's bucket by a
// binary search over its lane offsets; 1/2/4/8-byte element copies, a
// byte loop for string rows.  Byte offsets are 64-bit.
//
// Table (int64 words):
//   per column c, COL_WORDS: src data, src validity, src lengths or 0,
//                            bytes a row
//   per bucket k, BUCKET_WORDS: first output lane (prefix of the
//                            capacities), start in order, count, capacity
//   per (k, c), OUT_WORDS:   out data, out validity, out lengths or 0
#include "common.cuh"

namespace {

using srt::BLOCK;

constexpr int COL_WORDS = 4;
constexpr int BUCKET_WORDS = 4;
constexpr int OUT_WORDS = 3;
constexpr int MAX_BUCKETS = 64;
constexpr unsigned MAX_BLOCKS = 16384;

template <typename E>
__device__ __forceinline__ void copy_elem(const uint8_t* src, uint8_t* dst,
                                          long long from, long long to) {
  ((E*)dst)[to] = ((const E*)src)[from];
}

template <typename E>
__device__ __forceinline__ void zero_elem(uint8_t* dst, long long to) {
  ((E*)dst)[to] = (E)0;
}

__global__ void bucket_split_kernel(const long long* __restrict__ tab,
                                    int ncols, int nb, long long total,
                                    const int* __restrict__ order) {
  __shared__ long long bk[MAX_BUCKETS][BUCKET_WORDS];
  const long long* bt = tab + (long long)ncols * COL_WORDS;
  for (int i = threadIdx.x; i < nb * BUCKET_WORDS; i += blockDim.x)
    bk[i / BUCKET_WORDS][i % BUCKET_WORDS] = bt[i];
  __syncthreads();
  const int c = (int)blockIdx.y;
  const long long* col = tab + (long long)c * COL_WORDS;
  const uint8_t* const src = (const uint8_t*)col[0];
  const bool* const src_valid = (const bool*)col[1];
  const int* const src_len = (const int*)col[2];
  const long long rb = col[3];
  const long long* const outs = bt + (long long)nb * BUCKET_WORDS;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    // the last bucket whose first lane is at or before t
    int lo = 0, hi = nb - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (bk[mid][0] <= t) lo = mid; else hi = mid - 1;
    }
    const long long j = t - bk[lo][0];
    const long long* o = outs + ((long long)lo * ncols + c) * OUT_WORDS;
    uint8_t* const dst = (uint8_t*)o[0];
    bool* const dst_valid = (bool*)o[1];
    int* const dst_len = (int*)o[2];
    if (j < bk[lo][2]) {
      const long long row = order[bk[lo][1] + j];
      switch (rb) {
        case 1: copy_elem<uint8_t>(src, dst, row, j); break;
        case 2: copy_elem<uint16_t>(src, dst, row, j); break;
        case 4: copy_elem<uint32_t>(src, dst, row, j); break;
        case 8: copy_elem<unsigned long long>(src, dst, row, j); break;
        default: {
          const uint8_t* s = src + row * rb;
          uint8_t* d = dst + j * rb;
          for (long long q = 0; q < rb; ++q) d[q] = s[q];
        }
      }
      dst_valid[j] = src_valid[row];
      if (dst_len != nullptr) dst_len[j] = src_len[row];
    } else {
      switch (rb) {
        case 1: zero_elem<uint8_t>(dst, j); break;
        case 2: zero_elem<uint16_t>(dst, j); break;
        case 4: zero_elem<uint32_t>(dst, j); break;
        case 8: zero_elem<unsigned long long>(dst, j); break;
        default: {
          uint8_t* d = dst + j * rb;
          for (long long q = 0; q < rb; ++q) d[q] = 0;
        }
      }
      dst_valid[j] = false;
      if (dst_len != nullptr) dst_len[j] = 0;
    }
  }
}

}  // namespace

// table: as above, on the device; ncols >= 1 columns, 1 <= nb <= 64
// non-empty buckets whose capacities add up to `total` output lanes;
// order: int32 (K10's partition_order of the batch's bucket ids).
SRT_API int k25_bucket_split(const long long* table, int ncols, int nb,
                             long long total, const void* order,
                             void* stream) {
  if (ncols < 1 || ncols > 65535 || nb < 1 || nb > MAX_BUCKETS ||
      total < 1)
    return (int)cudaErrorInvalidValue;
  long long blocks = (total + BLOCK - 1) / BLOCK;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const dim3 grid((unsigned)blocks, (unsigned)ncols);
  bucket_split_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      table, ncols, nb, total, (const int*)order);
  return (int)cudaGetLastError();
}
