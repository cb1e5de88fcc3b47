// K26 — the ML hand-off's feature matrix: the selected columns of a batch
// cast to float32 and stacked row-major, the rows with a null in any of
// them dropped, the rest kept in order.
//
// Replaces spark_rapids_tpu/ml/columnar_export.py:53 to_feature_matrix
// (per batch: each column's data[:n].astype(float32), jnp.stack(cols, 1),
// m[valid] where some row is null; then jnp.concatenate).  A row r of a
// batch is kept when r < num_rows and every selected column is valid at
// r; kept row j of the batch lands at row offset + j of the output,
// offset being the kept rows of the batches before it.  Conversions round
// to nearest even, as torch's and numpy's casts do: __int2float_rn for
// bool (0/1), int8, int16, int32 and dates, __ll2float_rn for int64 and
// timestamps, __double2float_rn for doubles; a float column's bits pass
// through (NaN, +-inf and -0.0 included).
//
// Two passes over a batch, modelled on gather.cu's k4_compact_plan:
//   k26_count : each tile of 2048 rows counts its kept rows, then one
//               block turns the tile counts into exclusive offsets and
//               writes the batch's total (common.cuh's scan_tile_offsets);
//   k26_write : each tile walks its rows in 8 rounds of 256, a block scan
//               ranks the round's kept rows, and each kept row's k floats
//               are written at its rank.
// The wrapper (ops/kernels/export.py) reads every batch's total back at
// once to size one [rows, k] output, and each batch's write starts at its
// offset in it, so no concatenation follows.
//
// Bound on this card: bytes.  Each selected column's data and validity
// are read once over the batch's real rows, and each kept row's k floats
// written once (the Mortgage feature frame: 5,000,000 rows x 9 columns,
// 56 bytes of data and 9 of validity a row read, 36 written: ~0.5 GB).
// Design: the column descriptors (data, validity, type code) are one
// table on the device, kept in shared memory, so one launch covers any
// schema; a round's 256 threads read 256 consecutive rows of a column
// (coalesced); a row's k validity loads, and its k loads and stores, are
// issued together (no early exit, the loops unrolled by 8), not each
// after the last returns; no tensor cores and no TMA: the work is data
// movement.  A block writing a round's floats consecutively (one float a
// thread) measured slower on the card than these row stores.
#include "common.cuh"

namespace {

using srt::BLOCK;
using srt::ITEMS;
using srt::TILE;

constexpr int COL_WORDS = 3;   // data, validity, dtype code
constexpr int MAX_COLS = 256;

__device__ __forceinline__ float to_float(const void* data, int code,
                                          long long r) {
  switch (code) {
    case srt::DT_BOOL: return ((const bool*)data)[r] ? 1.0f : 0.0f;
    case srt::DT_I8: return __int2float_rn(((const int8_t*)data)[r]);
    case srt::DT_I16: return __int2float_rn(((const int16_t*)data)[r]);
    case srt::DT_I32: return __int2float_rn(((const int32_t*)data)[r]);
    case srt::DT_I64: return __ll2float_rn(((const long long*)data)[r]);
    case srt::DT_F32: return ((const float*)data)[r];
    default: return __double2float_rn(((const double*)data)[r]);
  }
}

// the table's k descriptors into shared memory
__device__ __forceinline__ void load_table(const long long* __restrict__ tab,
                                           int k, long long* s_tab) {
  for (int i = threadIdx.x; i < k * COL_WORDS; i += blockDim.x)
    s_tab[i] = tab[i];
  __syncthreads();
}

__device__ __forceinline__ bool kept(const long long* s_tab, int k,
                                     long long r, long long nrows) {
  if (r >= nrows) return false;
  // no early exit: the k loads go out together, not one after another
  bool ok = true;
#pragma unroll 8
  for (int c = 0; c < k; ++c)
    ok &= ((const bool*)s_tab[c * COL_WORDS + 1])[r];
  return ok;
}

__global__ void count_kernel(const long long* __restrict__ tab, int k,
                             const int* __restrict__ num_rows,
                             int* __restrict__ tile_sums) {
  __shared__ long long s_tab[MAX_COLS * COL_WORDS];
  load_table(tab, k, s_tab);
  const long long nrows = *num_rows;
  const long long base = (long long)blockIdx.x * TILE;
  int s = 0;
  for (int i = 0; i < ITEMS; ++i)
    s += kept(s_tab, k, base + (long long)i * BLOCK + threadIdx.x, nrows)
             ? 1 : 0;
  int total;
  srt::block_excl_scan(s, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

__global__ void write_kernel(const long long* __restrict__ tab, int k,
                             const int* __restrict__ num_rows,
                             const int* __restrict__ tile_offsets,
                             float* __restrict__ out) {
  __shared__ long long s_tab[MAX_COLS * COL_WORDS];
  load_table(tab, k, s_tab);
  const long long nrows = *num_rows;
  const long long base = (long long)blockIdx.x * TILE;
  long long at = tile_offsets[blockIdx.x];
  for (int i = 0; i < ITEMS; ++i) {
    const long long r = base + (long long)i * BLOCK + threadIdx.x;
    const bool keep = kept(s_tab, k, r, nrows);
    int total;
    const int rank = srt::block_excl_scan(keep ? 1 : 0, &total);
    if (keep) {
      float* dst = out + (at + rank) * (long long)k;
#pragma unroll 8
      for (int c = 0; c < k; ++c)
        dst[c] = to_float((const void*)s_tab[c * COL_WORDS],
                          (int)s_tab[c * COL_WORDS + 2], r);
    }
    at += total;
  }
}

}  // namespace

// table: k descriptors of COL_WORDS int64 words on the device (data,
// validity, dtype code of common.cuh; 1 <= k <= 256); num_rows: the
// batch's int32 row count on the device; padded >= 1 rows; tile_sums:
// scratch int32[ceil(padded / 2048)], left holding each tile's exclusive
// offset; count: int32, the batch's kept rows.  Two kernels.
SRT_API int k26_count(const long long* table, int k, long long padded,
                      const void* num_rows, void* tile_sums, void* count,
                      void* stream) {
  if (k < 1 || k > MAX_COLS || padded < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = srt::tiles_for(padded);
  count_kernel<<<ntiles, BLOCK, 0, st>>>(table, k, (const int*)num_rows,
                                         (int*)tile_sums);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  srt::scan_tile_offsets<<<1, srt::scan_threads(ntiles), 0, st>>>(
      (int*)tile_sums, ntiles, (int*)count);
  return (int)cudaGetLastError();
}

// tile_offsets: k26_count's tile_sums after it ran; out: the batch's first
// output row, room for its count rows of k floats.  One kernel.
SRT_API int k26_write(const long long* table, int k, long long padded,
                      const void* num_rows, const void* tile_offsets,
                      void* out, void* stream) {
  if (k < 1 || k > MAX_COLS || padded < 1) return (int)cudaErrorInvalidValue;
  write_kernel<<<srt::tiles_for(padded), BLOCK, 0, (cudaStream_t)stream>>>(
      table, k, (const int*)num_rows, (const int*)tile_offsets,
      (float*)out);
  return (int)cudaGetLastError();
}
