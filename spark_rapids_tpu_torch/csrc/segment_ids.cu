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
// validity, and lengths for strings) and the int32 ids written once; for
// Q1's two one-byte string keys over 8,388,608 rows that is about 110 MB,
// ~33 us at 3.35 TB/s.  Design: one flag kernel per key column ORs into a
// byte of flags (each reads row i and i-1, the second hit in L1/L2), then
// a three-launch multi-block scan (tile sums, one-block scan of the tile
// sums, per-row write) with warp-shuffle block scans; no atomics, so the
// ids are the same bits on every run.
#include "keys.cuh"

namespace {

using srt::BLOCK;
using srt::ITEMS;
using srt::TILE;

__global__ void flags_init(const bool* __restrict__ pad_valid, long long n,
                           uint8_t* __restrict__ change) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool c = (i == 0);
  if (pad_valid != nullptr && !pad_valid[i]) c = true;
  change[i] = c ? 1 : 0;
}

template <typename T>
__global__ void flags_num(const T* __restrict__ data,
                          const bool* __restrict__ valid, long long n,
                          uint8_t* __restrict__ change) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 1 || i >= n) return;
  const bool v1 = valid[i];
  const bool v0 = valid[i - 1];
  const bool neq = (v1 && v0 && srt::differs<T>(data[i], data[i - 1])) ||
                   (v1 != v0);
  if (neq) change[i] = 1;
}

__global__ void flags_str(const uint8_t* __restrict__ bytes,
                          const int* __restrict__ lengths,
                          const bool* __restrict__ valid, int w, long long n,
                          uint8_t* __restrict__ change) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 1 || i >= n) return;
  const bool v1 = valid[i];
  const bool v0 = valid[i - 1];
  const bool diff = srt::bytes_differ(bytes, lengths, w, i, i - 1);
  if ((v1 && v0 && diff) || (v1 != v0)) change[i] = 1;
}

// ids[i] = (inclusive prefix of change) - 1
__global__ void scan_ids(const uint8_t* __restrict__ change, long long n,
                         const int* __restrict__ tile_offsets,
                         int* __restrict__ ids) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  int f[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    f[j] = (i < n && change[i]) ? 1 : 0;
  }
  int tile_total;
  int run = tile_offsets[blockIdx.x] + srt::thread_prefix(f, &tile_total);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    run += f[j];
    if (i < n) ids[i] = run - 1;
  }
}

template <typename T>
cudaError_t launch_flags(const void* data, const void* valid, long long n,
                         void* change, cudaStream_t st) {
  flags_num<T><<<srt::blocks_for(n, BLOCK), BLOCK, 0, st>>>(
      (const T*)data, (const bool*)valid, n, (uint8_t*)change);
  return cudaGetLastError();
}

}  // namespace

SRT_API int k2_flags_init(const void* pad_valid, long long n, void* change,
                          void* stream) {
  flags_init<<<srt::blocks_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
      (const bool*)pad_valid, n, (uint8_t*)change);
  return (int)cudaGetLastError();
}

SRT_API int k2_flags_num(const void* data, const void* valid, int dtype,
                         long long n, void* change, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case srt::DT_BOOL:
    case srt::DT_I8:
    case srt::DT_U8:
      return (int)launch_flags<uint8_t>(data, valid, n, change, st);
    case srt::DT_I16:
      return (int)launch_flags<int16_t>(data, valid, n, change, st);
    case srt::DT_I32:
      return (int)launch_flags<int32_t>(data, valid, n, change, st);
    case srt::DT_I64:
      return (int)launch_flags<long long>(data, valid, n, change, st);
    case srt::DT_F32:
      return (int)launch_flags<float>(data, valid, n, change, st);
    case srt::DT_F64:
      return (int)launch_flags<double>(data, valid, n, change, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

SRT_API int k2_flags_str(const void* bytes, const void* lengths,
                         const void* valid, int w, long long n, void* change,
                         void* stream) {
  flags_str<<<srt::blocks_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bytes, (const int*)lengths, (const bool*)valid, w, n,
      (uint8_t*)change);
  return (int)cudaGetLastError();
}

// tile_sums: scratch int32[ceil(n / 2048)]
SRT_API int k2_scan_ids(const void* change, long long n, void* tile_sums,
                        void* ids, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = srt::tiles_for(n);
  srt::scan_tile_sums<<<ntiles, BLOCK, 0, st>>>((const uint8_t*)change, n,
                                                (int*)tile_sums);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  srt::scan_tile_offsets<<<1, srt::scan_threads(ntiles), 0, st>>>((int*)tile_sums, ntiles,
                                             nullptr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_ids<<<ntiles, BLOCK, 0, st>>>((const uint8_t*)change, n,
                                     (const int*)tile_sums, (int*)ids);
  return (int)cudaGetLastError();
}
