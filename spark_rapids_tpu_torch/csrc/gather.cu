// K4 — stream compaction and gather; K7 — the null-side gather of a join.
//
// Replaces spark_rapids_tpu/ops/kernels/gather.py:compact (33),
// gather_column (16) and gather_batch (27), and (K7, k7_gather_side)
// spark_rapids_tpu/ops/kernels/join.py:gather_side (158).  compact keeps the rows whose
// flag is set (and that lie below num_rows) at the front in their order,
// puts the dropped rows after them in their order (the reference's stable
// argsort of ~keep), and clears the validity past the new row count;
// gather is an indexed copy of rows (1-D data, validity, lengths, or a
// byte matrix's rows), with the index clamped into range as XLA does.
//
// Bound on this card: bytes.  compact reads the flags once for the scan
// and every column once, and writes every column once at its destination;
// for a 2,097,152-row Q1 reader batch (53 B a row) that is ~225 MB, about
// 67 us at 3.35 TB/s.  Design: a three-launch multi-block scan of the keep
// flags (tile sums, one-block scan, per-row destination), then one
// scatter launch per array with 1/2/4/8-byte element copies (or a byte
// loop for matrix rows); reads are coalesced, and the writes of kept rows
// are contiguous runs.  No atomics: the destinations come from the scan.
//
// K7 gathers a join side's column by the output's row indices, where -1
// gives a null row: validity = valid[idx] && idx >= 0 && slot_valid.  At
// Q3's second join (an output bucket of 32,768 slots, 4-8 B columns) it
// reads the index, the slot mask and a gathered row and writes the row,
// its validity and (strings) its length: ~15 B a slot a column, well
// under a microsecond at 3.35 TB/s, so the launch sets its time.  Design:
// data, validity and lengths of one column in one pass (one launch a
// column), with K4's 1/2/4/8-byte element copies or a byte loop for
// matrix rows.
#include "common.cuh"

namespace {

using srt::BLOCK;
using srt::ITEMS;
using srt::TILE;

__global__ void keep_flags(const bool* __restrict__ keep,
                           const int* __restrict__ num_rows, long long n,
                           uint8_t* __restrict__ flags) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  flags[i] = (keep[i] && i < (long long)(*num_rows)) ? 1 : 0;
}

// dest[i]: kept rows to [0, count), dropped rows to [count, n), stable
__global__ void destinations(const uint8_t* __restrict__ flags, long long n,
                             const int* __restrict__ tile_offsets,
                             const int* __restrict__ count,
                             int* __restrict__ dest) {
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  int f[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    f[j] = (i < n && flags[i]) ? 1 : 0;
  }
  int tile_total;
  int kept_before = tile_offsets[blockIdx.x] + srt::thread_prefix(f, &tile_total);
  const int total = *count;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i < n)
      dest[i] = f[j] ? kept_before : total + (int)(i - kept_before);
    kept_before += f[j];
  }
}

template <typename E>
__global__ void scatter_elems(const E* __restrict__ src,
                              const int* __restrict__ dest, long long n,
                              E* __restrict__ dst) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  dst[dest[i]] = src[i];
}

__global__ void scatter_bytes(const uint8_t* __restrict__ src,
                              const int* __restrict__ dest, long long n,
                              int row_bytes, uint8_t* __restrict__ dst) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* s = src + i * (long long)row_bytes;
  uint8_t* d = dst + (long long)dest[i] * row_bytes;
  for (int j = 0; j < row_bytes; ++j) d[j] = s[j];
}

__global__ void scatter_valid(const bool* __restrict__ valid,
                              const uint8_t* __restrict__ flags,
                              const int* __restrict__ dest, long long n,
                              bool* __restrict__ dst) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  dst[dest[i]] = flags[i] ? valid[i] : false;
}

__device__ __forceinline__ long long clamp_index(int v, long long n_src) {
  long long k = v;
  if (k < 0) k = 0;
  if (k > n_src - 1) k = n_src - 1;
  return k;
}

template <typename E>
__global__ void gather_elems(const E* __restrict__ src,
                             const int* __restrict__ idx, long long n_out,
                             long long n_src, E* __restrict__ dst) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  dst[i] = src[clamp_index(idx[i], n_src)];
}

__global__ void gather_bytes(const uint8_t* __restrict__ src,
                             const int* __restrict__ idx, long long n_out,
                             long long n_src, int row_bytes,
                             uint8_t* __restrict__ dst) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const uint8_t* s = src + clamp_index(idx[i], n_src) * row_bytes;
  uint8_t* d = dst + i * (long long)row_bytes;
  for (int j = 0; j < row_bytes; ++j) d[j] = s[j];
}

__global__ void gather_valid(const bool* __restrict__ valid,
                             const int* __restrict__ idx,
                             const bool* __restrict__ mask, long long n_out,
                             long long n_src, bool* __restrict__ dst) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  bool v = valid[clamp_index(idx[i], n_src)];
  if (mask != nullptr) v = v && mask[i];
  dst[i] = v;
}

// order[dest[i]] = i: the stable argsort of ~keep as a row index array
__global__ void invert_dest(const int* __restrict__ dest, long long n,
                            int* __restrict__ order) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  order[dest[i]] = (int)i;
}

// K7: gather one side of a join; an index of -1 yields a null row whose
// data is row 0's (the reference clips the index), and slot_valid masks
// the slots past the output's row count
template <typename E>
__global__ void gather_side_elems(const E* __restrict__ src,
                                  const bool* __restrict__ valid,
                                  const int* __restrict__ lengths,
                                  const int* __restrict__ idx,
                                  const bool* __restrict__ slot_valid,
                                  long long n_out, long long n_src,
                                  E* __restrict__ dst,
                                  bool* __restrict__ dst_valid,
                                  int* __restrict__ dst_lengths) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int v = idx[i];
  const long long k = clamp_index(v, n_src);
  dst[i] = src[k];
  dst_valid[i] = valid[k] && v >= 0 && slot_valid[i];
  if (dst_lengths != nullptr) dst_lengths[i] = lengths[k];
}

__global__ void gather_side_bytes(const uint8_t* __restrict__ src,
                                  int row_bytes,
                                  const bool* __restrict__ valid,
                                  const int* __restrict__ lengths,
                                  const int* __restrict__ idx,
                                  const bool* __restrict__ slot_valid,
                                  long long n_out, long long n_src,
                                  uint8_t* __restrict__ dst,
                                  bool* __restrict__ dst_valid,
                                  int* __restrict__ dst_lengths) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int v = idx[i];
  const long long k = clamp_index(v, n_src);
  const uint8_t* s = src + k * row_bytes;
  uint8_t* d = dst + i * (long long)row_bytes;
  for (int j = 0; j < row_bytes; ++j) d[j] = s[j];
  dst_valid[i] = valid[k] && v >= 0 && slot_valid[i];
  if (dst_lengths != nullptr) dst_lengths[i] = lengths[k];
}

}  // namespace

// flags: scratch uint8[n]; tile_sums: scratch int32[ceil(n / 2048)];
// dest: int32[n]; count: int32 scalar (the new num_rows)
SRT_API int k4_compact_plan(const void* keep, const void* num_rows,
                            long long n, void* flags, void* tile_sums,
                            void* dest, void* count, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = srt::tiles_for(n);
  keep_flags<<<srt::blocks_for(n, BLOCK), BLOCK, 0, st>>>(
      (const bool*)keep, (const int*)num_rows, n, (uint8_t*)flags);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  srt::scan_tile_sums<<<ntiles, BLOCK, 0, st>>>((const uint8_t*)flags, n,
                                                (int*)tile_sums);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  srt::scan_tile_offsets<<<1, srt::scan_threads(ntiles), 0, st>>>((int*)tile_sums, ntiles,
                                             (int*)count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  destinations<<<ntiles, BLOCK, 0, st>>>((const uint8_t*)flags, n,
                                         (const int*)tile_sums,
                                         (const int*)count, (int*)dest);
  return (int)cudaGetLastError();
}

// rows of row_bytes bytes (1-D data: the element size; byte matrix: width)
SRT_API int k4_scatter_rows(const void* src, const void* dest, long long n,
                            int row_bytes, void* dst, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = srt::blocks_for(n, BLOCK);
  const int* d = (const int*)dest;
  switch (row_bytes) {
    case 1:
      scatter_elems<uint8_t><<<g, BLOCK, 0, st>>>((const uint8_t*)src, d, n,
                                                  (uint8_t*)dst);
      break;
    case 2:
      scatter_elems<uint16_t><<<g, BLOCK, 0, st>>>((const uint16_t*)src, d,
                                                   n, (uint16_t*)dst);
      break;
    case 4:
      scatter_elems<uint32_t><<<g, BLOCK, 0, st>>>((const uint32_t*)src, d,
                                                   n, (uint32_t*)dst);
      break;
    case 8:
      scatter_elems<unsigned long long><<<g, BLOCK, 0, st>>>(
          (const unsigned long long*)src, d, n, (unsigned long long*)dst);
      break;
    default:
      scatter_bytes<<<g, BLOCK, 0, st>>>((const uint8_t*)src, d, n,
                                         row_bytes, (uint8_t*)dst);
  }
  return (int)cudaGetLastError();
}

SRT_API int k4_scatter_valid(const void* valid, const void* flags,
                             const void* dest, long long n, void* dst,
                             void* stream) {
  scatter_valid<<<srt::blocks_for(n, BLOCK), BLOCK, 0,
                  (cudaStream_t)stream>>>((const bool*)valid,
                                          (const uint8_t*)flags,
                                          (const int*)dest, n, (bool*)dst);
  return (int)cudaGetLastError();
}

SRT_API int k4_gather_rows(const void* src, const void* idx, long long n_out,
                           long long n_src, int row_bytes, void* dst,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = srt::blocks_for(n_out, BLOCK);
  const int* ix = (const int*)idx;
  switch (row_bytes) {
    case 1:
      gather_elems<uint8_t><<<g, BLOCK, 0, st>>>((const uint8_t*)src, ix,
                                                 n_out, n_src, (uint8_t*)dst);
      break;
    case 2:
      gather_elems<uint16_t><<<g, BLOCK, 0, st>>>(
          (const uint16_t*)src, ix, n_out, n_src, (uint16_t*)dst);
      break;
    case 4:
      gather_elems<uint32_t><<<g, BLOCK, 0, st>>>(
          (const uint32_t*)src, ix, n_out, n_src, (uint32_t*)dst);
      break;
    case 8:
      gather_elems<unsigned long long><<<g, BLOCK, 0, st>>>(
          (const unsigned long long*)src, ix, n_out, n_src,
          (unsigned long long*)dst);
      break;
    default:
      gather_bytes<<<g, BLOCK, 0, st>>>((const uint8_t*)src, ix, n_out,
                                        n_src, row_bytes, (uint8_t*)dst);
  }
  return (int)cudaGetLastError();
}

// mask == NULL: no mask
SRT_API int k4_gather_valid(const void* valid, const void* idx,
                            const void* mask, long long n_out,
                            long long n_src, void* dst, void* stream) {
  gather_valid<<<srt::blocks_for(n_out, BLOCK), BLOCK, 0,
                 (cudaStream_t)stream>>>((const bool*)valid, (const int*)idx,
                                         (const bool*)mask, n_out, n_src,
                                         (bool*)dst);
  return (int)cudaGetLastError();
}

// k4_compact_plan, then order[dest[i]] = i: the stable argsort of ~keep
// (kept rows first) as int32 row indices, and the kept count
SRT_API int k4_compact_order(const void* keep, const void* num_rows,
                             long long n, void* flags, void* tile_sums,
                             void* dest, void* count, void* order,
                             void* stream) {
  int e = k4_compact_plan(keep, num_rows, n, flags, tile_sums, dest, count,
                          stream);
  if (e != 0) return e;
  invert_dest<<<srt::blocks_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)dest, n, (int*)order);
  return (int)cudaGetLastError();
}

// K7: one column of a join side gathered by idx (-1 = null row) and
// masked by slot_valid, data, validity and lengths (NULL for 1-D data) in
// one pass; row_bytes: the element size, or the byte matrix's width
SRT_API int k7_gather_side(const void* src, int row_bytes, const void* valid,
                           const void* lengths, const void* idx,
                           const void* slot_valid, long long n_out,
                           long long n_src, void* dst, void* dst_valid,
                           void* dst_lengths, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = srt::blocks_for(n_out, BLOCK);
  const bool* v = (const bool*)valid;
  const int* ln = (const int*)lengths;
  const int* ix = (const int*)idx;
  const bool* sv = (const bool*)slot_valid;
  bool* dv = (bool*)dst_valid;
  int* dl = (int*)dst_lengths;
  switch (row_bytes) {
    case 1:
      gather_side_elems<uint8_t><<<g, BLOCK, 0, st>>>(
          (const uint8_t*)src, v, ln, ix, sv, n_out, n_src, (uint8_t*)dst,
          dv, dl);
      break;
    case 2:
      gather_side_elems<uint16_t><<<g, BLOCK, 0, st>>>(
          (const uint16_t*)src, v, ln, ix, sv, n_out, n_src,
          (uint16_t*)dst, dv, dl);
      break;
    case 4:
      gather_side_elems<uint32_t><<<g, BLOCK, 0, st>>>(
          (const uint32_t*)src, v, ln, ix, sv, n_out, n_src,
          (uint32_t*)dst, dv, dl);
      break;
    case 8:
      gather_side_elems<unsigned long long><<<g, BLOCK, 0, st>>>(
          (const unsigned long long*)src, v, ln, ix, sv, n_out, n_src,
          (unsigned long long*)dst, dv, dl);
      break;
    default:
      gather_side_bytes<<<g, BLOCK, 0, st>>>(
          (const uint8_t*)src, row_bytes, v, ln, ix, sv, n_out, n_src,
          (uint8_t*)dst, dv, dl);
  }
  return (int)cudaGetLastError();
}
