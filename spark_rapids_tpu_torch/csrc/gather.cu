// K4 — stream compaction and gather; K7 — a join output's side gather.
//
// Replaces spark_rapids_tpu/ops/kernels/gather.py:compact (33),
// gather_column (16) and gather_batch (27), and (K7, k7_gather)
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
// K7 gathers a join output's columns, both sides' in one launch, by the
// output slots' row indices, where -1 gives a null row: validity =
// valid[idx] && idx >= 0 && slot_valid.  At Q3's second join (32,768
// slots, 9 columns of 4-8 B) it reads two indices and the slot mask a
// slot and a row of each column, and writes the row, its validity and
// (strings) its length: ~10 B a slot a column, well under a microsecond
// at 3.35 TB/s, so launches and the host set its time.  Design: the
// columns travel as a descriptor table in the kernel parameters (a
// __grid_constant__ struct, K7_COLS columns and ~2 KB, inside the 4 KB
// every CUDA version takes, so no copy to the card comes first); the
// wrapper splits a wider join into as few launches as it needs.  A block
// takes K7_SLOTS slots, loads their left and right indices and slot mask
// into shared memory once and walks the columns; a column's rows are cut
// into units of 16, 8, 4, 2 or 1 bytes (the largest that divides the row
// width and both base addresses), and the block's threads take the
// tile's units in order, so neighbouring threads read neighbouring units
// of a row and write neighbouring units of the output: a byte-matrix
// row is read and written contiguously by a group of threads, and writes
// are coalesced for every width.  One launch a join output, against one
// a column before.
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

// K7: a join output's columns, described by a table in the kernel
// parameters; side 0 reads the left indices, side 1 the right ones
constexpr int K7_COLS = 32;    // columns a launch (the wrapper's table)
constexpr int K7_SLOTS = 512;  // output slots a block

struct K7Col {
  const uint8_t* src;
  const bool* valid;
  const int* lengths;  // NULL for 1-D data
  uint8_t* dst;
  bool* dst_valid;
  int* dst_lengths;    // NULL for 1-D data
  long long n_src;
  int row_bytes;       // the element size, or the byte matrix's width
  int side;
};

struct K7Table {
  int n;
  K7Col col[K7_COLS];
};

struct alignas(16) Bytes16 {
  unsigned long long lo, hi;
};

// the widest unit (16, 8, 4, 2 or 1 bytes) that divides the row width and
// both base addresses
__device__ __forceinline__ int unit_bytes(const K7Col& d) {
  const unsigned long long a = (unsigned long long)(uintptr_t)d.src |
                               (unsigned long long)(uintptr_t)d.dst |
                               (unsigned long long)d.row_bytes;
  return (a & 15ull) == 0 ? 16 : (a & 7ull) == 0 ? 8 : (a & 3ull) == 0 ? 4
       : (a & 1ull) == 0 ? 2 : 1;
}

// the tile's rows x units of one column, unit q to thread q % BLOCK: the
// output tile is one contiguous run of units
template <typename E>
__device__ __forceinline__ void copy_units(const K7Col& d, const int* ix,
                                           int rows, long long base) {
  const int u_row = d.row_bytes / (int)sizeof(E);
  const E* src = (const E*)d.src;
  E* dst = (E*)d.dst + base * u_row;
  const int units = rows * u_row;
  if (u_row == 1) {
    for (int q = threadIdx.x; q < units; q += blockDim.x)
      dst[q] = src[clamp_index(ix[q], d.n_src)];
    return;
  }
  for (int q = threadIdx.x; q < units; q += blockDim.x) {
    const int r = q / u_row;
    dst[q] = src[clamp_index(ix[r], d.n_src) * u_row + (q - r * u_row)];
  }
}

__global__ void __launch_bounds__(BLOCK)
    gather_pair(__grid_constant__ const K7Table t,
                const int* __restrict__ lidx, const int* __restrict__ ridx,
                const bool* __restrict__ slot_valid, long long n_out) {
  __shared__ int s_idx[2][K7_SLOTS];
  __shared__ bool s_ok[2][K7_SLOTS];
  const long long base = (long long)blockIdx.x * K7_SLOTS;
  const long long left = n_out - base;
  const int rows = left < K7_SLOTS ? (left > 0 ? (int)left : 0) : K7_SLOTS;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const bool sv = slot_valid[base + r];
    const int l = lidx[base + r];
    s_idx[0][r] = l;
    s_ok[0][r] = sv && l >= 0;
    if (ridx != nullptr) {
      const int x = ridx[base + r];
      s_idx[1][r] = x;
      s_ok[1][r] = sv && x >= 0;
    }
  }
  __syncthreads();
  for (int c = 0; c < t.n; ++c) {
    const K7Col& d = t.col[c];
    const int* ix = s_idx[d.side];
    const bool* ok = s_ok[d.side];
    switch (unit_bytes(d)) {
      case 16: copy_units<Bytes16>(d, ix, rows, base); break;
      case 8: copy_units<unsigned long long>(d, ix, rows, base); break;
      case 4: copy_units<uint32_t>(d, ix, rows, base); break;
      case 2: copy_units<uint16_t>(d, ix, rows, base); break;
      default: copy_units<uint8_t>(d, ix, rows, base);
    }
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const long long k = clamp_index(ix[r], d.n_src);
      d.dst_valid[base + r] = d.valid[k] && ok[r];
      if (d.dst_lengths != nullptr) d.dst_lengths[base + r] = d.lengths[k];
    }
  }
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

// K7: n_cols columns of a join output gathered in one launch.  `words`
// (host memory) holds 8 int64 words a column: source, validity, lengths
// (0: 1-D data), output data, output validity, output lengths (0), the
// source's rows, and row_bytes | side << 32 (side 0 reads lidx, 1 ridx;
// ridx may be NULL when no column reads it).  -1 = a null row; slots
// with slot_valid false are null.
SRT_API int k7_gather(const long long* words, int n_cols, const void* lidx,
                      const void* ridx, const void* slot_valid,
                      long long n_out, void* stream) {
  if (n_cols < 1 || n_cols > K7_COLS) return (int)cudaErrorInvalidValue;
  K7Table t;
  t.n = n_cols;
  for (int c = 0; c < n_cols; ++c) {
    const long long* w = words + 8 * c;
    K7Col& d = t.col[c];
    d.src = (const uint8_t*)(uintptr_t)w[0];
    d.valid = (const bool*)(uintptr_t)w[1];
    d.lengths = (const int*)(uintptr_t)w[2];
    d.dst = (uint8_t*)(uintptr_t)w[3];
    d.dst_valid = (bool*)(uintptr_t)w[4];
    d.dst_lengths = (int*)(uintptr_t)w[5];
    d.n_src = w[6];
    d.row_bytes = (int)(w[7] & 0xffffffffll);
    d.side = (int)(w[7] >> 32);
    if (d.row_bytes < 1 || d.side < 0 || d.side > 1 ||
        (d.side == 1 && ridx == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  gather_pair<<<srt::blocks_for(n_out, K7_SLOTS), BLOCK, 0,
                (cudaStream_t)stream>>>(t, (const int*)lidx,
                                        (const int*)ridx,
                                        (const bool*)slot_valid, n_out);
  return (int)cudaGetLastError();
}
