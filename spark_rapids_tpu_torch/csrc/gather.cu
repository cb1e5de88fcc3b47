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
// Bound on this card: bytes.  A gather reads its indices once and every
// array's rows once, and writes every output once; compact reads the
// keep flags once for the scan and once more for the move.  For a
// 2,097,152-row Q1 reader batch (53 B a row) that is ~225 MB, about 67 us
// at 3.35 TB/s.
//
// Design: every array of a call moves in ONE launch.  The arrays travel
// as a descriptor table in the kernel parameters (a __grid_constant__
// struct of MOVE_COLS columns, ~2 KB, inside the 4 KB every CUDA version
// takes, so no copy to the card comes first): a column is its data (1-D
// data of any element size, or a byte matrix of any width), its validity
// and its lengths, each optional but the data.  The wrapper splits a
// wider call into as few launches as it needs.  A block loads its rows'
// indices (and their row mask) into shared memory once.  A column's rows
// are cut into units of 16, 8, 4, 2 or 1 bytes (the largest that divides
// the row width and both base addresses), and neighbouring threads read
// neighbouring units of a row and write neighbouring units of the
// output: a byte-matrix row is read and written contiguously by a group
// of threads (a warp a row where the row has 16 units or more), and
// writes are coalesced for every width (no thread loops over a row's
// bytes).  A thread loads several rows or units before it stores any.
//
//   * gather (k4_gather, K7's k7_gather): a block takes MOVE_ROWS output
//     rows of one column, the blocks in column order, so those that run
//     together share one column's reads in L2 (a random gather of 8-byte
//     elements reads 32-byte sectors); validity = valid[idx] && mask
//     (K4: the caller's mask and, after a compaction order, row < count;
//     K7: idx >= 0 and the slot mask, -1 being a null row);
//   * compaction (k4_compact_plan + k4_compact_move): two launches scan
//     the keep flags (tile sums, one block of tile offsets and the kept
//     count); then one launch moves every array: a block takes one scan
//     tile of SOURCE rows, turns its flags and its tile offset into each
//     row's destination in shared memory (kept rows to [0, count) in
//     order, dropped rows after them in order) and scatters the tile's
//     units there, so reads are contiguous and the kept rows' writes
//     land in contiguous runs.  No atomics: the destinations come from
//     the scan.  k4_compact_order writes the same destinations as an
//     order (order[dest[i]] = i) for callers that want the permutation.
//     Scatter against an order and a gather (4 launches): the scatter was
//     faster at Q1's reader batch and the export's 147-byte rows
//     (tools/k3_k4_split.py, PERF.md §6).
//
// K10's split (k10_split) — the exchange's partition write, and the grace
// join's bucket split (K25).
//
// Replaces spark_rapids_tpu/shuffle/device_shuffle.py:packed_slice (118)
// on the exchange's path, and with it packed_build's gather of the batch
// into a block (96), and the per-bucket compactions of
// spark_rapids_tpu/exec/joins.py:108 _bucket_side: from K10's stable
// order of a batch by destination partition (csrc/shuffle.cu) and the
// counts read back once, ONE launch writes every column of every
// non-empty partition straight from the batch: partition p's lane l
// carries row order[starts[p] + l] for l < counts[p] (data, validity,
// lengths) and is zero, invalid and of length 0 past it, at
// bucket_rows(counts[p]) lanes.  Bound: bytes; each real row is read once
// and written once with its order entry, each padding lane written once
// (shuffle/device_shuffle.py:split_bytes).  Design: the outputs of one
// column are the partitions' lanes end to end in one array, so the
// gather's MoveTable and its row movers (units of 16/8/4/2/1 bytes, a
// warp a row for wide rows, several rows in flight a thread) write them;
// a block takes MOVE_ROWS lanes of ONE partition of one column (the
// partition table, one row of SPLIT_WORDS a partition plus an end row,
// in the kernel parameters up to 32 partitions, else on the card; one
// thread finds the block's partition by a binary search over the first
// blocks and puts its row in shared memory), loads its
// rows' indices from the order once, moves the real rows and zeroes the
// rest.  No lane index is built on the host and no block of the batch
// is written first.
#include "common.cuh"

namespace {

using srt::BLOCK;
using srt::Bytes16;
using srt::ITEMS;
using srt::TILE;

constexpr int MOVE_COLS = 32;   // columns a launch (the wrapper's table)
constexpr int MOVE_ROWS = TILE;  // output rows a gather block
// blocks an SM keeps resident (at most 64 registers a thread), so enough
// reads are in flight
constexpr int MIN_BLOCKS = 4;

struct MoveCol {
  const uint8_t* src;
  const bool* valid;    // NULL: no validity (a bare array)
  const int* lengths;   // NULL for 1-D data
  uint8_t* dst;
  bool* dst_valid;
  int* dst_lengths;     // NULL for 1-D data
  long long n_src;
  int row_bytes;        // the element size, or the byte matrix's width
  int side;             // K7: 0 reads the left indices, 1 the right ones
};

struct MoveTable {
  int n;
  MoveCol col[MOVE_COLS];
};

__device__ __forceinline__ long long clamp_index(int v, long long n_src) {
  long long k = v;
  if (k < 0) k = 0;
  if (k > n_src - 1) k = n_src - 1;
  return k;
}

// the widest unit (16, 8, 4, 2 or 1 bytes) that divides the row width and
// both base addresses
__device__ __forceinline__ int unit_bytes(const MoveCol& d) {
  const unsigned long long a = (unsigned long long)(uintptr_t)d.src |
                               (unsigned long long)(uintptr_t)d.dst |
                               (unsigned long long)d.row_bytes;
  return (a & 15ull) == 0 ? 16 : (a & 7ull) == 0 ? 8 : (a & 3ull) == 0 ? 4
       : (a & 1ull) == 0 ? 2 : 1;
}

// A thread takes ROW_BATCH rows at a time and loads them all before it
// stores any, so that many independent (random) reads are in flight (K10's
// split takes SPLIT_BATCH: a block's 2,048 rows in one batch a thread).
constexpr int ROW_BATCH = 4;
constexpr int SPLIT_BATCH = 8;

// Rows of one column, rows r + k * BLOCK (k < BATCH) to thread r: with
// DATA their element (E: the row's one unit), their validity ANDed with
// the row's ok flag and their length.  Gather: output row base + r read
// from source row clamp(ix[r]).  Scatter: source row base + r written to
// row ix[r].
template <typename E, bool SCATTER, bool DATA, int BATCH = ROW_BATCH>
__device__ __forceinline__ void move_rows(const MoveCol& d, const int* ix,
                                          const bool* ok, int rows,
                                          long long base) {
  const E* src = (const E*)d.src;
  E* dst = (E*)d.dst;
  for (int r0 = threadIdx.x; r0 < rows; r0 += BATCH * BLOCK) {
    E v[BATCH];
    bool val[BATCH];
    int len[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int r = r0 + k * BLOCK;
      if (r >= rows) continue;
      const long long from = SCATTER ? base + r : clamp_index(ix[r], d.n_src);
      if (DATA) v[k] = src[from];
      if (d.valid != nullptr) val[k] = d.valid[from];
      if (d.lengths != nullptr) len[k] = d.lengths[from];
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int r = r0 + k * BLOCK;
      if (r >= rows) continue;
      const long long to = SCATTER ? (long long)ix[r] : base + r;
      if (DATA) dst[to] = v[k];
      if (d.valid != nullptr) d.dst_valid[to] = val[k] && ok[r];
      if (d.lengths != nullptr) d.dst_lengths[to] = len[k];
    }
  }
}

// rows of WARP_ROW_UNITS units or more go a warp a row
constexpr int WARP_ROW_UNITS = 16;

// The rows x units of a byte-matrix column (several units a row), so that
// neighbouring threads read neighbouring units of a row and write
// neighbouring units of the output.  Wide rows: a warp takes two rows at a
// time, its lanes on the rows' units (no division).  Narrow rows: the
// rows' units are one contiguous run, units q and q + BLOCK to thread q.
template <typename E, bool SCATTER>
__device__ __forceinline__ void move_units(const MoveCol& d, const int* ix,
                                           int rows, long long base) {
  const int u_row = d.row_bytes / (int)sizeof(E);
  const E* src = (const E*)d.src;
  E* dst = (E*)d.dst;
  if (u_row >= WARP_ROW_UNITS) {
    const int lane = threadIdx.x & 31;
    constexpr int WARPS = BLOCK / 32;
    for (int r0 = threadIdx.x >> 5; r0 < rows; r0 += 2 * WARPS) {
      const int r1 = r0 + WARPS < rows ? r0 + WARPS : r0;
      const E* s0 =
          src + (SCATTER ? base + r0 : clamp_index(ix[r0], d.n_src)) * u_row;
      const E* s1 =
          src + (SCATTER ? base + r1 : clamp_index(ix[r1], d.n_src)) * u_row;
      E* o0 = dst + (SCATTER ? (long long)ix[r0] : base + r0) * u_row;
      E* o1 = dst + (SCATTER ? (long long)ix[r1] : base + r1) * u_row;
      for (int c = lane; c < u_row; c += 32) {
        const E a = s0[c];
        const E b = s1[c];
        o0[c] = a;
        o1[c] = b;
      }
    }
    return;
  }
  const int units = rows * u_row;
  for (int q0 = threadIdx.x; q0 < units; q0 += 2 * BLOCK) {
    E v[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int q = q0 + k * BLOCK;
      if (q >= units) continue;
      const int r = q / u_row;
      v[k] = src[(SCATTER ? base + r : clamp_index(ix[r], d.n_src)) * u_row +
                 (q - r * u_row)];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int q = q0 + k * BLOCK;
      if (q >= units) continue;
      const int r = q / u_row;
      dst[(SCATTER ? (long long)ix[r] : base + r) * u_row + (q - r * u_row)] =
          v[k];
    }
  }
}

template <typename E, bool SCATTER, int BATCH>
__device__ __forceinline__ void move_by(const MoveCol& d, const int* ix,
                                        const bool* ok, int rows,
                                        long long base) {
  if (d.row_bytes == (int)sizeof(E)) {
    move_rows<E, SCATTER, true, BATCH>(d, ix, ok, rows, base);
    return;
  }
  move_units<E, SCATTER>(d, ix, rows, base);
  if (d.valid != nullptr || d.lengths != nullptr)
    move_rows<uint8_t, SCATTER, false, BATCH>(d, ix, ok, rows, base);
}

// one column of the block's rows, in units of the widest size (16, 8, 4,
// 2 or 1 bytes) that divides its row width and both base addresses
template <bool SCATTER, int BATCH = ROW_BATCH>
__device__ __forceinline__ void move_column(const MoveCol& d, const int* ix,
                                            const bool* ok, int rows,
                                            long long base) {
  switch (unit_bytes(d)) {
    case 16: move_by<Bytes16, SCATTER, BATCH>(d, ix, ok, rows, base); break;
    case 8:
      move_by<unsigned long long, SCATTER, BATCH>(d, ix, ok, rows, base);
      break;
    case 4: move_by<uint32_t, SCATTER, BATCH>(d, ix, ok, rows, base); break;
    case 2: move_by<uint16_t, SCATTER, BATCH>(d, ix, ok, rows, base); break;
    default: move_by<uint8_t, SCATTER, BATCH>(d, ix, ok, rows, base);
  }
}

// K4 and K7's gather: block b moves output rows [base, base + MOVE_ROWS)
// of column b / tiles, tile b % tiles, so the blocks that run together
// read one column (random reads hit L2 where the column fits it) and a
// block loads its rows' indices once.  A row's ok flag: the mask (NULL:
// true), row < *count (count NULL: no bound), and with neg_null
// idx >= 0 (K7's null rows).
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
    gather_cols(__grid_constant__ const MoveTable t,
                const int* __restrict__ lidx, const int* __restrict__ ridx,
                const bool* __restrict__ mask, const int* __restrict__ count,
                int neg_null, long long n_out) {
  __shared__ int s_idx[MOVE_ROWS];
  __shared__ bool s_ok[MOVE_ROWS];
  const long long tiles = (n_out + MOVE_ROWS - 1) / MOVE_ROWS;
  const MoveCol& d = t.col[blockIdx.x / tiles];
  const long long base = (long long)(blockIdx.x % tiles) * MOVE_ROWS;
  const long long left = n_out - base;
  const int rows = left < MOVE_ROWS ? (int)left : MOVE_ROWS;
  const long long bound = count == nullptr ? n_out : (long long)*count;
  const int* idx = d.side == 0 ? lidx : ridx;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int x = idx[base + r];
    s_idx[r] = x;
    s_ok[r] = (mask == nullptr || mask[base + r]) && base + r < bound &&
              (!neg_null || x >= 0);
  }
  __syncthreads();
  move_column<false>(d, s_idx, s_ok, rows, base);
}

// zero units [first, first + units) of dst, neighbouring threads on
// neighbouring units
template <typename E>
__device__ __forceinline__ void zero_units(uint8_t* dst, long long first,
                                           long long units) {
  const E z{};
  for (long long q = threadIdx.x; q < units; q += BLOCK)
    ((E*)dst)[first + q] = z;
}

// output rows [from, from + rows) of a column: data zero, validity false,
// length 0
__device__ __forceinline__ void zero_rows(const MoveCol& d, long long from,
                                          int rows) {
  if (rows <= 0) return;
  const int ub = unit_bytes(d);
  const long long u_row = d.row_bytes / ub;
  const long long first = from * u_row, units = rows * u_row;
  switch (ub) {
    case 16: zero_units<Bytes16>(d.dst, first, units); break;
    case 8: zero_units<unsigned long long>(d.dst, first, units); break;
    case 4: zero_units<uint32_t>(d.dst, first, units); break;
    case 2: zero_units<uint16_t>(d.dst, first, units); break;
    default: zero_units<uint8_t>(d.dst, first, units);
  }
  for (int r = threadIdx.x; r < rows; r += BLOCK) {
    if (d.dst_valid != nullptr) d.dst_valid[from + r] = false;
    if (d.dst_lengths != nullptr) d.dst_lengths[from + r] = 0;
  }
}

// K10's split: the partition table's words a partition (first block of
// the partition among a column's blocks, first output lane, start in the
// order, count); row nparts ends the table (a column's blocks, every
// partition's lanes).  Up to SPLIT_PARAM_PARTS partitions travel in the
// kernel parameters beside the MoveTable (~1 KB of the 4 KB), more in a
// table on the card.
constexpr int SPLIT_WORDS = 4;
constexpr int SPLIT_PARAM_PARTS = 32;

struct SplitParts {
  long long w[(SPLIT_PARAM_PARTS + 1) * SPLIT_WORDS];
};

// block b of column b / per_col: lanes [k * MOVE_ROWS, ...) of the
// partition whose blocks hold b % per_col (k its block within them)
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
    split_cols(__grid_constant__ const MoveTable t,
               __grid_constant__ const SplitParts pp,
               const int* __restrict__ order,
               const long long* __restrict__ parts_dev, int nparts,
               long long per_col) {
  const long long* parts = parts_dev != nullptr ? parts_dev : pp.w;
  __shared__ int s_idx[MOVE_ROWS];
  __shared__ bool s_ok[MOVE_ROWS];
  __shared__ long long s_part[2 * SPLIT_WORDS];
  const long long b = (long long)blockIdx.x % per_col;
  if (threadIdx.x == 0) {
    // the last partition whose first block is at or before b
    int lo = 0, hi = nparts - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (parts[(long long)mid * SPLIT_WORDS] <= b) lo = mid; else hi = mid - 1;
    }
    for (int w = 0; w < 2 * SPLIT_WORDS; ++w)
      s_part[w] = parts[(long long)lo * SPLIT_WORDS + w];
  }
  __syncthreads();
  const long long l0 = (b - s_part[0]) * MOVE_ROWS;  // lane in the partition
  const long long cap = s_part[SPLIT_WORDS + 1] - s_part[1];
  const int rows = cap - l0 < MOVE_ROWS ? (int)(cap - l0) : MOVE_ROWS;
  const long long left = s_part[3] - l0;
  const int real = left <= 0 ? 0 : (left < rows ? (int)left : rows);
  const long long from = s_part[2] + l0;
  for (int r = threadIdx.x; r < real; r += blockDim.x) {
    s_idx[r] = order[from + r];
    s_ok[r] = true;
  }
  __syncthreads();
  const MoveCol& d = t.col[blockIdx.x / per_col];
  const long long base = s_part[1] + l0;
  if (real > 0) move_column<false, SPLIT_BATCH>(d, s_idx, s_ok, real, base);
  zero_rows(d, base + real, rows - real);
}

// the tile's keep flags: keep[i] && i < num_rows
__device__ __forceinline__ void load_flags(const bool* keep, int num_rows,
                                           long long n, long long base,
                                           int* f) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    f[j] = (i < n && keep[i] && i < (long long)num_rows) ? 1 : 0;
  }
}

__global__ void keep_tile_sums(const bool* __restrict__ keep,
                               const int* __restrict__ num_rows, long long n,
                               int* __restrict__ sums) {
  int f[ITEMS];
  load_flags(keep, *num_rows, n,
             (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS,
             f);
  int total;
  srt::thread_prefix(f, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// each row's destination (kept rows to [0, count), dropped rows to
// [count, n), both in order) into dest[tile row], and its flag into ok
__device__ __forceinline__ void tile_destinations(
    const bool* keep, const int* num_rows, long long n,
    const int* tile_offsets, const int* count, int* dest, bool* ok) {
  const long long tile = (long long)blockIdx.x * TILE;
  const int r0 = threadIdx.x * ITEMS;
  int f[ITEMS];
  load_flags(keep, *num_rows, n, tile + r0, f);
  int tile_total;
  int kept_before = tile_offsets[blockIdx.x] + srt::thread_prefix(f, &tile_total);
  const int total = *count;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = tile + r0 + j;
    dest[r0 + j] = f[j] ? kept_before : total + (int)(i - kept_before);
    ok[r0 + j] = f[j] != 0;
    kept_before += f[j];
  }
}

// order[dest[i]] = i: the stable argsort of ~keep as row indices
__global__ void compact_order_rows(const bool* __restrict__ keep,
                                   const int* __restrict__ num_rows,
                                   long long n,
                                   const int* __restrict__ tile_offsets,
                                   const int* __restrict__ count,
                                   int* __restrict__ order) {
  __shared__ int s_dest[TILE];
  __shared__ bool s_ok[TILE];
  tile_destinations(keep, num_rows, n, tile_offsets, count, s_dest, s_ok);
  const long long tile = (long long)blockIdx.x * TILE;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int r = threadIdx.x * ITEMS + j;
    if (tile + r < n) order[s_dest[r]] = (int)(tile + r);
  }
}

// the compaction's move: one scan tile of source rows a block, every
// column of the table scattered to its rows' destinations
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
    compact_cols(__grid_constant__ const MoveTable t,
                 const bool* __restrict__ keep,
                 const int* __restrict__ num_rows, long long n,
                 const int* __restrict__ tile_offsets,
                 const int* __restrict__ count) {
  __shared__ int s_dest[TILE];
  __shared__ bool s_ok[TILE];
  tile_destinations(keep, num_rows, n, tile_offsets, count, s_dest, s_ok);
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE;
  const long long left = n - base;
  const int rows = left < TILE ? (int)left : TILE;
  for (int c = 0; c < t.n; ++c)
    move_column<true>(t.col[c], s_dest, s_ok, rows, base);
}

// rank[order[i]] = i: the inverse of a permutation
__global__ void invert_rows(const int* __restrict__ order, long long n,
                            int* __restrict__ rank) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rank[order[i]] = (int)i;
}

// The table from `words` (host memory), 8 int64 words a column: data,
// validity (0: none), lengths (0: 1-D data), output data, output validity,
// output lengths, the source's rows, and row_bytes | side << 32.
int load_table(const long long* words, int n_cols, int sides,
               MoveTable* t) {
  if (n_cols < 1 || n_cols > MOVE_COLS) return (int)cudaErrorInvalidValue;
  t->n = n_cols;
  for (int c = 0; c < n_cols; ++c) {
    const long long* w = words + 8 * c;
    MoveCol& d = t->col[c];
    d.src = (const uint8_t*)(uintptr_t)w[0];
    d.valid = (const bool*)(uintptr_t)w[1];
    d.lengths = (const int*)(uintptr_t)w[2];
    d.dst = (uint8_t*)(uintptr_t)w[3];
    d.dst_valid = (bool*)(uintptr_t)w[4];
    d.dst_lengths = (int*)(uintptr_t)w[5];
    d.n_src = w[6];
    d.row_bytes = (int)(w[7] & 0xffffffffll);
    d.side = (int)(w[7] >> 32);
    if (d.row_bytes < 1 || d.side < 0 || d.side >= sides ||
        (d.valid != nullptr) != (d.dst_valid != nullptr) ||
        (d.lengths != nullptr) != (d.dst_lengths != nullptr))
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// tile_sums: scratch int32[ceil(n / 2048)] (left holding each tile's
// offset); count: int32 scalar (the new num_rows).  Two launches.
SRT_API int k4_compact_plan(const void* keep, const void* num_rows,
                            long long n, void* tile_sums, void* count,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = srt::tiles_for(n);
  keep_tile_sums<<<ntiles, BLOCK, 0, st>>>((const bool*)keep,
                                           (const int*)num_rows, n,
                                           (int*)tile_sums);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  srt::scan_tile_offsets<<<1, srt::scan_threads(ntiles), 0, st>>>(
      (int*)tile_sums, ntiles, (int*)count);
  return (int)cudaGetLastError();
}

// after k4_compact_plan: every column of the table (8 words a column,
// see load_table; side 0) moved to its compacted rows in one launch
SRT_API int k4_compact_move(const long long* words, int n_cols,
                            const void* keep, const void* num_rows,
                            long long n, const void* tile_sums,
                            const void* count, void* stream) {
  MoveTable t;
  int e = load_table(words, n_cols, 1, &t);
  if (e != 0) return e;
  compact_cols<<<srt::tiles_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      t, (const bool*)keep, (const int*)num_rows, n,
      (const int*)tile_sums, (const int*)count);
  return (int)cudaGetLastError();
}

// k4_compact_plan, then order[dest[i]] = i: the stable argsort of ~keep
// (kept rows first) as int32 row indices, and the kept count.  Three
// launches.
SRT_API int k4_compact_order(const void* keep, const void* num_rows,
                             long long n, void* tile_sums, void* count,
                             void* order, void* stream) {
  int e = k4_compact_plan(keep, num_rows, n, tile_sums, count, stream);
  if (e != 0) return e;
  compact_order_rows<<<srt::tiles_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const bool*)keep, (const int*)num_rows, n, (const int*)tile_sums,
      (const int*)count, (int*)order);
  return (int)cudaGetLastError();
}

// K4: every column of the table (side 0) gathered by idx in one launch;
// validity ANDed with mask (NULL: none) and cleared from row *count on
// (count NULL: none)
SRT_API int k4_gather(const long long* words, int n_cols, const void* idx,
                      const void* mask, const void* count, long long n_out,
                      void* stream) {
  MoveTable t;
  int e = load_table(words, n_cols, 1, &t);
  if (e != 0) return e;
  gather_cols<<<(unsigned)(n_cols * srt::blocks_for(n_out, MOVE_ROWS)),
                BLOCK, 0, (cudaStream_t)stream>>>(t, (const int*)idx, nullptr,
                                        (const bool*)mask,
                                        (const int*)count, 0, n_out);
  return (int)cudaGetLastError();
}

SRT_API int k4_invert(const void* order, long long n, void* rank,
                      void* stream) {
  invert_rows<<<srt::blocks_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)order, n, (int*)rank);
  return (int)cudaGetLastError();
}

// K10's split: every column of the table (side 0; outputs of every
// partition's lanes end to end) written from the batch through order
// (int32, K10's build) in one launch; the partition table, int64[(nparts
// + 1) * SPLIT_WORDS] (see split_cols), in host memory (parts_host, at
// most SPLIT_PARAM_PARTS partitions: copied into the parameters) or on
// the card (parts_dev); per_col the blocks of one column
SRT_API int k10_split(const long long* words, int n_cols, const void* order,
                      const long long* parts_host, const void* parts_dev,
                      int nparts, long long per_col, void* stream) {
  MoveTable t;
  int e = load_table(words, n_cols, 1, &t);
  if (e != 0) return e;
  if (nparts < 1 || per_col < 1 || per_col * n_cols > 0x7fffffffll ||
      (parts_dev == nullptr &&
       (parts_host == nullptr || nparts > SPLIT_PARAM_PARTS)))
    return (int)cudaErrorInvalidValue;
  SplitParts pp;
  if (parts_dev == nullptr)
    for (int i = 0; i < (nparts + 1) * SPLIT_WORDS; ++i)
      pp.w[i] = parts_host[i];
  split_cols<<<(unsigned)(per_col * n_cols), BLOCK, 0,
               (cudaStream_t)stream>>>(t, pp, (const int*)order,
                                       (const long long*)parts_dev, nparts,
                                       per_col);
  return (int)cudaGetLastError();
}

// K7: n_cols columns of a join output gathered in one launch (the table
// as k4_gather's, side 0 reading lidx and 1 ridx; ridx may be NULL when
// no column reads it).  -1 = a null row; slots with slot_valid false are
// null.
SRT_API int k7_gather(const long long* words, int n_cols, const void* lidx,
                      const void* ridx, const void* slot_valid,
                      long long n_out, void* stream) {
  MoveTable t;
  int e = load_table(words, n_cols, ridx == nullptr ? 1 : 2, &t);
  if (e != 0) return e;
  gather_cols<<<(unsigned)(n_cols * srt::blocks_for(n_out, MOVE_ROWS)),
                BLOCK, 0, (cudaStream_t)stream>>>(t, (const int*)lidx,
                                        (const int*)ridx,
                                        (const bool*)slot_valid, nullptr, 1,
                                        n_out);
  return (int)cudaGetLastError();
}
