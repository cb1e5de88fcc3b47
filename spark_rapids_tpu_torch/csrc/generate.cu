// K22 — explode: every input row k times, its k elements interleaved.
//
// Replaces spark_rapids_tpu/exec/generate.py:47 TpuGenerateExec._compute
// (the reference's statically shaped explode; its plain twin is
// ops/kernels/generate.py:explode_plain).  p padded input rows become
// p * k output rows; input row s owns output rows s * k .. s * k + k - 1.
// Each output column is one descriptor of K22_WORDS int64 words in a
// table on the device (ops/kernels/generate.py builds it):
//   0 kind: 0 pass-through fixed, 1 pass-through string, 2 pos,
//           3 element fixed, 4 element string
//   1 source dtype code   2 source data   3 source validity
//   4 source lengths      5 source row stride (bytes; 0 = one row
//                           broadcast)   6 source row width (bytes)
//   7 source length stride (0 or 1)      8 output dtype code
//   9 output data   10 output validity   11 output lengths
//   12 output row width (bytes)
// The element columns' sources (words 1-7) follow the output entries,
// one descriptor per element j.  A pass-through column's validity is
// validity & row_mask, the pos column's the row mask; an element's its
// own validity & row_mask, its value converted to the output type
// (convert.cuh, as Tensor.to), a string element's bytes copied up to its
// width and zero-padded to the widest element's.
//
// Bound on this card: bytes.  The unpivot of store_sales (2,097,152
// padded rows, four 8-byte pass-through columns, three float64
// elements, k = 3) reads ~80 MB and writes ~370 MB: ~0.13 ms at
// 3.35 TB/s.  Design: blockIdx.y is the output column, so every thread
// of a block runs the same branch; x strides over input rows, one thread
// per input row reading it once and writing its k output rows (no
// division by k); the k element descriptors sit in shared memory.
#include "convert.cuh"

namespace {

using srt::BLOCK;

constexpr int WORDS = 13;
constexpr int MAX_K = 64;
constexpr unsigned MAX_BLOCKS = 16384;

// the output row of input row s's element j: row-major, a row's k
// elements consecutive
__device__ __forceinline__ long long out_row(long long s, int j, int k) {
  return s * k + j;
}

__global__ void explode_kernel(const long long* __restrict__ tab,
                               int n_entries, int k, long long p,
                               const int* __restrict__ num_rows) {
  __shared__ long long elem[MAX_K][WORDS];
  const long long* d = tab + (long long)blockIdx.y * WORDS;
  const int kind = (int)d[0];
  if (kind >= 3) {
    for (int i = threadIdx.x; i < k * WORDS; i += blockDim.x)
      elem[i / WORDS][i % WORDS] = tab[(long long)n_entries * WORDS + i];
    __syncthreads();
  }
  const long long nrows = *num_rows;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int dc = (int)d[8];
  uint8_t* const out = (uint8_t*)d[9];
  bool* const out_valid = (bool*)d[10];
  int* const out_len = (int*)d[11];
  const long long ow = d[12];
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       s < p; s += stride) {
    const bool rm = s < nrows;
    if (kind == 2) {  // pos
      for (int j = 0; j < k; ++j) {
        const long long o = out_row(s, j, k);
        ((int32_t*)out)[o] = j;
        out_valid[o] = rm;
      }
    } else if (kind < 2) {  // a pass-through column: read once, k writes
      const bool v = ((const bool*)d[3])[s] && rm;
      const uint8_t* sdata = (const uint8_t*)d[2] + s * d[5];
      if (kind == 1) {
        const long long sw = d[6];
        const int ln = ((const int*)d[4])[s * d[7]];
        for (int j = 0; j < k; ++j) {
          const long long o = out_row(s, j, k);
          uint8_t* dst = out + o * ow;
          for (long long q = 0; q < ow; ++q) dst[q] = q < sw ? sdata[q] : 0;
          out_len[o] = ln;
          out_valid[o] = v;
        }
      } else {
        for (int j = 0; j < k; ++j) {
          const long long o = out_row(s, j, k);
          srt::convert_value(sdata, (int)d[1], out + o * ow, dc);
          out_valid[o] = v;
        }
      }
    } else {  // the elements, element j at out_row(s, j)
      for (int j = 0; j < k; ++j) {
        const long long o = out_row(s, j, k);
        const long long* e = elem[j];
        const uint8_t* sdata = (const uint8_t*)e[2] + s * e[5];
        out_valid[o] = ((const bool*)e[3])[s] && rm;
        if (kind == 4) {
          const long long sw = e[6];
          uint8_t* dst = out + o * ow;
          for (long long q = 0; q < ow; ++q) dst[q] = q < sw ? sdata[q] : 0;
          out_len[o] = ((const int*)e[4])[s * e[7]];
        } else {
          srt::convert_value(sdata, (int)e[1], out + o * ow, dc);
        }
      }
    }
  }
}

}  // namespace

// table: n_entries output descriptors, then k element descriptors
SRT_API int k22_explode(const long long* table, int n_entries, int k,
                        long long p, const int* num_rows, void* stream) {
  if (n_entries < 1 || n_entries > 65535 || k < 1 || k > MAX_K) return 1;
  long long blocks = (p + BLOCK - 1) / BLOCK;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const dim3 grid((unsigned)blocks, (unsigned)n_entries);
  explode_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      table, n_entries, k, p, num_rows);
  return (int)cudaGetLastError();
}
