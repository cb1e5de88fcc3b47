// K23 — expand: all k projection batches of one input batch, one launch.
//
// Replaces spark_rapids_tpu/exec/basic.py:223 TpuExpandExec._mk_kernel
// (one jitted body per projection list in the reference; its plain twin
// is ops/kernels/generate.py:expand_plain).  Every output column of every
// projection is one op of K23_WORDS int64 words in a table on the device
// (ops/kernels/generate.py builds it):
//   0 data mode: 0 none (the data is shared with the source), 1 convert
//                the source to the output type (convert.cuh, as
//                Tensor.to: the widening cast of basic.py:229-231),
//                2 fill with literal bits
//   1 source dtype code   2 source data   3 source row stride (bytes)
//   4 source validity (0: use word 5)     5 literal validity (0 or 1)
//   6 output dtype code   7 output data   8 output validity
//   9 literal bits (the value already in the output type)
// Every op writes its validity, source validity (or the literal's) AND
// the row mask: a reference keeps its rows' nulls, a literal is valid on
// the logical rows, a null never.
//
// Bound on this card: bytes.  A rollup's references write a validity
// each and share their data; its grouping ids and typed nulls write
// data.  q67 at one partition (8 grouping sets x 9 columns over
// ~1,048,576 padded rows) writes ~0.15 GB: ~0.05 ms at 3.35 TB/s.
// Design: blockIdx.y is the op, so a block runs one branch; x strides
// over rows, coalesced reads and writes.
#include "convert.cuh"

namespace {

using srt::BLOCK;

constexpr int WORDS = 10;
constexpr unsigned MAX_BLOCKS = 4096;

__global__ void expand_kernel(const long long* __restrict__ tab,
                              long long p,
                              const int* __restrict__ num_rows) {
  const long long* d = tab + (long long)blockIdx.y * WORDS;
  const int mode = (int)d[0];
  const int sc = (int)d[1];
  const uint8_t* const src = (const uint8_t*)d[2];
  const long long sstride = d[3];
  const bool* const svalid = (const bool*)d[4];
  const bool lit_valid = d[5] != 0;
  const int dc = (int)d[6];
  uint8_t* const out = (uint8_t*)d[7];
  bool* const out_valid = (bool*)d[8];
  const long long bits = d[9];
  const int ob = srt::code_bytes(dc);
  const long long nrows = *num_rows;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < p; r += stride) {
    const bool rm = r < nrows;
    out_valid[r] = (svalid != nullptr ? svalid[r] : lit_valid) && rm;
    if (mode == 1) {
      srt::convert_value(src + r * sstride, sc, out + r * ob, dc);
    } else if (mode == 2) {
      srt::convert_value((const uint8_t*)&bits, dc, out + r * ob, dc);
    }
  }
}

}  // namespace

SRT_API int k23_expand(const long long* table, int n_ops, long long p,
                       const int* num_rows, void* stream) {
  if (n_ops < 1 || n_ops > 65535) return 1;
  long long blocks = (p + BLOCK - 1) / BLOCK;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const dim3 grid((unsigned)blocks, (unsigned)n_ops);
  expand_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(table, p,
                                                          num_rows);
  return (int)cudaGetLastError();
}
