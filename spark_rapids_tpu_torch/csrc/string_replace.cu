// K21 — replace every occurrence of one search byte in byte matrices.
//
// Replaces spark_rapids_tpu/ops/kernels/stringkernels.py:replace_single
// (250), which ops/stringexprs.py's StringReplace runs when its search
// string is one byte (a single byte cannot overlap itself, so every match
// is one of str.replace's).  Each row of (uint8[n, w] bytes, int32
// lengths) becomes a row of out_w = max(w * max(k, 1), 1) bytes: the
// bytes below the length in order, each search byte replaced by the k
// bytes of the replacement (k = 0 deletes it), then zeros; the new length
// is len + (k - 1) * matches.  The row loop is strings.cuh's str_replace,
// which K12 inlines, writing into a scratch row, when a StringReplace
// sits in a fused segment.
//
// Bound on this card: bytes.  A row reads its w bytes and length and
// writes out_w bytes and a length: for orders' comment (1,500,000 rows
// padded to 2,097,152, ~100 bytes, k = 1) ~0.42 GB, ~0.13 ms at
// 3.35 TB/s; for customer's phone (150,000 rows padded to 262,144, 15
// bytes, k = 0) ~10 MB, a few microseconds, below a launch.  Design: one
// thread a row with a running output offset (an output byte's position
// depends on the matches before it in the row, so a thread a byte would
// need a scan of its row); the reads and writes walk the row, strided
// across threads, as K13's reads do.  The replacement travels in the
// launch parameters (at most REPL_MAX bytes) and each block copies it to
// shared memory.
#include <string.h>

#include "strings.cuh"

namespace {

using srt::BLOCK;

constexpr int REPL_MAX = 1024;
constexpr unsigned MAX_BLOCKS = 65535;

struct Repl {
  int k;
  uint8_t b[REPL_MAX];
};

__global__ void replace_rows(const uint8_t* __restrict__ bm,
                             const int* __restrict__ lengths, int w,
                             long long n, int search,
                             __grid_constant__ const Repl rp, int out_w,
                             uint8_t* __restrict__ out,
                             int* __restrict__ out_len) {
  __shared__ uint8_t s_rp[REPL_MAX];
  for (int j = threadIdx.x; j < rp.k; j += blockDim.x) s_rp[j] = rp.b[j];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride)
    out_len[row] = srt::str_replace(bm + row * (long long)w, w,
                                    lengths[row], search, s_rp, rp.k,
                                    out + row * (long long)out_w, out_w);
}

}  // namespace

// search: the byte to replace (0..255); repl: k bytes of host memory,
// copied into the launch's parameters; out uint8[n, out_w], out_len
// int32[n]
SRT_API int k21_replace(const void* bm, const void* lengths, int w,
                        long long n, int search, const void* repl, int k,
                        int out_w, void* out, void* out_len, void* stream) {
  if (w < 1 || out_w < 1 || k < 0 || k > REPL_MAX || search < 0 ||
      search > 255)
    return (int)cudaErrorInvalidValue;
  Repl rp;
  rp.k = k;
  if (k > 0) memcpy(rp.b, repl, (size_t)k);
  long long blocks = (n + BLOCK - 1) / BLOCK;
  blocks = blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks);
  replace_rows<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bm, (const int*)lengths, w, n, search, rp, out_w,
      (uint8_t*)out, (int*)out_len);
  return (int)cudaGetLastError();
}
