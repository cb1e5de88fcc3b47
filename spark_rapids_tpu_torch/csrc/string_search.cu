// K13 — string search over byte matrices: contains, startswith, endswith
// and locate_from with a literal needle.
//
// Replaces spark_rapids_tpu/ops/kernels/stringkernels.py:_find (134),
// contains (156), startswith (160), endswith (174) and locate_from (190),
// the kernels ops/stringexprs.py's Contains/StartsWith/EndsWith and Like
// (473-500) lower onto.  The row functions are strings.cuh's, shared with
// K8 and the generated K12 segments.  A row is (uint8[n, w] bytes, int32
// lengths); bytes at or past the length never match, an empty needle
// matches, a needle wider than w never matches, and locate_from is
// 1-based with 0 when absent, searching from a per-row 0-based start.
// Mode LOCATE is stringkernels.py:locate (204), which StringLocate runs:
// locate_from with one start for every row (start[0]).
//
// Bound on this card: bytes.  For Q13's o_comment (1,500,000 rows of a
// ~63-byte matrix) contains must read each row once and write one byte:
// ~101 MB, ~30 us at 3.35 TB/s.  Design: the needle travels in the kernel
// parameters (a __grid_constant__ struct of up to 1,024 bytes) and each
// block copies it to shared memory; one thread per row scans its own row.
// A thread's reads walk its row, so neighbouring threads read addresses
// w bytes apart: the loads are strided, not coalesced (one 32-byte sector
// a row, reused through L1 while the thread scans).  A warp-per-row or
// tiled layout is left for a later PR.
#include <string.h>

#include "strings.cuh"

namespace {

using srt::BLOCK;

constexpr int NEEDLE_MAX = 1024;

struct Needle {
  int k;
  uint8_t b[NEEDLE_MAX];
};

enum Mode {
  CONTAINS = 0, STARTSWITH = 1, ENDSWITH = 2, LOCATE_FROM = 3, LOCATE = 4
};

__global__ void search_rows(const uint8_t* __restrict__ bm,
                            const int* __restrict__ lengths, int w,
                            long long n, __grid_constant__ const Needle nd,
                            int mode, const int* __restrict__ start,
                            void* __restrict__ out) {
  __shared__ uint8_t s_nd[NEEDLE_MAX];
  for (int j = threadIdx.x; j < nd.k; j += blockDim.x) s_nd[j] = nd.b[j];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* row = bm + i * (long long)w;
  const int len = lengths[i];
  switch (mode) {
    case CONTAINS:
      ((bool*)out)[i] = srt::str_contains(row, w, len, s_nd, nd.k);
      break;
    case STARTSWITH:
      ((bool*)out)[i] = srt::str_startswith(row, w, len, s_nd, nd.k);
      break;
    case ENDSWITH:
      ((bool*)out)[i] = srt::str_endswith(row, w, len, s_nd, nd.k);
      break;
    default:
      ((int*)out)[i] = srt::str_locate_from(row, w, len, s_nd, nd.k,
                                            start[mode == LOCATE ? 0 : i]);
  }
}

}  // namespace

// mode: 0 contains, 1 startswith, 2 endswith (bool out), 3 locate_from
// (int32 out; start: int32[n] 0-based offsets, else NULL), 4 locate
// (int32 out; start: int32[1], one 0-based offset for every row); the
// needle is k bytes of host memory, copied into the launch's parameters
SRT_API int k13_search(const void* bm, const void* lengths, int w,
                       long long n, const void* needle, int k, int mode,
                       const void* start, void* out, void* stream) {
  if (k < 0 || k > NEEDLE_MAX || mode < CONTAINS || mode > LOCATE ||
      (mode >= LOCATE_FROM && start == nullptr))
    return (int)cudaErrorInvalidValue;
  Needle nd;
  nd.k = k;
  if (k > 0) memcpy(nd.b, needle, (size_t)k);
  search_rows<<<srt::blocks_for(n, BLOCK), BLOCK, 0,
                (cudaStream_t)stream>>>(
      (const uint8_t*)bm, (const int*)lengths, w, n, nd, mode,
      (const int*)start, out);
  return (int)cudaGetLastError();
}
