// K11 — range partition ids from sampled bounds.
//
// Replaces spark_rapids_tpu/exec/exchange.py:range_pids_from_bounds (98):
// pid = the number of bounds a row exceeds lexicographically over the
// range key passes, passes[0] dominating.  The passes are int64 in
// "signed order" (the reference's order-preserving uint64 passes with
// the top bit flipped), so a signed compare orders them as the
// reference's unsigned compare does.  The count is monotone in the sort
// order for any bounds, so sample quality moves balance, never order.
//
// Bound on this card: bytes.  Each row reads its k 8-byte passes once
// and writes a 4-byte pid; for Q3's final sort (k = 4 passes: null rank
// and value of revenue, then of o_orderdate) over a 16,384-row partition
// batch that is ~0.6 MB, well under a microsecond at 3.35 TB/s, so the
// launch sets the time.  Design: the bounds (int64[k][n_out - 1], tiny)
// go to shared memory once per block (read from global memory where
// they do not fit); one thread per row walks the bounds, comparing pass
// by pass until the first difference.  The passes are pass-major
// [k][padded], so the threads of a warp read neighbouring addresses.
#include "common.cuh"

namespace {

constexpr int MAX_SHARED_BOUNDS = 4096;  // 32 KB of int64

__global__ void range_pids(const long long* __restrict__ passes, int k,
                           long long n, const long long* __restrict__ bounds,
                           int nb, int* __restrict__ pids) {
  __shared__ long long s_bounds[MAX_SHARED_BOUNDS];
  const long long* bd = bounds;
  if (k * nb <= MAX_SHARED_BOUNDS) {
    for (int j = threadIdx.x; j < k * nb; j += blockDim.x)
      s_bounds[j] = bounds[j];
    __syncthreads();
    bd = s_bounds;
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int pid = 0;
  for (int b = 0; b < nb; ++b) {
    // row > bound b: the first pass that differs decides
    for (int j = 0; j < k; ++j) {
      const long long p = passes[(long long)j * n + i];
      const long long q = bd[(long long)j * nb + b];
      if (p != q) {
        if (p > q) ++pid;
        break;
      }
    }
  }
  pids[i] = pid;
}

}  // namespace

// passes: int64[k][n]; bounds: int64[k][nb] (nb = n_out - 1 >= 1);
// pids: int32[n]
SRT_API int k11_range_pids(const void* passes, int k, long long n,
                           const void* bounds, int nb, void* pids,
                           void* stream) {
  if (k < 1 || nb < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  range_pids<<<srt::blocks_for(n, srt::BLOCK), srt::BLOCK, 0,
               (cudaStream_t)stream>>>((const long long*)passes, k, n,
                                       (const long long*)bounds, nb,
                                       (int*)pids);
  return (int)cudaGetLastError();
}
