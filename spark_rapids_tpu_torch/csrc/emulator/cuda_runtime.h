// CPU emulation of the CUDA subset the kernels in csrc/ use, so their
// logic can run on a machine with no card: the test file
// tests/test_torch_kernels_emulated.py builds them with g++ against this
// header (the package's own build never includes it).  One std::thread
// per CUDA thread of a block, created once a launch; the blocks of a
// launch run one after another (every thread meets the others at a
// barrier after each block), so a function-local `static` stands in for
// __shared__ memory.  Warp intrinsics exchange
// values through a per-warp slot array between two warp barriers.  It
// checks logic only: timing, memory coalescing and races between blocks
// are not modelled.
#pragma once
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <barrier>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __constant__
#define __grid_constant__
#define __forceinline__ inline
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
#define __launch_bounds__(...)
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct SrtWarp {
  std::barrier<> bar;
  uint64_t slot[32];
  SrtWarp() : bar(32) {}
};
inline std::barrier<>* srt_block_barrier;
inline std::vector<SrtWarp*>* srt_warps;

inline void __syncthreads() { srt_block_barrier->arrive_and_wait(); }

template <class T>
T __shfl_up_sync(unsigned, T v, int o) {
  const int lane = threadIdx.x & 31;
  SrtWarp& w = *(*srt_warps)[threadIdx.x >> 5];
  uint64_t bits = 0;
  memcpy(&bits, &v, sizeof(T));
  w.slot[lane] = bits;
  w.bar.arrive_and_wait();
  T r = v;
  if (lane >= o) memcpy(&r, &w.slot[lane - o], sizeof(T));
  w.bar.arrive_and_wait();
  return r;
}

inline unsigned __match_any_sync(unsigned, int v) {
  const int lane = threadIdx.x & 31;
  SrtWarp& w = *(*srt_warps)[threadIdx.x >> 5];
  w.slot[lane] = (uint64_t)(int64_t)v;
  w.bar.arrive_and_wait();
  unsigned m = 0;
  for (int j = 0; j < 32; ++j)
    if (w.slot[j] == (uint64_t)(int64_t)v) m |= 1u << j;
  w.bar.arrive_and_wait();
  return m;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline int __clzll(long long x) {
  return x == 0 ? 64 : __builtin_clzll((unsigned long long)x);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline long long __double_as_longlong(double d) {
  long long i; memcpy(&i, &d, 8); return i;
}
inline double __longlong_as_double(long long i) {
  double d; memcpy(&d, &i, 8); return d;
}
// conversions rounding to nearest even (the host's default rounding mode)
inline float __int2float_rn(int i) { return (float)i; }
inline float __ll2float_rn(long long i) { return (float)i; }
inline float __double2float_rn(double d) { return (float)d; }

// `kernel<<<grid, block, smem, stream>>>(args)` is rewritten by the build
// into `srt_launch(srt_cfg(grid, block, smem, stream), kernel, args)`
struct SrtCfg { dim3 grid, block; };
inline SrtCfg srt_cfg(dim3 g, dim3 b, size_t = 0, cudaStream_t = 0) {
  return SrtCfg{g, b};
}

// The launch's blockDim.x threads are created once; each runs the blocks
// of the grid in order, and all of them meet at a barrier after every
// block, so the blocks still run one after another (shared memory, a
// function-local static, is never seen by two blocks at once).
template <class... KA, class... A>
void srt_launch(SrtCfg c, void (*kernel)(KA...), A... args) {
  gridDim = c.grid;
  blockDim = c.block;
  const int nt = (int)c.block.x;
  std::barrier<> bar(nt);
  std::barrier<> block_end(nt);
  srt_block_barrier = &bar;
  std::vector<SrtWarp*> warps;
  for (int w = 0; w < (nt + 31) / 32; ++w) warps.push_back(new SrtWarp());
  srt_warps = &warps;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t);
      for (unsigned by = 0; by < c.grid.y; ++by)
        for (unsigned bx = 0; bx < c.grid.x; ++bx) {
          blockIdx = dim3(bx, by);
          kernel(static_cast<KA>(args)...);
          block_end.arrive_and_wait();
        }
    });
  for (auto& th : threads) th.join();
  for (auto* w : warps) delete w;
}
