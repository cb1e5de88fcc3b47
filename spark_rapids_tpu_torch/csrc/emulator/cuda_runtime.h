// CPU emulation of the CUDA subset the kernels in csrc/ use, so their
// logic can run on a machine with no card: the test file
// tests/test_torch_kernels_emulated.py builds them with g++ against this
// header (the package's own build never includes it).  A block's CUDA
// threads are cooperative fibers on the calling OS thread (x86-64 only:
// a six-register context switch and a stack of their own each); a fiber
// runs until it meets a barrier (__syncthreads, or a warp intrinsic's
// exchange), then the next one runs, and a barrier opens when its last
// thread arrives.  The blocks of a launch run one after another, so a
// function-local `static` stands in for __shared__ memory.  Warp
// intrinsics exchange values through a per-warp slot array between two
// warp barriers.  It checks logic only: timing, memory coalescing and
// races between blocks are not modelled, and the threads of a block run
// in a fixed order between barriers.  Since blocks run in index order, a
// decoupled look-back (common.cuh) always finds its predecessors'
// status words set; its wait aborts where one is not (SRT_EMULATED).
#pragma once
#define SRT_EMULATED 1
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <stdio.h>
#include <stdlib.h>

#include <functional>
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
// the vector types a kernel loads and stores as one access
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
#define __launch_bounds__(...)
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// ---- fibers --------------------------------------------------------------
// srt_fiber_switch(save, to): pushes the callee-saved registers, stores the
// stack pointer in *save, loads `to` and pops the registers saved there.
extern "C" void srt_fiber_switch(void** save, void* to);
asm(R"(
  .text
  .globl srt_fiber_switch
  .hidden srt_fiber_switch
  .type srt_fiber_switch, @function
srt_fiber_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size srt_fiber_switch, .-srt_fiber_switch
)");

constexpr size_t SRT_FIBER_STACK = 256 * 1024;

struct SrtFiber {
  void* sp = nullptr;
  char* stack = nullptr;
  bool done = true;
};

// one launch's scheduler state (launches run one at a time).  `static`:
// each library keeps its own (an `inline` variable with a destructor would
// be one object shared by every library loaded, destroyed by each)
static void* srt_sched_sp;
static std::vector<SrtFiber> srt_fibers;
static int srt_current;
static std::function<void()> srt_body;
// barrier arrivals and fibers finished: a pass over the fibers that adds
// none means every unfinished one waits on a barrier that cannot open
static unsigned long long srt_progress;

static inline void srt_yield() { srt_fiber_switch(&srt_fibers[srt_current].sp,
                                           srt_sched_sp); }

[[noreturn]] static void srt_fiber_entry() {
  srt_body();
  srt_fibers[srt_current].done = true;
  ++srt_progress;
  srt_fiber_switch(&srt_fibers[srt_current].sp, srt_sched_sp);
  abort();  // a finished fiber is never resumed
}

// a barrier of `expected` fibers: the last to arrive goes on, the others
// yield until it has opened the barrier
struct SrtBarrier {
  int expected = 0, count = 0;
  unsigned gen = 0;
  void arrive_and_wait() {
    const unsigned g = gen;
    ++srt_progress;
    if (++count == expected) {
      count = 0;
      ++gen;
      return;
    }
    while (gen == g) srt_yield();
  }
};

struct SrtWarp {
  SrtBarrier bar;
  uint64_t slot[32];
};
static SrtBarrier srt_block_barrier;
static std::vector<SrtWarp> srt_warps;

inline void __syncthreads() { srt_block_barrier.arrive_and_wait(); }

template <class T>
T __shfl_up_sync(unsigned, T v, int o) {
  const int lane = threadIdx.x & 31;
  SrtWarp& w = srt_warps[threadIdx.x >> 5];
  uint64_t bits = 0;
  memcpy(&bits, &v, sizeof(T));
  w.slot[lane] = bits;
  w.bar.arrive_and_wait();
  T r = v;
  if (lane >= o) memcpy(&r, &w.slot[lane - o], sizeof(T));
  w.bar.arrive_and_wait();
  return r;
}

template <class T>
T __shfl_sync(unsigned, T v, int src) {
  const int lane = threadIdx.x & 31;
  SrtWarp& w = srt_warps[threadIdx.x >> 5];
  uint64_t bits = 0;
  memcpy(&bits, &v, sizeof(T));
  w.slot[lane] = bits;
  w.bar.arrive_and_wait();
  T r;
  memcpy(&r, &w.slot[src & 31], sizeof(T));
  w.bar.arrive_and_wait();
  return r;
}

template <class T>
T __shfl_xor_sync(unsigned, T v, int o) {
  const int lane = threadIdx.x & 31;
  SrtWarp& w = srt_warps[threadIdx.x >> 5];
  uint64_t bits = 0;
  memcpy(&bits, &v, sizeof(T));
  w.slot[lane] = bits;
  w.bar.arrive_and_wait();
  T r;
  memcpy(&r, &w.slot[lane ^ o], sizeof(T));
  w.bar.arrive_and_wait();
  return r;
}

inline unsigned __match_any_sync(unsigned, int v) {
  const int lane = threadIdx.x & 31;
  SrtWarp& w = srt_warps[threadIdx.x >> 5];
  w.slot[lane] = (uint64_t)(int64_t)v;
  w.bar.arrive_and_wait();
  unsigned m = 0;
  for (int j = 0; j < 32; ++j)
    if (w.slot[j] == (uint64_t)(int64_t)v) m |= 1u << j;
  w.bar.arrive_and_wait();
  return m;
}

inline unsigned __ballot_sync(unsigned, int pred) {
  const int lane = threadIdx.x & 31;
  SrtWarp& w = srt_warps[threadIdx.x >> 5];
  w.slot[lane] = pred ? 1u : 0u;
  w.bar.arrive_and_wait();
  unsigned m = 0;
  for (int j = 0; j < w.bar.expected; ++j)
    if (w.slot[j]) m |= 1u << j;
  w.bar.arrive_and_wait();
  return m;
}

inline void __syncwarp(unsigned = 0xffffffffu) {
  srt_warps[threadIdx.x >> 5].bar.arrive_and_wait();
}
// fibers of one OS thread: every store is seen by the next load
inline void __threadfence() {}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline int __clzll(long long x) {
  return x == 0 ? 64 : __builtin_clzll((unsigned long long)x);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicOr(unsigned long long* p,
                                   unsigned long long v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicAnd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_and(p, v, __ATOMIC_SEQ_CST);
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

// Each block starts one fiber a CUDA thread, then resumes the unfinished
// fibers in thread order, each until it yields at a barrier or returns,
// until all have returned.  A pass in which no fiber arrived at a barrier
// or returned means the unfinished ones wait on barriers that can never
// open (a barrier some threads skipped): the emulator aborts.
template <class... KA, class... A>
void srt_launch(SrtCfg c, void (*kernel)(KA...), A... args) {
  gridDim = c.grid;
  blockDim = c.block;
  const int nt = (int)c.block.x;
  if ((int)srt_fibers.size() < nt) srt_fibers.resize(nt);
  for (int t = 0; t < nt; ++t)
    if (srt_fibers[t].stack == nullptr) {
      srt_fibers[t].stack = (char*)malloc(SRT_FIBER_STACK);
      if (srt_fibers[t].stack == nullptr) abort();
    }
  srt_block_barrier = SrtBarrier{nt, 0, 0};
  srt_warps.assign((nt + 31) / 32, SrtWarp{});
  for (int w = 0; w < (int)srt_warps.size(); ++w)
    srt_warps[w].bar.expected = nt - w * 32 < 32 ? nt - w * 32 : 32;
  srt_body = [&] { kernel(static_cast<KA>(args)...); };
  for (unsigned by = 0; by < c.grid.y; ++by)
    for (unsigned bx = 0; bx < c.grid.x; ++bx) {
      blockIdx = dim3(bx, by);
      for (int t = 0; t < nt; ++t) {
        SrtFiber& f = srt_fibers[t];
        // the registers srt_fiber_switch pops, then the entry as the
        // return address (the stack 16-byte aligned at its call)
        void** sp = (void**)(((uintptr_t)(f.stack + SRT_FIBER_STACK)) &
                             ~(uintptr_t)15) - 8;
        for (int r = 0; r < 6; ++r) sp[r] = nullptr;
        sp[6] = (void*)&srt_fiber_entry;
        sp[7] = nullptr;
        f.sp = sp;
        f.done = false;
      }
      int alive = nt;
      while (alive > 0) {
        const unsigned long long progress = srt_progress;
        for (int t = 0; t < nt; ++t) {
          if (srt_fibers[t].done) continue;
          srt_current = t;
          threadIdx = dim3(t);
          srt_fiber_switch(&srt_sched_sp, srt_fibers[t].sp);
          if (srt_fibers[t].done) --alive;
        }
        if (alive > 0 && srt_progress == progress) {
          fprintf(stderr, "emulator: %d threads of block (%u, %u) wait on "
                  "a barrier that the others skipped\n", alive, bx, by);
          abort();
        }
      }
    }
  srt_body = nullptr;
}
