// A CUDA emulation shim: lets g++ compile a kernel source of
// ls1_mardyn_tpu_torch/csrc for the CPU, so that its logic can be run
// against the plain PyTorch versions on a machine without a card.
//
// tools/cuda_emu.py prepares a source for it (the launch syntax
// `kern<<<grid, block, smem, stream>>>(args)` and the dynamic
// `extern __shared__` array are the only rewrites) and compiles it with
//   g++ -std=c++20 -ffp-contract=off -pthread -shared -fPIC -x c++
// with this header standing in for <cuda_runtime.h>.
//
// How a launch runs: the blocks one after another on the calling thread;
// the threads of a block as fibers (ucontext) on that thread, switched
// only at a barrier, so a block's `__shared__` variables can be function
// statics and atomics need no lock.  __syncthreads() is a barrier of the
// block's fibers; every warp intrinsic (shuffles, __ballot_sync,
// __any_sync, __match_any_sync, __reduce_*_sync, __syncwarp) is a
// barrier of the warp's 32 fibers around a per-warp exchange buffer
// (double-buffered, one barrier per exchange).  Only full-warp masks are
// taken: anything else aborts, as does a barrier that can never be
// released (a divergent __syncthreads).  Dynamic shared memory starts as
// 0xff bytes (NaN in f32/f64), so a read before a write shows.
//
// Arithmetic: the _rn intrinsics are the plain IEEE operations (hence
// -ffp-contract=off); rsqrtf / rsqrt are 1/sqrt (the card's are within
// 2 / 1 ulp); exp, erfc and sqrt are the C library's.

#pragma once

#include <math.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

#include <ucontext.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  constexpr dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1)
      : x(a), y(b), z(c) {}
};

typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

inline dim3 threadIdx, blockIdx, blockDim, gridDim;

// Marks a library built under this shim: the port's launch code hands
// only such a library CPU tensors (ls1_mardyn_tpu_torch/ops/_build.py:
// stream_of).  One source is one library, so one definition.
extern "C" int cuda_emu_host_build(void) { return 1; }

namespace emu {

constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block can use
constexpr size_t STACK = 256 * 1024;
constexpr unsigned FULL = 0xffffffffu;

[[noreturn]] inline void die(const char* what) {
  std::fprintf(stderr, "cuda_emu: %s\n", what);
  std::abort();
}

struct Warp {
  unsigned gen = 0, count = 0;
  uint64_t buf[2][32];
};

struct Block {
  std::vector<ucontext_t> ctx;
  std::vector<dim3> tid;
  std::vector<char> done;
  std::vector<unsigned> seq;  // exchanges made by each thread
  std::vector<Warp> warps;
  std::vector<char> stacks;
  std::vector<unsigned char> dyn;
  ucontext_t main;
  std::function<void()> body;
  unsigned nthreads = 0, cur = 0, gen = 0, count = 0, live = 0;
  unsigned long long progress = 0;
};

inline Block* B = nullptr;
inline int last_error = cudaSuccess;

inline unsigned char* dyn_smem() { return B->dyn.data(); }

inline unsigned linear_tid() {
  return threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
}

inline void yield() { swapcontext(&B->ctx[B->cur], &B->main); }

inline void entry() {
  B->body();
  B->done[B->cur] = 1;
  --B->live;
  ++B->progress;
  if (B->count && B->count == B->live) {  // the others wait at a barrier
    B->count = 0;
    ++B->gen;
  }
}

inline void sync_block() {
  const unsigned g = B->gen;
  ++B->progress;
  if (++B->count == B->live) {
    B->count = 0;
    ++B->gen;
    return;
  }
  while (B->gen == g) yield();
}

inline void sync_warp() {
  Warp& w = B->warps[linear_tid() >> 5];
  const unsigned g = w.gen;
  ++B->progress;
  if (++w.count == 32) {
    w.count = 0;
    ++w.gen;
    return;
  }
  while (w.gen == g) yield();
}

// Every lane of the warp deposits v; returns the 32 deposits.
template <typename V>
inline const uint64_t* exchange(unsigned mask, V v) {
  static_assert(sizeof(V) <= 8, "exchange of at most 8 bytes");
  if (mask != FULL) die("only full-warp masks are emulated");
  const unsigned t = linear_tid();
  Warp& w = B->warps[t >> 5];
  const unsigned p = B->seq[t]++ & 1;
  uint64_t raw = 0;
  std::memcpy(&raw, &v, sizeof(V));
  w.buf[p][t & 31] = raw;
  sync_warp();
  return w.buf[p];
}

template <typename V>
inline V pick(const uint64_t* buf, int src) {
  V out;
  std::memcpy(&out, &buf[src], sizeof(V));
  return out;
}

// Run kern(args...) over the grid, each block's threads as fibers.
struct Cfg {
  dim3 g, b;
  size_t smem;
  Cfg(dim3 g_, dim3 b_, size_t smem_ = 0, cudaStream_t = nullptr)
      : g(g_), b(b_), smem(smem_) {}
};

template <typename K, typename... A>
void launch(Cfg c, K kern, A... args) {
  const unsigned n = c.b.x * c.b.y * c.b.z;
  if (n == 0 || n > 1024 || n % 32 || c.smem > SMEM_MAX) {
    last_error = cudaErrorInvalidValue;
    return;
  }
  Block blk;
  blk.nthreads = n;
  blk.ctx.resize(n);
  blk.tid.resize(n);
  blk.done.assign(n, 0);
  blk.seq.assign(n, 0);
  blk.warps.resize(n / 32);
  blk.stacks.resize(n * STACK);
  blk.dyn.resize(std::max<size_t>(c.smem, 16));
  blk.body = [&] { kern(args...); };
  Block* saved = B;
  B = &blk;
  gridDim = c.g;
  blockDim = c.b;
  for (unsigned bz = 0; bz < c.g.z; ++bz)
    for (unsigned by = 0; by < c.g.y; ++by)
      for (unsigned bx = 0; bx < c.g.x; ++bx) {
        blockIdx = dim3(bx, by, bz);
        std::fill(blk.done.begin(), blk.done.end(), 0);
        std::fill(blk.seq.begin(), blk.seq.end(), 0);
        std::fill(blk.dyn.begin(), blk.dyn.end(), 0xff);
        for (Warp& w : blk.warps) w = Warp();
        blk.gen = blk.count = 0;
        blk.live = n;
        for (unsigned i = 0; i < n; ++i) {
          blk.tid[i] = dim3(i % c.b.x, (i / c.b.x) % c.b.y, i / (c.b.x * c.b.y));
          getcontext(&blk.ctx[i]);
          blk.ctx[i].uc_stack.ss_sp = blk.stacks.data() + i * STACK;
          blk.ctx[i].uc_stack.ss_size = STACK;
          blk.ctx[i].uc_link = &blk.main;
          makecontext(&blk.ctx[i], entry, 0);
        }
        while (blk.live) {
          const unsigned long long before = blk.progress;
          for (unsigned i = 0; i < n; ++i) {
            if (blk.done[i]) continue;
            blk.cur = i;
            threadIdx = blk.tid[i];
            swapcontext(&blk.main, &blk.ctx[i]);
          }
          if (blk.live && blk.progress == before)
            die("a barrier that no thread can release (divergent sync?)");
        }
      }
  B = saved;
  last_error = cudaSuccess;
}

}  // namespace emu

// -- the CUDA runtime calls the sources make --------------------------------

template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes >= 0 && (size_t)bytes <= emu::SMEM_MAX ? cudaSuccess
                                                      : cudaErrorInvalidValue;
}

inline cudaError_t cudaGetLastError() {
  const int e = emu::last_error;
  emu::last_error = cudaSuccess;
  return e;
}

// -- device intrinsics --------------------------------------------------------

inline void __syncthreads() { emu::sync_block(); }
inline void __syncwarp(unsigned mask = emu::FULL) {
  if (mask != emu::FULL) emu::die("only full-warp masks are emulated");
  emu::sync_warp();
}

template <typename V>
inline V __shfl_sync(unsigned mask, V v, int src, int width = 32) {
  if (width != 32) emu::die("shuffle width other than 32");
  return emu::pick<V>(emu::exchange(mask, v), src & 31);
}
template <typename V>
inline V __shfl_up_sync(unsigned mask, V v, unsigned d, int width = 32) {
  if (width != 32) emu::die("shuffle width other than 32");
  const int lane = emu::linear_tid() & 31;
  const uint64_t* b = emu::exchange(mask, v);
  return lane >= (int)d ? emu::pick<V>(b, lane - (int)d) : v;
}
template <typename V>
inline V __shfl_down_sync(unsigned mask, V v, unsigned d, int width = 32) {
  if (width != 32) emu::die("shuffle width other than 32");
  const int lane = emu::linear_tid() & 31;
  const uint64_t* b = emu::exchange(mask, v);
  return lane + (int)d < 32 ? emu::pick<V>(b, lane + (int)d) : v;
}
template <typename V>
inline V __shfl_xor_sync(unsigned mask, V v, int m, int width = 32) {
  if (width != 32) emu::die("shuffle width other than 32");
  return emu::pick<V>(emu::exchange(mask, v), (emu::linear_tid() & 31) ^ (m & 31));
}

inline unsigned __ballot_sync(unsigned mask, int pred) {
  const uint64_t* b = emu::exchange(mask, (int)(pred != 0));
  unsigned out = 0;
  for (int l = 0; l < 32; ++l) out |= (unsigned)emu::pick<int>(b, l) << l;
  return out;
}

inline int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0u;
}
// the lanes whose value equals this lane's
inline unsigned __match_any_sync(unsigned mask, int v) {
  const uint64_t* b = emu::exchange(mask, v);
  unsigned out = 0;
  for (int l = 0; l < 32; ++l) out |= (unsigned)(emu::pick<int>(b, l) == v) << l;
  return out;
}

template <typename V, typename Op>
inline V emu_reduce(unsigned mask, V v, Op op) {
  const uint64_t* b = emu::exchange(mask, v);
  V out = emu::pick<V>(b, 0);
  for (int l = 1; l < 32; ++l) out = op(out, emu::pick<V>(b, l));
  return out;
}
inline int __reduce_min_sync(unsigned mask, int v) {
  return emu_reduce(mask, v, [](int a, int b) { return std::min(a, b); });
}
inline unsigned __reduce_min_sync(unsigned mask, unsigned v) {
  return emu_reduce(mask, v, [](unsigned a, unsigned b) { return std::min(a, b); });
}
inline int __reduce_max_sync(unsigned mask, int v) {
  return emu_reduce(mask, v, [](int a, int b) { return std::max(a, b); });
}
inline unsigned __reduce_max_sync(unsigned mask, unsigned v) {
  return emu_reduce(mask, v, [](unsigned a, unsigned b) { return std::max(a, b); });
}
inline int __reduce_add_sync(unsigned mask, int v) {
  return emu_reduce(mask, v, [](int a, int b) { return a + b; });
}
inline unsigned __reduce_add_sync(unsigned mask, unsigned v) {
  return emu_reduce(mask, v, [](unsigned a, unsigned b) { return a + b; });
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }

inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline int __float2int_rn(float a) { return (int)std::nearbyint(a); }
inline int __double2int_rn(double a) { return (int)std::nearbyint(a); }
inline float rsqrtf(float a) { return 1.0f / std::sqrt(a); }
inline double rsqrt(double a) { return 1.0 / std::sqrt(a); }

template <typename V>
inline V __ldg(const V* p) { return *p; }

// fibers switch only at barriers, so a read-modify-write is atomic
template <typename V>
inline V atomicAdd(V* p, V v) { const V old = *p; *p = old + v; return old; }
template <typename V>
inline V atomicMin(V* p, V v) { const V old = *p; *p = std::min(old, v); return old; }
template <typename V>
inline V atomicMax(V* p, V v) { const V old = *p; *p = std::max(old, v); return old; }
template <typename V>
inline V atomicOr(V* p, V v) { const V old = *p; *p = old | v; return old; }

using std::erfc;
using std::exp;
using std::floor;
using std::max;
using std::min;
using std::sqrt;
