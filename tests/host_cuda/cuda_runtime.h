// CPU emulation of the CUDA runtime pieces the K1-K5 kernels use: every
// CUDA thread of a launch is a std::thread, the lane counter a host
// atomic, and the 32 threads of a warp meet at a barrier of their own for
// the warp's ballots, shuffles, reductions and __syncwarp, exchanging
// values through one slot a thread (two sets of slots, used in turn, so
// that one barrier an exchange suffices); a collective of a part of the
// warp (a tile's mask) meets at a barrier of the mask's threads and
// exchanges through a third set, written and read between two of its
// barriers (the tiles of a warp are disjoint); the threads of a block
// meet at the block's barrier for __syncthreads and __syncthreads_or. A
// block's __shared__ storage is a static variable: a build whose kernels
// declare it defines EMU_SHARED (elsewhere __shared__ does not compile),
// and its launches run one block at a time. The card reports EMU_SMS SMs
// (1 unless the build defines it), each holding one block. For checking
// kernel logic against the plain version on the host; no performance
// meaning. A launch's dynamic shared memory (its third launch argument) is
// a buffer a block, which dynamic_shared() returns.
#pragma once
#include <math.h>
#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#ifndef EMU_SMS
#define EMU_SMS 1
#endif

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#ifdef EMU_SHARED
#define __shared__ static
#else
#define __shared__ __shared___needs_EMU_SHARED
#endif

struct dim3 { unsigned x = 1, y = 1, z = 1; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef void* cudaStream_t;
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class F> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->numRegs = 1; a->localSizeBytes = 0; return 0; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, F, int, size_t) { *n = 1; return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = EMU_SMS; return 0; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n); return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline int atomicCAS(int* p, int cmp, int v) {
  __atomic_compare_exchange_n(p, &cmp, v, false, __ATOMIC_SEQ_CST,
                              __ATOMIC_SEQ_CST);
  return cmp;
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }

namespace emu {
// A reusable barrier of `count` threads, which also returns whether the
// predicate held on any of them (a generation's result is kept until every
// thread has left it: two generations later).
struct Barrier {
  std::mutex m;
  std::condition_variable cv;
  int arrived = 0, any = 0, result[2] = {0, 0};
  unsigned long gen = 0;
  int sync(int count, int p = 0) {
    std::unique_lock<std::mutex> l(m);
    const unsigned long g = gen;
    any |= p != 0;
    if (++arrived == count) {
      result[g & 1] = any;
      any = arrived = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(l, [&] { return gen != g; });
    }
    return result[g & 1];
  }
};
// The threads of one warp: its barrier and two sets of a slot a thread.
// Every thread of the warp runs the same collectives, so they agree on
// the set an exchange uses; a thread writes one set only after every
// thread has passed the barrier of the exchange that last used the other,
// and so has read the set it is about to write.
struct Warp {
  Barrier bar;
  unsigned long long slot[2][32];
  unsigned long long part[32];  // the exchanges of a part of the warp
  std::mutex m;
  std::map<unsigned, std::unique_ptr<Barrier>> parts;
  void sync() { bar.sync(32); }
  void sync(unsigned mask) {
    if (mask == 0xffffffffu) return sync();
    Barrier* p;
    {
      std::lock_guard<std::mutex> l(m);
      std::unique_ptr<Barrier>& q = parts[mask];
      if (!q) q.reset(new Barrier);
      p = q.get();
    }
    p->sync(__builtin_popcount(mask));
  }
};
inline thread_local unsigned turns = 0;  // exchanges this thread made
inline std::unique_ptr<Warp[]> warps;      // of the running launch
inline std::unique_ptr<Barrier[]> blocks;  // of the running launch
inline Warp& warp() {
  return warps[(blockIdx.x * blockDim.x + threadIdx.x) / 32];
}
// v of every thread of the mask in its slot; returns the slot of src (a
// thread of the mask)
template <class V> V exchange(V v, int src, unsigned mask = 0xffffffffu) {
  static_assert(sizeof(V) <= sizeof(unsigned long long), "8 bytes at most");
  Warp& w = warp();
  const int l = threadIdx.x & 31;
  if (!((mask >> l) & 1u) || !((mask >> (src & 31)) & 1u)) std::abort();
  V out;
  if (mask != 0xffffffffu) {
    std::memcpy(&w.part[l], &v, sizeof(V));
    w.sync(mask);
    std::memcpy(&out, &w.part[src & 31], sizeof(V));
    w.sync(mask);
    return out;
  }
  unsigned long long* slot = w.slot[turns++ & 1];
  std::memcpy(&slot[l], &v, sizeof(V));
  w.sync();
  std::memcpy(&out, &slot[src & 31], sizeof(V));
  return out;
}
}  // namespace emu

template <class V> V __shfl_sync(unsigned mask, V v, int src, int width = 32) {
  return emu::exchange(v, (threadIdx.x & 31 & ~(width - 1)) + (src & (width - 1)),
                       mask);
}
template <class V>
V __shfl_xor_sync(unsigned mask, V v, int lane_mask, int width = 32) {
  const int l = threadIdx.x & 31;
  return emu::exchange(v, (l & ~(width - 1)) + ((l ^ lane_mask) & (width - 1)),
                       mask);
}
inline void __syncwarp(unsigned mask = 0xffffffffu) { emu::warp().sync(mask); }
inline void __syncthreads() { emu::blocks[blockIdx.x].sync(blockDim.x); }
inline int __syncthreads_or(int p) {
  return emu::blocks[blockIdx.x].sync(blockDim.x, p);
}
namespace emu {
// every thread's v of the mask, into all[] (0 outside the mask)
inline void gather(unsigned mask, unsigned long long v, unsigned long long* all) {
  Warp& w = warp();
  const int l = threadIdx.x & 31;
  if (!((mask >> l) & 1u)) std::abort();
  unsigned long long* slot = mask == 0xffffffffu ? w.slot[turns++ & 1] : w.part;
  slot[l] = v;
  w.sync(mask);
  for (int i = 0; i < 32; ++i) all[i] = (mask >> i) & 1u ? slot[i] : 0;
  if (mask != 0xffffffffu) w.sync(mask);
}
}  // namespace emu
inline unsigned __ballot_sync(unsigned mask, bool p) {
  unsigned long long all[32];
  emu::gather(mask, p, all);
  unsigned out = 0;
  for (int i = 0; i < 32; ++i) out |= (all[i] ? 1u : 0u) << i;
  return out;
}
inline int __any_sync(unsigned mask, int p) { return __ballot_sync(mask, p != 0) != 0; }
// Threads run on their own here: at any point a thread is the one thread
// of its warp that runs it.
inline unsigned __activemask() { return 1u << (threadIdx.x & 31); }
inline unsigned __reduce_max_sync(unsigned mask, unsigned v) {
  unsigned long long all[32];
  emu::gather(mask, v, all);
  unsigned long long out = 0;
  for (int i = 0; i < 32; ++i) out = all[i] > out ? all[i] : out;
  return (unsigned)out;
}

namespace emu {
// A build that defines K1_ON_SOLVE(lane) as emu::count(lane) counts each
// lane's solves into the ints that emu_count_into names.
inline int* counts = nullptr;
inline void count(int lane) {
  if (counts) __atomic_fetch_add(&counts[lane], 1, __ATOMIC_SEQ_CST);
}
}  // namespace emu
extern "C" void emu_count_into(int* p) { emu::counts = p; }

namespace emu {
inline std::unique_ptr<unsigned long long[]> dyn;  // of the running launch
inline size_t dyn_words = 0;                        // a block's, in 8 bytes
}  // namespace emu
#define EMU_DYNAMIC_SHARED
// the block's dynamic shared memory
inline unsigned char* dynamic_shared() {
  return reinterpret_cast<unsigned char*>(emu::dyn.get() +
                                          blockIdx.x * emu::dyn_words);
}

namespace emu {
template <class K, class... A>
void run(K kernel, dim3 g, dim3 b, size_t smem, A... args) {
  gridDim = g; blockDim = b;
  if (b.x % 32) std::abort();  // blocks of whole warps
  warps.reset(new Warp[g.x * b.x / 32]);
  blocks.reset(new Barrier[g.x]);
  dyn_words = (smem + 7) / 8;
  dyn.reset(new unsigned long long[g.x * dyn_words + 1]);
#ifdef EMU_SHARED
  const unsigned batch = 1;  // a block's shared storage is static
#else
  const unsigned batch = 8;
#endif
  for (unsigned b0 = 0; b0 < g.x; b0 += batch) {
    std::vector<std::thread> ts;
    for (unsigned bi = b0; bi < g.x && bi < b0 + batch; ++bi)
      for (unsigned t = 0; t < b.x; ++t)
        ts.emplace_back([=] {
          blockIdx.x = bi; threadIdx.x = t;
          kernel(args...);
        });
    for (auto& t : ts) t.join();
  }
}
template <class K> struct Launcher {
  K k; dim3 g, b; size_t smem;
  template <class... A> void operator()(A... args) const {
    run(k, g, b, smem, args...);
  }
};
inline dim3 d3(unsigned x) { dim3 d; d.x = x; return d; }
inline dim3 d3(dim3 x) { return x; }
template <class K, class GG, class BB>
Launcher<K> launcher(K k, GG g, BB b, size_t smem = 0,
                     cudaStream_t = nullptr) {
  return Launcher<K>{k, d3((unsigned)g), d3((unsigned)b), smem};
}
}  // namespace emu
