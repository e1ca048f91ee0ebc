// CPU emulation of the CUDA runtime pieces the K3 and K5 kernels use: every
// CUDA thread of a launch is a std::thread, the lane counter a host atomic.
// The card reports EMU_SMS SMs (1 unless the build defines it), each
// holding one block. For checking kernel logic against the plain version
// on the host; no performance meaning.
#pragma once
#include <math.h>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#ifndef EMU_SMS
#define EMU_SMS 1
#endif

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct dim3 { unsigned x = 1, y = 1, z = 1; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidConfiguration = 9 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
typedef void* cudaStream_t;
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class F> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->numRegs = 1; a->localSizeBytes = 0; return 0; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, F, int, size_t) { *n = 1; return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = EMU_SMS; return 0; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n); return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
// declared for the thread tiles of tile.cuh, which K3 and K5 do not use
template <class V> V __shfl_sync(unsigned, V, int, int = 32);
template <class V> V __shfl_xor_sync(unsigned, V, int, int = 32);
unsigned __ballot_sync(unsigned, bool);

namespace emu {
template <class K, class... A>
void run(K kernel, dim3 g, dim3 b, A... args) {
  gridDim = g; blockDim = b;
  const unsigned batch = 8;
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
  K k; dim3 g, b;
  template <class... A> void operator()(A... args) const { run(k, g, b, args...); }
};
inline dim3 d3(unsigned x) { dim3 d; d.x = x; return d; }
inline dim3 d3(dim3 x) { return x; }
template <class K, class GG, class BB>
Launcher<K> launcher(K k, GG g, BB b, size_t = 0, cudaStream_t = nullptr) {
  return Launcher<K>{k, d3((unsigned)g), d3((unsigned)b)};
}
}  // namespace emu
