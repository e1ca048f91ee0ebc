// Thread tiles and lane queues of the per-lane kernels: a tile of G threads
// of one warp owns a lane (Tile; K1, K2), the resources of a loaded kernel
// (kernel_attributes), and, for the kernels whose lanes take different
// numbers of LM trips (K3, K5), a grid sized to what the card holds at once
// whose threads take their lanes from a counter as they finish (next_lane,
// launch_lanes).
#pragma once

#include <cuda_runtime.h>

namespace ilqr {

// The resources of a loaded kernel as the CUDA runtime reports them, for
// blocks of `threads` threads: out[0] registers a thread, out[1] bytes of
// local memory a thread (its stack frame, register spills included),
// out[2] resident warps an SM. Returns the first failing query's
// cudaError_t, else 0.
template <typename F>
int kernel_attributes(F* kernel, int threads, int* out) {
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks * threads / 32;
  return 0;
}

// A tile of G consecutive threads of a warp (G a power of two <= 32) that
// owns one lane. Blocks are whole warps and a lane's tile starts at a
// multiple of G, so a tile never straddles a warp; its shuffles and ballots
// name only its own threads, so the tiles of a warp may diverge or exit.
template <int G>
struct Tile {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: 1, 2, ..., 32");
  static constexpr unsigned LOW = G == 32 ? 0xffffffffu : (1u << (G & 31)) - 1u;
  unsigned mask;  // the tile's threads within the warp
  int base;       // the tile's first thread within the warp
  int rank;       // this thread's index within the tile

  __device__ __forceinline__ Tile() {
    const int wl = threadIdx.x & 31;
    base = wl & ~(G - 1);
    rank = wl & (G - 1);
    mask = LOW << base;
  }
  // v of the tile's thread src
  template <typename V>
  __device__ __forceinline__ V shfl(V v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
  template <typename V>
  __device__ __forceinline__ V shfl_xor(V v, int lane_mask) const {
    return __shfl_xor_sync(mask, v, lane_mask, G);
  }
  // bit q set iff the predicate holds on the tile's thread q
  __device__ __forceinline__ unsigned ballot(bool p) const {
    return (__ballot_sync(mask, p) >> base) & LOW;
  }
};

// The lane a thread takes when its lane is done: the grid's n_threads
// threads start at lanes 0 .. n_threads - 1 by their index, and the counter
// hands out the rest in order.
__device__ __forceinline__ int next_lane(int* counter, int n_threads) {
  return n_threads + atomicAdd(counter, 1);
}

// Blocks of 128 threads of Kernel the card holds at once (its resident
// blocks an SM times the SMs), queried at the process's first launch of
// Kernel and kept; -(the failing query's cudaError_t). A grid of any size
// takes every lane, so the size, read on the first launch's card, sets
// only the time.
template <auto Kernel>
int resident_blocks() {
  static const int held = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, 128,
                                                        0);
    return e == cudaSuccess ? per_sm * sms : -(int)e;
  }();
  return held;
}

// Launches Kernel (one thread a lane, blocks of 128, its last two
// parameters the lane counter and the grid's threads) on as many blocks as
// the card holds at once, and no more than B lanes need. `counter` is one
// int of device memory, zeroed on the stream first. Returns the first
// failing call's cudaError_t, else 0.
template <auto Kernel, typename... A>
int launch_lanes(int B, int* counter, cudaStream_t stream, A... args) {
  const int held = resident_blocks<Kernel>();
  if (held <= 0) return held < 0 ? -held : (int)cudaErrorInvalidConfiguration;
  const int need = (int)(((long long)B + 127) / 128);
  const int blocks = need < held ? need : held;
  const cudaError_t e = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  Kernel<<<blocks, 128, 0, stream>>>(args..., counter, blocks * 128);
  return (int)cudaGetLastError();
}

}  // namespace ilqr
