// K3: one LM-iLQR candidate solve per lane.
//
// Replaces ilqr_iterative_tasks_tpu/ops/pallas_ilqr.py::build_fused_ilqr
// (kernel :87, pallas_call :139). Same contract:
// (x0 (4,B), x_term (4,B), u_init (N,2,B), obs (6,B), optional skip (B,))
// -> (us (N,2,B), x_last (4,B), cost (B,), dist (B,)); a lane with
// skip > 0.5 runs no LM iteration (its outputs are the rollout of u_init).
//
// One thread a lane, blocks of 128; the body is the per-lane solve of
// lm_core.cuh. Lanes are refilled as they finish: the grid holds as many
// blocks as the card keeps resident (launch_lanes, tile.cuh), a thread
// takes its first lane by its index and, when that lane's solve ends,
// writes its outputs and takes the next lane from a counter (next_lane).
// A warp reconverges where its lanes' LM loops end, so it takes new lanes
// when its slowest lane is done. A lane's arithmetic does not depend on
// the thread or the order, so every output equals the plain version's bit
// for bit. What bounds it on the card: the per-lane LM dependency chain (a
// backward Riccati pass of ~N*150 dependent flops and 5N transcendentals
// per iteration) times the trips of each warp's slowest lane, summed over
// the lanes a warp takes; the lane reads 16+2N and writes 6+2N values, so
// memory traffic is negligible.
#include "lm_core.cuh"

namespace ilqr {

template <typename T, int N>
__global__ void __launch_bounds__(128)
    fused_ilqr_kernel(const Consts<T> C, int B, const T* __restrict__ x0,
                      const T* __restrict__ xt, const T* __restrict__ u_init,
                      const T* __restrict__ obs,
                      const float* __restrict__ skip, T* __restrict__ us_out,
                      T* __restrict__ xl_out, T* __restrict__ cost_out,
                      T* __restrict__ dist_out, int* __restrict__ counter,
                      int n_threads) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b = next_lane(counter, n_threads)) {
    T x0l[4], xtl[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x0l[c] = x0[c * B + b];
      xtl[c] = xt[c * B + b];
    }
    const Obs<T> o = load_obs(obs, B, b);
    T us[N][2];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      us[i][0] = u_init[(2 * i) * B + b];
      us[i][1] = u_init[(2 * i + 1) * B + b];
    }
    const bool done0 = skip != nullptr && skip[b] > 0.5f;
    const Solve<T, N> S{C, x0l, xtl, o};
    T xl[4], cost, dist;
    S.lm_solve(us, done0, xl, cost, dist);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      us_out[(2 * i) * B + b] = us[i][0];
      us_out[(2 * i + 1) * B + b] = us[i][1];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) xl_out[c * B + b] = xl[c];
    cost_out[b] = cost;
    dist_out[b] = dist;
  }
}

template <typename T, int N>
int launch_fused_ilqr(const double* consts, int max_iter, int B,
                      const void* x0, const void* xt, const void* u_init,
                      const void* obs, const void* skip, void* us, void* xl,
                      void* cost, void* dist, void* counter,
                      cudaStream_t stream) {
  const Consts<T> C = make_consts<T>(consts, max_iter);
  return launch_lanes<fused_ilqr_kernel<T, N>>(
      B, (int*)counter, stream, C, B, (const T*)x0, (const T*)xt,
      (const T*)u_init, (const T*)obs, (const float*)skip, (T*)us, (T*)xl,
      (T*)cost, (T*)dist);
}

}  // namespace ilqr

// dtype: 0 float32, 1 float64; counter: one int of device memory the
// launch takes its lanes from (launch_lanes, tile.cuh). Returns the
// cudaError_t of the launch, or -1 when no kernel is instantiated for
// (dtype, n).
extern "C" int fused_ilqr_launch(int dtype, int n, const double* consts,
                                 int max_iter, int B, const void* x0,
                                 const void* xt, const void* u_init,
                                 const void* obs, const void* skip, void* us,
                                 void* xl, void* cost, void* dist,
                                 void* stream, void* counter) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 6 && dtype == 0)
    return ilqr::launch_fused_ilqr<float, 6>(consts, max_iter, B, x0, xt,
                                             u_init, obs, skip, us, xl, cost,
                                             dist, counter, s);
  if (n == 6 && dtype == 1)
    return ilqr::launch_fused_ilqr<double, 6>(consts, max_iter, B, x0, xt,
                                              u_init, obs, skip, us, xl, cost,
                                              dist, counter, s);
  return -1;
}

// The loaded kernel's resources for (dtype, n), as the runtime reports them
// (kernel_attributes, tile.cuh); -1 when no kernel is instantiated.
extern "C" int fused_ilqr_attributes(int dtype, int n, int* out) {
  if (n == 6 && dtype == 0)
    return ilqr::kernel_attributes(ilqr::fused_ilqr_kernel<float, 6>, 128,
                                   out);
  if (n == 6 && dtype == 1)
    return ilqr::kernel_attributes(ilqr::fused_ilqr_kernel<double, 6>, 128,
                                   out);
  return -1;
}
