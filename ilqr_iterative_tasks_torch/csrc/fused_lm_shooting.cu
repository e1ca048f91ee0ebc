// K4: one NLMPC candidate feasibility solve (projected LM shooting) per
// lane.
//
// Replaces ilqr_iterative_tasks_tpu/ops/pallas_lm_shooting.py::
// build_fused_lm_shooting (kernel :97, pallas_call :163) as built with
// with_skip=True and with_hzn=True: per lane, the multi-start solve of
// nlmpc_core.cuh at the lane's horizon m = clip(hzn, 2, N), returning the
// clipped solution, x_m, term_err and the 0/1 verdict. Lanes with skip=1
// run no LM iteration in either start (their outputs are the better of the
// clipped warm start and zeros).
//
// Design: one thread per lane, blocks of 128, the ragged edge masked. The
// TPU tile's lockstep LM loop becomes each thread's own loop; nothing is
// staged in shared memory. What bounds it on the card: the per-lane LM
// dependency chain (up to 2 x max_iters iterations, each a Jacobian, a 9x9
// Cholesky and 6 rollouts with sin/cos), register spills, and warp
// divergence from the lanes' different trip counts. It reads 29 and writes
// 18 values per lane.
#include "nlmpc_core.cuh"

namespace ilqr {

template <typename T, int N>
__global__ void __launch_bounds__(128) fused_lm_shooting_kernel(
    const NlmpcConsts<T> C, int B, const T* __restrict__ x0,
    const T* __restrict__ xt, const T* __restrict__ uw,
    const T* __restrict__ obs, const float* __restrict__ skip,
    const int* __restrict__ hzn, T* __restrict__ us_out,
    T* __restrict__ xl_out, T* __restrict__ te_out, T* __restrict__ fe_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  T a[4], t[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a[c] = x0[c * B + b];
    t[c] = xt[c * B + b];
  }
  const Obs7<T> o = load_obs7(C, obs, B, b);
  const int h = hzn[b];
  const Shoot<T, N> S{C, a, t, o, h < 2 ? 2 : (h > N ? N : h)};
  T warm[2 * N];
  load_warm<T, N>(C, uw, B, b, warm);
  T us[N][2], xm[4], te;
  const bool fe = S.feasibility_solve(warm, skip[b] > 0.5f, us, xm, te);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    us_out[(2 * j) * B + b] = us[j][0];
    us_out[(2 * j + 1) * B + b] = us[j][1];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) xl_out[c * B + b] = xm[c];
  te_out[b] = te;
  fe_out[b] = fe ? (T)1 : (T)0;
}

template <typename T, int N>
int launch_fused_lm_shooting(const double* consts, int max_iters, int B,
                             const void* x0, const void* xt, const void* uw,
                             const void* obs, const void* skip,
                             const void* hzn, void* us, void* xl, void* te,
                             void* fe, cudaStream_t stream) {
  const NlmpcConsts<T> C = make_nlmpc_consts<T>(consts, max_iters);
  fused_lm_shooting_kernel<T, N><<<(B + 127) / 128, 128, 0, stream>>>(
      C, B, (const T*)x0, (const T*)xt, (const T*)uw, (const T*)obs,
      (const float*)skip, (const int*)hzn, (T*)us, (T*)xl, (T*)te, (T*)fe);
  return (int)cudaGetLastError();
}

}  // namespace ilqr

// dtype: 0 float32, 1 float64. Returns the cudaError_t of the launch, or -1
// when no kernel is instantiated for (dtype, n).
extern "C" int fused_lm_shooting_launch(int dtype, int n, const double* consts,
                                        int max_iters, int B, const void* x0,
                                        const void* xt, const void* uw,
                                        const void* obs, const void* skip,
                                        const void* hzn, void* us, void* xl,
                                        void* te, void* fe, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 6 && dtype == 0)
    return ilqr::launch_fused_lm_shooting<float, 6>(
        consts, max_iters, B, x0, xt, uw, obs, skip, hzn, us, xl, te, fe, s);
  if (n == 6 && dtype == 1)
    return ilqr::launch_fused_lm_shooting<double, 6>(
        consts, max_iters, B, x0, xt, uw, obs, skip, hzn, us, xl, te, fe, s);
  return -1;
}

// The loaded kernel's resources for (dtype, n), as the runtime reports them
// (kernel_attributes, tile.cuh); -1 when no kernel is instantiated.
extern "C" int fused_lm_shooting_attributes(int dtype, int n, int* out) {
  if (n == 6 && dtype == 0)
    return ilqr::kernel_attributes(ilqr::fused_lm_shooting_kernel<float, 6>,
                                   128, out);
  if (n == 6 && dtype == 1)
    return ilqr::kernel_attributes(ilqr::fused_lm_shooting_kernel<double, 6>,
                                   128, out);
  return -1;
}
