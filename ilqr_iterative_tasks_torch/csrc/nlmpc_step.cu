// K2: one whole NLMPC control step (calc_input, spaceVarying) per lane.
//
// Replaces ilqr_iterative_tasks_tpu/ops/pallas_nlmpc_step.py::
// build_fused_nlmpc_step in mode "spaceVarying" (factory :54, kernel :245,
// pallas_call :979; body _pallas_nlmpc_core.make_nlmpc_tile_funcs :39).
// Per lane, at its shrinking horizon hzn: the L1-kNN of the terminal guess
// over the last nsi stored laps (k nearest rows below the lap's length,
// ties to the lower row; missing slots are row 0 and not selectable), the
// k candidates' multi-start LM feasibility solves at m = clip(hzn, 2, n)
// (nlmpc_core.cuh), the horizon-1 reach check for hzn <= 1 lanes
// (|step(x, raw u_warm[0]) - x_term| <= 1e-3; their solves start done),
// the cost hzn + Qfun where feasible, the lexicographic row-min over laps
// (absent slots -inf, laps not yet stored +inf) and a first-min argmin in
// the winning row (lm_core.cuh lex_select), then the winner's solution,
// `succ` = idx + 1 <= len - 1, and the pre-freeze guess advance: the
// successor point when succ, else the winner's x_m (x_term for h1 lanes).
//
// Computes what the composed XLA path of control/batched_nlmpc_soa.py
// (solve_step_general) computes. None of the TPU kernel's options
// (qsort_skip, zeros_skip, prox_skip, all_rev_skip, stream_safe_set,
// with_stats, store_solutions) is ported: the shipped qsort_skip is
// bitwise-neutral for nsi = 1, so this plain kernel, which solves all k
// candidates, computes what the bench's kernel computes.
//
// Design: one thread per lane, blocks of 128, the ragged edge masked; skip
// lanes write zeros and exit. The safe set is read straight from global
// memory in its batch-trailing layout (coalesced across a warp), only below
// the lap's length. The winner is not stored: after selection it is solved
// again through the candidates' own call site (a pure function of x, its
// terminal state, the warm start and m, so bitwise the candidate's
// solution, as the TPU kernel's store_solutions=False does).
//
// What bounds it on the card: the per-lane LM chain (nsi*k + 1 solves of 2
// starts x up to max_iters iterations, each with a 9x9 Cholesky and six
// rollouts with sin/cos), register spills, and warp divergence from the
// lanes' different trip counts. The kNN reads one stored lap, T x 4 states
// and k Qfun values, per lane per step.
#include "nlmpc_core.cuh"

namespace ilqr {

template <typename T, int N, int K, int NSI>
__global__ void __launch_bounds__(128) nlmpc_step_kernel(
    const NlmpcConsts<T> C, int B, int T_rows, const T* __restrict__ x,
    const T* __restrict__ guess, const T* __restrict__ uw,
    const T* __restrict__ states, const T* __restrict__ qfun,
    const int* __restrict__ lap_len, const int* __restrict__ lap_ids,
    const int* __restrict__ lap_ok, const T* __restrict__ obs,
    const float* __restrict__ skip, const int* __restrict__ hzn,
    T* __restrict__ us_out, T* __restrict__ fe_out, T* __restrict__ ng_out,
    int* __restrict__ idx_out, int* __restrict__ row_out,
    T* __restrict__ succ_out) {
  constexpr int NC = NSI * K;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  if (skip[b] > 0.5f) {
#pragma unroll
    for (int i = 0; i < 2 * N; ++i) us_out[i * B + b] = (T)0;
#pragma unroll
    for (int c = 0; c < 4; ++c) ng_out[c * B + b] = (T)0;
    fe_out[b] = (T)0;
    idx_out[b] = 0;
    row_out[b] = 0;
    succ_out[b] = (T)0;
    return;
  }
  const T inf = (T)INFINITY;
  T x0[4], xg[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    x0[c] = x[c * B + b];
    xg[c] = guess[c * B + b];
  }
  const Obs7<T> o = load_obs7(C, obs, B, b);
  const int h = hzn[b];
  const int mm = h < 2 ? 2 : (h > N ? N : h);
  const bool h1 = h <= 1;
  const T hf = (T)h;
  T warm[2 * N];
  load_warm<T, N>(C, uw, B, b, warm);
  T x1[4];  // horizon-1 reach state: one step of the raw first warm input
  step_dt(C.dt, x0, uw[b], uw[B + b], x1);
  int lap[NSI], len[NSI];
  bool lok[NSI];
#pragma unroll
  for (int r = 0; r < NSI; ++r) {
    lap[r] = lap_ids[r];
    lok[r] = lap_ok[r] != 0;
    len[r] = lap_len[(size_t)lap[r] * B + b];
  }
  const size_t row_stride = (size_t)4 * B;  // one safe-set row (4, B)

  // ---- kNN + candidate extraction, one stored lap per row ----
  T cxt[NC][4], cq[NC];
  int cidx[NC];
  bool cst[NC];
#pragma unroll
  for (int r = 0; r < NSI; ++r) {
    T dk[K];
    int ik[K];
    const T* st = states + (size_t)lap[r] * T_rows * row_stride + b;
    knn_rows<T, K>(st, row_stride, B, len[r] < T_rows ? len[r] : T_rows, xg,
                   dk, ik);
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int c = r * K + s;
      const T* p = st + ik[s] * row_stride;
      cidx[c] = ik[s];
      cst[c] = dk[s] < inf;
#pragma unroll
      for (int q = 0; q < 4; ++q) cxt[c][q] = p[q * B];
      cq[c] = qfun[((size_t)lap[r] * T_rows + ik[s]) * B + b];
    }
  }

  // ---- candidate solves, then the winner's re-solve (c == NC) ----
  T cost[NC], cmp[NC];
  int win = 0, row_sel = 0;
#pragma unroll 1
  for (int c = 0; c <= NC; ++c) {
    if (c == NC) win = lex_select<T, NSI, K>(cmp, cost, row_sel);
    const int cc = c < NC ? c : win;
    T xt[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) xt[q] = cxt[cc][q];
    const Shoot<T, N> S{C, x0, xt, o, mm};
    T us[N][2], xm[4], te;
    const bool feasible = S.feasibility_solve(warm, h1, us, xm, te);
    if (c < NC) {
      bool feas = feasible;
      if (h1) {
        T dr[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) dr[q] = x1[q] - xt[q];
        feas = sqrt(dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2] +
                    dr[3] * dr[3]) <= (T)1e-3;
      }
      const bool okc = cst[c] && lok[c / K];
      cost[c] = feas && okc ? hf + cq[c] : inf;
      cmp[c] = lok[c / K] ? (cst[c] ? cost[c] : -inf) : inf;
    } else {
      const int idx_sel = cidx[win];
      const int len_sel = len[row_sel];
      const bool succ = idx_sel + 1 <= len_sel - 1;
      const int nxt = succ ? idx_sel + 1 : idx_sel;  // successor row
      const T* nx = states + ((size_t)lap[row_sel] * T_rows + nxt) *
                                 row_stride + b;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        us_out[(2 * i) * B + b] = us[i][0];
        us_out[(2 * i + 1) * B + b] = us[i][1];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ng_out[q * B + b] = succ ? nx[q * B] : (h1 ? xt[q] : xm[q]);
      fe_out[b] = isfinite(cost[win]) ? (T)1 : (T)0;
      idx_out[b] = idx_sel;
      row_out[b] = row_sel;
      succ_out[b] = succ ? (T)1 : (T)0;
    }
  }
}

template <typename T, int N, int K, int NSI>
int launch_nlmpc_step(const double* consts, int max_iters, int B, int T_rows,
                      const void* x, const void* guess, const void* uw,
                      const void* states, const void* qfun,
                      const void* lap_len, const void* lap_ids,
                      const void* lap_ok, const void* obs, const void* skip,
                      const void* hzn, void* us, void* fe, void* ng,
                      void* idx, void* row, void* succ,
                      cudaStream_t stream) {
  const NlmpcConsts<T> C = make_nlmpc_consts<T>(consts, max_iters);
  nlmpc_step_kernel<T, N, K, NSI><<<(B + 127) / 128, 128, 0, stream>>>(
      C, B, T_rows, (const T*)x, (const T*)guess, (const T*)uw,
      (const T*)states, (const T*)qfun, (const int*)lap_len,
      (const int*)lap_ids, (const int*)lap_ok, (const T*)obs,
      (const float*)skip, (const int*)hzn, (T*)us, (T*)fe, (T*)ng,
      (int*)idx, (int*)row, (T*)succ);
  return (int)cudaGetLastError();
}

}  // namespace ilqr

// dtype: 0 float32, 1 float64. The kernel reads only the laps named by
// lap_ids. Returns the cudaError_t of the launch, or -1 when no kernel is
// instantiated for (dtype, n, k, nsi).
extern "C" int nlmpc_step_launch(int dtype, int n, int k, int nsi,
                                 const double* consts, int max_iters, int B,
                                 int T_rows, const void* x, const void* guess,
                                 const void* uw, const void* states,
                                 const void* qfun, const void* lap_len,
                                 const void* lap_ids, const void* lap_ok,
                                 const void* obs, const void* skip,
                                 const void* hzn, void* us, void* fe,
                                 void* ng, void* idx, void* row, void* succ,
                                 void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 6 && k == 8 && nsi == 1 && dtype == 0)
    return ilqr::launch_nlmpc_step<float, 6, 8, 1>(
        consts, max_iters, B, T_rows, x, guess, uw, states, qfun, lap_len,
        lap_ids, lap_ok, obs, skip, hzn, us, fe, ng, idx, row, succ, s);
  if (n == 6 && k == 8 && nsi == 1 && dtype == 1)
    return ilqr::launch_nlmpc_step<double, 6, 8, 1>(
        consts, max_iters, B, T_rows, x, guess, uw, states, qfun, lap_len,
        lap_ids, lap_ok, obs, skip, hzn, us, fe, ng, idx, row, succ, s);
  return -1;
}
