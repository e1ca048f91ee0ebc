// K2: one whole NLMPC control step (calc_input) per lane, safe-set modes
// spaceVarying and timeVarying.
//
// Replaces ilqr_iterative_tasks_tpu/ops/pallas_nlmpc_step.py::
// build_fused_nlmpc_step in modes "spaceVarying" and "timeVarying", with
// and without qsort_skip (factory :54, kernel :245, pallas_call :979; body
// _pallas_nlmpc_core.make_nlmpc_tile_funcs :39). Mode "all" is
// nlmpc_step_all.cu. Per lane, at its shrinking horizon hzn, per stored lap
// of the window (the last nsi laps): the k candidates, either
//   spaceVarying: the L1-kNN of the terminal guess (k nearest rows below
//     the lap's length, ties to the lower row; missing slots are row 0 and
//     not selectable), or
//   timeVarying: the advancing window of k consecutive rows from
//     start = (len - 1) - min_cost + n + t, an entry valid iff
//     0 < idx < len, falling back to row len - 1 (valid) when none is,
//     indices clipped to [0, T-1] (batched_nlmpc_soa.py:346-376);
// then the candidates' multi-start LM feasibility solves at
// m = clip(hzn, 2, n) (nlmpc_core.cuh), the horizon-1 reach check for
// hzn <= 1 lanes (|step(x, raw u_warm[0]) - x_term| <= 1e-3; their solves
// start done), the cost hzn + Qfun where feasible, the lexicographic row-min
// over laps (absent slots -inf, laps not yet stored +inf) and a first-min
// argmin in the winning row (lm_core.cuh lex_select), then the winner's
// solution, `succ` = idx + 1 <= len - 1, and the pre-freeze guess advance:
// the successor point when succ, else the winner's x_m (x_term for h1
// lanes). Computes what the composed XLA path of
// control/batched_nlmpc_soa.py (solve_step_general) computes.
//
// qsort_skip (nsi = 1): the cost hzn + Qfun is known before the solve,
// which only decides feasibility. The candidates are ranked by (Qfun,
// slot), invalid ones last, stably, and solved in that order; the lane
// stops at the first position with hzn + q >= the best cost so far, i.e.
// right after its first feasible candidate (q ascends). The first feasible
// position is the first-min argmin, so the result equals the plain order's
// bit for bit; with nothing feasible every valid candidate is solved and
// slot 0 is the fallback, as in the plain order. On the TPU a tile runs
// until every lane is skipped; here each lane breaks on its own.
//
// Design: one thread per lane, blocks of 128, the ragged edge masked; skip
// lanes write zeros and exit. The safe set is read straight from global
// memory in its batch-trailing layout (coalesced across a warp), only below
// the lap's length. Candidates that no stored row backs, and rows of laps
// not yet stored, enter their solves done (their cost is +inf whatever the
// solve says). The winner is not stored: after selection it is solved again
// through the candidates' own call site (a pure function of x, its
// terminal state, the warm start and m, so bitwise the candidate's
// solution, as the TPU kernel's store_solutions=False does). Mode and
// options are flags uniform over the grid, so one instantiation serves
// all of them.
//
// What bounds it on the card: the per-lane LM chain (up to nsi*k + 1
// solves of 2 starts x up to max_iters iterations, each with a 9x9 Cholesky
// and six rollouts with sin/cos), register spills, and warp divergence from
// the lanes' different trip counts. The enumeration reads one stored lap,
// T x 4 states (kNN) or k rows (window), and k Qfun values per lane per
// step.
#include "nlmpc_core.cuh"

namespace ilqr {

template <typename T, int N, int K, int NSI>
__global__ void __launch_bounds__(128) nlmpc_step_kernel(
    const NlmpcConsts<T> C, int B, int T_rows, bool time_varying, bool qsort,
    const T* __restrict__ x, const T* __restrict__ guess,
    const T* __restrict__ uw, const T* __restrict__ states,
    const T* __restrict__ qfun, const int* __restrict__ lap_len,
    const int* __restrict__ lap_ids, const int* __restrict__ lap_ok,
    const T* __restrict__ obs, const float* __restrict__ skip,
    const int* __restrict__ hzn, const int* __restrict__ t_in,
    const int* __restrict__ mc_in, const StepOut<T, N> out) {
  constexpr int NC = NSI * K;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  if (skip[b] > 0.5f) {
    out.skip_lane(B, b);
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

  // ---- candidate extraction, one stored lap per row ----
  T cxt[NC][4], cq[NC];
  int cidx[NC];
  bool cst[NC];
#pragma unroll
  for (int r = 0; r < NSI; ++r) {
    const T* st = states + (size_t)lap[r] * T_rows * row_stride + b;
    const T* qf = qfun + (size_t)lap[r] * T_rows * B + b;
    if (time_varying) {
      const int start = (len[r] - 1) - mc_in[b] + N + t_in[b];
      bool any = false;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int ij = start + s;
        any = any || (ij > 0 && ij < len[r]);
      }
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int c = r * K + s;
        int ij = start + s;
        bool v = ij > 0 && ij < len[r];
        if (s == 0 && !any) {  // no valid entry: the lap's last point
          ij = len[r] - 1;
          v = true;
        }
        const int ijc = ij < 0 ? 0 : (ij > T_rows - 1 ? T_rows - 1 : ij);
        const T* p = st + ijc * row_stride;
        cidx[c] = ijc;
        cst[c] = v;
#pragma unroll
        for (int q = 0; q < 4; ++q) cxt[c][q] = v ? p[q * B] : (T)0;
        cq[c] = v ? qf[(size_t)ijc * B] : (T)0;
      }
    } else {
      T dk[K];
      int ik[K];
      knn_rows<T, K>(st, row_stride, B, len[r] < T_rows ? len[r] : T_rows,
                     xg, dk, ik);
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int c = r * K + s;
        const T* p = st + ik[s] * row_stride;
        cidx[c] = ik[s];
        cst[c] = dk[s] < inf;
#pragma unroll
        for (int q = 0; q < 4; ++q) cxt[c][q] = p[q * B];
        cq[c] = qf[(size_t)ik[s] * B];
      }
    }
  }

  // ---- qsort_skip order: slots by (q, slot), invalid last (nsi = 1) ----
  T qk[K];
  int qslot[K];
  if (qsort) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      qk[s] = cst[s] && lok[0] ? cq[s] : inf;
      qslot[s] = s;
    }
#pragma unroll
    for (int i = 0; i < K - 1; ++i) {  // bubble sort: stable on ties
#pragma unroll
      for (int j = 0; j < K - 1 - i; ++j) {
        if (qk[j] > qk[j + 1]) {
          const T tq = qk[j];
          qk[j] = qk[j + 1];
          qk[j + 1] = tq;
          const int ts = qslot[j];
          qslot[j] = qslot[j + 1];
          qslot[j + 1] = ts;
        }
      }
    }
  }

  // ---- candidate solves, then the winner's re-solve (fin) ----
  T cost[NC], cmp[NC];
  T best = inf;  // qsort_skip: running best cost and its slot
  int best_slot = 0;
  int win = 0, row_sel = 0;
#pragma unroll 1
  for (int p = 0;; ++p) {
    bool fin;
    int cc;
    if (qsort) {
      fin = p >= K || (p > 0 && hf + qk[p] >= best);
      cc = fin ? best_slot : qslot[p];
      if (fin) win = cc;
    } else {
      fin = p >= NC;
      if (fin) win = lex_select<T, NSI, K>(cmp, cost, row_sel);
      cc = fin ? win : p;
    }
    const bool okc = cst[cc] && lok[cc / K];
    T xt[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) xt[q] = cxt[cc][q];
    const Shoot<T, N> S{C, x0, xt, o, mm};
    T us[N][2], xm[4], te;
    const bool feasible =
        S.feasibility_solve(warm, h1 || (!fin && !okc), us, xm, te);
    if (!fin) {
      const bool feas = h1 ? reaches(x1, xt) : feasible;
      const T c_cost = feas && okc ? hf + cq[cc] : inf;
      if (qsort) {
        if (c_cost < best) {  // ties keep the earlier position
          best = c_cost;
          best_slot = cc;
        }
      } else {
        cost[cc] = c_cost;
        cmp[cc] = lok[cc / K] ? (cst[cc] ? c_cost : -inf) : inf;
      }
      continue;
    }
    const int idx_sel = cidx[win];
    const bool succ = idx_sel + 1 <= len[row_sel] - 1;
    const int nxt = succ ? idx_sel + 1 : idx_sel;  // successor row
    const T* nx = states + ((size_t)lap[row_sel] * T_rows + nxt) *
                               row_stride + b;
    out.write(B, b, us, xm, xt, nx, h1,
              isfinite(qsort ? best : cost[win]), idx_sel, row_sel, succ);
    break;
  }
}

template <typename T, int N, int K, int NSI>
int launch_nlmpc_step(const double* consts, int max_iters, int B, int T_rows,
                      bool time_varying, bool qsort, const void* x,
                      const void* guess, const void* uw, const void* states,
                      const void* qfun, const void* lap_len,
                      const void* lap_ids, const void* lap_ok,
                      const void* obs, const void* skip, const void* hzn,
                      const void* t, const void* mc, void* us, void* fe,
                      void* ng, void* idx, void* row, void* succ,
                      cudaStream_t stream) {
  const NlmpcConsts<T> C = make_nlmpc_consts<T>(consts, max_iters);
  const StepOut<T, N> out{(T*)us, (T*)fe, (T*)ng, (int*)idx, (int*)row,
                          (T*)succ};
  nlmpc_step_kernel<T, N, K, NSI><<<(B + 127) / 128, 128, 0, stream>>>(
      C, B, T_rows, time_varying, qsort, (const T*)x, (const T*)guess,
      (const T*)uw, (const T*)states, (const T*)qfun, (const int*)lap_len,
      (const int*)lap_ids, (const int*)lap_ok, (const T*)obs,
      (const float*)skip, (const int*)hzn, (const int*)t, (const int*)mc,
      out);
  return (int)cudaGetLastError();
}

}  // namespace ilqr

// dtype: 0 float32, 1 float64; time_varying: 0 spaceVarying (t, mc unused,
// may be null), 1 timeVarying (t, min_cost (B,) i32); qsort: 1 for
// qsort_skip (nsi = 1 only). The kernel reads only the laps named by
// lap_ids. Returns the cudaError_t of the launch, or -1 when no kernel is
// instantiated for (dtype, n, k, nsi) or qsort is asked with nsi != 1.
extern "C" int nlmpc_step_launch(int dtype, int n, int k, int nsi,
                                 int time_varying, int qsort,
                                 const double* consts, int max_iters, int B,
                                 int T_rows, const void* x, const void* guess,
                                 const void* uw, const void* states,
                                 const void* qfun, const void* lap_len,
                                 const void* lap_ids, const void* lap_ok,
                                 const void* obs, const void* skip,
                                 const void* hzn, const void* t,
                                 const void* mc, void* us, void* fe,
                                 void* ng, void* idx, void* row, void* succ,
                                 void* stream) {
  if (B <= 0) return 0;
  if (qsort && nsi != 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const bool tv = time_varying != 0, qs = qsort != 0;
  if (n == 6 && k == 8 && nsi == 1 && dtype == 0)
    return ilqr::launch_nlmpc_step<float, 6, 8, 1>(
        consts, max_iters, B, T_rows, tv, qs, x, guess, uw, states, qfun,
        lap_len, lap_ids, lap_ok, obs, skip, hzn, t, mc, us, fe, ng, idx, row,
        succ, s);
  if (n == 6 && k == 8 && nsi == 1 && dtype == 1)
    return ilqr::launch_nlmpc_step<double, 6, 8, 1>(
        consts, max_iters, B, T_rows, tv, qs, x, guess, uw, states, qfun,
        lap_len, lap_ids, lap_ok, obs, skip, hzn, t, mc, us, fe, ng, idx, row,
        succ, s);
  return -1;
}
