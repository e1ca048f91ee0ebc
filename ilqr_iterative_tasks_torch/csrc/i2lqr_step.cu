// K1: one whole i2LQR control step (calc_input) per lane.
//
// Replaces ilqr_iterative_tasks_tpu/ops/pallas_i2lqr_step.py::
// build_fused_i2lqr_step (kernel :221, pallas_call :903). Per lane, each of
// 3 relaxation passes: an L1-kNN of the guess over the last nsi stored laps
// (k nearest rows, ties to the lower row; with fewer valid rows than k the
// missing slots are row 0 and not selectable), k zeros-initialised LM-iLQR
// candidate solves per lap (lm_core.cuh), the relaxed reach cost
// q + n + 100*ceil(d/unit - 1e-12) with unit = 80/10^pass and cutoff
// d <= unit*max_relax_iter, the lexicographic row-min over laps (absent
// slots rank -inf in the row compare, laps not yet stored +inf) and a
// first-min argmin in the winning row; the guess is re-centred on the
// winner's terminal state. The step ends with the shrink flag
// (idx + 1) > (lap_len - 1) of the final winner.
//
// Computes what the composed XLA path of control/batched_soa.py computes
// (the TPU kernel's oracle); for nsi = 1 that is exactly the TPU kernel.
// For a lap that is not yet stored (lap_ok = 0) the kNN runs on the clipped
// lap id, as there, and its costs are masked. None of the TPU kernel's
// options (dedup, qsort_skip, dom_skip, group, stream_safe_set, with_stats,
// reuse_extract) is ported: the shipped dedup and qsort_skip are
// bitwise-neutral, so this plain kernel computes what the bench's does.
//
// Design: one thread per lane, blocks of 128, the ragged edge masked; skip
// lanes write zeros and exit. The TPU tile's lockstep LM loop becomes each
// thread's own loop. The safe set is read straight from global memory in
// its batch-trailing layout, so a warp's reads of one row are coalesced;
// only rows below the lap's length are scanned (the others are never
// selectable). The k best rows are kept sorted in registers by insertion.
// The winning solution is not stored: after selection the winner is solved
// again through the same call site as the candidates (the solve is a pure
// function of x0, x_term and the obstacle, so this is bitwise the stored
// solution, as the TPU kernel's store_solutions=False does).
//
// What bounds it on the card: the per-lane LM dependency chain with its
// transcendentals (3 passes x (nsi*k + 1) solves of up to max_iter
// iterations each) and warp divergence from the lanes' different trip
// counts. The kNN reads 3 passes x nsi x lap_len x 5 values per lane.
#include "lm_core.cuh"

namespace ilqr {

template <typename T, int N, int K, int NSI>
__global__ void __launch_bounds__(128) i2lqr_step_kernel(
    const Consts<T> C, int B, int T_rows, const T* __restrict__ x,
    const T* __restrict__ g0, const T* __restrict__ states,
    const T* __restrict__ qfun, const int* __restrict__ lap_len,
    const int* __restrict__ lap_ids, const int* __restrict__ lap_ok,
    const T* __restrict__ obs, const float* __restrict__ skip,
    T* __restrict__ us_out, T* __restrict__ shrink_out,
    int* __restrict__ idx_out, int* __restrict__ row_out) {
  constexpr int NC = NSI * K;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  if (skip[b] > 0.5f) {
#pragma unroll
    for (int i = 0; i < 2 * N; ++i) us_out[i * B + b] = (T)0;
    shrink_out[b] = (T)0;
    idx_out[b] = 0;
    row_out[b] = 0;
    return;
  }
  const T inf = (T)INFINITY;
  T x0[4], xg[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    x0[c] = x[c * B + b];
    xg[c] = g0[c * B + b];
  }
  const Obs<T> o = load_obs(obs, B, b);
  int lap[NSI], len[NSI];
  bool lok[NSI];
#pragma unroll
  for (int r = 0; r < NSI; ++r) {
    lap[r] = lap_ids[r];
    lok[r] = lap_ok[r] != 0;
    len[r] = lap_len[(size_t)lap[r] * B + b];
  }
  const size_t row_stride = (size_t)4 * B;  // one safe-set row (4, B)

  T cxt[NC][4], cq[NC], ccost[NC];
  int cidx[NC];
  bool cok[NC];
  T us_sel[N][2];
  int idx_sel = 0, row_sel = 0;

  for (int pass = 0; pass < 3; ++pass) {
    // ---- kNN + candidate extraction, one stored lap per row ----
#pragma unroll
    for (int r = 0; r < NSI; ++r) {
      T dk[K];
      int ik[K];
      const T* st = states + (size_t)lap[r] * T_rows * row_stride + b;
      knn_rows<T, K>(st, row_stride, B, len[r] < T_rows ? len[r] : T_rows,
                     xg, dk, ik);
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int c = r * K + s;
        const T* p = st + ik[s] * row_stride;
        cidx[c] = ik[s];
        cok[c] = dk[s] < inf && lok[r];
#pragma unroll
        for (int q = 0; q < 4; ++q) cxt[c][q] = p[q * B];
        cq[c] = qfun[((size_t)lap[r] * T_rows + ik[s]) * B + b];
      }
    }
    // ---- candidate solves, then the winner's re-solve (c == NC) ----
    const T unit = C.unit[pass];
    const T cutoff = C.cutoff[pass];
    int win = 0;
    for (int c = 0; c <= NC; ++c) {
      if (c == NC) {
        // lexicographic row-min over laps (ragged list compare: absent
        // slots -inf, laps not yet stored +inf), then the first-min argmin
        // over the winning row
        T cmp[NC];
#pragma unroll
        for (int q = 0; q < NC; ++q)
          cmp[q] = lok[q / K] ? (cok[q] ? ccost[q] : -inf) : inf;
        win = lex_select<T, NSI, K>(cmp, ccost, row_sel);
        idx_sel = cidx[win];
      }
      const int cc = c < NC ? c : win;
      T xt[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) xt[q] = cxt[cc][q];
      T us[N][2];
#pragma unroll
      for (int i = 0; i < N; ++i) us[i][0] = us[i][1] = (T)0;
      const Solve<T, N> S{C, x0, xt, o};
      T xl[4], cost, dist;
      S.lm_solve(us, false, xl, cost, dist);
      if (c < NC) {
        const T i_rel = fmax(ceil(dist / unit - (T)1e-12), (T)1.0);
        T rc = dist <= cutoff ? cq[c] + (T)N + (T)100.0 * i_rel : inf;
        ccost[c] = cok[c] ? rc : inf;
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          us_sel[i][0] = us[i][0];
          us_sel[i][1] = us[i][1];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) xg[q] = xl[q];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    us_out[(2 * i) * B + b] = us_sel[i][0];
    us_out[(2 * i + 1) * B + b] = us_sel[i][1];
  }
  shrink_out[b] = (idx_sel + 1) > (len[row_sel] - 1) ? (T)1 : (T)0;
  idx_out[b] = idx_sel;
  row_out[b] = row_sel;
}

template <typename T, int N, int K, int NSI>
int launch_i2lqr_step(const double* consts, int max_iter, int B, int T_rows,
                      const void* x, const void* g0, const void* states,
                      const void* qfun, const void* lap_len,
                      const void* lap_ids, const void* lap_ok,
                      const void* obs, const void* skip, void* us,
                      void* shrink, void* idx, void* row,
                      cudaStream_t stream) {
  const Consts<T> C = make_consts<T>(consts, max_iter);
  i2lqr_step_kernel<T, N, K, NSI><<<(B + 127) / 128, 128, 0, stream>>>(
      C, B, T_rows, (const T*)x, (const T*)g0, (const T*)states,
      (const T*)qfun, (const int*)lap_len, (const int*)lap_ids,
      (const int*)lap_ok, (const T*)obs, (const float*)skip, (T*)us,
      (T*)shrink, (int*)idx, (int*)row);
  return (int)cudaGetLastError();
}

}  // namespace ilqr

#define I2LQR_CASE(TYPE, CODE, N_, K_, NSI_)                                 \
  if (dtype == CODE && n == N_ && k == K_ && nsi == NSI_)                    \
    return ilqr::launch_i2lqr_step<TYPE, N_, K_, NSI_>(                      \
        consts, max_iter, B, T_rows, x, g0, states, qfun, lap_len, lap_ids,  \
        lap_ok, obs, skip, us, shrink, idx, row, s);

// dtype: 0 float32, 1 float64. max_laps is the safe set's leading size
// (the kernel reads only the laps named by lap_ids). Returns the
// cudaError_t of the launch, or -1 when no kernel is instantiated for
// (dtype, n, k, nsi).
extern "C" int i2lqr_step_launch(int dtype, int n, int k, int nsi,
                                 const double* consts, int max_iter, int B,
                                 int T_rows, int max_laps, const void* x,
                                 const void* g0, const void* states,
                                 const void* qfun, const void* lap_len,
                                 const void* lap_ids, const void* lap_ok,
                                 const void* obs, const void* skip, void* us,
                                 void* shrink, void* idx, void* row,
                                 void* stream) {
  (void)max_laps;
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  I2LQR_CASE(float, 0, 6, 8, 1)
  I2LQR_CASE(double, 1, 6, 8, 1)
  I2LQR_CASE(float, 0, 6, 8, 2)
  I2LQR_CASE(double, 1, 6, 8, 2)
  return -1;
}
