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
// Design: a tile of G = nsi * k threads per lane, one thread per
// candidate (Tile, lm_core.cuh); blocks of 128 threads hold 128 / G lanes,
// the ragged edge is masked and skip lanes write zeros and exit, each a
// whole tile. Per pass, the k threads of lap row r run the kNN of that lap
// together (knn_rows_group: thread s scans rows s, s + k, ... and a merge
// by (distance, row) gives knn_rows' rows in its order), thread c = r*k + s
// solves candidate s of row r (zeros-initialised lm_solve) and its reach
// cost, and every thread runs the unchanged lex_select over the tile's
// costs, gathered by shuffles. The winner's thread holds its solution: the
// new guess is its terminal state, broadcast by shuffles, and after the
// last pass it writes us, so the winner is never solved again (the solve
// is a pure function of x0, x_term and the obstacle; this is bitwise what
// the one-thread design's re-solve gave). A thread keeps only its own
// candidate in registers. The safe set is read from global memory in its
// batch-trailing layout; only rows below the lap's length are scanned.
//
// What bounds it on the card: the per-candidate LM dependency chain with
// its transcendentals (3 passes x one solve of up to max_iter iterations a
// thread) and warp divergence between the trip counts of the 32 / G lanes'
// candidates a warp holds; the solve's registers set the resident warps
// (K1_MIN_BLOCKS). The earlier one-thread-a-lane design ran
// 3 x (nsi*k + 1) solves in series a thread and kept the lane's candidate
// table in registers. The kNN reads 3 passes x nsi x lap_len x 5 values a
// lane.
//
// More candidates than a warp holds (k = 32, nsi 2 and 4: the robustness
// sweep's k32 / nsi4 candidate set, experiments/scenario_sweep.py) run in
// i2lqr_step_block_kernel: a lane is a block of nsi * 32 threads, warp r
// lap row r and its thread s candidate s. The kNN is the warp's
// (knn_rows_group over the lap with lists of depth ceil(T / 32): a thread
// sees at most that many rows, so deeper lists would hold only +inf); the
// candidates' compare values and costs go to shared memory, and after a
// barrier every thread runs lex_select over that table; the winner's
// thread writes its terminal state and kNN row there, and after a second
// barrier every thread reads the new guess. A skip lane is a whole block
// and exits before any barrier. What bounds it is the tile's: the
// candidates' LM chains (on an H100 a candidate solve costs the step as
// much as in the tile kernel), plus a block's wait at each pass's barriers
// for the slowest of its nsi * 32 solves.
#include "lm_core.cuh"

namespace ilqr {

// The least blocks of 128 threads an SM must hold (__launch_bounds__),
// which caps the registers a thread may use: 4 blocks, 128 registers and
// 16 warps an SM, against 233 registers and 8 warps uncapped (f32, nsi 1).
// The capped build spills a little and was the fastest of 1, 3, 4 and 5
// at every capture on an H100 (PERF.md, experiments/kernel_ab.py).
constexpr int K1_MIN_BLOCKS = 4;

template <typename T, int N, int K, int NSI>
__global__ void __launch_bounds__(128, K1_MIN_BLOCKS) i2lqr_step_kernel(
    const Consts<T> C, int B, int T_rows, const T* __restrict__ x,
    const T* __restrict__ g0, const T* __restrict__ states,
    const T* __restrict__ qfun, const int* __restrict__ lap_len,
    const int* __restrict__ lap_ids, const int* __restrict__ lap_ok,
    const T* __restrict__ obs, const float* __restrict__ skip,
    T* __restrict__ us_out, T* __restrict__ shrink_out,
    int* __restrict__ idx_out, int* __restrict__ row_out) {
  constexpr int G = NSI * K;  // threads a lane, one a candidate
  static_assert(128 % G == 0, "a block holds whole lanes");
  const Tile<G> tl;
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (b >= B) return;
  const int c = tl.rank;  // candidate s = c % K of lap row r = c / K
  const int r = c / K, s = c % K;
  if (skip[b] > 0.5f) {
    for (int i = c; i < 2 * N; i += G) us_out[i * B + b] = (T)0;
    if (c == 0) {
      shrink_out[b] = (T)0;
      idx_out[b] = 0;
      row_out[b] = 0;
    }
    return;
  }
  const T inf = (T)INFINITY;
  T x0[4], xg[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    x0[q] = x[q * B + b];
    xg[q] = g0[q * B + b];
  }
  const Obs<T> o = load_obs(obs, B, b);
  bool lok[NSI];
#pragma unroll
  for (int rr = 0; rr < NSI; ++rr) lok[rr] = lap_ok[rr] != 0;
  const int lap = lap_ids[r];
  const bool lap_stored = lap_ok[r] != 0;
  const int len = lap_len[(size_t)lap * B + b];
  const int rows = len < T_rows ? len : T_rows;
  const size_t row_stride = (size_t)4 * B;  // one safe-set row (4, B)
  const T* st = states + (size_t)lap * T_rows * row_stride + b;

  T us[N][2];
  int win = 0, idx_sel = 0, row_sel = 0;
  for (int pass = 0; pass < 3; ++pass) {
    // ---- kNN of this thread's lap row, then its candidate ----
    T dk;
    int ik;
    knn_rows_group<T, K, G>(tl, s, st, row_stride, B, rows, xg, dk, ik);
    const bool cok = dk < inf && lap_stored;
    T xt[4];
    const T* p = st + ik * row_stride;
#pragma unroll
    for (int q = 0; q < 4; ++q) xt[q] = p[q * B];
    const T cq = qfun[((size_t)lap * T_rows + ik) * B + b];
    // ---- its zeros-initialised solve and relaxed reach cost ----
#pragma unroll
    for (int i = 0; i < N; ++i) us[i][0] = us[i][1] = (T)0;
    const Solve<T, N> S{C, x0, xt, o};
    T xl[4], cost, dist;
    S.lm_solve(us, false, xl, cost, dist);
    const T unit = C.unit[pass];
    const T i_rel = fmax(ceil(dist / unit - (T)1e-12), (T)1.0);
    const T rc = dist <= C.cutoff[pass] ? cq + (T)N + (T)100.0 * i_rel : inf;
    const T ccost = cok ? rc : inf;
    // ---- selection over the tile's candidates, in every thread:
    // lexicographic row-min over laps (ragged list compare: absent slots
    // -inf, laps not yet stored +inf), then the first-min argmin over the
    // winning row ----
    T cmp[G], cst[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      cst[q] = tl.shfl(ccost, q);
      const bool okq = tl.shfl((int)cok, q) != 0;
      cmp[q] = lok[q / K] ? (okq ? cst[q] : -inf) : inf;
    }
    win = lex_select<T, NSI, K>(cmp, cst, row_sel);
    idx_sel = tl.shfl(ik, win);
    // the guess re-centres on the winner's terminal state
#pragma unroll
    for (int q = 0; q < 4; ++q) xg[q] = tl.shfl(xl[q], win);
  }
  if (c == win) {  // the winner's thread holds its solution
#pragma unroll
    for (int i = 0; i < N; ++i) {
      us_out[(2 * i) * B + b] = us[i][0];
      us_out[(2 * i + 1) * B + b] = us[i][1];
    }
    const int len_sel = lap_len[(size_t)lap_ids[row_sel] * B + b];
    shrink_out[b] = (idx_sel + 1) > (len_sel - 1) ? (T)1 : (T)0;
    idx_out[b] = idx_sel;
    row_out[b] = row_sel;
  }
}

// The resident warps an SM that __launch_bounds__ asks of the block
// kernel (NSI * 32 threads a block: 16 / NSI blocks), which caps its
// registers as K1_MIN_BLOCKS caps the tile kernel's: 128 a thread. It
// spills a little and was the fastest of 8 (uncapped), 16 and 24 warps
// at every capture on an H100 (PERF.md, experiments/kernel_ab.py).
constexpr int K1_BLOCK_MIN_WARPS = 16;
constexpr int K1_BLOCK_K = 32;  // candidates a lap row: a warp

// One lane a block of NSI * 32 threads (header). D: the depth of a
// thread's kNN list; the launcher runs it only for T_rows <= 32 * D.
template <typename T, int N, int NSI, int D>
__global__ void __launch_bounds__(NSI * K1_BLOCK_K,
                                  K1_BLOCK_MIN_WARPS / NSI)
    i2lqr_step_block_kernel(
        const Consts<T> C, int B, int T_rows, const T* __restrict__ x,
        const T* __restrict__ g0, const T* __restrict__ states,
        const T* __restrict__ qfun, const int* __restrict__ lap_len,
        const int* __restrict__ lap_ids, const int* __restrict__ lap_ok,
        const T* __restrict__ obs, const float* __restrict__ skip,
        T* __restrict__ us_out, T* __restrict__ shrink_out,
        int* __restrict__ idx_out, int* __restrict__ row_out) {
  constexpr int K = K1_BLOCK_K, G = NSI * K;
  __shared__ T s_cmp[G], s_cost[G];  // the lane's selection table
  __shared__ T s_xg[4];              // the winner's terminal state
  __shared__ int s_idx;              // and its kNN row
  const int b = blockIdx.x;
  const int c = threadIdx.x;  // candidate s = c % K of lap row r = c / K
  const int r = c / K, s = c % K;
  if (skip[b] > 0.5f) {  // the whole block: no barrier is reached
    for (int i = c; i < 2 * N; i += G) us_out[i * B + b] = (T)0;
    if (c == 0) {
      shrink_out[b] = (T)0;
      idx_out[b] = 0;
      row_out[b] = 0;
    }
    return;
  }
  const Tile<K> warp;
  const T inf = (T)INFINITY;
  T x0[4], xg[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    x0[q] = x[q * B + b];
    xg[q] = g0[q * B + b];
  }
  const Obs<T> o = load_obs(obs, B, b);
  const int lap = lap_ids[r];
  const bool lap_stored = lap_ok[r] != 0;
  const int len = lap_len[(size_t)lap * B + b];
  const int rows = len < T_rows ? len : T_rows;
  const size_t row_stride = (size_t)4 * B;  // one safe-set row (4, B)
  const T* st = states + (size_t)lap * T_rows * row_stride + b;

  T us[N][2];
  int win = 0, idx_sel = 0, row_sel = 0;
  for (int pass = 0; pass < 3; ++pass) {
    // ---- kNN of this warp's lap row, then this thread's candidate ----
    T dk;
    int ik;
    knn_rows_group<T, K, K, D>(warp, s, st, row_stride, B, rows, xg, dk,
                               ik);
    const bool cok = dk < inf && lap_stored;
    T xt[4];
    const T* p = st + ik * row_stride;
#pragma unroll
    for (int q = 0; q < 4; ++q) xt[q] = p[q * B];
    const T cq = qfun[((size_t)lap * T_rows + ik) * B + b];
#pragma unroll
    for (int i = 0; i < N; ++i) us[i][0] = us[i][1] = (T)0;
    const Solve<T, N> S{C, x0, xt, o};
    T xl[4], cost, dist;
    S.lm_solve(us, false, xl, cost, dist);
    const T unit = C.unit[pass];
    const T i_rel = fmax(ceil(dist / unit - (T)1e-12), (T)1.0);
    const T rc = dist <= C.cutoff[pass] ? cq + (T)N + (T)100.0 * i_rel : inf;
    const T ccost = cok ? rc : inf;
    // ---- the selection table in shared memory (ragged list compare:
    // absent slots -inf, laps not yet stored +inf), read by every thread
    s_cmp[c] = lap_stored ? (cok ? ccost : -inf) : inf;
    s_cost[c] = ccost;
    __syncthreads();
    const T* cmp_t = s_cmp;
    const T* cost_t = s_cost;
    win = lex_select<T, NSI, K>(cmp_t, cost_t, row_sel);
    if (c == win) {  // the guess re-centres on the winner's terminal state
#pragma unroll
      for (int q = 0; q < 4; ++q) s_xg[q] = xl[q];
      s_idx = ik;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) xg[q] = s_xg[q];
    idx_sel = s_idx;
  }
  if (c == win) {  // the winner's thread holds its solution
#pragma unroll
    for (int i = 0; i < N; ++i) {
      us_out[(2 * i) * B + b] = us[i][0];
      us_out[(2 * i + 1) * B + b] = us[i][1];
    }
    const int len_sel = lap_len[(size_t)lap_ids[row_sel] * B + b];
    shrink_out[b] = (idx_sel + 1) > (len_sel - 1) ? (T)1 : (T)0;
    idx_out[b] = idx_sel;
    row_out[b] = row_sel;
  }
}

template <typename T, int N, int NSI, int D>
int launch_i2lqr_step_block(const double* consts, int max_iter, int B,
                            int T_rows, const void* x, const void* g0,
                            const void* states, const void* qfun,
                            const void* lap_len, const void* lap_ids,
                            const void* lap_ok, const void* obs,
                            const void* skip, void* us, void* shrink,
                            void* idx, void* row, cudaStream_t stream) {
  if (T_rows > K1_BLOCK_K * D) return -1;  // a thread would drop rows
  const Consts<T> C = make_consts<T>(consts, max_iter);
  i2lqr_step_block_kernel<T, N, NSI, D><<<B, NSI * K1_BLOCK_K, 0, stream>>>(
      C, B, T_rows, (const T*)x, (const T*)g0, (const T*)states,
      (const T*)qfun, (const int*)lap_len, (const int*)lap_ids,
      (const int*)lap_ok, (const T*)obs, (const float*)skip, (T*)us,
      (T*)shrink, (int*)idx, (int*)row);
  return (int)cudaGetLastError();
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
  constexpr int lanes_per_block = 128 / (NSI * K);
  i2lqr_step_kernel<T, N, K, NSI>
      <<<(B + lanes_per_block - 1) / lanes_per_block, 128, 0, stream>>>(
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

// k = 32: one lane a block, kNN lists of depth 4 (T <= 128 rows).
#define I2LQR_BLOCK_CASE(TYPE, CODE, N_, NSI_)                              \
  if (dtype == CODE && n == N_ && k == 32 && nsi == NSI_)                    \
    return ilqr::launch_i2lqr_step_block<TYPE, N_, NSI_, 4>(                 \
        consts, max_iter, B, T_rows, x, g0, states, qfun, lap_len, lap_ids,  \
        lap_ok, obs, skip, us, shrink, idx, row, s);

// dtype: 0 float32, 1 float64. max_laps is the safe set's leading size
// (the kernel reads only the laps named by lap_ids). Returns the
// cudaError_t of the launch, or -1 when no kernel is instantiated for
// (dtype, n, k, nsi) or, at k = 32, for more than 128 rows T.
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
  I2LQR_BLOCK_CASE(float, 0, 6, 2)
  I2LQR_BLOCK_CASE(double, 1, 6, 2)
  I2LQR_BLOCK_CASE(float, 0, 6, 4)
  I2LQR_BLOCK_CASE(double, 1, 6, 4)
  return -1;
}

#define I2LQR_ATTRIBUTES(TYPE, CODE, N_, K_, NSI_)                           \
  if (dtype == CODE && n == N_ && k == K_ && nsi == NSI_)                    \
    return ilqr::kernel_attributes(                                          \
        ilqr::i2lqr_step_kernel<TYPE, N_, K_, NSI_>, 128, out);

#define I2LQR_BLOCK_ATTRIBUTES(TYPE, CODE, N_, NSI_)                        \
  if (dtype == CODE && n == N_ && k == 32 && nsi == NSI_)                    \
    return ilqr::kernel_attributes(                                          \
        ilqr::i2lqr_step_block_kernel<TYPE, N_, NSI_, 4>,                    \
        NSI_ * ilqr::K1_BLOCK_K, out);

// The loaded kernel's resources for (dtype, n, k, nsi), as the runtime
// reports them (kernel_attributes, tile.cuh); -1 when no kernel is
// instantiated.
extern "C" int i2lqr_step_attributes(int dtype, int n, int k, int nsi,
                                     int* out) {
  I2LQR_ATTRIBUTES(float, 0, 6, 8, 1)
  I2LQR_ATTRIBUTES(double, 1, 6, 8, 1)
  I2LQR_ATTRIBUTES(float, 0, 6, 8, 2)
  I2LQR_ATTRIBUTES(double, 1, 6, 8, 2)
  I2LQR_BLOCK_ATTRIBUTES(float, 0, 6, 2)
  I2LQR_BLOCK_ATTRIBUTES(double, 1, 6, 2)
  I2LQR_BLOCK_ATTRIBUTES(float, 0, 6, 4)
  I2LQR_BLOCK_ATTRIBUTES(double, 1, 6, 4)
  return -1;
}
