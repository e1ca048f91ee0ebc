// K2: one whole NLMPC control step (calc_input) per lane, safe-set modes
// spaceVarying and timeVarying.
//
// Replaces ilqr_iterative_tasks_tpu/ops/pallas_nlmpc_step.py::
// build_fused_nlmpc_step in modes "spaceVarying" and "timeVarying", with
// and without qsort_skip (factory :54, kernel :245, the qsort branch
// :574-679, pallas_call :979; body _pallas_nlmpc_core.make_nlmpc_tile_funcs
// :39). Mode "all" is nlmpc_step_all.cu. Per lane, at its shrinking horizon
// hzn, per stored lap of the window (the last nsi laps): the k candidates,
// either
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
// control/batched_nlmpc_soa.py (solve_step_general) computes. Candidates
// that no stored row backs, and rows of laps not yet stored, enter their
// solves done (their cost is +inf whatever the solve says).
//
// qsort_skip (nsi = 1): the cost hzn + Qfun is known before the solve,
// which only decides feasibility. The candidates are ranked by (Qfun,
// slot), invalid ones last, as a stable sort orders them; the serial rule
// solves rank 0 and then rank p only while hzn + q[p] < the best cost so
// far, i.e. up to the first feasible rank (q ascends), which is the
// first-min argmin, so the result equals the plain order's bit for bit.
// With nothing feasible every rank with a finite key is solved and slot 0
// is the fallback, as in the plain order.
//
// Design: a tile of G threads per lane (Tile, lm_core.cuh); blocks of 128
// threads hold 128 / G lanes, the ragged edge is masked and skip lanes
// write zeros and exit, each a whole tile.
// - Plain order (nsi 1 or 2, and spaceVarying with qsort_skip): G = nsi *
//   k, one candidate a thread. Thread c = r*k + s takes slot s of lap row
//   r: the k threads of a row run its kNN together (knn_rows_group), or
//   compute their own window entry; every thread runs the unchanged
//   lex_select over the tile's costs, gathered by shuffles. spaceVarying's
//   qsort_skip needs no kernel of its own: ranked in rounds of k threads,
//   its first round holds every rank, so it solves what the plain order
//   solves (the two measured equal on an H100, PERF.md).
// - timeVarying with qsort_skip: G = K2_TV_G, every thread holds the lane's
//   k window slots, their Qfun keys and the stable rank order. Round r
//   gives thread j the rank r*G + j, solved under the serial rule; a ballot
//   over the round's feasible threads picks the lowest, the first feasible
//   rank, and the rounds stop there (the solves past it are speculative:
//   pure functions that only cost time).
// The winner's thread holds its solution and writes the outputs
// (StepOut::write), so a winner is not solved again: the solve is a pure
// function of x, x_term, the warm start, m and done0, so this is bitwise
// the one-thread design's re-solve, which ran with done0 = h1. Only where
// the winner's own solve started done on a lane with h > 1 (a candidate
// that no stored row backs, or a lap not yet stored: its cost is +inf, so
// only as a fallback) is it solved again with done0 = h1, as the re-solve
// was. The safe set is read from global memory in its batch-trailing
// layout; only rows below the lap's length are scanned. Mode is a flag
// uniform over the grid.
//
// What bounds it on the card: the per-candidate LM chains (2 starts x up to
// max_iters iterations, each with a 9x9 Cholesky and six rollouts with
// sin/cos) and warp divergence between the chains a warp holds; the solve's
// registers set the resident warps (the cap below). The earlier
// one-thread-a-lane design ran up to nsi*k + 1 solves in series a lane
// (the winner again after selection) with the lane's candidate table in
// registers, and its kNN on one thread. The enumeration reads one stored
// lap, T x 4 states (kNN) or k rows (window), and k Qfun values per lane
// per step.
#include "nlmpc_core.cuh"

namespace ilqr {

// G, the threads a lane of timeVarying under qsort_skip, and the least
// blocks of 128 threads an SM must hold there (__launch_bounds__, which
// caps the registers a thread may use). Of G = 1, 2, 4, 8 and caps 1, 3, 4
// on an H100, one thread capped at 3 blocks (168 registers, 12 warps an
// SM) took the least K2 device time over the timeVarying headline
// (PERF.md, experiments/kernel_ab.py). The plain order runs uncapped: at 8
// threads a lane, caps of 3 and 4 blocks cost spaceVarying 5 and 46 % of
// its device time there.
constexpr int K2_TV_G = 1;
constexpr int K2_TV_MIN_BLOCKS = 3;

// Entry s of the advancing window from `start` over a lap of length len
// (`any`: some entry is valid); sets its validity v, returns its row.
__device__ __forceinline__ int window_row(int start, int s, int len,
                                          bool any, int T_rows, bool& v) {
  int ij = start + s;
  v = ij > 0 && ij < len;
  if (s == 0 && !any) {  // no valid entry: the lap's last point
    ij = len - 1;
    v = true;
  }
  return ij < 0 ? 0 : (ij > T_rows - 1 ? T_rows - 1 : ij);
}

template <int K>
__device__ __forceinline__ bool window_any(int start, int len) {
  bool any = false;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int ij = start + s;
    any = any || (ij > 0 && ij < len);
  }
  return any;
}

template <typename T, int N, int K, int NSI, int G, bool QSORT>
__global__ void __launch_bounds__(128, QSORT ? K2_TV_MIN_BLOCKS : 1)
    nlmpc_step_kernel(
    const NlmpcConsts<T> C, int B, int T_rows, bool time_varying,
    const T* __restrict__ x, const T* __restrict__ guess,
    const T* __restrict__ uw, const T* __restrict__ states,
    const T* __restrict__ qfun, const int* __restrict__ lap_len,
    const int* __restrict__ lap_ids, const int* __restrict__ lap_ok,
    const T* __restrict__ obs, const float* __restrict__ skip,
    const int* __restrict__ hzn, const int* __restrict__ t_in,
    const int* __restrict__ mc_in, const StepOut<T, N> out) {
  static_assert(128 % G == 0, "a block holds whole lanes");
  static_assert(QSORT ? (NSI == 1 && G <= K && K <= 16) : G == NSI * K,
                "qsort_skip (timeVarying): one row of at most 16 slots; "
                "else one candidate a thread");
  const Tile<G> tl;
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (b >= B) return;
  const int j = tl.rank;
  if (skip[b] > 0.5f) {
    if (j == 0) out.skip_lane(B, b);
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
  bool lok[NSI];
#pragma unroll
  for (int rr = 0; rr < NSI; ++rr) lok[rr] = lap_ok[rr] != 0;
  // this thread's lap row: the one row, or row r of its candidate
  const int r = QSORT ? 0 : j / K;
  const bool lok_r = lap_ok[r] != 0;
  const int lap = lap_ids[r];
  const int len = lap_len[(size_t)lap * B + b];
  const int rows = len < T_rows ? len : T_rows;
  const size_t row_stride = (size_t)4 * B;  // one safe-set row (4, B)
  const T* st = states + (size_t)lap * T_rows * row_stride + b;
  const T* qf = qfun + (size_t)lap * T_rows * B + b;
  int start = 0;
  bool any = false;
  if (time_varying) {
    start = (len - 1) - mc_in[b] + N + t_in[b];
    any = window_any<K>(start, len);
  }

  // ---- candidates: this thread's (ci its row, cval backed by a stored
  // row, cq its Qfun); under qsort_skip (timeVarying) every slot's window
  // row sidx, validity (vmask) and key qk (Qfun where valid and the lap
  // stored, else +inf), the slots in rank order (4 bits a rank) and the
  // ranks to solve ----
  int ci = 0;
  bool cval = false;
  T cq = (T)0;
  int sidx[QSORT ? K : 1];
  T qk[QSORT ? K : 1];
  unsigned vmask = 0;
  unsigned long long order = 0;
  int nsolve = 1;
  if constexpr (QSORT) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bool v;
      sidx[s] = window_row(start, s, len, any, T_rows, v);
      vmask |= (unsigned)v << s;
    }
    int finite = 0;
#pragma unroll
    for (int s = 0; s < K; ++s)
      qk[s] = ((vmask >> s) & 1u) && lok_r ? qf[(size_t)sidx[s] * B] : inf;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      int rank = 0;  // stable (key, slot) order
#pragma unroll
      for (int s2 = 0; s2 < K; ++s2)
        rank += qk[s2] < qk[s] || (qk[s2] == qk[s] && s2 < s);
      order |= (unsigned long long)s << (4 * rank);
      finite += hf + qk[s] < inf;
    }
    nsolve = finite > 1 ? finite : 1;  // rank 0 always
  } else {
    const int s = j % K;
    if (time_varying) {
      ci = window_row(start, s, len, any, T_rows, cval);
    } else {
      T d;
      knn_rows_group<T, K, G>(tl, s, st, row_stride, B, rows, xg, d, ci);
      cval = d < inf;
    }
    cq = cval ? qf[(size_t)ci * B] : (T)0;
  }

  // ---- rounds of solves (one for the plain order), then the winner's
  // write; `fin`: the winner is solved again with done0 = h1 ----
  bool fin = false;
  int win = 0;  // plain order: the winning thread
#pragma unroll 1
  for (int round = 0;; ++round) {
    bool go;
    int slot = 0;
    if constexpr (QSORT) {
      const int p = round * G + j;
      go = fin ? j == 0 : p < nsolve;
      slot = fin ? 0 : (int)((order >> (4 * (p < K ? p : 0))) & 15u);
#pragma unroll
      for (int s = 0; s < K; ++s)
        if (s == slot) {
          ci = sidx[s];
          cq = qk[s];
        }
      cval = (vmask >> slot) & 1u;
    } else {
      go = !fin || j == win;
    }
    const bool okc = cval && lok_r;
    T xt[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      xt[q] = go && (cval || !time_varying)
                  ? st[(size_t)ci * row_stride + q * B] : (T)0;
    T us[N][2], xm[4], te;
    bool feasible = false;
    if (go) {
      const Shoot<T, N> S{C, x0, xt, o, mm};
      feasible = S.feasibility_solve(warm, h1 || (!fin && !okc), us, xm, te);
    }
    bool write = go, feas_out = false;
    if (!fin) {
      const bool feas = h1 ? reaches(x1, xt) : feasible;
      const T cost = go && feas && okc ? hf + cq : inf;
      // this solve is the winner's re-solve (it ran with done0 = h1)
      const bool held = go && (h1 || okc);
      if constexpr (QSORT) {
        const unsigned found = tl.ballot(cost < inf);
        if (found) {  // the first feasible rank wins
          write = j == __ffs(found) - 1;
          feas_out = true;
        } else if ((round + 1) * G < nsolve) {
          continue;
        } else {  // nothing feasible: slot 0, held if this round solved it
          const unsigned h0 = tl.ballot(held && slot == 0);
          fin = h0 == 0;
          if (fin) continue;
          write = j == __ffs(h0) - 1;
        }
      } else {
        T cst[G], cmp[G];
        const unsigned stm = tl.ballot(cval);
#pragma unroll
        for (int q = 0; q < G; ++q) {
          cst[q] = tl.shfl(cost, q);
          cmp[q] = lok[q / K] ? ((stm >> q) & 1u ? cst[q] : -inf) : inf;
        }
        int row_sel;
        win = lex_select<T, NSI, K>(cmp, cst, row_sel);
        feas_out = (tl.ballot(cost < inf) >> win) & 1u;
        fin = !feas_out && !((tl.ballot(held) >> win) & 1u);
        if (fin) continue;
        write = j == win;
      }
    }
    if (write) {
      const bool succ = ci + 1 <= len - 1;
      const int nxt = succ ? ci + 1 : ci;  // successor row
      out.write(B, b, us, xm, xt, st + (size_t)nxt * row_stride, h1,
                feas_out, ci, r, succ);
    }
    break;
  }
}

// The kernel for (dtype, sizes, mode, qsort) and its threads a lane:
// timeVarying's qsort_skip at K2_TV_G threads, else the plain order at one
// thread a candidate.
template <typename T, int N, int K, int NSI>
struct StepKernel {
  using F = decltype(&nlmpc_step_kernel<T, N, K, NSI, NSI * K, false>);
  F f = &nlmpc_step_kernel<T, N, K, NSI, NSI * K, false>;
  int g = NSI * K;
  StepKernel(bool time_varying, bool qsort) {
    if constexpr (NSI == 1) {
      if (qsort && time_varying) {
        f = &nlmpc_step_kernel<T, N, K, 1, K2_TV_G, true>;
        g = K2_TV_G;
      }
    }
  }
};

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
  const StepKernel<T, N, K, NSI> kern(time_varying, qsort);
  const auto f = kern.f;
  const int lanes_per_block = 128 / kern.g;
  f<<<(B + lanes_per_block - 1) / lanes_per_block, 128, 0, stream>>>(
      C, B, T_rows, time_varying, (const T*)x, (const T*)guess,
      (const T*)uw, (const T*)states, (const T*)qfun, (const int*)lap_len,
      (const int*)lap_ids, (const int*)lap_ok, (const T*)obs,
      (const float*)skip, (const int*)hzn, (const int*)t, (const int*)mc,
      out);
  return (int)cudaGetLastError();
}

}  // namespace ilqr

#define NLMPC_STEP_CASE(TYPE, CODE, N_, K_, NSI_)                            \
  if (dtype == CODE && n == N_ && k == K_ && nsi == NSI_)                    \
    return ilqr::launch_nlmpc_step<TYPE, N_, K_, NSI_>(                      \
        consts, max_iters, B, T_rows, tv, qs, x, guess, uw, states, qfun,    \
        lap_len, lap_ids, lap_ok, obs, skip, hzn, t, mc, us, fe, ng, idx,    \
        row, succ, s);

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
  NLMPC_STEP_CASE(float, 0, 6, 8, 1)
  NLMPC_STEP_CASE(double, 1, 6, 8, 1)
  NLMPC_STEP_CASE(float, 0, 6, 8, 2)
  NLMPC_STEP_CASE(double, 1, 6, 8, 2)
  return -1;
}

#define NLMPC_STEP_ATTRIBUTES(TYPE, CODE, N_, K_, NSI_)                      \
  if (dtype == CODE && n == N_ && k == K_ && nsi == NSI_)                    \
    return ilqr::kernel_attributes(                                          \
        ilqr::StepKernel<TYPE, N_, K_, NSI_>(tv, qs).f, 128, out);

// The resources of the kernel that nlmpc_step_launch runs for the same
// (dtype, n, k, nsi, time_varying, qsort), as the runtime reports them
// (kernel_attributes, lm_core.cuh); -1 when none is instantiated.
extern "C" int nlmpc_step_attributes(int dtype, int n, int k, int nsi,
                                     int time_varying, int qsort, int* out) {
  if (qsort && nsi != 1) return -1;
  const bool tv = time_varying != 0, qs = qsort != 0;
  NLMPC_STEP_ATTRIBUTES(float, 0, 6, 8, 1)
  NLMPC_STEP_ATTRIBUTES(double, 1, 6, 8, 1)
  NLMPC_STEP_ATTRIBUTES(float, 0, 6, 8, 2)
  NLMPC_STEP_ATTRIBUTES(double, 1, 6, 8, 2)
  return -1;
}
