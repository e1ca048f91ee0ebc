// K2 in safe-set mode "all": one whole NLMPC control step per lane where
// every stored point of each lap row is a candidate.
//
// Replaces ilqr_iterative_tasks_tpu/ops/pallas_nlmpc_step.py::
// build_fused_nlmpc_step in mode "all" (kernel :245, the all-mode branches
// :412-572, pallas_call :979), with and without all_iter and all_rev_skip.
// Per lane, at its shrinking horizon hzn, over the lap rows named by
// lap_ids (the last nsi stored laps, or with all_iter every slot, those
// not yet stored flagged by lap_ok): each stored position t < len of a row
// is a candidate with cost hzn + Qfun[t] where its feasibility solve (or,
// for hzn <= 1 lanes, the reach check) passes; the rows are compared as
// Python compares lists (positions at or past a row's length rank -inf,
// rows of laps not yet stored +inf) and the winning row's first-min
// position is the winner, whose solution, successor and guess advance
// follow as in nlmpc_step.cu. Computes what the composed XLA path of
// control/batched_nlmpc_soa.py (solve_step_general, mode "all") computes.
//
// Forward scan: per row, positions in order. The best row's compare list
// lives in a (T, B) global scratch (coalesced per position); the current
// row is compared with it as it is solved, so only the first differing
// position decides: a row found greater stops at once (its later
// positions count for nothing and, past the current chunk, are never
// solved), a row found smaller writes its values from
// there on and becomes the best with its running first-min. Rows of laps
// not yet stored (all +inf) never rank below the best and are skipped;
// until a row is taken the best is an all-+inf row 0, which is what the
// plain version's fold starts from in effect. With one row (no all_iter,
// nsi = 1) no scratch is used.
//
// all_rev_skip (one row): Qfun = len - 1 - t strictly decreases in t, so
// the first-min is the LAST feasible position and no two costs tie. The
// lane scans positions descending and stops at its first feasible one;
// positions beyond the reach bound, xy distance from x over
// n dt |v0| + a_max dt^2 n^2 / 2 + 1, are known infeasible (the clipped
// rollout cannot cover more, and the margin exceeds the 1e-4 terminal and
// 1e-3 reach tolerances) and are not solved. A lane with nothing feasible
// keeps position 0, as the forward scan does. Bitwise equal to it.
//
// Design: a tile of G threads per lane (Tile, lm_core.cuh; G is the
// compile-time K2_ALL_G, 32: one lane a warp), blocks of 128 threads
// holding 128 / G lanes; the ragged edge and skip lanes leave as whole
// tiles (skip lanes write zeros).
// Each round the tile solves up to G positions at once, one a thread,
// through the one call site of the feasibility solve (nlmpc_core.cuh):
// - all_rev_skip: thread q tests position t - q against the reach bound,
//   a ballot compacts the in-reach ones, and windows are taken until G
//   in-reach positions (or the lap's start) are found; thread q solves the
//   q-th in descending order. A ballot of the feasible ones picks the
//   lowest thread, the highest feasible position, which is the first one
//   the serial descending scan meets: that thread holds its solution and
//   writes the outputs, and the tile is done. Otherwise the next round
//   goes on below.
// - the forward scan (one row, or all_iter's rows): the tile solves the G
//   positions t .. t + G - 1 of the current row (those below its length);
//   thread 0 folds the G costs, gathered by shuffles, in position order
//   with the serial scan's fold, first-min and stopping rule, and alone
//   reads and writes the scratch; the scan's state is then broadcast. A
//   row found greater stops the fold, and the chunk's later solves are
//   discarded. After the last row every thread solves the winner again
//   and thread 0 writes the outputs.
// A lane with nothing feasible keeps position 0, solved in a last round.
// zeros_skip is an instantiation of its own (ZSKIP: every feasibility
// solve skips its zeros start where its warm start converged,
// nlmpc_core.cuh), which changes results.
// Every position's solve is a pure function of (x0, warm, x_term, obs,
// hzn), and each variant decides in the serial scan's order, so the
// outputs are bitwise those of the one-thread-a-lane scan; the solves past
// the stopping point cost only time.
//
// What bounds it on the card: the per-position LM chains (up to 2 starts x
// max_iters iterations each), and warp divergence between the positions a
// warp's threads solve; a lane's scan takes ceil(positions / G) rounds.
// The earlier one-thread-a-lane design ran every position of a lane in
// series, with B / 128 blocks (64 at the all headline's B = 8 192, on 132
// SMs).
#include <cuda_runtime.h>

#ifdef K1_COUNT_SOLVES
// a counting build's events (tile.cuh): zeros starts zeros_skip skipped
namespace ilqr {
__device__ unsigned long long k2_all_events[1];
}
#define K2_ON_ZSKIP() ILQR_EVENT(k2_all_events, 0)
#endif

#include "nlmpc_core.cuh"

namespace ilqr {

// G, the threads a lane: 32, one lane a warp, was the fastest of G = 4, 8,
// 16 and 32 at the all headline's lap-2 capture on an H100 (PERF.md,
// experiments/kernel_ab.py).
constexpr int K2_ALL_G = 32;

// the index of the n-th (from 0) set bit of m, which has more than n
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  for (int i = 0; i < n; ++i) m &= m - 1;
  return __ffs(m) - 1;
}

template <typename T, int N, int G, bool ZSKIP = false>
__global__ void __launch_bounds__(128) nlmpc_step_all_kernel(
    const NlmpcConsts<T> C, T rb_v, T rb_c, int B, int nb, int T_rows,
    int n_rows, bool rev, const T* __restrict__ x, const T* __restrict__ uw,
    const T* __restrict__ states, const T* __restrict__ qfun,
    const int* __restrict__ lap_len, const int* __restrict__ lap_ids,
    const int* __restrict__ lap_ok, const T* __restrict__ obs,
    const float* __restrict__ skip, const int* __restrict__ hzn,
    T* __restrict__ scratch, const StepOut<T, N> out) {
  static_assert(128 % G == 0, "a block holds whole lanes");
  const Tile<G> tl;
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (b >= nb) return;
  const int j = tl.rank;
  if (skip[b] > 0.5f) {
    if (j == 0) out.skip_lane(B, b);
    return;
  }
  const T inf = (T)INFINITY;
  T x0[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) x0[c] = x[c * B + b];
  const Obs7<T> o = load_obs7(C, obs, B, b);
  const int h = hzn[b];
  const int mm = h < 2 ? 2 : (h > N ? N : h);
  const bool h1 = h <= 1;
  const T hf = (T)h;
  T warm[2 * N];
  load_warm<T, N>(C, uw, B, b, warm);
  T x1[4];  // horizon-1 reach state: one step of the raw first warm input
  step_dt(C.dt, x0, uw[b], uw[B + b], x1);
  const size_t row_stride = (size_t)4 * B;  // one safe-set row (4, B)
  const T rb = rb_v * fabs(x0[2]) + rb_c;  // all_rev_skip reach bound
  const T rb2 = rb * rb;
  const bool multi = n_rows > 1;

  // the scan's state, the same in every thread of the tile
  // the best row so far; `virt`: none taken yet (an all-+inf row 0)
  bool virt = true;
  int best_row = 0, best_idx = 0, best_len = 0;
  T best_cost = inf;
  // the row being scanned: its next position t, compare state dec (0
  // equal so far, -1 below the best, +1 above) and running first-min
  int r = -1, len = 0, t = 0, dec = 0, tmax = 0, rarg = 0;
  T rmin = inf;
  bool in_row = false;
  const T* st = nullptr;
  const T* qf = nullptr;
  // fold the current row's compare value at t into dec and the scratch
  // (thread 0 only)
  auto fold = [&](T cv) {
    if (dec == 0) {
      const T bv = virt ? inf
                        : (t < best_len ? scratch[(size_t)t * B + b] : -inf);
      if (cv != bv) dec = cv < bv ? -1 : 1;
    }
    if (multi && t < len && (virt || dec < 0)) scratch[(size_t)t * B + b] = cv;
  };
  auto cont = [&]() { return dec == 0 ? t < tmax : (dec < 0 && t < len); };

#pragma unroll 1
  for (;;) {
    // ---- this round's positions: pos, this thread's (-1: none); fin:
    // selection is over, solve the winner ----
    int pos = -1;
    bool fin = false;
#pragma unroll 1
    for (;;) {
      if (in_row) {
        if (rev) {
          // the next G in-reach positions from t down, thread q the q-th
          int got = 0;
#pragma unroll 1
          while (got < G && t >= 0) {
            const int tp = t - j;
            bool near = false;
            if (tp >= 0) {
              const T* p = st + (size_t)tp * row_stride;
              const T dx = p[0] - x0[0], dy = p[B] - x0[1];
              near = !(dx * dx + dy * dy > rb2);
            }
            const unsigned m = tl.ballot(near);  // bit q: t - q in reach
            const int n = __popc(m);
            if (j >= got && j - got < n) pos = t - nth_set_bit(m, j - got);
            if (got + n >= G) {
              t -= nth_set_bit(m, G - 1 - got) + 1;
              got = G;
            } else {
              got += n;
              t -= G;
            }
          }
          if (got > 0) break;
        } else {
          if (cont()) {
            if (t + j < len) pos = t + j;
            break;
          }
          if (dec < 0) {  // the row ranks below the best: take it
            virt = false;
            best_row = r;
            best_idx = rarg;
            best_cost = rmin;
            best_len = len;
          }
        }
        in_row = false;
      }
      if (++r >= n_rows) {
        fin = true;
        break;
      }
      if (lap_ok[r] == 0) continue;  // +inf row: never below the best
      const int lap = lap_ids[r];
      len = lap_len[(size_t)lap * B + b];
      len = len < T_rows ? len : T_rows;
      st = states + (size_t)lap * T_rows * row_stride + b;
      qf = qfun + (size_t)lap * T_rows * B + b;
      dec = 0;
      rmin = inf;
      rarg = 0;
      tmax = virt ? T_rows : (len > best_len ? len : best_len);
      t = rev ? len - 1 : 0;
      if (rev) best_row = r;
      in_row = true;
    }
    const T* p = fin ? states + ((size_t)lap_ids[best_row] * T_rows +
                                 best_idx) * row_stride + b
                     : st + (size_t)(pos < 0 ? 0 : pos) * row_stride;
    T xt[4], us[N][2], xm[4], te;
    bool feasible = false;
    if (fin || pos >= 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) xt[q] = p[q * B];
      if constexpr (ZSKIP) {
        feasible = feasibility_call<T, N, false, true>(
            C, x0, xt, o, mm, warm, h1, &us[0][0], xm, &te, nullptr);
      } else {
        const Shoot<T, N> S{C, x0, xt, o, mm};
        feasible = S.feasibility_solve(warm, h1, us, xm, te);
      }
    }
    T cost = inf;
    if (!fin && pos >= 0) {
      const bool feas = h1 ? reaches(x1, xt) : feasible;
      cost = feas ? hf + qf[(size_t)pos * B] : inf;
    }
    bool write = fin && j == 0;
    if (!fin && rev) {
      const unsigned found = tl.ballot(cost < inf);
      if (!found) continue;
      fin = true;  // the highest feasible position wins
      write = j == __ffs(found) - 1;
      best_cost = cost;
      best_idx = pos;
    }
    if (fin) {
      if (write) {
        const int len_sel =
            lap_len[(size_t)lap_ids[best_row] * B + b];
        const bool succ = best_idx + 1 <= len_sel - 1;
        const T* nx = succ ? p + row_stride : p;  // successor row
        out.write(B, b, us, xm, xt, nx, h1, best_cost < inf, best_idx,
                  best_row, succ);
      }
      break;
    }
    // ---- forward: thread 0 folds the chunk's costs in position order ----
    bool run = true;
#pragma unroll 1
    for (int q = 0; q < G; ++q) {
      const T cq = tl.shfl(cost, q);  // position t + q of the chunk start
      if (j == 0 && run) {
        if (cont()) {
          if (t < len) {
            if (cq < rmin) {  // first-min over the row
              rmin = cq;
              rarg = t;
            }
            fold(cq);
          } else {
            fold(-inf);  // at or past the row's length
          }
          ++t;
        } else {
          run = false;
        }
      }
    }
    t = tl.shfl(t, 0);
    dec = tl.shfl(dec, 0);
    rmin = tl.shfl(rmin, 0);
    rarg = tl.shfl(rarg, 0);
  }
}

template <typename T, int N, bool ZSKIP>
int launch_nlmpc_step_all(const double* consts, int max_iters, int B,
                          int nb, int T_rows, int n_rows, bool rev,
                          const void* x,
                          const void* uw, const void* states,
                          const void* qfun, const void* lap_len,
                          const void* lap_ids, const void* lap_ok,
                          const void* obs, const void* skip, const void* hzn,
                          void* scratch, void* us, void* fe, void* ng,
                          void* idx, void* row, void* succ,
                          cudaStream_t stream) {
  const NlmpcConsts<T> C = make_nlmpc_consts<T>(consts, max_iters);
  // reach bound n dt |v0| + (a_max dt^2 n^2 / 2 + 1), folded in double
  const T rb_v = (T)((double)N * consts[0]);
  const T rb_c = (T)(consts[1] * consts[0] * consts[0] * N * N / 2.0 + 1.0);
  const StepOut<T, N> out{(T*)us, (T*)fe, (T*)ng, (int*)idx, (int*)row,
                          (T*)succ};
  constexpr int G = K2_ALL_G;
  nlmpc_step_all_kernel<T, N, G, ZSKIP>
      <<<(nb + 128 / G - 1) / (128 / G), 128, 0, stream>>>(
      C, rb_v, rb_c, B, nb, T_rows, n_rows, rev, (const T*)x, (const T*)uw,
      (const T*)states, (const T*)qfun, (const int*)lap_len,
      (const int*)lap_ids, (const int*)lap_ok, (const T*)obs,
      (const float*)skip, (const int*)hzn, (T*)scratch, out);
  return (int)cudaGetLastError();
}

}  // namespace ilqr

// dtype: 0 float32, 1 float64; n_rows: the lap rows of lap_ids / lap_ok
// (nsi, or max_laps with all_iter); rev ORs 1 for all_rev_skip (n_rows = 1
// only) and 4 for zeros_skip (its ZSKIP instantiation); scratch: (T_rows,
// B) of the dtype when n_rows > 1, else unused. B is the lane stride; the
// kernel runs the first `lanes` lanes, as i2lqr_step_launch's (last, so
// that an earlier checkout's launcher runs every lane). Returns the
// cudaError_t of the launch, or -1 when no kernel is instantiated for
// (dtype, n) or rev is asked with n_rows != 1.
extern "C" int nlmpc_step_all_launch(int dtype, int n, int n_rows, int rev,
                                     const double* consts, int max_iters,
                                     int B, int T_rows, const void* x,
                                     const void* uw, const void* states,
                                     const void* qfun, const void* lap_len,
                                     const void* lap_ids, const void* lap_ok,
                                     const void* obs, const void* skip,
                                     const void* hzn, void* scratch, void* us,
                                     void* fe, void* ng, void* idx, void* row,
                                     void* succ, void* stream, int lanes) {
  if (lanes < 0 || lanes > B) return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  const bool zskip = rev & 4;
  rev &= 1;
  if ((rev && n_rows != 1) || n_rows < 1 || (n_rows > 1 && !scratch))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
#define NLMPC_ALL_CASE(TYPE, CODE, ZSKIP_)                                   \
  if (n == 6 && dtype == CODE && zskip == ZSKIP_)                            \
    return ilqr::launch_nlmpc_step_all<TYPE, 6, ZSKIP_>(                     \
        consts, max_iters, B, lanes, T_rows, n_rows, rev != 0, x, uw, states, \
        qfun, lap_len, lap_ids, lap_ok, obs, skip, hzn, scratch, us, fe, ng,  \
        idx, row, succ, s);
  NLMPC_ALL_CASE(float, 0, false)
  NLMPC_ALL_CASE(double, 1, false)
  NLMPC_ALL_CASE(float, 0, true)
  NLMPC_ALL_CASE(double, 1, true)
#undef NLMPC_ALL_CASE
  return -1;
}

#ifdef K1_COUNT_SOLVES
// A counting build's events of this file (above) into out[0]; zeroes it.
// Waits for the device.
extern "C" int nlmpc_step_all_events(unsigned long long* out) {
  return ilqr::read_events(ilqr::k2_all_events, out);
}
#endif

// The zeros_skip instantiation's resources (as below).
extern "C" int nlmpc_step_all_zskip_attributes(int dtype, int n, int* out) {
  if (n == 6 && dtype == 0)
    return ilqr::kernel_attributes(
        ilqr::nlmpc_step_all_kernel<float, 6, ilqr::K2_ALL_G, true>, 128,
        out);
  if (n == 6 && dtype == 1)
    return ilqr::kernel_attributes(
        ilqr::nlmpc_step_all_kernel<double, 6, ilqr::K2_ALL_G, true>, 128,
        out);
  return -1;
}

// The loaded kernel's resources for (dtype, n), as the runtime reports
// them (kernel_attributes, lm_core.cuh); -1 when no kernel is instantiated.
extern "C" int nlmpc_step_all_attributes(int dtype, int n, int* out) {
  if (n == 6 && dtype == 0)
    return ilqr::kernel_attributes(
        ilqr::nlmpc_step_all_kernel<float, 6, ilqr::K2_ALL_G>, 128, out);
  if (n == 6 && dtype == 1)
    return ilqr::kernel_attributes(
        ilqr::nlmpc_step_all_kernel<double, 6, ilqr::K2_ALL_G>, 128, out);
  return -1;
}
