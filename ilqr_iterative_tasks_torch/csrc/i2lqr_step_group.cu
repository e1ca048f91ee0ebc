// K1 at k = 8 with the TPU kernel's `group` option
// (ilqr_iterative_tasks_tpu/ops/pallas_i2lqr_step.py, factory docstring
// :149-155, kernel :511-537; _pallas_lm_core.py:418 lm_solve_multi): the
// candidates solved `group` at a time in one interleaved LM loop. It
// computes what i2lqr_step_kernel (i2lqr_step.cu) computes, bit for bit:
// each member's result is lm_solve's (lm_core.cuh, lm_solve_multi).
//
// Design: a tile of G = nsi * k / M threads a lane, where M = group; thread
// t holds the M consecutive candidates t*M .. t*M + M - 1 (lap row c / k,
// slot c % k of candidate c), blocks of 128 threads. Per pass each thread
// runs the kNN of the lap rows its members read on its own (knn_rows, the
// K nearest rows in the order knn_rows_group gives the tile kernel), solves
// its members in one lm_solve_multi, and every thread runs the unchanged
// lex_select over the tile's costs, gathered by shuffles; the guess
// re-centres on the winner's terminal state and its thread writes its us,
// as in the tile kernel. Options beside group (runtime flags):
// - dedup: each member keeps what it gave in passes 0 and 1 (row,
//   validity, distance, terminal state); a later pass's valid candidate
//   whose row an entry of the same lap row holds takes that entry and is
//   not solved (its member enters the loop done); a final winner so taken
//   is solved again in a round of its own, as i2lqr_step_opts.cu does.
// - reuse_extract: a pass whose guess did not move keeps the members' kNN
//   rows (i2lqr_step_opts.cu).
// - dom_skip: the TPU kernel tests a group's members against the lane's
//   best cost from the groups solved before it (:516-519). Here every
//   group of a lane runs at once, so that best is +inf and nothing is
//   skipped: the schedule is sound (it solves what the test would let
//   through) and the kernel is the same.
//
// What bounds it on the card: the members' LM chains in series within a
// thread (the loop lasts its longest member), and the members' state,
// which for M >= 4 outgrows the register file (local memory); M threads'
// kNN scans of the same lap a lane.
#include "lm_core.cuh"

namespace ilqr {

constexpr int K1_GROUP_DEDUP = 2, K1_GROUP_REUSE = 8;

#ifdef K1_COUNT_SOLVES
// a counting build's events (tile.cuh): lane-passes 1-2 under
// reuse_extract, and of them those whose kNN was kept
__device__ unsigned long long k1_group_events[2];
#endif

template <typename T, int N, int K, int NSI, int M>
__global__ void __launch_bounds__(128) i2lqr_step_group_kernel(
    const Consts<T> C, int B, int nb, int T_rows, int opts,
    const T* __restrict__ x, const T* __restrict__ g0,
    const T* __restrict__ states, const T* __restrict__ qfun,
    const int* __restrict__ lap_len, const int* __restrict__ lap_ids,
    const int* __restrict__ lap_ok, const T* __restrict__ obs,
    const float* __restrict__ skip, T* __restrict__ us_out,
    T* __restrict__ shrink_out, int* __restrict__ idx_out,
    int* __restrict__ row_out) {
  constexpr int NC = NSI * K, G = NC / M;  // candidates; threads a lane
  static_assert(NC % M == 0 && 128 % G == 0, "a block holds whole lanes");
  static_assert(M <= K ? K % M == 0 : G == 1,
                "a thread's members lie in one lap row, or one thread");
  const bool dedup = opts & K1_GROUP_DEDUP, reuse = opts & K1_GROUP_REUSE;
  const Tile<G> tl;
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (b >= nb) return;
  const int t = tl.rank;  // members t * M .. t * M + M - 1
  if (skip[b] > 0.5f) {
    for (int i = t; i < 2 * N; i += G) us_out[i * B + b] = (T)0;
    if (t == 0) {
      shrink_out[b] = (T)0;
      idx_out[b] = 0;
      row_out[b] = 0;
    }
    return;
  }
  const T inf = (T)INFINITY;
  T x0[4], xg[4], xp[4] = {};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    x0[q] = x[q * B + b];
    xg[q] = g0[q * B + b];
  }
  const Obs<T> o = load_obs(obs, B, b);
  bool lok[NSI];
#pragma unroll
  for (int rr = 0; rr < NSI; ++rr) lok[rr] = lap_ok[rr] != 0;
  const size_t row_stride = (size_t)4 * B;  // one safe-set row (4, B)

  // the members' candidates: kNN row, validity, Qfun, terminal state
  int ik[M];
  bool cok[M];
  T cq[M], xt[M][4];
  // the dedup cache: each member's row, validity, distance and terminal
  // state in passes 0 and 1
  int e_idx[2][M];
  bool e_ok[2][M];
  T e_d[2][M], e_xl[2][M][4];
  T us[M][N][2], xl[M][4], dist[M];
  int solved_pass[M];  // the pass of a member's last solve (its us)
  // the loops over members below run as loops (unroll 1), their arrays in
  // local memory: unrolled, the 14 instantiations took the build minutes
#pragma unroll 1
  for (int m = 0; m < M; ++m) {
    solved_pass[m] = -1;
    e_ok[0][m] = e_ok[1][m] = false;
  }
  int win = 0, idx_sel = 0, row_sel = 0;
  bool again = false;  // the final winner's us are to be solved again
  // passes 0-2, then (where dedup gave a lane's final winner) a round that
  // solves it again
  for (int pass = 0; pass < 4; ++pass) {
    const bool fin = pass == 3;
    if (fin && !again) break;
    bool hit[M];
    T hd[M], hxl[M][4];
#pragma unroll 1
    for (int m = 0; m < M; ++m) hit[m] = false;
    if (!fin) {
      // ---- the kNN of the lap rows the members read ----
      const bool same = reuse && pass > 0 && same_guess(xg, xp);
      if (reuse && pass > 0 && t == 0) ILQR_EVENT(k1_group_events, 0);
      if (same && t == 0) ILQR_EVENT(k1_group_events, 1);
#pragma unroll
      for (int q = 0; q < 4; ++q) xp[q] = xg[q];
#pragma unroll 1
      for (int rr = 0; rr < NSI; ++rr) {
        if (same || rr < t * M / K || rr > (t * M + M - 1) / K) continue;
        const int lap = lap_ids[rr];
        const int len = lap_len[(size_t)lap * B + b];
        const int rows = len < T_rows ? len : T_rows;
        const T* st = states + (size_t)lap * T_rows * row_stride + b;
        T dk[K];
        int ikk[K];
        knn_rows<T, K, 4>(st, row_stride, B, rows, xg, dk, ikk);
#pragma unroll 1
        for (int m = 0; m < M; ++m) {
          const int c = t * M + m;
          if (c / K != rr) continue;
          const int im = ikk[c % K];
          ik[m] = im;
          cok[m] = dk[c % K] < inf && lap_ok[rr] != 0;
          const T* p = st + im * row_stride;
#pragma unroll
          for (int q = 0; q < 4; ++q) xt[m][q] = p[q * B];
          cq[m] = qfun[((size_t)lap * T_rows + im) * B + b];
        }
      }
      // ---- dedup: the entries of the member's lap row, earlier passes
      // first, then slot order; the first match wins. Entry j of row r is
      // candidate r*K + j: member (r*K + j) % M of thread (r*K + j) / M,
      // which is j % M where M divides K (every thread then reads the
      // same member's value), or the thread's own where it holds the lane
      // (G = 1) ----
      if (dedup) {
#pragma unroll 1
        for (int pp = 0; pp < pass && pp < 2; ++pp) {
#pragma unroll 1
          for (int m = 0; m < M; ++m) {
            const int r = (t * M + m) / K;
#pragma unroll 1
            for (int j = 0; j < K; ++j) {
              const int q = r * K + j;
              const int mq = G == 1 ? q : j % M;
              const int from = G == 1 ? 0 : q / M;
              const int oi = tl.shfl(e_idx[pp][mq], from);
              const bool ook = tl.shfl((int)e_ok[pp][mq], from) != 0;
              const T od = tl.shfl(e_d[pp][mq], from);
              T oxl[4];
#pragma unroll
              for (int c = 0; c < 4; ++c)
                oxl[c] = tl.shfl(e_xl[pp][mq][c], from);
              if (!hit[m] && ook && cok[m] && oi == ik[m]) {
                hit[m] = true;
                hd[m] = od;
#pragma unroll
                for (int c = 0; c < 4; ++c) hxl[m][c] = oxl[c];
              }
            }
          }
        }
      }
    }
    // ---- the members' solves in one interleaved loop: every candidate
    // the cache does not give, or (the final round) the winner again ----
    bool done0[M];
#pragma unroll 1
    for (int m = 0; m < M; ++m)
      done0[m] = fin ? t * M + m != win : hit[m];
    lm_solve_multi<T, N, M>(C, x0, xt, o, done0, us, xl, dist);
#pragma unroll 1
    for (int m = 0; m < M; ++m)
      if (!done0[m]) solved_pass[m] = pass;
    const int wm = win % M;  // the winner's member on its thread
    if (fin) {
      if (t == win / M) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          us_out[(2 * i) * B + b] = us[wm][i][0];
          us_out[(2 * i + 1) * B + b] = us[wm][i][1];
        }
      }
      break;
    }
    // ---- each member's relaxed reach cost, then the selection over the
    // tile's candidates, in every thread ----
    const T unit = C.unit[pass], cutoff = C.cutoff[pass];
    T d_me[M], xl_me[M][4], ccost[M];
#pragma unroll 1
    for (int m = 0; m < M; ++m) {
      d_me[m] = hit[m] ? hd[m] : dist[m];
#pragma unroll
      for (int q = 0; q < 4; ++q) xl_me[m][q] = hit[m] ? hxl[m][q] : xl[m][q];
      ccost[m] = inf;
      if (cok[m]) {
        const T i_rel = fmax(ceil(d_me[m] / unit - (T)1e-12), (T)1.0);
        ccost[m] = d_me[m] <= cutoff ? cq[m] + (T)N + (T)100.0 * i_rel : inf;
      }
    }
    T cmp[NC], cst[NC];
#pragma unroll 1
    for (int q = 0; q < NC; ++q) {
      cst[q] = tl.shfl(ccost[q % M], q / M);
      const bool okq = tl.shfl((int)cok[q % M], q / M) != 0;
      cmp[q] = lok[q / K] ? (okq ? cst[q] : -inf) : inf;
    }
    win = lex_select<T, NSI, K>(cmp, cst, row_sel);
    // the winner's row and terminal state, from its thread's member
    const int wn = win % M;
    idx_sel = tl.shfl(ik[wn], win / M);
#pragma unroll
    for (int q = 0; q < 4; ++q) xg[q] = tl.shfl(xl_me[wn][q], win / M);
    if (pass < 2 && dedup) {  // the cache keeps what the pass solved or took
#pragma unroll 1
      for (int m = 0; m < M; ++m) {
        e_idx[pass][m] = ik[m];
        e_ok[pass][m] = cok[m];
        e_d[pass][m] = d_me[m];
#pragma unroll
        for (int q = 0; q < 4; ++q) e_xl[pass][m][q] = xl_me[m][q];
      }
    }
    if (pass == 2) {
      // the winner's us are not this pass's solve: solved again
      again = tl.shfl((int)(solved_pass[wn] != pass), win / M) != 0;
      if (t == win / M) {
        if (!again) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            us_out[(2 * i) * B + b] = us[wn][i][0];
            us_out[(2 * i + 1) * B + b] = us[wn][i][1];
          }
        }
        const int len_sel = lap_len[(size_t)lap_ids[row_sel] * B + b];
        shrink_out[b] = (idx_sel + 1) > (len_sel - 1) ? (T)1 : (T)0;
        idx_out[b] = idx_sel;
        row_out[b] = row_sel;
      }
    }
  }
}

template <typename T, int N, int K, int NSI, int M>
int launch_i2lqr_step_group(int opts, const double* consts, int max_iter,
                            int B, int nb, int T_rows, const void* x,
                            const void* g0, const void* states,
                            const void* qfun, const void* lap_len,
                            const void* lap_ids, const void* lap_ok,
                            const void* obs, const void* skip, void* us,
                            void* shrink, void* idx, void* row,
                            cudaStream_t stream) {
  const Consts<T> C = make_consts<T>(consts, max_iter);
  constexpr int lanes_per_block = 128 / (NSI * K / M);
  i2lqr_step_group_kernel<T, N, K, NSI, M>
      <<<(nb + lanes_per_block - 1) / lanes_per_block, 128, 0, stream>>>(
      C, B, nb, T_rows, opts, (const T*)x, (const T*)g0, (const T*)states,
      (const T*)qfun, (const int*)lap_len, (const int*)lap_ids,
      (const int*)lap_ok, (const T*)obs, (const float*)skip, (T*)us,
      (T*)shrink, (int*)idx, (int*)row);
  return (int)cudaGetLastError();
}

}  // namespace ilqr

#define I2LQR_GROUP_CASE(TYPE, CODE, NSI_, M_)                               \
  if (dtype == CODE && nsi == NSI_ && group == M_)                           \
    return ilqr::launch_i2lqr_step_group<TYPE, 6, 8, NSI_, M_>(              \
        opts, consts, max_iter, B, lanes, T_rows, x, g0, states, qfun,       \
        lap_len, lap_ids, lap_ok, obs, skip, us, shrink, idx, row, s);

// K1 at k = 8 with group = M > 1 (nsi 1: M 2, 4, 8; nsi 2: M 2, 4, 8, 16):
// opts ORs 2 (dedup) and 8 (reuse_extract); arguments as
// i2lqr_step_launch's with the group and opts after nsi. Returns the
// cudaError_t of the launch, or -1 when no kernel is instantiated.
extern "C" int i2lqr_step_group_launch(
    int dtype, int n, int k, int nsi, int group, int opts,
    const double* consts, int max_iter, int B, int T_rows, int max_laps,
    const void* x, const void* g0, const void* states, const void* qfun,
    const void* lap_len, const void* lap_ids, const void* lap_ok,
    const void* obs, const void* skip, void* us, void* shrink, void* idx,
    void* row, void* stream, int lanes) {
  (void)max_laps;
  if (lanes < 0 || lanes > B) return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  if (n != 6 || k != 8 ||
      (opts & ~(ilqr::K1_GROUP_DEDUP | ilqr::K1_GROUP_REUSE)))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  I2LQR_GROUP_CASE(float, 0, 1, 2)
  I2LQR_GROUP_CASE(double, 1, 1, 2)
  I2LQR_GROUP_CASE(float, 0, 1, 4)
  I2LQR_GROUP_CASE(double, 1, 1, 4)
  I2LQR_GROUP_CASE(float, 0, 1, 8)
  I2LQR_GROUP_CASE(double, 1, 1, 8)
  I2LQR_GROUP_CASE(float, 0, 2, 2)
  I2LQR_GROUP_CASE(double, 1, 2, 2)
  I2LQR_GROUP_CASE(float, 0, 2, 4)
  I2LQR_GROUP_CASE(double, 1, 2, 4)
  I2LQR_GROUP_CASE(float, 0, 2, 8)
  I2LQR_GROUP_CASE(double, 1, 2, 8)
  I2LQR_GROUP_CASE(float, 0, 2, 16)
  I2LQR_GROUP_CASE(double, 1, 2, 16)
  return -1;
}

#ifdef K1_COUNT_SOLVES
// A counting build's events of this file (above) into out[0..1]; zeroes
// them. Waits for the device.
extern "C" int i2lqr_step_group_events(unsigned long long* out) {
  return ilqr::read_events(ilqr::k1_group_events, out);
}
#endif

#define I2LQR_GROUP_ATTRIBUTES(TYPE, CODE, NSI_, M_)                         \
  if (dtype == CODE && nsi == NSI_ && group == M_)                           \
    return ilqr::kernel_attributes(                                          \
        ilqr::i2lqr_step_group_kernel<TYPE, 6, 8, NSI_, M_>, 128, out);

// The group kernel's resources for (dtype, n, k, nsi, group), as the CUDA
// runtime reports them (kernel_attributes, tile.cuh); -1 when none is
// instantiated.
extern "C" int i2lqr_step_group_attributes(int dtype, int n, int k, int nsi,
                                           int group, int* out) {
  if (n != 6 || k != 8) return -1;
  I2LQR_GROUP_ATTRIBUTES(float, 0, 1, 2)
  I2LQR_GROUP_ATTRIBUTES(double, 1, 1, 2)
  I2LQR_GROUP_ATTRIBUTES(float, 0, 1, 4)
  I2LQR_GROUP_ATTRIBUTES(double, 1, 1, 4)
  I2LQR_GROUP_ATTRIBUTES(float, 0, 1, 8)
  I2LQR_GROUP_ATTRIBUTES(double, 1, 1, 8)
  I2LQR_GROUP_ATTRIBUTES(float, 0, 2, 2)
  I2LQR_GROUP_ATTRIBUTES(double, 1, 2, 2)
  I2LQR_GROUP_ATTRIBUTES(float, 0, 2, 4)
  I2LQR_GROUP_ATTRIBUTES(double, 1, 2, 4)
  I2LQR_GROUP_ATTRIBUTES(float, 0, 2, 8)
  I2LQR_GROUP_ATTRIBUTES(double, 1, 2, 8)
  I2LQR_GROUP_ATTRIBUTES(float, 0, 2, 16)
  I2LQR_GROUP_ATTRIBUTES(double, 1, 2, 16)
  return -1;
}
