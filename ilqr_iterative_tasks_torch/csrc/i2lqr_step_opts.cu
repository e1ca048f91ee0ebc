// K1 at k = 8 with the TPU kernel's options: with_stats, dedup,
// qsort_skip, reuse_extract and dom_skip
// (ilqr_iterative_tasks_tpu/ops/pallas_i2lqr_step.py, factory docstring
// :82-190, kernel :240-292, :355-367, :380-391, :485-508, :541-720). It
// computes what i2lqr_step_kernel (i2lqr_step.cu) computes, bit for bit:
// the options change which candidate solves run, never the outputs. The
// kernel without options stays i2lqr_step_kernel, whose registers these
// options would change, and so each option added later is a template
// flag of its own (the instantiations without it keep their registers).
// group, the last option, is i2lqr_step_group.cu.
//
// reuse_extract (the REUSE flag of both kernels below): in passes 1 and 2
// a lane whose guess equals the previous pass's on every component (float
// ==, the TPU kernel's != test) keeps that pass's kNN rows and candidates
// and runs no kNN. The TPU kernel gates a whole tile of lanes on it; here
// the gate is a lane's (a tile's threads, or the lane queue's thread):
// the kNN is a pure function of the guess and the safe set, so either
// gives the same bits.
//
// The plain order (with_stats, dedup; nsi 1 and 2), i2lqr_step_opts_kernel:
// as i2lqr_step_kernel, a tile of G = nsi * k threads a lane, one thread a
// candidate slot, blocks of 128 threads. Unlike it, a warp's tiles stay
// together to the end (a skipped lane's tile, or one past B, does no work
// but takes part in the warp's collectives), so that the warp can count
// its trips. dedup: thread c keeps what its slot gave in passes 0 and 1
// (kNN row, whether it was a valid candidate, its distance and terminal
// state). In a later pass a valid candidate whose row an entry of the same
// lap row holds (the K threads of that row, read by shuffles) takes that
// entry's distance and terminal state and is not solved. A final winner so
// taken is solved again by its thread in a round of its own: its us (the
// same pure solve, bitwise).
//
// qsort_skip (nsi = 1), i2lqr_step_lanes_kernel: a lane queue, one thread
// a lane, warps fed 32 live lanes at a time (below). dom_skip (nsi = 1) is
// the same queue (its DOM flag) in slot order. A tile of 8 threads
// that solved one position a lane a round measured 7.70 ms at the i2LQR
// headline's lap-2 capture against the first lane queue's 2.39 (PERF.md):
// at the headline a lane solves about one position a pass, which left 7
// of a tile's 8 threads idle.
//
// with_stats: three int32 (B,) counts a lane, summed over the step.
// iters_useful: the trips of the lane's solves (lm_solve's count, the
// plain version's lane_iters). iters_executed: thread-trips its warp pays,
// in the tile every solve round its warp runs (a round a pass, and a
// winner solved again one more), the lane's G threads times the warp's
// longest solve of the round; in the lane queue each solve's longest
// trips among the threads of its round (the warp's 32 queued live lanes,
// one a thread) that run it together (its __activemask there). upass
// (3, B): a pass's useful trips plus one arrival at each position the
// lane visits (every slot in the plain order, the slots not skipped under
// qsort_skip), the final winner's solve again counted in pass 2; the
// wrapper takes JAX's queue_floor from it (ops/i2lqr_step.py). Skipped
// lanes write 0.
//
// What bounds it on the card: the tile as i2lqr_step_kernel; the lane
// queue a lane's LM chains in series (about one solve a pass at the
// headline), a round's 32 lanes' longest series, and its kNN scans (a
// lap's rows, three times a lane-step).
#include "lm_core.cuh"

namespace ilqr {

constexpr int K1_OPT_STATS = 1, K1_OPT_DEDUP = 2, K1_OPT_QSORT = 4,
              K1_OPT_REUSE = 8, K1_OPT_DOM = 16;
// the lane queue's compile-time flags
constexpr int K1_LQ_REUSE = 1, K1_LQ_DOM = 2;

#ifdef K1_COUNT_SOLVES
// a counting build's events (tile.cuh): lane-passes 1-2 of a REUSE
// instantiation, of them those whose kNN was kept, and slots dom_skip
// passed over
__device__ unsigned long long k1_opts_events[3];
#endif


// v summed over the tile's threads, in every thread
template <int G>
__device__ __forceinline__ int tile_sum(const Tile<G>& tl, int v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += tl.shfl_xor(v, off);
  return v;
}

template <typename T, int N, int K, int NSI, bool REUSE = false>
__global__ void __launch_bounds__(128, 4) i2lqr_step_opts_kernel(
    const Consts<T> C, int B, int nb, int T_rows, int opts,
    const T* __restrict__ x, const T* __restrict__ g0,
    const T* __restrict__ states, const T* __restrict__ qfun,
    const int* __restrict__ lap_len, const int* __restrict__ lap_ids,
    const int* __restrict__ lap_ok, const T* __restrict__ obs,
    const float* __restrict__ skip, T* __restrict__ us_out,
    T* __restrict__ shrink_out, int* __restrict__ idx_out,
    int* __restrict__ row_out, int* __restrict__ useful_out,
    int* __restrict__ exec_out, int* __restrict__ upass_out) {
  constexpr int G = NSI * K;  // threads a lane, one a candidate
  static_assert(128 % G == 0, "a block holds whole lanes");
  constexpr unsigned FULL = 0xffffffffu;
  const bool stats = opts & K1_OPT_STATS, dedup = opts & K1_OPT_DEDUP;
  const Tile<G> tl;
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int c = tl.rank;  // candidate s = c % K of lap row r = c / K
  const int r = c / K, s = c % K;
  const bool in = b < nb;
  const bool live = in && skip[b] <= 0.5f;
  if (in && !live) {
    for (int i = c; i < 2 * N; i += G) us_out[i * B + b] = (T)0;
    if (c == 0) {
      shrink_out[b] = (T)0;
      idx_out[b] = 0;
      row_out[b] = 0;
      if (stats) {
        useful_out[b] = 0;
        exec_out[b] = 0;
        for (int p = 0; p < 3; ++p) upass_out[p * B + b] = 0;
      }
    }
  }
  if (__ballot_sync(FULL, live) == 0) return;  // the whole warp
  const T inf = (T)INFINITY;
  T x0[4] = {}, xg[4] = {};
  Obs<T> o{};
  int lap = 0, len = 0;
  bool lap_stored = false, lok[NSI];
#pragma unroll
  for (int rr = 0; rr < NSI; ++rr) lok[rr] = lap_ok[rr] != 0;
  if (live) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x0[q] = x[q * B + b];
      xg[q] = g0[q * B + b];
    }
    o = load_obs(obs, B, b);
    lap = lap_ids[r];
    lap_stored = lap_ok[r] != 0;
    len = lap_len[(size_t)lap * B + b];
  }
  const int rows = len < T_rows ? len : T_rows;
  const size_t row_stride = (size_t)4 * B;  // one safe-set row (4, B)
  const T* st = states + (size_t)lap * T_rows * row_stride + b;

  T us[N][2];
  // the dedup cache: this slot's kNN row, validity, distance and terminal
  // state in passes 0 and 1
  int e_idx[2] = {0, 0};
  bool e_ok[2] = {false, false};
  T e_d[2] = {(T)0, (T)0}, e_xl[2][4] = {};
  int win = 0, idx_sel = 0, row_sel = 0;
  bool again = false;     // the final winner's us are to be solved again
  int solved_pass = -1;   // the pass of this thread's last solve (its us)
  int useful = 0, executed = 0, up2 = 0, fin_tr = 0;
  T xt[4] = {};
  // reuse_extract: the last kNN's guess, row, validity and Qfun
  [[maybe_unused]] T xp[4] = {};
  [[maybe_unused]] int ik_kept = 0;
  [[maybe_unused]] bool cok_kept = false;
  [[maybe_unused]] T cq_kept = (T)0;
  // passes 0-2, then (where a lane's final winner was taken from the
  // cache) a round that solves it again: the kernel's one lm_solve
  for (int pass = 0; pass < 4; ++pass) {
    const bool fin = pass == 3;
    if (fin && !__any_sync(FULL, again)) break;
    // ---- kNN of this thread's lap row, its candidate, the cache ----
    int ik = 0;
    bool cok = false, hit = false;
    T cq = (T)0, hd = (T)0, hxl[4] = {};
    if (!fin && live) {
      bool same = false;  // the guess did not move: the last kNN's rows
      if constexpr (REUSE) {
        same = pass > 0 && same_guess(xg, xp);
        if (pass > 0 && c == 0) ILQR_EVENT(k1_opts_events, 0);
        if (same && c == 0) ILQR_EVENT(k1_opts_events, 1);
      }
      if (same) {
        ik = ik_kept;
        cok = cok_kept;
        cq = cq_kept;
      } else {
        T dk;
        knn_rows_group<T, K, G>(tl, s, st, row_stride, B, rows, xg, dk, ik);
        cok = dk < inf && lap_stored;
        const T* p = st + ik * row_stride;
#pragma unroll
        for (int q = 0; q < 4; ++q) xt[q] = p[q * B];
        cq = qfun[((size_t)lap * T_rows + ik) * B + b];
      }
      if constexpr (REUSE) {
        ik_kept = ik;
        cok_kept = cok;
        cq_kept = cq;
#pragma unroll
        for (int q = 0; q < 4; ++q) xp[q] = xg[q];
      }
      if (dedup) {
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          if (pp >= pass) break;
          int src = -1;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int q = r * K + j;
            const int oi = tl.shfl(e_idx[pp], q);
            const bool ook = tl.shfl((int)e_ok[pp], q) != 0;
            if (src < 0 && ook && cok && oi == ik) src = q;
          }
          const int from = src < 0 ? c : src;
          const T d = tl.shfl(e_d[pp], from);
          T xl[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) xl[q] = tl.shfl(e_xl[pp][q], from);
          if (!hit && src >= 0) {
            hit = true;
            hd = d;
#pragma unroll
            for (int q = 0; q < 4; ++q) hxl[q] = xl[q];
          }
        }
      }
    }
    // ---- the pass's round of solves (every candidate the cache does not
    // give), or the final round (a winner the cache gave, again) ----
    const bool visit = live;  // the plain order visits every slot
    const T unit = fin ? (T)1 : C.unit[pass];
    const T cutoff = fin ? (T)0 : C.cutoff[pass];
    T d_me = hd, xl_me[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) xl_me[q] = hxl[q];
    const bool go = fin ? live && again && c == win : live && !hit;
    int tr = 0;  // this thread's trips this round
    if (go) {  // ---- the zeros-initialised solve ----
#pragma unroll
      for (int i = 0; i < N; ++i) us[i][0] = us[i][1] = (T)0;
      const Solve<T, N> S{C, x0, xt, o};
      T cost;
      S.template lm_solve<true>(us, false, xl_me, cost, d_me, &tr);
      solved_pass = pass;
    }
    if (stats) {
      useful += tr;
      const int most = (int)__reduce_max_sync(FULL, (unsigned)tr);
      if (live) executed += G * most;
    }
    if (fin) {
      fin_tr = tr;
      if (go) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          us_out[(2 * i) * B + b] = us[i][0];
          us_out[(2 * i + 1) * B + b] = us[i][1];
        }
      }
      break;
    }
    if (!live) continue;
    // ---- this slot's relaxed reach cost, then the selection over the
    // tile's candidates, in every thread: lexicographic row-min over laps
    // (ragged list compare: absent slots -inf, laps not yet stored +inf),
    // then the first-min argmin over the winning row ----
    T ccost = inf;
    if (visit && cok) {
      const T i_rel = fmax(ceil(d_me / unit - (T)1e-12), (T)1.0);
      ccost = d_me <= cutoff ? cq + (T)N + (T)100.0 * i_rel : inf;
    }
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
    for (int q = 0; q < 4; ++q) xg[q] = tl.shfl(xl_me[q], win);
    if (pass < 2) {  // the cache keeps what the schedule solved or took
      const bool ok = cok && visit;
      if (pass == 0) {
        e_idx[0] = ik;
        e_ok[0] = ok;
        e_d[0] = d_me;
#pragma unroll
        for (int q = 0; q < 4; ++q) e_xl[0][q] = xl_me[q];
      } else {
        e_idx[1] = ik;
        e_ok[1] = ok;
        e_d[1] = d_me;
#pragma unroll
        for (int q = 0; q < 4; ++q) e_xl[1][q] = xl_me[q];
      }
    }
    if (stats) {  // the pass's useful trips and arrivals, a lane's sum
      const int u = tile_sum(tl, tr + (visit ? 1 : 0));
      if (pass < 2) {
        if (c == 0) upass_out[pass * B + b] = u;
      } else {
        up2 = u;
      }
    }
    if (pass == 2) {
      again = tl.shfl((int)(solved_pass != 2), win) != 0;
      if (c == win) {
        if (!again) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            us_out[(2 * i) * B + b] = us[i][0];
            us_out[(2 * i + 1) * B + b] = us[i][1];
          }
        }
        const int len_sel = lap_len[(size_t)lap_ids[row_sel] * B + b];
        shrink_out[b] = (idx_sel + 1) > (len_sel - 1) ? (T)1 : (T)0;
        idx_out[b] = idx_sel;
        row_out[b] = row_sel;
      }
    }
  }
  if (stats && live) {  // the lane's counts (the final solve again in pass 2)
    useful = tile_sum(tl, useful);
    const int again_tr = tile_sum(tl, fin_tr);
    if (c == 0) {
      useful_out[b] = useful;
      exec_out[b] = executed;
      upass_out[2 * B + b] = up2 + again_tr + (again ? 1 : 0);
    }
  }
}

// qsort_skip at nsi = 1 as a lane queue: one thread a lane walks its own
// positions. Warps take their lanes in chunks of 32 (the grid holds what
// the card keeps resident; a warp's first chunk by its index, the rest
// from a counter, one atomicAdd a chunk, as K4's). A warp reads a chunk's
// skip flags with one ballot, writes its skipped lanes' zeros at once
// (coalesced) and queues its live lanes in a ring of 64 in shared memory;
// once 32 are queued, or the chunks are spent, each thread runs one of
// them (a round; the warp reconverges after it). Per pass the thread runs
// the lane's kNN alone (knn_rows, a few rows' loads in flight), ranks its
// K slots by (Qfun, slot), invalid slots last, and visits the positions
// in that order under the strict skip: position p > 0 is skipped when it
// is invalid or q + n + 100 > the best cost so far (tier-quantised costs
// tie across different q), which ends the lane's pass (dominance is
// monotone in position). It keeps the lexicographic (cost, slot) minimum,
// the plain order's first-min argmin, with its terminal state and, where
// it solved it, its us. dedup: the lane's solves of passes 0 and 1 (row,
// distance, terminal state), matched by row, the first match winning (a
// row the cache holds is not stored again). A final winner taken from the
// cache is solved again, at the kernel's one call of lm_solve.
//
// State that lm_solve's registers would otherwise push to local memory
// lives in the block's dynamic shared memory, a slice a thread (LaneSlots):
// the dedup cache, the winner's us and the kNN rows. Measured designs
// (PERF.md; H100, the headline's lap-2 capture, K1's device seconds a
// headline run): the first queue (a thread took its next lane from the
// counter, the cache and us in local memory, one row's loads at a time)
// 2.365-2.414 ms, 0.332-0.335 s; this one 2.547-2.610 ms, 0.274-0.275 s;
// without the register cap (245 registers, 8 warps an SM) 2.330-2.354 ms,
// 0.314 s; rounds in which a warp's threads step their lanes to their
// next solve and solve together, the lane's state in the slice, 3.282-
// 3.404 ms, 0.311 s; a thread running the ring's lanes one after another
// from that state 2.631-2.640 ms, 0.286 s.

constexpr int K1_LQ_THREADS = 128;  // threads a block
constexpr int K1_LQ_RING = 64;      // queued live lanes a warp can hold
constexpr int K1_KNN_ROWS = 4;      // rows whose loads a kNN step issues
// f32 blocks an SM the register cap is set for (168 registers, as many as
// the shared slices allow; f64 takes no cap)
constexpr int K1_LQ_F32_BLOCKS = 3;

// A thread's slice of the block's dynamic shared memory, each field a
// column of K1_LQ_THREADS (thread-fastest, so a warp's accesses to one
// field fall in distinct banks): the dedup cache's 2K entries (distance,
// terminal state, row), the winner's us and the pass's K kNN rows (an
// invalid slot's row with bit 30 set); then a ring of K1_LQ_RING queued
// lanes a warp.
template <typename T, int N, int K>
struct LaneSlots {
  static constexpr int E = 2 * K;           // cache entries
  static constexpr int NT = 5 * E + 2 * N;  // T fields
  static constexpr int NI = E + K;          // int fields
  static constexpr int SLICES = K1_LQ_THREADS * (NT * (int)sizeof(T) +
                                                 NI * (int)sizeof(int));
  static constexpr int BYTES =
      SLICES + (K1_LQ_THREADS / 32) * K1_LQ_RING * (int)sizeof(int);
  static constexpr int INVALID = 1 << 30;
  T* t;
  int* i;
  __device__ __forceinline__ LaneSlots(unsigned char* base, int tid)
      : t(reinterpret_cast<T*>(base) + tid),
        i(reinterpret_cast<int*>(base + K1_LQ_THREADS * NT * sizeof(T)) +
          tid) {}
  __device__ __forceinline__ T& d(int e) { return t[e * K1_LQ_THREADS]; }
  __device__ __forceinline__ T& xl(int e, int c) {
    return t[(E + 4 * e + c) * K1_LQ_THREADS];
  }
  __device__ __forceinline__ T& us(int i_, int j) {
    return t[(5 * E + 2 * i_ + j) * K1_LQ_THREADS];
  }
  __device__ __forceinline__ int& row(int e) { return i[e * K1_LQ_THREADS]; }
  __device__ __forceinline__ int& ik(int s) {
    return i[(E + s) * K1_LQ_THREADS];
  }
  // the ring of the warp of block thread tid
  static __device__ __forceinline__ int* ring(unsigned char* base, int tid) {
    return reinterpret_cast<int*>(base + SLICES) + (tid / 32) * K1_LQ_RING;
  }
};

// One live lane b of the lane queue: the kernel's parameters as
// i2lqr_step_lanes_kernel's, its slice sl.
//
// dom_skip (X & K1_LQ_DOM): the slots in their own order under JAX's
// non-strict predicate: slot p > 0 is skipped when it is invalid or
// q + n + 100 >= the best cost so far (its cost +inf, no solve, no cache
// entry, one arrival counted); q is not monotone in slot order, so a skip
// does not end the pass. A tie keeps the earlier slot, so the best is the
// plain order's first-min argmin (pallas_i2lqr_step.py:133-147).
// reuse_extract (X & K1_LQ_REUSE): a pass whose guess did not move keeps
// the slice's kNN rows and the rank order.
template <typename T, int N, int K, int X>
__device__ __forceinline__ void lane_step(
    const Consts<T>& C, int B, int T_rows, bool stats, bool dedup, int lap,
    bool lap_stored, int b, LaneSlots<T, N, K>& sl, const T* __restrict__ x,
    const T* __restrict__ g0, const T* __restrict__ states,
    const T* __restrict__ qfun, const int* __restrict__ lap_len,
    const T* __restrict__ obs, T* __restrict__ us_out,
    T* __restrict__ shrink_out, int* __restrict__ idx_out,
    int* __restrict__ row_out, int* __restrict__ useful_out,
    int* __restrict__ exec_out, int* __restrict__ upass_out) {
  using Slots = LaneSlots<T, N, K>;
  const T inf = (T)INFINITY;
  const size_t row_stride = (size_t)4 * B;  // one safe-set row (4, B)
  T x0[4], xg[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    x0[q] = x[q * B + b];
    xg[q] = g0[q * B + b];
  }
  const Obs<T> o = load_obs(obs, B, b);
  const int len = lap_len[(size_t)lap * B + b];
  const int rows = len < T_rows ? len : T_rows;
  const T* st = states + (size_t)lap * T_rows * row_stride + b;
  const T* qf = qfun + (size_t)lap * T_rows * B + b;  // row t at t * B
  int n_cache = 0, useful = 0, executed = 0, win_row = 0;
  bool held = false;  // the slice's us hold the final winner's solution
  unsigned order = 0;  // position p's slot in bits 4p..4p+3
  [[maybe_unused]] T xp[4];  // reuse_extract: the last kNN's guess
  for (int pass = 0; pass < 3; ++pass) {
    bool same = false;
    if constexpr ((X & K1_LQ_REUSE) != 0) {
      same = pass > 0 && same_guess(xg, xp);
      if (pass > 0) ILQR_EVENT(k1_opts_events, 0);
      if (same) ILQR_EVENT(k1_opts_events, 1);
    }
    if (!same) {
      order = 0;
      T dk[K], qe[K];
      int ik[K];
      knn_rows<T, K, K1_KNN_ROWS>(st, row_stride, B, rows, xg, dk, ik);
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const bool ok = dk[s] < inf && lap_stored;
        qe[s] = ok ? qf[(size_t)ik[s] * B] : inf;
        sl.ik(s) = ok ? ik[s] : ik[s] | Slots::INVALID;
      }
#pragma unroll
      for (int s = 0; s < K; ++s) {
        int rank = s;  // dom_skip: the slot order
        if constexpr ((X & K1_LQ_DOM) == 0) {
          rank = 0;
#pragma unroll
          for (int j = 0; j < K; ++j)
            rank += qe[j] < qe[s] || (qe[j] == qe[s] && j < s);
        }
        order |= (unsigned)s << (4 * rank);
      }
    }
    if constexpr ((X & K1_LQ_REUSE) != 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) xp[c] = xg[c];
    }
    const T unit = C.unit[pass], cutoff = C.cutoff[pass];
    const int n_prev = n_cache;  // this pass matches earlier passes only
    T best = inf, xl_win[4] = {};
    int best_slot = 0, up = 0;
    // positions in rank order (the lane stops at the first it skips; under
    // dom_skip it goes on), then, after pass 2, the final winner again
    // where the cache gave it: the kernel's one lm_solve
    for (int p = 0; p <= K; ++p) {
      int s = K, row = 0;
      T q = inf;
      bool stop = p == K, dom = false;
      if (!stop) {
        s = (int)((order >> (4 * p)) & 15u);
        const int e = sl.ik(s);
        row = e & (Slots::INVALID - 1);
        if (!(e & Slots::INVALID)) q = qf[(size_t)row * B];
        if constexpr ((X & K1_LQ_DOM) != 0)
          dom = p > 0 && (!(q < inf) || q + (T)N + (T)100.0 >= best);
        else
          stop = p > 0 && (!(q < inf) || q + (T)N + (T)100.0 > best);
      }
      const bool again = stop && pass == 2 && !held;
      if (stop && !again) break;
      if (dom) {  // a dominated slot: its arrival only
        ILQR_EVENT(k1_opts_events, 2);
        up += 1;
        continue;
      }
      if (again) row = win_row;
      const bool ok = !again && q < inf;
      int hit = -1;
      if (dedup && ok)  // a bounded scan of the slice's rows
        for (int e = 0; e < n_prev; ++e)
          if (sl.row(e) == row) {
            hit = e;
            break;
          }
      T d, xl[4], us[N][2];
      int tr = 0;
      if (hit >= 0) {
        d = sl.d(hit);
#pragma unroll
        for (int c = 0; c < 4; ++c) xl[c] = sl.xl(hit, c);
      } else {
        T xt[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) xt[c] = st[row * row_stride + c * B];
#pragma unroll
        for (int i = 0; i < N; ++i) us[i][0] = us[i][1] = (T)0;
        const Solve<T, N> S{C, x0, xt, o};
        T cost;
        S.template lm_solve<true>(us, false, xl, cost, d, &tr);
        if (stats)
          executed += (int)__reduce_max_sync(__activemask(), (unsigned)tr);
      }
      useful += tr;
      up += 1 + tr;
      // the final winner's us (solved again), or a new best's that it
      // solved
      const T i_rel = fmax(ceil(d / unit - (T)1e-12), (T)1.0);
      const T cost = ok && d <= cutoff ? q + (T)N + (T)100.0 * i_rel : inf;
      // the (cost, slot) lexicographic minimum; slot 0 is the winner while
      // every cost is +inf
      const bool better = !again && (s == best_slot || cost < best ||
                                     (cost == best && s < best_slot));
      if (again || (better && hit < 0)) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          sl.us(i, 0) = us[i][0];
          sl.us(i, 1) = us[i][1];
        }
      }
      if (again) break;
      if (dedup && ok && pass < 2 && hit < 0) {  // a row not cached yet
        sl.row(n_cache) = row;
        sl.d(n_cache) = d;
#pragma unroll
        for (int c = 0; c < 4; ++c) sl.xl(n_cache, c) = xl[c];
        ++n_cache;
      }
      if (better) {
        best = cost;
        best_slot = s;
        win_row = row;
#pragma unroll
        for (int c = 0; c < 4; ++c) xl_win[c] = xl[c];
        held = hit < 0;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) xg[c] = xl_win[c];
    if (stats) upass_out[pass * B + b] = up;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    us_out[(2 * i) * B + b] = sl.us(i, 0);
    us_out[(2 * i + 1) * B + b] = sl.us(i, 1);
  }
  shrink_out[b] = (win_row + 1) > (len - 1) ? (T)1 : (T)0;
  idx_out[b] = win_row;
  row_out[b] = 0;
  if (stats) {
    useful_out[b] = useful;
    exec_out[b] = executed;
  }
}

template <typename T, int N, int K, int X = 0>
__global__ void __launch_bounds__(K1_LQ_THREADS,
                      sizeof(T) == 4 ? K1_LQ_F32_BLOCKS : 1)
    i2lqr_step_lanes_kernel(
        const Consts<T> C, int B, int nb, int T_rows, int opts,
        const T* __restrict__ x, const T* __restrict__ g0,
        const T* __restrict__ states, const T* __restrict__ qfun,
        const int* __restrict__ lap_len, const int* __restrict__ lap_ids,
        const int* __restrict__ lap_ok, const T* __restrict__ obs,
        const float* __restrict__ skip, T* __restrict__ us_out,
        T* __restrict__ shrink_out, int* __restrict__ idx_out,
        int* __restrict__ row_out, int* __restrict__ useful_out,
        int* __restrict__ exec_out, int* __restrict__ upass_out,
        int* __restrict__ counter, int n_threads) {
  static_assert(K <= 8, "the rank order: K slots of 4 bits");
  constexpr unsigned FULL = 0xffffffffu;
  const bool stats = opts & K1_OPT_STATS, dedup = opts & K1_OPT_DEDUP;
  const int lap = lap_ids[0];
  const bool lap_stored = lap_ok[0] != 0;
  const int wl = threadIdx.x & 31;
  unsigned char* smem = dynamic_shared();
  LaneSlots<T, N, K> sl(smem, threadIdx.x);
  int* ring = LaneSlots<T, N, K>::ring(smem, threadIdx.x);
  // the warp's chunk of lanes chunk .. chunk + 31; the first by its index
  int chunk = blockIdx.x * blockDim.x + threadIdx.x - wl;
  int head = 0, queued = 0;  // the ring's first slot and its lanes
  for (;;) {
    if (queued >= 32 || (queued > 0 && chunk >= nb)) {
      // a round: the ring's next 32 live lanes, one a thread
      __syncwarp();
      const int b = wl < queued ? ring[(head + wl) % K1_LQ_RING] : -1;
      __syncwarp();
      head = (head + 32) % K1_LQ_RING;
      queued = queued > 32 ? queued - 32 : 0;
      if (b >= 0)
        lane_step<T, N, K, X>(C, B, T_rows, stats, dedup, lap, lap_stored, b,
                           sl, x, g0, states, qfun, lap_len, obs, us_out,
                           shrink_out, idx_out, row_out, useful_out,
                           exec_out, upass_out);
    } else if (chunk < nb) {
      // a chunk: its skipped lanes now, its live lanes into the ring
      const int c = chunk + wl;
      const bool in = c < nb;
      const bool sk = in && skip[c] > 0.5f;
      const unsigned mask = __ballot_sync(FULL, in && !sk);
      if (in && !sk)
        ring[(head + queued + __popc(mask & ((1u << wl) - 1u))) %
             K1_LQ_RING] = c;
      queued += __popc(mask);
      int next = 0;
      if (wl == 0) next = n_threads + atomicAdd(counter, 32);
      chunk = __shfl_sync(FULL, next, 0);
      if (sk) {
        for (int i = 0; i < 2 * N; ++i) us_out[i * B + c] = (T)0;
        shrink_out[c] = (T)0;
        idx_out[c] = 0;
        row_out[c] = 0;
        if (stats) {
          useful_out[c] = 0;
          exec_out[c] = 0;
          for (int p = 0; p < 3; ++p) upass_out[p * B + c] = 0;
        }
      }
    } else {
      break;
    }
  }
}

// The lane queue with the compile-time flags X.
template <typename T, int N, int K, int X>
int launch_i2lqr_step_lanes(const Consts<T>& C, int opts, int B, int nb,
                            int T_rows, const void* x, const void* g0,
                            const void* states, const void* qfun,
                            const void* lap_len, const void* lap_ids,
                            const void* lap_ok, const void* obs,
                            const void* skip, void* us, void* shrink,
                            void* idx, void* row, void* useful, void* exec,
                            void* upass, void* counter, cudaStream_t stream) {
  return launch_lanes<i2lqr_step_lanes_kernel<T, N, K, X>,
                      LaneSlots<T, N, K>::BYTES>(
      nb, (int*)counter, stream, C, B, nb, T_rows, opts, (const T*)x,
      (const T*)g0, (const T*)states, (const T*)qfun, (const int*)lap_len,
      (const int*)lap_ids, (const int*)lap_ok, (const T*)obs,
      (const float*)skip, (T*)us, (T*)shrink, (int*)idx, (int*)row,
      (int*)useful, (int*)exec, (int*)upass);
}

template <typename T, int N, int K, int NSI>
int launch_i2lqr_step_opts(int opts, const double* consts, int max_iter,
                           int B, int nb, int T_rows, const void* x,
                           const void* g0,
                           const void* states, const void* qfun,
                           const void* lap_len, const void* lap_ids,
                           const void* lap_ok, const void* obs,
                           const void* skip, void* us, void* shrink,
                           void* idx, void* row, void* useful, void* exec,
                           void* upass, void* counter, cudaStream_t stream) {
  const Consts<T> C = make_consts<T>(consts, max_iter);
  const bool reuse = opts & K1_OPT_REUSE;
  if constexpr (NSI == 1) {
    if (opts & (K1_OPT_QSORT | K1_OPT_DOM)) {
      const int x_flags = (reuse ? K1_LQ_REUSE : 0) |
                          (opts & K1_OPT_DOM ? K1_LQ_DOM : 0);
#define K1_LANES_CASE(X_)                                                   \
  if (x_flags == X_)                                                         \
    return launch_i2lqr_step_lanes<T, N, K, X_>(                             \
        C, opts, B, nb, T_rows, x, g0, states, qfun, lap_len, lap_ids,       \
        lap_ok, obs, skip, us, shrink, idx, row, useful, exec, upass,        \
        counter, stream);
      K1_LANES_CASE(0)
      K1_LANES_CASE(K1_LQ_REUSE)
      K1_LANES_CASE(K1_LQ_DOM)
      K1_LANES_CASE(K1_LQ_REUSE | K1_LQ_DOM)
#undef K1_LANES_CASE
    }
  }
  constexpr int lanes_per_block = 128 / (NSI * K);
  const auto kernel = reuse ? i2lqr_step_opts_kernel<T, N, K, NSI, true>
                            : i2lqr_step_opts_kernel<T, N, K, NSI>;
  kernel<<<(nb + lanes_per_block - 1) / lanes_per_block, 128, 0, stream>>>(
      C, B, nb, T_rows, opts, (const T*)x, (const T*)g0, (const T*)states,
      (const T*)qfun, (const int*)lap_len, (const int*)lap_ids,
      (const int*)lap_ok, (const T*)obs, (const float*)skip, (T*)us,
      (T*)shrink, (int*)idx, (int*)row, (int*)useful, (int*)exec,
      (int*)upass);
  return (int)cudaGetLastError();
}

}  // namespace ilqr

#define I2LQR_OPTS_CASE(TYPE, CODE, N_, K_, NSI_)                            \
  if (dtype == CODE && n == N_ && k == K_ && nsi == NSI_)                    \
    return ilqr::launch_i2lqr_step_opts<TYPE, N_, K_, NSI_>(                 \
        opts, consts, max_iter, B, lanes, T_rows, x, g0, states, qfun,       \
        lap_len,                                                             \
        lap_ids, lap_ok, obs, skip, us, shrink, idx, row, useful, exec,      \
        upass, counter, s);

// K1 at k = 8 with options: opts ORs 1 (with_stats), 2 (dedup), 4
// (qsort_skip, nsi = 1 only: the lane queue), 8 (reuse_extract) and 16
// (dom_skip, nsi = 1 only: the lane queue in slot order). Arguments as
// i2lqr_step_launch's, then the stats (int32: useful (B,), executed (B,),
// upass (3, B); read only with with_stats, else may be null), the lane
// queue's counter (one int32 of device memory), the stream and the lanes
// to run (as i2lqr_step_launch's). Returns the cudaError_t of the launch,
// or -1 when no kernel is
// instantiated for (dtype, n, k, nsi) or qsort_skip is asked with
// nsi != 1.
extern "C" int i2lqr_step_opts_launch(
    int dtype, int n, int k, int nsi, int opts, const double* consts,
    int max_iter, int B, int T_rows, int max_laps, const void* x,
    const void* g0, const void* states, const void* qfun,
    const void* lap_len, const void* lap_ids, const void* lap_ok,
    const void* obs, const void* skip, void* us, void* shrink, void* idx,
    void* row, void* useful, void* exec, void* upass, void* counter,
    void* stream, int lanes) {
  (void)max_laps;
  if (lanes < 0 || lanes > B) return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  if ((opts & (ilqr::K1_OPT_QSORT | ilqr::K1_OPT_DOM)) && nsi != 1) return -1;
  if (opts & ~(2 * ilqr::K1_OPT_DOM - 1)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  I2LQR_OPTS_CASE(float, 0, 6, 8, 1)
  I2LQR_OPTS_CASE(double, 1, 6, 8, 1)
  I2LQR_OPTS_CASE(float, 0, 6, 8, 2)
  I2LQR_OPTS_CASE(double, 1, 6, 8, 2)
  return -1;
}

#define I2LQR_OPTS_ATTRIBUTES(TYPE, CODE, N_, K_, NSI_)                      \
  if (dtype == CODE && n == N_ && k == K_ && nsi == NSI_)                    \
    return ilqr::kernel_attributes(                                          \
        ilqr::i2lqr_step_opts_kernel<TYPE, N_, K_, NSI_>, 128, out);

// The loaded options kernel's resources (kernel_attributes, tile.cuh): the
// tile's at nsi 1 and 2, the lane queue's (qsort_skip) at nsi 0; -1 when
// none is instantiated.
extern "C" int i2lqr_step_opts_attributes(int dtype, int n, int k, int nsi,
                                          int* out) {
  if (n == 6 && k == 8 && nsi == 0)
    return dtype == 0
               ? ilqr::kernel_attributes(
                     ilqr::i2lqr_step_lanes_kernel<float, 6, 8>, 128, out,
                     ilqr::LaneSlots<float, 6, 8>::BYTES)
               : ilqr::kernel_attributes(
                     ilqr::i2lqr_step_lanes_kernel<double, 6, 8>, 128, out,
                     ilqr::LaneSlots<double, 6, 8>::BYTES);
  I2LQR_OPTS_ATTRIBUTES(float, 0, 6, 8, 1)
  I2LQR_OPTS_ATTRIBUTES(double, 1, 6, 8, 1)
  I2LQR_OPTS_ATTRIBUTES(float, 0, 6, 8, 2)
  I2LQR_OPTS_ATTRIBUTES(double, 1, 6, 8, 2)
  return -1;
}

#ifdef K1_COUNT_SOLVES
// A counting build's events of this file since the last call (lane-passes
// 1-2 under reuse_extract, those whose kNN was kept, slots dom_skip passed
// over) into out[0..2]; zeroes them. Waits for the device.
extern "C" int i2lqr_step_opts_events(unsigned long long* out) {
  return ilqr::read_events(ilqr::k1_opts_events, out);
}
#endif

#define I2LQR_VARIANT_ATTRIBUTES(TYPE, CODE, NSI_)                            \
  if (dtype == CODE && nsi == NSI_) {                                        \
    if (NSI_ == 1 && (opts & (ilqr::K1_OPT_QSORT | ilqr::K1_OPT_DOM))) {     \
      const int x = (reuse ? ilqr::K1_LQ_REUSE : 0) |                        \
                    (opts & ilqr::K1_OPT_DOM ? ilqr::K1_LQ_DOM : 0);         \
      const int bytes = ilqr::LaneSlots<TYPE, 6, 8>::BYTES;                  \
      if (x == 0)                                                            \
        return ilqr::kernel_attributes(                                      \
            ilqr::i2lqr_step_lanes_kernel<TYPE, 6, 8, 0>, 128, out, bytes);  \
      if (x == ilqr::K1_LQ_REUSE)                                            \
        return ilqr::kernel_attributes(                                      \
            ilqr::i2lqr_step_lanes_kernel<TYPE, 6, 8, ilqr::K1_LQ_REUSE>,    \
            128, out, bytes);                                                \
      if (x == ilqr::K1_LQ_DOM)                                              \
        return ilqr::kernel_attributes(                                      \
            ilqr::i2lqr_step_lanes_kernel<TYPE, 6, 8, ilqr::K1_LQ_DOM>, 128, \
            out, bytes);                                                     \
      return ilqr::kernel_attributes(                                        \
          ilqr::i2lqr_step_lanes_kernel<TYPE, 6, 8,                          \
                                        ilqr::K1_LQ_REUSE | ilqr::K1_LQ_DOM>, \
          128, out, bytes);                                                  \
    }                                                                        \
    return reuse ? ilqr::kernel_attributes(                                  \
                       ilqr::i2lqr_step_opts_kernel<TYPE, 6, 8, NSI_, true>, \
                       128, out)                                             \
                 : ilqr::kernel_attributes(                                  \
                       ilqr::i2lqr_step_opts_kernel<TYPE, 6, 8, NSI_>, 128,  \
                       out);                                                 \
  }

// The resources of the kernel i2lqr_step_opts_launch runs for (dtype, n,
// k, nsi, opts), as i2lqr_step_opts_attributes reports them; -1 when none
// is instantiated.
extern "C" int i2lqr_step_opts_variant_attributes(int dtype, int n, int k,
                                                  int nsi, int opts,
                                                  int* out) {
  if (n != 6 || k != 8) return -1;
  const bool reuse = opts & ilqr::K1_OPT_REUSE;
  I2LQR_VARIANT_ATTRIBUTES(float, 0, 1)
  I2LQR_VARIANT_ATTRIBUTES(double, 1, 1)
  I2LQR_VARIANT_ATTRIBUTES(float, 0, 2)
  I2LQR_VARIANT_ATTRIBUTES(double, 1, 2)
  return -1;
}
