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
// lap id, as there, and its costs are masked. Of the TPU kernel's options
// this file takes none at k = 8, and at k = 32 dedup is in effect whatever
// the factory says (below), and reuse_extract is an instantiation of its
// own. At k = 8, with_stats, dedup, qsort_skip, reuse_extract and dom_skip
// run in i2lqr_step_opts.cu and group in i2lqr_step_group.cu, which compute
// this kernel's outputs bit for bit (the options are bitwise-neutral), so
// this kernel computes what the bench's does; stream_safe_set and
// store_solutions are not ported (ops/i2lqr_step.py, _UNPORTED).
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
// i2lqr_step_block_kernel, which solves each distinct (lap, kNN row) of a
// step once, as the JAX sweep's k = 32 build does (dedup=True,
// store_solutions=False: ops/pallas_i2lqr_step.py:82-109). A candidate's
// solve is a pure function of (x0, its safe-set row, the obstacle), so a
// row repeats bit for bit wherever it recurs: in a later pass, in a row of
// a lap not yet stored (its lap id clipped onto a stored lap), or when a
// lap of at most 32 rows gives every row in every pass. A block holds 4
// lanes, lane i on warp i. Per pass a lane's warp runs the kNN of each
// distinct lap id in turn (knn_rows_group over the lap with lists of depth
// ceil(T / 32): a thread sees at most that many rows, so deeper lists
// would hold only +inf) into the lane's table in shared memory, and queues
// the valid slots of the laps a stored row reads whose (lap, row) the step
// has not solved (a ballot and its popcount prefix, in slot order). The
// block's 128 threads then solve its lanes' queues, one after the other,
// one solve a thread (zeros-initialised lm_solve; entry j on thread
// (the block's solves so far + j) % 128), keeping each solve's
// distance and, for a lane's first K1_BLOCK_XL solves, terminal state in
// the lane's cache, indexed by (lap, row). reuse_extract (a REUSE
// instantiation): a lane whose guess did not move since the last pass
// (float == on every component) keeps its table's kNN rows and runs no
// kNN; its queue is then empty (every row it names is solved). Each thread
// of a lane's warp
// reads its slot of every row, takes the reach cost from the cache with
// this pass's unit and cutoff, and the warp selects by ballots and
// shuffles what lex_select does (the first differing slot decides a row
// compare, a first-min argmin the column); the guess re-centres on the
// winner's cached terminal state. A winner that no cost read (slot 0 of a
// lap without rows, or of a lap that only rows not yet stored name) or
// whose terminal state was not kept is solved then, in a round of the
// block's such winners. Absent slots and rows of laps not yet stored are
// never solved. The final winner's us are written by the thread that
// solved it when no later solve of that thread overwrote them (the
// rotation above makes that so for a block's last 128 solves), else it is
// solved once more (bitwise the same solution). The kernel has one call
// of lm_solve: three sites made nvcc keep it a function whose arrays live
// in local memory. Skipped lanes write zeros; their warps solve with the
// block.
//
// What bounds it on the card: the distinct solves' LM chains, 128 a round
// of the block, each round lasting its slowest solve: a block pools its
// lanes' solves, so a step with few live lanes runs a lane's pass in one
// or two rounds (a step's latency is what the sweep's late steps pay, with
// few lanes left), and a full step runs about a quarter of the plain
// order's solves (a counting build, K1_COUNT_SOLVES below, counts them on
// the card). The solve's registers set 16 resident warps
// (K1_BLOCK_MIN_WARPS, 128 registers); the cache is 5.5 KB a lane in f32
// (dist direct-mapped, K1_BLOCK_XL terminal states). A counting (STATS)
// instantiation adds each solve's trips a (u, row) in shared memory and
// counts with_stats from them (i2lqr_step_block_kernel's comment).
//
// Every kernel here takes the count of lanes to run (nb) apart from B, the
// lane stride of its arrays: a launch over the first nb lanes of
// full-width arrays, as the simulators' tail_shrink prefix launches, reads
// and writes nothing past them.
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
    const Consts<T> C, int B, int nb, int T_rows, const T* __restrict__ x,
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
  if (b >= nb) return;
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

// The resident warps an SM that __launch_bounds__ asks of the k = 32
// kernel, which caps its registers as K1_MIN_BLOCKS caps the tile
// kernel's: 128 a thread; the fastest of 8, 12 and 16 warps (PERF.md,
// experiments/kernel_ab.py).
constexpr int K1_BLOCK_MIN_WARPS = 16;
constexpr int K1_BLOCK_K = 32;    // candidates a lap row: a warp
constexpr int K1_BLOCK_D = 4;     // kNN list depth: T_rows <= 32 * 4
constexpr int K1_BLOCK_ROWS = K1_BLOCK_K * K1_BLOCK_D;
// terminal states a lane keeps, in solve order (a winner past them is
// solved again)
constexpr int K1_BLOCK_XL = 160;
// lanes a block: lane w on warp w (its kNN, queue and selection); the
// block's 128 threads solve the lanes' queues together
constexpr int K1_BLOCK_LANES = 4;

#ifdef K1_COUNT_SOLVES
// A counting build (nvcc -DK1_COUNT_SOLVES): the k = 32 kernel adds each
// solve it runs to k1_solves, which i2lqr_step_solves reads and zeroes,
// and its REUSE instantiations their events (tile.cuh): lane-passes 1-2,
// and of them those whose kNN was kept.
__device__ unsigned long long k1_solves;
__device__ unsigned long long k1_block_events[2];
#define K1_ON_SOLVE(lane) atomicAdd(&k1_solves, 1ull)
#endif

// One lane's state of the k = 32 kernel in shared memory: the cache of the
// step's solves by (distinct lap u, safe-set row) and this pass's table. A
// distinct lap is named by the first lap row r whose lap id it is.
template <typename T, int NSI>
struct K1Lane {
  T dist[NSI][K1_BLOCK_ROWS];  // |x_N - x_term| of a solved (u, row)
  // terminal states in solve order; the last, a winner solved again
  T xl[K1_BLOCK_XL + 1][4];
  // 0: (u, row) not solved; else 1 + its entry of xl (K1_BLOCK_XL: not kept)
  unsigned char at[NSI][K1_BLOCK_ROWS];
  unsigned char ik[NSI][K1_BLOCK_K];  // this pass's kNN rows of lap u
  unsigned valid[NSI];                // slot s of lap u holds a row
  unsigned short queue[NSI * K1_BLOCK_K];  // u * ROWS + row, to solve
  int n_queue;  // of queue
  int kept;     // the queues' solves before this pass
  int key;      // the final winner: u * ROWS + row, and its lap row
  int best;
  int writer;   // the thread that holds the winner's us
};

// What a counting instantiation of the k = 32 kernel (STATS) keeps in
// shared memory a lane: each solved (distinct lap u, row)'s trips, and
// under dedup the rows a lap row's valid candidates named in passes 0 and
// 1. The plain instantiation keeps a char instead.
template <int NSI>
struct K1Counts {
  unsigned short trips[K1_BLOCK_LANES][NSI][K1_BLOCK_ROWS];
  unsigned seen[K1_BLOCK_LANES][NSI][K1_BLOCK_ROWS / 32];
};
template <bool STATS, int NSI>
struct K1CountsOf {
  using type = K1Counts<NSI>;
};
template <int NSI>
struct K1CountsOf<false, NSI> {
  using type = char;
};

// A lane's outputs: its winner's us (held by this thread), the shrink
// flag, the winner's kNN row and lap row.
template <typename T, int N, int NSI>
__device__ __forceinline__ void k1_write(const K1Lane<T, NSI>& L,
                                         const T (&us)[N][2], int B, int b,
                                         const int* lap_len,
                                         const int* lap_ids, T* us_out,
                                         T* shrink_out, int* idx_out,
                                         int* row_out) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    us_out[(2 * i) * B + b] = us[i][0];
    us_out[(2 * i + 1) * B + b] = us[i][1];
  }
  const int idx = L.key % K1_BLOCK_ROWS;
  const int len_sel = lap_len[(size_t)lap_ids[L.best] * B + b];
  shrink_out[b] = (idx + 1) > (len_sel - 1) ? (T)1 : (T)0;
  idx_out[b] = idx;
  row_out[b] = L.best;
}

// K1 at k = 32: K1_BLOCK_LANES lanes a block, a warp each (header).
//
// with_stats (a STATS instantiation, i2lqr_step_block_stats_launch): the
// counts of i2lqr_step_opts.cu, a lane's, summed over the step.
// iters_useful and upass (3, B) are the plain version's per lane
// (i2lqr_step_reference): every candidate slot's trips a pass in the
// plain order, a slot without a row solving row 0, a lap row not yet
// stored its clipped lap's rows, and under dedup (opts & 2) not the slots
// a valid candidate of the same lap row named in passes 0 and 1, the
// final winner so taken counted again; the kernel reads them from the
// trips of its pooled solves (a solve is a pure function of its lap and
// row, so its trips repeat wherever the row recurs). iters_executed is
// the warp's: each round of solves its 32 threads run together, 32 times
// the longest solve among them, a pooled solve counted on the warp that
// runs it, whichever lane it serves (a skipped lane's warp solves for
// the block, and is counted; a warp past the launch's last lane is not).
// So a block's useful trips may exceed its executed thread-trips: that
// excess is what pooling saves.
template <typename T, int N, int NSI, bool STATS = false, bool REUSE = false>
__global__ void __launch_bounds__(K1_BLOCK_LANES * 32,
                                  K1_BLOCK_MIN_WARPS / K1_BLOCK_LANES)
    i2lqr_step_block_kernel(
        const Consts<T> C, int B, int nb, int T_rows,
        const T* __restrict__ x, const T* __restrict__ g0,
        const T* __restrict__ states,
        const T* __restrict__ qfun, const int* __restrict__ lap_len,
        const int* __restrict__ lap_ids, const int* __restrict__ lap_ok,
        const T* __restrict__ obs, const float* __restrict__ skip,
        T* __restrict__ us_out, T* __restrict__ shrink_out,
        int* __restrict__ idx_out, int* __restrict__ row_out,
        int opts = 0, int* __restrict__ useful_out = nullptr,
        int* __restrict__ exec_out = nullptr,
        int* __restrict__ upass_out = nullptr) {
  static_assert(NSI <= 4, "two bits a lap row's distinct lap");
  constexpr int K = K1_BLOCK_K, ROWS = K1_BLOCK_ROWS, XL = K1_BLOCK_XL;
  constexpr int LANES = K1_BLOCK_LANES, THREADS = 32 * LANES;
  __shared__ K1Lane<T, NSI> lanes[LANES];
  __shared__ typename K1CountsOf<STATS, NSI>::type cnt;
  const int tid = threadIdx.x, w = tid / 32, s = tid % 32;
  const int b0 = blockIdx.x * LANES;  // the block's first lane
  const int b = b0 + w;               // this warp's lane
  if (b < nb && skip[b] > 0.5f) {  // a skipped lane: zeros
    for (int i = s; i < 2 * N; i += 32) us_out[i * B + b] = (T)0;
    if (s == 0) {
      shrink_out[b] = (T)0;
      idx_out[b] = 0;
      row_out[b] = 0;
    }
  }
  // this warp runs a live lane (else it only solves the block's queues)
  const bool own = b < nb && skip[b] <= 0.5f;
  K1Lane<T, NSI>& L = lanes[w];
  const Tile<32> warp;
  const T inf = (T)INFINITY;
  T xg[4];
  [[maybe_unused]] T xp[4];  // reuse_extract: the last kNN's guess
  if (own) {
#pragma unroll
    for (int q = 0; q < 4; ++q) xg[q] = g0[q * B + b];
  }
  const size_t row_stride = (size_t)4 * B;  // one safe-set row (4, B)
  // bit masks of the lap rows: stored, and distinct laps whose costs a
  // stored row reads; two bits a row: the first row of its lap id
  unsigned lok = 0, need = 0, firsts = 0;
#pragma unroll
  for (int r = 0; r < NSI; ++r) {
    int f = r;
    for (int r2 = r - 1; r2 >= 0; --r2)
      if (lap_ids[r2] == lap_ids[r]) f = r2;
    firsts |= (unsigned)f << (2 * r);
    if (lap_ok[r] != 0) {
      lok |= 1u << r;
      need |= 1u << f;
    }
  }
  auto first = [&](int r) { return (int)(firsts >> (2 * r)) & 3; };
  for (int i = s; i < NSI * ROWS; i += 32) (&L.at[0][0])[i] = 0;
  if (s == 0) {
    L.n_queue = 0;
    L.kept = 0;
    L.writer = -1;
  }
  // the counts: the warp's thread-trips, the lane's useful trips, a pass's
  // useful trips and arrivals (upass)
  int executed = 0, useful = 0, upass[3] = {0, 0, 0};
  const bool dedup = opts & 2;
  if constexpr (STATS) {
    for (int i = s; i < NSI * ROWS; i += 32) {
      (&cnt.trips[w][0][0])[i] = 0;
      if (i < NSI * ROWS / 32) (&cnt.seen[w][0][0])[i] = 0u;
    }
  }

  T us[N][2];
  int held = -1, held_lane = -1;  // the (lane, u * ROWS + row) of `us`
  int pass = 0, best = 0, idx_sel = 0, e_sel = 0;
  // the block's solves so far: entry j of a round goes to thread
  // (solved + j) % THREADS, so that a thread solves again only after every
  // other one has (its last solution is then the newest it could hold)
  int solved = 0;
  // what the queues hold: a pass's candidates, winners no cost read or
  // whose terminal states were not kept, or final winners
  enum { PASS, WINNER, FINAL } queue = PASS;
  for (;;) {
    if (queue == PASS) {
      __syncthreads();  // the last pass's tables are read
      bool same = false;  // reuse_extract: the table's rows stand
      if constexpr (REUSE) {
        same = own && pass > 0 && same_guess(xg, xp);
        if (own && pass > 0 && s == 0) ILQR_EVENT(k1_block_events, 0);
        if (same && s == 0) ILQR_EVENT(k1_block_events, 1);
        if (own) {
#pragma unroll
          for (int q = 0; q < 4; ++q) xp[q] = xg[q];
        }
      }
      if (own) {
        // ---- the kNN of each distinct lap ----
#pragma unroll
        for (int u = 0; u < NSI; ++u) {
          if (same || first(u) != u) continue;
          const int len = lap_len[(size_t)lap_ids[u] * B + b];
          const int rows = len < T_rows ? len : T_rows;
          T dk;
          int ik;
          knn_rows_group<T, K, K, K1_BLOCK_D>(
              warp, s,
              states + (size_t)lap_ids[u] * T_rows * row_stride + b,
              row_stride, B, rows, xg, dk, ik);
          L.ik[u][s] = (unsigned char)ik;
          const unsigned v = warp.ballot(dk < inf);
          if (s == 0) L.valid[u] = v;
        }
        __syncwarp();
        // ---- the queue: valid slots of needed laps not solved yet;
        // entry q keeps its terminal state in entry kept + q of xl, if
        // any ----
        int n = 0;
#pragma unroll
        for (int u = 0; u < NSI; ++u) {
          if (first(u) != u || !((need >> u) & 1u)) continue;
          const int row = L.ik[u][s];
          const bool fresh =
              ((L.valid[u] >> s) & 1u) && L.at[u][row] == 0;
          const unsigned m = warp.ballot(fresh);
          if (fresh) {
            const int q = n + __popc(m & ((1u << s) - 1u));
            L.queue[q] = (unsigned short)(u * ROWS + row);
            L.at[u][row] =
                (unsigned char)(1 + (L.kept + q < XL ? L.kept + q : XL));
          }
          n += __popc(m);
        }
        if (s == 0) L.n_queue = n;
      }
      __syncthreads();
    }
    // ---- the lanes' queues, one after the other, THREADS at a time (the
    // kernel's one solve: its distance and terminal state into the lane's
    // cache; `us` keeps its solution) ----
    int total = 0;
#pragma unroll
    for (int i = 0; i < LANES; ++i) total += lanes[i].n_queue;
    for (int j = (tid - solved % THREADS + THREADS) % THREADS; j < total;
         j += THREADS) {
      int i = 0, q = j;
      while (q >= lanes[i].n_queue) q -= lanes[i++].n_queue;
      K1Lane<T, NSI>& Li = lanes[i];
      const int bi = b0 + i;
      const int key = Li.queue[q], u = key / ROWS, row = key % ROWS;
      const int e = queue == PASS && Li.kept + q < XL ? Li.kept + q : XL;
      T x0[4], xt[4];
      const T* p =
          states + ((size_t)lap_ids[u] * T_rows + row) * row_stride + bi;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        x0[c] = x[c * B + bi];
        xt[c] = p[c * B];
      }
      const Obs<T> o = load_obs(obs, B, bi);
#pragma unroll
      for (int c = 0; c < N; ++c) us[c][0] = us[c][1] = (T)0;
      const Solve<T, N> S{C, x0, xt, o};
      T xl[4], cost, dist;
      if constexpr (STATS) {
        int tr = 0;
        S.template lm_solve<true>(us, false, xl, cost, dist, &tr);
        cnt.trips[i][u][row] = (unsigned short)tr;
      } else {
        S.lm_solve(us, false, xl, cost, dist);
      }
      Li.dist[u][row] = dist;
      // past the kept entries, a PASS round's solves all write entry XL;
      // it is read only after a WINNER round, whose one solve a lane is
      // then its last writer (a winner at XL is always solved again)
#pragma unroll
      for (int c = 0; c < 4; ++c) Li.xl[e][c] = xl[c];
      held = key;
      held_lane = i;
#ifdef K1_ON_SOLVE
      K1_ON_SOLVE(bi);  // a counting build counts the solves
#endif
      if (queue == FINAL)
        k1_write<T, N, NSI>(Li, us, B, bi, lap_len, lap_ids, us_out,
                            shrink_out, idx_out, row_out);
    }
    solved += total;
    __syncthreads();
    if constexpr (STATS) {
      // the round's thread-trips on this warp: every pass of the loop
      // above, 32 times its threads' longest solve
      const int j0 = (tid - (solved - total) % THREADS + THREADS) % THREADS;
      for (int j = j0, m = 0; m * THREADS < total; ++m, j += THREADS) {
        int tr = 0;
        if (j < total) {
          int i = 0, q = j;
          while (q >= lanes[i].n_queue) q -= lanes[i++].n_queue;
          const int key = lanes[i].queue[q];
          tr = cnt.trips[i][key / ROWS][key % ROWS];
        }
        executed += 32 * (int)__reduce_max_sync(0xffffffffu, (unsigned)tr);
      }
      __syncthreads();  // the queues are read
    }
    if (queue == FINAL) break;
    bool again = false;  // this lane's winner is to be solved
    if (own && queue == PASS) {
      if (s == 0) L.kept += L.n_queue;
      // ---- this thread's slot of every row: the relaxed reach cost
      // (masked on laps not yet stored and absent slots) and the ragged
      // list compare value (absent slots -inf, laps not yet stored +inf)
      const T unit = C.unit[pass], cutoff = C.cutoff[pass];
      T cmp[NSI], cst[NSI];
      unsigned hits = 0;  // STATS: the lap rows whose slot dedup takes
      int mine = 0;       // STATS: this thread's slots' useful trips
#pragma unroll
      for (int r = 0; r < NSI; ++r) {
        const int u = first(r);
        const int row = L.ik[u][s];
        const bool cok = ((lok >> r) & 1u) && ((L.valid[u] >> s) & 1u);
        if constexpr (STATS) {
          // this slot's useful trips, unless an earlier pass's valid
          // candidate of this lap row named its row (dedup)
          const bool hit = dedup && cok &&
                           ((cnt.seen[w][r][row / 32] >> (row % 32)) & 1u);
          hits |= (unsigned)hit << r;
          if (!hit) mine += cnt.trips[w][u][row];
        }
        T c = inf;
        if (cok) {
          const T dist = L.dist[u][row];
          const T cq = qfun[((size_t)lap_ids[r] * T_rows + row) * B + b];
          const T i_rel = fmax(ceil(dist / unit - (T)1e-12), (T)1.0);
          c = dist <= cutoff ? cq + (T)N + (T)100.0 * i_rel : inf;
        }
        cst[r] = c;
        cmp[r] = ((lok >> r) & 1u) ? (cok ? c : -inf) : inf;
      }
      // ---- lex_select by the warp: a row replaces the best where its
      // first differing slot is less; then the first-min slot of the best
      // row ----
      best = 0;
#pragma unroll
      for (int r = 1; r < NSI; ++r) {
        T bb = cmp[0];
#pragma unroll
        for (int q = 1; q < NSI; ++q)
          if (q == best) bb = cmp[q];
        const unsigned diff = warp.ballot(cmp[r] != bb);
        if (diff != 0u &&
            warp.shfl((int)(cmp[r] < bb), __ffs((int)diff) - 1) != 0)
          best = r;
      }
      T bc = cst[0];
#pragma unroll
      for (int q = 1; q < NSI; ++q)
        if (q == best) bc = cst[q];
      int col = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const T oc = warp.shfl_xor(bc, off);
        const int ocol = warp.shfl_xor(col, off);
        if (oc < bc || (oc == bc && ocol < col)) {
          bc = oc;
          col = ocol;
        }
      }
      const int u = first(best);
      idx_sel = L.ik[u][col];
      e_sel = (int)L.at[u][idx_sel] - 1;
      if constexpr (STATS) {
        // the pass's useful trips and its slots' arrivals; dedup keeps
        // this pass's rows
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mine += warp.shfl_xor(mine, off);
        useful += mine;
        upass[pass] = mine + NSI * K;
        if (dedup && pass < 2) {
#pragma unroll
          for (int r = 0; r < NSI; ++r) {
            const int row = L.ik[first(r)][s];
            if (((lok >> r) & 1u) && ((L.valid[first(r)] >> s) & 1u))
              atomicOr(&cnt.seen[w][r][row / 32], 1u << (row % 32));
          }
        }
        // a final winner dedup took is solved again: its trips once more
        if (pass == 2 && warp.shfl((int)((hits >> best) & 1u), col) != 0) {
          const int tr = cnt.trips[w][u][idx_sel];
          useful += tr;
          upass[2] += tr + 1;
        }
      }
      // a winner no cost read, or whose terminal state was not kept, is
      // solved now into the last entry of xl
      again = e_sel < 0 || e_sel == XL;
      __syncwarp();
      if (s == 0) {
        L.n_queue = again ? 1 : 0;
        if (again) {
          L.queue[0] = (unsigned short)(u * ROWS + idx_sel);
          L.at[u][idx_sel] = (unsigned char)(1 + XL);
        }
      }
      if (again) e_sel = XL;
    }
    if (queue == PASS && __syncthreads_or(again)) {
      queue = WINNER;
      continue;
    }
    if (own) {  // the guess re-centres on the winner's terminal state
#pragma unroll
      for (int c = 0; c < 4; ++c) xg[c] = L.xl[e_sel][c];
    }
    queue = PASS;
    if (++pass < 3) continue;
    // ---- each lane's us: written by the thread that holds them, else
    // solved once more ----
    if (own && s == 0) {
      L.key = first(best) * ROWS + idx_sel;
      L.best = best;
    }
    __syncthreads();
    // only live lanes queue solves; of the threads that hold a winner (its
    // solver and a WINNER round's, past the kept entries) one writes
    if (held_lane >= 0 && held == lanes[held_lane].key &&
        atomicCAS(&lanes[held_lane].writer, -1, tid) == -1)
      k1_write<T, N, NSI>(lanes[held_lane], us, B, b0 + held_lane, lap_len,
                          lap_ids, us_out, shrink_out, idx_out, row_out);
    __syncthreads();
    const bool last = own && L.writer < 0;
    if (own && s == 0) {
      L.n_queue = last ? 1 : 0;
      L.queue[0] = (unsigned short)L.key;
    }
    if (!__syncthreads_or(last)) break;
    queue = FINAL;
  }
  if constexpr (STATS) {  // a lane's counts; a skipped lane's warp's
    if (b < nb && s == 0) {
      useful_out[b] = own ? useful : 0;
      exec_out[b] = executed;
#pragma unroll
      for (int p = 0; p < 3; ++p) upass_out[p * B + b] = own ? upass[p] : 0;
    }
  }
}

template <typename T, int N, int NSI, bool STATS = false,
          bool REUSE = false>
int launch_i2lqr_step_block(const double* consts, int max_iter, int B,
                            int nb, int T_rows, const void* x,
                            const void* g0, const void* states,
                            const void* qfun, const void* lap_len,
                            const void* lap_ids, const void* lap_ok,
                            const void* obs, const void* skip, void* us,
                            void* shrink, void* idx, void* row,
                            cudaStream_t stream, int opts = 0,
                            void* useful = nullptr, void* exec = nullptr,
                            void* upass = nullptr) {
  if (T_rows > K1_BLOCK_ROWS) return -1;  // a thread would drop rows
  const Consts<T> C = make_consts<T>(consts, max_iter);
  constexpr int lanes = K1_BLOCK_LANES;
  i2lqr_step_block_kernel<T, N, NSI, STATS, REUSE>
      <<<(nb + lanes - 1) / lanes, lanes * 32, 0, stream>>>(
      C, B, nb, T_rows, (const T*)x, (const T*)g0, (const T*)states,
      (const T*)qfun, (const int*)lap_len, (const int*)lap_ids,
      (const int*)lap_ok, (const T*)obs, (const float*)skip, (T*)us,
      (T*)shrink, (int*)idx, (int*)row, opts, (int*)useful, (int*)exec,
      (int*)upass);
  return (int)cudaGetLastError();
}

template <typename T, int N, int K, int NSI>
int launch_i2lqr_step(const double* consts, int max_iter, int B, int nb,
                      int T_rows, const void* x, const void* g0,
                      const void* states, const void* qfun,
                      const void* lap_len, const void* lap_ids,
                      const void* lap_ok, const void* obs, const void* skip,
                      void* us, void* shrink, void* idx, void* row,
                      cudaStream_t stream) {
  const Consts<T> C = make_consts<T>(consts, max_iter);
  constexpr int lanes_per_block = 128 / (NSI * K);
  i2lqr_step_kernel<T, N, K, NSI>
      <<<(nb + lanes_per_block - 1) / lanes_per_block, 128, 0, stream>>>(
      C, B, nb, T_rows, (const T*)x, (const T*)g0, (const T*)states,
      (const T*)qfun, (const int*)lap_len, (const int*)lap_ids,
      (const int*)lap_ok, (const T*)obs, (const float*)skip, (T*)us,
      (T*)shrink, (int*)idx, (int*)row);
  return (int)cudaGetLastError();
}

}  // namespace ilqr

#define I2LQR_CASE(TYPE, CODE, N_, K_, NSI_)                                 \
  if (dtype == CODE && n == N_ && k == K_ && nsi == NSI_)                    \
    return ilqr::launch_i2lqr_step<TYPE, N_, K_, NSI_>(                      \
        consts, max_iter, B, lanes, T_rows, x, g0, states, qfun, lap_len,    \
        lap_ids, lap_ok, obs, skip, us, shrink, idx, row, s);

// k = 32: one lane a warp, kNN lists of depth 4 (T <= 128 rows).
#define I2LQR_BLOCK_CASE(TYPE, CODE, N_, NSI_)                              \
  if (dtype == CODE && n == N_ && k == 32 && nsi == NSI_)                    \
    return ilqr::launch_i2lqr_step_block<TYPE, N_, NSI_>(                    \
        consts, max_iter, B, lanes, T_rows, x, g0, states, qfun, lap_len,    \
        lap_ids, lap_ok, obs, skip, us, shrink, idx, row, s);

// dtype: 0 float32, 1 float64. B is the lane stride of every (..., B)
// array; the kernel runs lanes 0 .. lanes - 1 (lanes <= B) and writes
// nothing past them (the caller's outputs there stay as they were).
// `lanes` comes last, so that an earlier checkout's launcher, which does
// not take it, runs every lane. max_laps is the safe set's leading size
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
                                 void* stream, int lanes) {
  (void)max_laps;
  if (lanes < 0 || lanes > B) return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
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

#define I2LQR_BLOCK_STATS_CASE(TYPE, CODE, N_, NSI_)                        \
  if (dtype == CODE && n == N_ && nsi == NSI_)                               \
    return opts & 8 ? ilqr::launch_i2lqr_step_block<TYPE, N_, NSI_, true,    \
                                                    true>(                   \
                          consts, max_iter, B, lanes, T_rows, x, g0, states, \
                          qfun, lap_len, lap_ids, lap_ok, obs, skip, us,     \
                          shrink, idx, row, s, opts, useful, exec, upass)    \
                    : ilqr::launch_i2lqr_step_block<TYPE, N_, NSI_, true>(   \
                          consts, max_iter, B, lanes, T_rows, x, g0, states, \
                          qfun, lap_len, lap_ids, lap_ok, obs, skip, us,     \
                          shrink, idx, row, s, opts, useful, exec, upass);

// K1 at k = 32 with with_stats: its STATS instantiation (the kernel's
// header), arguments as i2lqr_step_launch's without k, opts (2: dedup,
// which changes the counts only; 8: reuse_extract, its REUSE
// instantiation) after nsi, and the counts (int32: useful (B,), executed
// (B,), upass (3, B)) before the stream.
extern "C" int i2lqr_step_block_stats_launch(
    int dtype, int n, int nsi, int opts, const double* consts, int max_iter,
    int B, int T_rows, int max_laps, const void* x, const void* g0,
    const void* states, const void* qfun, const void* lap_len,
    const void* lap_ids, const void* lap_ok, const void* obs,
    const void* skip, void* us, void* shrink, void* idx, void* row,
    void* useful, void* exec, void* upass, void* stream, int lanes) {
  (void)max_laps;
  if (lanes < 0 || lanes > B) return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  I2LQR_BLOCK_STATS_CASE(float, 0, 6, 2)
  I2LQR_BLOCK_STATS_CASE(double, 1, 6, 2)
  I2LQR_BLOCK_STATS_CASE(float, 0, 6, 4)
  I2LQR_BLOCK_STATS_CASE(double, 1, 6, 4)
  return -1;
}

#define I2LQR_BLOCK_REUSE_CASE(TYPE, CODE, N_, NSI_)                        \
  if (dtype == CODE && n == N_ && nsi == NSI_)                               \
    return ilqr::launch_i2lqr_step_block<TYPE, N_, NSI_, false, true>(       \
        consts, max_iter, B, lanes, T_rows, x, g0, states, qfun, lap_len,    \
        lap_ids, lap_ok, obs, skip, us, shrink, idx, row, s);

// K1 at k = 32 with reuse_extract: the block kernel's REUSE instantiation,
// arguments as i2lqr_step_launch's without k.
extern "C" int i2lqr_step_block_reuse_launch(
    int dtype, int n, int nsi, const double* consts, int max_iter, int B,
    int T_rows, int max_laps, const void* x, const void* g0,
    const void* states, const void* qfun, const void* lap_len,
    const void* lap_ids, const void* lap_ok, const void* obs,
    const void* skip, void* us, void* shrink, void* idx, void* row,
    void* stream, int lanes) {
  (void)max_laps;
  if (lanes < 0 || lanes > B) return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  I2LQR_BLOCK_REUSE_CASE(float, 0, 6, 2)
  I2LQR_BLOCK_REUSE_CASE(double, 1, 6, 2)
  I2LQR_BLOCK_REUSE_CASE(float, 0, 6, 4)
  I2LQR_BLOCK_REUSE_CASE(double, 1, 6, 4)
  return -1;
}

#define I2LQR_ATTRIBUTES(TYPE, CODE, N_, K_, NSI_)                           \
  if (dtype == CODE && n == N_ && k == K_ && nsi == NSI_)                    \
    return ilqr::kernel_attributes(                                          \
        ilqr::i2lqr_step_kernel<TYPE, N_, K_, NSI_>, 128, out);

#define I2LQR_BLOCK_ATTRIBUTES(TYPE, CODE, N_, NSI_, ...)                   \
  if (dtype == CODE && n == N_ && k == 32 && nsi == NSI_)                    \
    return ilqr::kernel_attributes(                                          \
        ilqr::i2lqr_step_block_kernel<TYPE, N_, NSI_, __VA_ARGS__>,          \
        ilqr::K1_BLOCK_LANES * 32, out);

// The loaded kernel's resources for (dtype, n, k, nsi), as the runtime
// reports them (kernel_attributes, tile.cuh); -1 when no kernel is
// instantiated.
extern "C" int i2lqr_step_attributes(int dtype, int n, int k, int nsi,
                                     int* out) {
  I2LQR_ATTRIBUTES(float, 0, 6, 8, 1)
  I2LQR_ATTRIBUTES(double, 1, 6, 8, 1)
  I2LQR_ATTRIBUTES(float, 0, 6, 8, 2)
  I2LQR_ATTRIBUTES(double, 1, 6, 8, 2)
  I2LQR_BLOCK_ATTRIBUTES(float, 0, 6, 2, false)
  I2LQR_BLOCK_ATTRIBUTES(double, 1, 6, 2, false)
  I2LQR_BLOCK_ATTRIBUTES(float, 0, 6, 4, false)
  I2LQR_BLOCK_ATTRIBUTES(double, 1, 6, 4, false)
  return -1;
}

// The STATS instantiation's resources at k = 32 (as above).
extern "C" int i2lqr_step_block_stats_attributes(int dtype, int n, int nsi,
                                                 int* out) {
  const int k = 32;
  I2LQR_BLOCK_ATTRIBUTES(float, 0, 6, 2, true)
  I2LQR_BLOCK_ATTRIBUTES(double, 1, 6, 2, true)
  I2LQR_BLOCK_ATTRIBUTES(float, 0, 6, 4, true)
  I2LQR_BLOCK_ATTRIBUTES(double, 1, 6, 4, true)
  return -1;
}

// The REUSE instantiation's resources at k = 32 (as above).
extern "C" int i2lqr_step_block_reuse_attributes(int dtype, int n, int nsi,
                                                 int* out) {
  const int k = 32;
  I2LQR_BLOCK_ATTRIBUTES(float, 0, 6, 2, false, true)
  I2LQR_BLOCK_ATTRIBUTES(double, 1, 6, 2, false, true)
  I2LQR_BLOCK_ATTRIBUTES(float, 0, 6, 4, false, true)
  I2LQR_BLOCK_ATTRIBUTES(double, 1, 6, 4, false, true)
  return -1;
}

#ifdef K1_COUNT_SOLVES
// A counting build's solves of the k = 32 kernel since the last call, into
// *out; zeroes the count. Waits for the device. Returns the cudaError_t.
extern "C" int i2lqr_step_solves(unsigned long long* out) {
  const unsigned long long zero = 0;
  int rc = (int)cudaMemcpyFromSymbol(out, ilqr::k1_solves, sizeof zero);
  if (rc == 0)
    rc = (int)cudaMemcpyToSymbol(ilqr::k1_solves, &zero, sizeof zero);
  return rc;
}

// The REUSE instantiations' events (above) into out[0..1]; zeroes them.
extern "C" int i2lqr_step_block_events(unsigned long long* out) {
  return ilqr::read_events(ilqr::k1_block_events, out);
}
#endif
