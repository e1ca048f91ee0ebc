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
// Design: warps that solve only live lanes, taken from a lane queue. On the
// NLMPC per-candidate path about a quarter of the lanes are live over a
// run, scattered among skipped ones, and a warp lasts as long as its
// slowest live lane. The grid holds what the card keeps resident
// (launch_lanes, tile.cuh). A warp takes its lanes in chunks of 32: its
// first chunk by its index, the rest from a counter, one atomicAdd a chunk.
// It reads a chunk's skip flags with one ballot; its threads finish the
// chunk's skipped lanes at once (two residuals, a rollout and the verdict,
// no LM trip) and queue its live lanes in registers (slot s of the warp's
// queue is held by thread s % 32, in its q[s / 32]; the ballot's popcount
// and prefix place them). Once 16 live lanes are queued, or the chunks are
// spent, the warp solves a round of them, two adjacent threads a lane: one
// runs its clipped warm start, the other zeros; they exchange their
// residuals by a shuffle (the warm start wins ties) and the winner's thread
// finishes the lane. A round lasts the slowest of 16 lanes' longer start
// (one thread running both starts in series, 32 lanes a round, measured
// slower: the slowest of 32 lanes' summed trips); the warp reconverges
// when it is done.
//
// A lane's arithmetic does not depend on the thread that runs it or on
// the order of lanes, so every output equals the plain version's bit for
// bit. What bounds it on the card: the per-lane LM dependency chain (up to
// max_iters trips a start, each a Jacobian, a 9x9 Cholesky and 6 rollouts
// with sin/cos) times the trips of each round's slowest start, and
// registers (8 warps an SM). It reads 29 and writes 18 values per lane.
#include "nlmpc_core.cuh"

namespace ilqr {

constexpr int K4_ROUND = 16;  // live lanes a warp solves at once
constexpr unsigned K4_WARP = 0xffffffffu;

// The position of the k-th set bit (from 0) of m, which has more than k.
__device__ __forceinline__ int nth_set_bit(unsigned m, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (k >= c) {
      k -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// The tail of Shoot::feasibility_solve for a chosen iterate uf: the
// clipped solution, x_m of its rollout, term_err and the verdict.
template <typename T, int N>
__device__ __forceinline__ bool finish_lane(const Shoot<T, N>& S,
                                            const T (&uf)[2 * N],
                                            T (&us)[N][2], T (&x_m)[4],
                                            T& term_err) {
  const NlmpcConsts<T>& C = S.C;
  T xs[N + 1][4];
  S.rollout(uf, xs);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    us[j][0] = clip(uf[2 * j], C.neg_a_max, C.a_max);
    us[j][1] = clip(uf[2 * j + 1], C.neg_d_max, C.d_max);
  }
  T dd[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    x_m[c] = S.at_m(xs, c);
    dd[c] = x_m[c] - S.xt[c];
  }
  const T d2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2] + dd[3] * dd[3];
  term_err = sqrt(fmax(d2, (T)0.0));
  T viol = (T)0.0;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    T dx, dy;
    T g = S.o.present * S.obstacle_g(xs, k, dx, dy);
    g = k < S.mm ? g : (T)-INFINITY;  // row absent at horizon m
    viol = k == 1 ? g : fmax(viol, g);
  }
  return term_err <= C.term_tol && viol <= C.viol_tol;
}

// The kernel's inputs and outputs, (rows, B) each; a lane is a column.
template <typename T>
struct K4Lanes {
  int B;
  const T *x0, *xt, *uw, *obs;
  const float* skip;
  const int* hzn;
  T *us, *xl, *te, *fe;
};

// Lane b's inputs: the solve at its horizon and its clipped warm start.
template <typename T, int N>
struct K4Lane {
  T a[4], t[4], warm[2 * N];
  Obs7<T> o;
  int mm;

  __device__ __forceinline__ K4Lane(const NlmpcConsts<T>& C,
                                    const K4Lanes<T>& L, int b) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      a[c] = L.x0[c * L.B + b];
      t[c] = L.xt[c * L.B + b];
    }
    o = load_obs7(C, L.obs, L.B, b);
    const int h = L.hzn[b];
    mm = h < 2 ? 2 : (h > N ? N : h);
    load_warm<T, N>(C, L.uw, L.B, b, warm);
  }
};

template <typename T, int N>
__device__ __forceinline__ void store_lane(const K4Lanes<T>& L, int b,
                                           const T (&us)[N][2],
                                           const T (&xm)[4], T te, bool fe) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    L.us[(2 * j) * L.B + b] = us[j][0];
    L.us[(2 * j + 1) * L.B + b] = us[j][1];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) L.xl[c * L.B + b] = xm[c];
  L.te[b] = te;
  L.fe[b] = fe ? (T)1 : (T)0;
}

// Skipped lane b on one thread: both starts with no LM trip.
template <typename T, int N>
__device__ __forceinline__ void shoot_skipped(const NlmpcConsts<T>& C,
                                              const K4Lanes<T>& L, int b) {
  const K4Lane<T, N> in(C, L, b);
  const Shoot<T, N> S{C, in.a, in.t, in.o, in.mm};
  T us[N][2], xm[4], te;
  const bool fe = S.feasibility_solve(in.warm, true, us, xm, te);
  store_lane<T, N>(L, b, us, xm, te, fe);
}

// Live lane b's warm start on thread 2i of the warp, its zeros start on
// 2i + 1 (b < 0: no lane); every thread of the warp calls it.
template <typename T, int N>
__device__ __forceinline__ void shoot_start(const NlmpcConsts<T>& C,
                                            const K4Lanes<T>& L, int b,
                                            bool zeros) {
  T f = (T)0.0, us[N][2], xm[4], te;
  bool fe = false;
  if (b >= 0) {
    const K4Lane<T, N> in(C, L, b);
    const Shoot<T, N> S{C, in.a, in.t, in.o, in.mm};
    T uf[2 * N];
#pragma unroll
    for (int i = 0; i < 2 * N; ++i) uf[i] = zeros ? (T)0.0 : in.warm[i];
    f = S.solve_from(uf, false);
    fe = finish_lane(S, uf, us, xm, te);
  }
  const T f_other = __shfl_xor_sync(K4_WARP, f, 1);
  // strict: the warm start wins ties
  if (b >= 0 && (zeros ? f < f_other : !(f_other < f)))
    store_lane<T, N>(L, b, us, xm, te, fe);
}

template <typename T, int N>
__global__ void __launch_bounds__(128)
    fused_lm_shooting_kernel(const NlmpcConsts<T> C, const K4Lanes<T> L,
                             int* __restrict__ counter, int n_threads) {
  constexpr int R = K4_ROUND;
  const int wl = threadIdx.x & 31;
  // the warp's chunk of lanes chunk .. chunk + 31; the first by its index
  int chunk = blockIdx.x * blockDim.x + threadIdx.x - wl;
  int queued = 0;      // live lanes queued, the same on every thread
  int q0 = 0, q1 = 0;  // the lanes of queue slots wl and 32 + wl
  for (;;) {
    if (queued >= R || (queued > 0 && chunk >= L.B)) {
      // a round of live lanes: the queue's slots 0 .. R - 1, slot s on
      // threads 2s and 2s + 1
      const int s = wl / 2;
      const int lane = __shfl_sync(K4_WARP, q0, s);
      const int b = s < queued ? lane : -1;
      const int src = (wl + R) & 31;  // slot s + R to slot s
      const int a0 = __shfl_sync(K4_WARP, q0, src);
      const int a1 = __shfl_sync(K4_WARP, q1, src);
      q0 = wl < 32 - R ? a0 : a1;
      q1 = a1;
      queued = queued > R ? queued - R : 0;
      shoot_start<T, N>(C, L, b, wl & 1);
    } else if (chunk < L.B) {
      // a chunk: its skipped lanes now, its live lanes into the queue
      const int c = chunk + wl;
      const bool in = c < L.B;
      const bool sk = in && L.skip[c] > 0.5f;
      const unsigned mask = __ballot_sync(K4_WARP, in && !sk);
      const int n = __popc(mask);
      const int k = wl - queued;  // the live rank slot wl takes
      if (k >= 0 && k < n) q0 = chunk + nth_set_bit(mask, k);
      if (k + 32 < n) q1 = chunk + nth_set_bit(mask, k + 32);
      queued += n;
      int next = 0;
      if (wl == 0) next = n_threads + atomicAdd(counter, 32);
      chunk = __shfl_sync(K4_WARP, next, 0);
      if (sk) shoot_skipped<T, N>(C, L, c);
    } else {
      break;
    }
  }
}

template <typename T, int N>
int launch_fused_lm_shooting(const double* consts, int max_iters, int B,
                             const void* x0, const void* xt, const void* uw,
                             const void* obs, const void* skip,
                             const void* hzn, void* us, void* xl, void* te,
                             void* fe, void* counter, cudaStream_t stream) {
  const NlmpcConsts<T> C = make_nlmpc_consts<T>(consts, max_iters);
  const K4Lanes<T> L{B, (const T*)x0, (const T*)xt, (const T*)uw,
                     (const T*)obs, (const float*)skip, (const int*)hzn,
                     (T*)us, (T*)xl, (T*)te, (T*)fe};
  return launch_lanes<fused_lm_shooting_kernel<T, N>>(B, (int*)counter,
                                                     stream, C, L);
}

}  // namespace ilqr

// dtype: 0 float32, 1 float64; counter: one int of device memory the
// launch takes its chunks of lanes from (launch_lanes, tile.cuh). Returns
// the cudaError_t of the launch, or -1 when no kernel is instantiated for
// (dtype, n).
extern "C" int fused_lm_shooting_launch(int dtype, int n, const double* consts,
                                        int max_iters, int B, const void* x0,
                                        const void* xt, const void* uw,
                                        const void* obs, const void* skip,
                                        const void* hzn, void* us, void* xl,
                                        void* te, void* fe, void* stream,
                                        void* counter) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 6 && dtype == 0)
    return ilqr::launch_fused_lm_shooting<float, 6>(
        consts, max_iters, B, x0, xt, uw, obs, skip, hzn, us, xl, te, fe,
        counter, s);
  if (n == 6 && dtype == 1)
    return ilqr::launch_fused_lm_shooting<double, 6>(
        consts, max_iters, B, x0, xt, uw, obs, skip, hzn, us, xl, te, fe,
        counter, s);
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
