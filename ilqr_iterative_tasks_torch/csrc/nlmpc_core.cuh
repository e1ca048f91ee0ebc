// Per-lane projected-LM feasibility solve (NLMPC candidate NLP) shared by
// the K4 (fused_lm_shooting.cu) and K2 (nlmpc_step.cu) kernels: one CUDA
// thread owns one lane.
//
// Replaces the tile math of ilqr_iterative_tasks_tpu/ops/_pallas_nlmpc_core.py
// (make_nlmpc_tile_funcs :39: clip_a/clip_d, step :84, center_at :90,
// residual :95, jacobian :125, lm_step :193, solve_from :245,
// feasibility_solve :306; bake_nlmpc_consts :25). The TPU version runs a
// (rows, 128) tile of lanes in lockstep until every lane is done; here each
// thread runs its own `while (it < max_iters && !done)`, which gives every
// lane the same result because done lanes freeze in the lockstep loop.
//
// Per lane, at horizon m = clip(hzn, 2, N): minimise |r(u)|^2, r = the
// terminal error at x_m and the obstacle rows sqrt(w) present
// max(g_k + margin, 0) for k < m, by projected LM: closed-form prefix-sum
// Jacobian (columns j >= m masked), gram J J^T + lam I factored by an
// unrolled (N+3)x(N+3) Cholesky with the pivot floored at
// sqrt(max(d, tiny)), du = -J^T z, a 5-point line search keeping strictly
// better points, lam x0.33 (>= 1e-12) on accept and x4 on reject, stop at
// f < 1e-14 or a reject with lam > 1e10; the clipped warm start, then
// zeros, the warm start winning ties. The verdict at x_m: term_err <= 1e-4
// and the obstacle rows k < m violated by at most 1e-4.
//
// Arithmetic follows the plain torch version (ops/lm_shooting_soa.py)
// operation by operation and in the same order; sums over Jacobian entries
// skip the structural zeros (compile-time), where the torch version adds
// exact zeros. Built with -fmad=false and without fast math, so the float
// kernel rounds as the plain version's torch ops do on the card.
//
// Registers are what bounds it: one LM step holds the Jacobian (N+3 rows x
// 2N columns; the structural zeros, about half, take no register), the
// 45-entry Cholesky factor, 2N inputs and the rollout; expect 255
// registers and spills to local memory (the build log reports them).
#pragma once

#include "lm_core.cuh"

namespace ilqr {

template <typename T>
struct NlmpcConsts {
  T dt, half_dt2;  // half_dt2 = 0.5*dt*dt folded in double
  T a_max, d_max, neg_a_max, neg_d_max;  // d_max: raw delta_max
  T sqrt_w, margin, term_tol, viol_tol;
  T floor;  // Cholesky pivot floor
  int max_iters;
};

// `c` holds 7 doubles: dt, a_max, d_max, sqrt_w, margin, term_tol,
// viol_tol (ops/_build.py nlmpc_consts_array).
template <typename T>
NlmpcConsts<T> make_nlmpc_consts(const double* c, int max_iters) {
  NlmpcConsts<T> k;
  k.dt = (T)c[0];
  k.half_dt2 = (T)(0.5 * c[0] * c[0]);
  k.a_max = (T)c[1];
  k.d_max = (T)c[2];
  k.neg_a_max = (T)(-c[1]);
  k.neg_d_max = (T)(-c[2]);
  k.sqrt_w = (T)c[3];
  k.margin = (T)c[4];
  k.term_tol = (T)c[5];
  k.viol_tol = (T)c[6];
  k.floor = sizeof(T) == 8 ? (T)1e-300 : (T)1e-38;
  k.max_iters = max_iters;
  return k;
}

// One lane's obstacle: the 7 packed rows of ops/fused_lm_shooting.py
// obstacle_to_lanes_nlmpc [cx, cy, 1/w^2, 1/h^2, spd_up, spd_left,
// present], and sqrt(w) * present.
template <typename T>
struct Obs7 {
  T ox, oy, iw, ih, su, sl, present, sw_p;
};

template <typename T>
__device__ __forceinline__ Obs7<T> load_obs7(const NlmpcConsts<T>& C,
                                             const T* obs, int B, int b) {
  Obs7<T> o;
  o.ox = obs[b];
  o.oy = obs[B + b];
  o.iw = obs[2 * B + b];
  o.ih = obs[3 * B + b];
  o.su = obs[4 * B + b];
  o.sl = obs[5 * B + b];
  o.present = obs[6 * B + b];
  o.sw_p = C.sqrt_w * o.present;
  return o;
}

// d/dz clip(z, -m, m) and d/dz max(z, 0), with JAX's 0.5 at the ties
template <typename T>
__device__ __forceinline__ T clip_grad(T z, T m) {
  const T a = fabs(z);
  return (a < m ? (T)1 : (T)0) + (T)0.5 * (a == m ? (T)1 : (T)0);
}

template <typename T>
__device__ __forceinline__ T relu_grad(T z) {
  return (z > (T)0 ? (T)1 : (T)0) + (T)0.5 * (z == (T)0 ? (T)1 : (T)0);
}

// Structural zeros of the Jacobian: row 2 (v) has no d/dl columns, row 3
// (theta) no d/da columns, obstacle row 3+k no columns j >= k.
__host__ __device__ constexpr bool jac_zero(int r, int c) {
  return (r == 2 && (c & 1)) || (r == 3 && !(c & 1)) ||
         (r >= 4 && c >= 2 * (r - 3));
}

template <typename T, int N>
struct Shoot {
  static constexpr int M = N + 3;   // residual rows
  static constexpr int NV = 2 * N;  // inputs
  const NlmpcConsts<T>& C;
  const T* x0;  // (4)
  const T* xt;  // (4)
  const Obs7<T>& o;
  int mm;  // horizon m in [2, N]

  __device__ __forceinline__ void rollout(const T (&uf)[NV],
                                          T (&xs)[N + 1][4]) const {
#pragma unroll
    for (int c = 0; c < 4; ++c) xs[0][c] = x0[c];
#pragma unroll
    for (int j = 0; j < N; ++j)
      step_dt(C.dt, xs[j], clip(uf[2 * j], C.neg_a_max, C.a_max),
              clip(uf[2 * j + 1], C.neg_d_max, C.d_max), xs[j + 1]);
  }

  __device__ __forceinline__ T at_m(const T (&xs)[N + 1][4], int c) const {
    T v = xs[N][c];
#pragma unroll
    for (int k = 2; k < N; ++k)
      if (mm == k) v = xs[k][c];
    return v;
  }

  // g_k = 1 - (dx^2/w^2 + dy^2/h^2) about the centre k steps ahead
  __device__ __forceinline__ T obstacle_g(const T (&xs)[N + 1][4], int k,
                                          T& dx, T& dy) const {
    const T kf = (T)k;
    dx = xs[k][0] - (o.ox - o.sl * kf);
    dy = xs[k][1] - (o.oy + o.su * kf);
    return (T)1.0 - (dx * dx * o.iw + dy * dy * o.ih);
  }

  // f = |r|^2 of inputs uf; writes the rows and the rollout
  __device__ __forceinline__ T residual(const T (&uf)[NV], T (&rows)[M],
                                        T (&xs)[N + 1][4]) const {
    rollout(uf, xs);
#pragma unroll
    for (int c = 0; c < 4; ++c) rows[c] = at_m(xs, c) - xt[c];
#pragma unroll
    for (int k = 1; k < N; ++k) {
      T dx, dy;
      const T g = obstacle_g(xs, k, dx, dy);
      const T r = o.sw_p * fmax(g + C.margin, (T)0.0);
      rows[3 + k] = k < mm ? r : (T)0.0;
    }
    T f = rows[0] * rows[0];
#pragma unroll
    for (int r = 1; r < M; ++r) f = f + rows[r] * rows[r];
    return f;
  }

  __device__ __forceinline__ T residual_f(const T (&uf)[NV]) const {
    T rows[M], xs[N + 1][4];
    return residual(uf, rows, xs);
  }

  // Closed-form Jacobian d r / d uf at the rollout xs; structural zeros
  // (jac_zero) are left unset.
  __device__ __forceinline__ void jacobian(const T (&uf)[NV],
                                           const T (&xs)[N + 1][4],
                                           T (&J)[M][NV]) const {
    const T dt = C.dt;
    T cs[N], sn[N], arc[N], ma[N], md[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T ua = clip(uf[2 * i], C.neg_a_max, C.a_max);
      cs[i] = dcos(xs[i][3]);
      sn[i] = dsin(xs[i][3]);
      arc[i] = xs[i][2] * dt + (T)0.5 * ua * dt * dt;
      ma[i] = i < mm ? clip_grad(uf[2 * i], C.a_max) : (T)0.0;
      md[i] = i < mm ? clip_grad(uf[2 * i + 1], C.d_max) : (T)0.0;
    }
    // cum[q][k] = sum_{i=1}^{k-1} of the q-th sensitivity increment
    T cum[4][N + 1];
#pragma unroll
    for (int q = 0; q < 4; ++q) cum[q][0] = cum[q][1] = (T)0.0;
#pragma unroll
    for (int i = 1; i < N; ++i) {
      cum[0][i + 1] = cum[0][i] + cs[i] * dt * dt;
      cum[1][i + 1] = cum[1][i] + (-arc[i] * sn[i]) * dt;
      cum[2][i + 1] = cum[2][i] + sn[i] * dt * dt;
      cum[3][i + 1] = cum[3][i] + arc[i] * cs[i] * dt;
    }
    T cm[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cm[q] = cum[q][N];
#pragma unroll
      for (int k = 2; k < N; ++k)
        if (mm == k) cm[q] = cum[q][k];
    }
    // terminal rows: d (x_m - xt) / d u
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T b00 = C.half_dt2 * cs[j], b10 = C.half_dt2 * sn[j];
      J[0][2 * j] = (b00 + cm[0] - cum[0][j + 1]) * ma[j];
      J[0][2 * j + 1] = (cm[1] - cum[1][j + 1]) * md[j];
      J[1][2 * j] = (b10 + cm[2] - cum[2][j + 1]) * ma[j];
      J[1][2 * j + 1] = (cm[3] - cum[3][j + 1]) * md[j];
      J[2][2 * j] = dt * ma[j];
      J[3][2 * j + 1] = dt * md[j];
    }
    // obstacle rows k = 1..N-1 over the columns j < k
#pragma unroll
    for (int k = 1; k < N; ++k) {
      T dx, dy;
      const T g = obstacle_g(xs, k, dx, dy);
      const T gate = k < mm ? o.sw_p * relu_grad(g + C.margin) : (T)0.0;
      const T gx = gate * ((T)-2.0 * o.iw) * dx;
      const T gy = gate * ((T)-2.0 * o.ih) * dy;
#pragma unroll
      for (int j = 0; j < k; ++j) {
        const T b00 = C.half_dt2 * cs[j], b10 = C.half_dt2 * sn[j];
        const T ka0 = b00 + cum[0][k] - cum[0][j + 1];
        const T kd0 = cum[1][k] - cum[1][j + 1];
        const T ka1 = b10 + cum[2][k] - cum[2][j + 1];
        const T kd1 = cum[3][k] - cum[3][j + 1];
        J[3 + k][2 * j] = (gx * ka0 + gy * ka1) * ma[j];
        J[3 + k][2 * j + 1] = (gx * kd0 + gy * kd1) * md[j];
      }
    }
  }

  // du = -J^T (J J^T + lam I)^-1 r by a scalar Cholesky
  __device__ __forceinline__ void lm_step(const T (&uf)[NV],
                                          const T (&rows)[M],
                                          const T (&xs)[N + 1][4], T lam,
                                          T (&du)[NV]) const {
    T J[M][NV];
    jacobian(uf, xs, J);
    T L[M][M], inv[M];
#pragma unroll
    for (int c = 0; c < M; ++c) {
#pragma unroll
      for (int r = c; r < M; ++r) {
        // gram entry (r, c) over the columns nonzero in both rows
        T g = (T)0.0;
        bool first = true;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          if (jac_zero(r, j) || jac_zero(c, j)) continue;
          const T p = J[r][j] * J[c][j];
          g = first ? p : g + p;
          first = false;
        }
        if (r == c) {
          T d = g + lam;
#pragma unroll
          for (int t = 0; t < c; ++t) d = d - L[c][t] * L[c][t];
          const T ld = sqrt(fmax(d, C.floor));
          L[c][c] = ld;
          inv[c] = (T)1.0 / ld;
        } else {
          T v = g;
#pragma unroll
          for (int t = 0; t < c; ++t) v = v - L[r][t] * L[c][t];
          L[r][c] = v * inv[c];
        }
      }
    }
    T y[M], z[M];
#pragma unroll
    for (int r = 0; r < M; ++r) {
      T v = rows[r];
#pragma unroll
      for (int t = 0; t < r; ++t) v = v - L[r][t] * y[t];
      y[r] = v * inv[r];
    }
#pragma unroll
    for (int r = M - 1; r >= 0; --r) {
      T v = y[r];
#pragma unroll
      for (int t = r + 1; t < M; ++t) v = v - L[t][r] * z[t];
      z[r] = v * inv[r];
    }
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      T acc = J[0][c] * z[0];
#pragma unroll
      for (int r = 1; r < M; ++r)
        if (!jac_zero(r, c)) acc = acc + J[r][c] * z[r];
      du[c] = -acc;
    }
  }

  // The LM loop from uf (in: start; out: the iterate). A lane that starts
  // done runs no iteration. Returns the residual of the final iterate.
  __device__ T solve_from(T (&uf)[NV], bool done) const {
    T lam = (T)1e-3;
    const T alphas[5] = {(T)1.0, (T)0.5, (T)0.25, (T)0.1, (T)0.02};
    for (int it = 0; it < C.max_iters && !done; ++it) {
      T rows[M], xs[N + 1][4], du[NV];
      const T f0 = residual(uf, rows, xs);
      lm_step(uf, rows, xs, lam, du);
      T best_f = (T)0.0, best[NV];
#pragma unroll 1
      for (int a = 0; a < 5; ++a) {
        T cand[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) cand[i] = uf[i] + alphas[a] * du[i];
        const T fc = residual_f(cand);
        if (a == 0 || fc < best_f) {
          best_f = fc;
#pragma unroll
          for (int i = 0; i < NV; ++i) best[i] = cand[i];
        }
      }
      const bool accept = best_f < f0;
      if (accept) {
#pragma unroll
        for (int i = 0; i < NV; ++i) uf[i] = best[i];
      }
      lam = accept ? fmax(lam * (T)0.33, (T)1e-12) : lam * (T)4.0;
      const T f_new = accept ? best_f : f0;
      done = f_new < (T)1e-14 || (!accept && lam > (T)1e10);
    }
    return residual_f(uf);
  }

  // Both starts and the verdict. warm: the clipped warm start. Writes the
  // clipped solution, x_m of its rollout and term_err; returns feasible.
  __device__ bool feasibility_solve(const T (&warm)[NV], bool done0,
                                    T (&us)[N][2], T (&x_m)[4],
                                    T& term_err) const {
    T uf[NV], uz[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      uf[i] = warm[i];
      uz[i] = (T)0.0;
    }
    const T f_w = solve_from(uf, done0);
    const T f_z = solve_from(uz, done0);
    if (f_z < f_w) {  // strict: the warm start wins ties
#pragma unroll
      for (int i = 0; i < NV; ++i) uf[i] = uz[i];
    }
    T xs[N + 1][4];
    rollout(uf, xs);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      us[j][0] = clip(uf[2 * j], C.neg_a_max, C.a_max);
      us[j][1] = clip(uf[2 * j + 1], C.neg_d_max, C.d_max);
    }
    T dd[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x_m[c] = at_m(xs, c);
      dd[c] = x_m[c] - xt[c];
    }
    const T d2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2] + dd[3] * dd[3];
    term_err = sqrt(fmax(d2, (T)0.0));
    T viol = (T)0.0;
#pragma unroll
    for (int k = 1; k < N; ++k) {
      T dx, dy;
      T g = o.present * obstacle_g(xs, k, dx, dy);
      g = k < mm ? g : (T)-INFINITY;  // row absent at horizon m
      viol = k == 1 ? g : fmax(viol, g);
    }
    return term_err <= C.term_tol && viol <= C.viol_tol;
  }
};

// Lane b's clipped warm start from the (N, 2, B) inputs.
template <typename T, int N>
__device__ __forceinline__ void load_warm(const NlmpcConsts<T>& C,
                                          const T* uw, int B, int b,
                                          T (&warm)[2 * N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    warm[2 * j] = clip(uw[(2 * j) * B + b], C.neg_a_max, C.a_max);
    warm[2 * j + 1] = clip(uw[(2 * j + 1) * B + b], C.neg_d_max, C.d_max);
  }
}

// The outputs of one whole NLMPC step (K2) for lane b.
template <typename T, int N>
struct StepOut {
  T* us;    // (N, 2, B)
  T* fe;    // (B,) feasible_any
  T* ng;    // (4, B) new guess
  int* idx;  // (B,) chosen point
  int* row;  // (B,) chosen lap row
  T* succ;  // (B,)

  __device__ __forceinline__ void skip_lane(int B, int b) const {
#pragma unroll
    for (int i = 0; i < 2 * N; ++i) us[i * B + b] = (T)0;
#pragma unroll
    for (int c = 0; c < 4; ++c) ng[c * B + b] = (T)0;
    fe[b] = (T)0;
    idx[b] = 0;
    row[b] = 0;
    succ[b] = (T)0;
  }

  // The winner's solution and the pre-freeze guess advance: the successor
  // point `nx` (rows B apart) when succ, else x_m (x_term for h1 lanes).
  __device__ __forceinline__ void write(int B, int b, const T (&u)[N][2],
                                        const T (&xm)[4], const T (&xt)[4],
                                        const T* nx, bool h1, bool feasible,
                                        int idx_sel, int row_sel,
                                        bool succ_sel) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      us[(2 * i) * B + b] = u[i][0];
      us[(2 * i + 1) * B + b] = u[i][1];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      ng[q * B + b] = succ_sel ? nx[q * B] : (h1 ? xt[q] : xm[q]);
    fe[b] = feasible ? (T)1 : (T)0;
    idx[b] = idx_sel;
    row[b] = row_sel;
    succ[b] = succ_sel ? (T)1 : (T)0;
  }
};

// The horizon-1 reach check: |x1 - x_term| <= 1e-3.
template <typename T>
__device__ __forceinline__ bool reaches(const T (&x1)[4], const T (&xt)[4]) {
  T dr[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) dr[q] = x1[q] - xt[q];
  return sqrt(dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2] + dr[3] * dr[3]) <=
         (T)1e-3;
}

}  // namespace ilqr
