// Per-lane LM-iLQR solve shared by the K1 (i2lqr_step.cu) and K3
// (fused_ilqr.cu) kernels: one CUDA thread runs one solve. Also the safe-set
// kNN scan and the candidate selection that both whole-step kernels, K1 and
// K2 (nlmpc_step.cu), run per lane, and the kNN of a thread group of the
// kernels that spread one lane over a tile of threads (tile.cuh).
//
// Replaces the tile math of ilqr_iterative_tasks_tpu/ops/_pallas_lm_core.py
// (make_tile_funcs: rollout :155, cost_of :161, obs_terms :168, backward
// :183, forward :325, lm_solve :354; bake_consts :29). The TPU version runs
// a (rows, 128) tile of lanes in lockstep until every lane is done; here
// each thread runs its own `while (it < max_iter && !done)`, which gives
// every lane the same result because done lanes freeze in the lockstep loop.
//
// Arithmetic follows the plain torch version (ops/ilqr_soa.py) operation by
// operation and in the same order, with constants folded on the host in
// double exactly where the torch code folds Python floats. Built with
// -fmad=false and without fast math, the float kernel rounds as the plain
// version's torch ops do: the LM accept/reject tests amplify any one-ulp
// difference into another iterate.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "tile.cuh"

namespace ilqr {

// Solver constants, passed to the kernels by value.
template <typename T>
struct Consts {
  T q[4][4], two_q[4][4];    // symmetrized running state weight, and 2x
  T qt[4][4], two_qt[4][4];  // symmetrized terminal weight, and 2x
  T r[2][2], two_r[2][2];    // symmetrized running input weight, and 2x
  bool q_nz[4][4], qt_nz[4][4], r_nz[2][2];  // nonzero pattern
  T q1c_q2c, q1c_q2c2, q1o_q2o, q1o_q2o2, q2c, q2o;
  T one_margin;  // 1 + safety margin
  T eps, lamb0, lamb_factor, max_lamb;
  T a_max, d_max, neg_a_max, neg_d_max;
  T param_horizon, dt, dt2, half_dt2;  // dt2 = dt*dt folded in double
  T cutoff[3];  // relaxed-reach cutoffs (80/10^pass) * max_relax_iter
  T unit[3];    // 80/10^pass
  int max_iter;
};

// `c` holds 50 doubles: qt (4x4), q (4x4), r (2x2) row-major, then q1c,
// q2c, q1o, q2o, margin, eps, lamb0, lamb_factor, max_lamb,
// max_relax_iter, a_max, d_max, param_horizon, dt (ops/_build.py).
template <typename T>
Consts<T> make_consts(const double* c, int max_iter) {
  Consts<T> k;
  const double* qt = c;
  const double* q = c + 16;
  const double* r = c + 32;
  const double q1c = c[36], q2c = c[37], q1o = c[38], q2o = c[39];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      k.qt[i][j] = (T)qt[4 * i + j];
      k.two_qt[i][j] = (T)(2.0 * qt[4 * i + j]);
      k.qt_nz[i][j] = qt[4 * i + j] != 0.0;
      k.q[i][j] = (T)q[4 * i + j];
      k.two_q[i][j] = (T)(2.0 * q[4 * i + j]);
      k.q_nz[i][j] = q[4 * i + j] != 0.0;
    }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      k.r[i][j] = (T)r[2 * i + j];
      k.two_r[i][j] = (T)(2.0 * r[2 * i + j]);
      k.r_nz[i][j] = r[2 * i + j] != 0.0;
    }
  k.q1c_q2c = (T)(q1c * q2c);
  k.q1c_q2c2 = (T)(q1c * q2c * q2c);
  k.q1o_q2o = (T)(q1o * q2o);
  k.q1o_q2o2 = (T)(q1o * q2o * q2o);
  k.q2c = (T)q2c;
  k.q2o = (T)q2o;
  k.one_margin = (T)(1.0 + c[40]);
  k.eps = (T)c[41];
  k.lamb0 = (T)c[42];
  k.lamb_factor = (T)c[43];
  k.max_lamb = (T)c[44];
  const double max_relax_iter = c[45];
  k.a_max = (T)c[46];
  k.d_max = (T)c[47];
  k.neg_a_max = (T)(-c[46]);
  k.neg_d_max = (T)(-c[47]);
  k.param_horizon = (T)c[48];
  k.dt = (T)c[49];
  k.dt2 = (T)(c[49] * c[49]);
  k.half_dt2 = (T)(0.5 * c[49] * c[49]);
  double unit = 80.0;
  for (int p = 0; p < 3; ++p) {
    k.unit[p] = (T)unit;
    k.cutoff[p] = (T)(unit * max_relax_iter);
    unit = 80.0 / (p == 0 ? 10.0 : 100.0);
  }
  k.max_iter = max_iter;
  return k;
}

__device__ __forceinline__ float dsin(float x) { return sinf(x); }
__device__ __forceinline__ double dsin(double x) { return sin(x); }
__device__ __forceinline__ float dcos(float x) { return cosf(x); }
__device__ __forceinline__ double dcos(double x) { return cos(x); }
__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  return fmin(fmax(v, lo), hi);
}

// sum_ij m_ij d_i d_j over the nonzero weights, in row-major order
template <typename T, int D>
__device__ __forceinline__ T quad(const T (&m)[D][D], const bool (&nz)[D][D],
                                  const T* d) {
  T acc = 0;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (nz[i][j]) acc = acc + m[i][j] * d[i] * d[j];
  return acc;
}

// sum_j 2 m_row,j d_j over the nonzero weights
template <typename T>
__device__ __forceinline__ T lin4(const T (&two_m)[4][4],
                                  const bool (&nz)[4][4], int row,
                                  const T* d) {
  T acc = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (nz[row][j]) acc = acc + two_m[row][j] * d[j];
  return acc;
}

// One bicycle step, as ops/ilqr_soa.py::step_soa computes it.
template <typename T>
__device__ __forceinline__ void step_dt(T dt, const T* x, T ua, T ud, T* y) {
  const T arc = x[2] * dt + (T)0.5 * ua * dt * dt;
  y[0] = x[0] + dcos(x[3]) * arc;
  y[1] = x[1] + dsin(x[3]) * arc;
  y[2] = x[2] + ua * dt;
  y[3] = x[3] + ud * dt;
}

template <typename T>
__device__ __forceinline__ void step(const Consts<T>& C, const T* x, T ua,
                                     T ud, T* y) {
  step_dt(C.dt, x, ua, ud, y);
}

// One lane's obstacle: the 6 packed rows of ops/fused_ilqr.py
// obstacle_to_lanes [cx, cy, present/w^2, present/h^2, spd_up, spd_left].
template <typename T>
struct Obs {
  T ox, oy, inv_a2, inv_b2, spd_up, spd_left, present;
};

// Barrier derivative terms at horizon offset `off`:
// (q1o q2o e, q1o q2o^2 e, dh/dpx, dh/dpy)
template <typename T>
__device__ __forceinline__ void obs_terms(const Consts<T>& C, const Obs<T>& o,
                                          T px, T py, T off, T& ge, T& he,
                                          T& hd0, T& hd1) {
  const T dz = px - (o.ox - o.spd_left * off);
  const T dy = py - (o.oy + o.spd_up * off);
  const T hval = C.one_margin - (dz * dz * o.inv_a2 + dy * dy * o.inv_b2);
  const T e = o.present * dexp(C.q2o * hval);
  hd0 = (T)-2.0 * o.inv_a2 * dz;
  hd1 = (T)-2.0 * o.inv_b2 * dy;
  ge = C.q1o_q2o * e;
  he = C.q1o_q2o2 * e;
}

template <typename T, int N>
struct Solve {
  const Consts<T>& C;
  const T* x0;  // (4)
  const T* xt;  // (4)
  const Obs<T>& o;

  __device__ __forceinline__ void rollout(const T (&us)[N][2],
                                          T (&xs)[N + 1][4]) const {
#pragma unroll
    for (int c = 0; c < 4; ++c) xs[0][c] = x0[c];
#pragma unroll
    for (int i = 0; i < N; ++i) step(C, xs[i], us[i][0], us[i][1], xs[i + 1]);
  }

  __device__ __forceinline__ T cost_of(const T (&xs)[N + 1][4],
                                       const T (&us)[N][2]) const {
    T acc = 0;
#pragma unroll
    for (int i = 0; i < N; ++i)
      acc = acc + quad<T, 4>(C.q, C.q_nz, xs[i]) +
            quad<T, 2>(C.r, C.r_nz, us[i]);
    T d[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) d[c] = xs[N][c] - xt[c];
    return acc + quad<T, 4>(C.qt, C.qt_nz, d);
  }

  // Backward Riccati pass with the Jacobians at the successor state and
  // the closed-form 2x2 spectral clamp of Quu (_pallas_lm_core.py:183-323).
  __device__ __forceinline__ void backward(const T (&xs)[N + 1][4],
                                           const T (&us)[N][2], T lamb,
                                           T (&ks)[N][2],
                                           T (&kk)[N][2][4]) const {
    const T dt = C.dt;
    T dterm[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) dterm[c] = xs[N][c] - xt[c];
    T ge, he, hd0, hd1;
    obs_terms(C, o, xs[N][0], xs[N][1], C.param_horizon, ge, he, hd0, hd1);
    T vx0 = lin4(C.two_qt, C.qt_nz, 0, dterm) + ge * hd0;
    T vx1 = lin4(C.two_qt, C.qt_nz, 1, dterm) + ge * hd1;
    T vx2 = lin4(C.two_qt, C.qt_nz, 2, dterm);
    T vx3 = lin4(C.two_qt, C.qt_nz, 3, dterm);
    T v00 = C.two_qt[0][0] + he * hd0 * hd0;
    T v01 = C.two_qt[0][1] + he * hd0 * hd1;
    T v02 = C.two_qt[0][2];
    T v03 = C.two_qt[0][3];
    T v11 = C.two_qt[1][1] + he * hd1 * hd1;
    T v12 = C.two_qt[1][2];
    T v13 = C.two_qt[1][3];
    T v22 = C.two_qt[2][2];
    T v23 = C.two_qt[2][3];
    T v33 = C.two_qt[3][3];
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      const T v_nx = xs[i + 1][2];
      const T th_n = xs[i + 1][3];
      const T ua = us[i][0], ud = us[i][1];
      const T arc = v_nx * dt + (T)0.5 * ua * dt * dt;
      const T sin_t = dsin(th_n), cos_t = dcos(th_n);
      const T a02 = cos_t * dt;
      const T a03 = -arc * sin_t;
      const T a12 = sin_t * dt;
      const T a13 = arc * cos_t;
      const T b00 = C.half_dt2 * cos_t;
      const T b10 = C.half_dt2 * sin_t;
      const T ea_hi = dexp(C.q2c * (ua - C.a_max));
      const T ea_lo = dexp(C.q2c * (C.neg_a_max - ua));
      const T ed_hi = dexp(C.q2c * (ud - C.d_max));
      const T ed_lo = dexp(C.q2c * (C.neg_d_max - ud));
      const T lu0 = (T)2.0 * (C.r[0][0] * ua + C.r[0][1] * ud) +
                    C.q1c_q2c * (ea_hi - ea_lo);
      const T lu1 = (T)2.0 * (C.r[1][0] * ua + C.r[1][1] * ud) +
                    C.q1c_q2c * (ed_hi - ed_lo);
      const T luu00 = C.two_r[0][0] + C.q1c_q2c2 * (ea_hi + ea_lo);
      const T luu01 = C.two_r[0][1];
      const T luu11 = C.two_r[1][1] + C.q1c_q2c2 * (ed_hi + ed_lo);
      T gei, hei, h0, h1;
      obs_terms(C, o, xs[i][0], xs[i][1], (T)i, gei, hei, h0, h1);
      const T lx0 = lin4(C.two_q, C.q_nz, 0, xs[i]) + gei * h0;
      const T lx1 = lin4(C.two_q, C.q_nz, 1, xs[i]) + gei * h1;
      const T lx2 = lin4(C.two_q, C.q_nz, 2, xs[i]);
      const T lx3 = lin4(C.two_q, C.q_nz, 3, xs[i]);
      const T gn00 = hei * h0 * h0;
      const T gn01 = hei * h0 * h1;
      const T gn11 = hei * h1 * h1;
      const T qx0 = lx0 + vx0;
      const T qx1 = lx1 + vx1;
      const T qx2 = lx2 + a02 * vx0 + a12 * vx1 + vx2;
      const T qx3 = lx3 + a03 * vx0 + a13 * vx1 + vx3;
      const T qu0 = lu0 + b00 * vx0 + b10 * vx1 + dt * vx2;
      const T qu1 = lu1 + dt * vx3;
      const T w02 = a02 * v00 + a12 * v01 + v02;
      const T w12 = a02 * v01 + a12 * v11 + v12;
      const T w22 = a02 * v02 + a12 * v12 + v22;
      const T w32 = a02 * v03 + a12 * v13 + v23;
      const T w03 = a03 * v00 + a13 * v01 + v03;
      const T w13 = a03 * v01 + a13 * v11 + v13;
      const T w23 = a03 * v02 + a13 * v12 + v23;
      const T w33 = a03 * v03 + a13 * v13 + v33;
      const T m00 = C.two_q[0][0] + gn00 + v00;
      const T m01 = C.two_q[0][1] + gn01 + v01;
      const T m02 = C.two_q[0][2] + w02;
      const T m03 = C.two_q[0][3] + w03;
      const T m11 = C.two_q[1][1] + gn11 + v11;
      const T m12 = C.two_q[1][2] + w12;
      const T m13 = C.two_q[1][3] + w13;
      const T m22 = C.two_q[2][2] + a02 * w02 + a12 * w12 + w22;
      const T m23 = C.two_q[2][3] + a02 * w03 + a12 * w13 + w23;
      const T m33 = C.two_q[3][3] + a03 * w03 + a13 * w13 + w33;
      const T quu00 = luu00 + b00 * (b00 * v00 + b10 * v01 + dt * v02) +
                      b10 * (b00 * v01 + b10 * v11 + dt * v12) +
                      dt * (b00 * v02 + b10 * v12 + dt * v22);
      const T quu01 = luu01 + dt * (b00 * v03 + b10 * v13 + dt * v23);
      const T quu11 = luu11 + C.dt2 * v33;
      const T qux00 = b00 * v00 + b10 * v01 + dt * v02;
      const T qux01 = b00 * v01 + b10 * v11 + dt * v12;
      const T qux02 = b00 * w02 + b10 * w12 + dt * w22;
      const T qux03 = b00 * w03 + b10 * w13 + dt * w23;
      const T qux10 = dt * v03;
      const T qux11 = dt * v13;
      const T qux12 = dt * w32;
      const T qux13 = dt * w33;
      // closed-form spectral inverse f(Quu), f(e) = 1/(max(e,0)+lamb)
      const T mean = (T)0.5 * (quu00 + quu11);
      const T disc = sqrt(fmax((T)0.25 * ((quu00 - quu11) * (quu00 - quu11)) +
                                   quu01 * quu01,
                               (T)0.0));
      const T e1 = mean + disc, e2 = mean - disc;
      const T f1 = (T)1.0 / (fmax(e1, (T)0.0) + lamb);
      const T f2 = (T)1.0 / (fmax(e2, (T)0.0) + lamb);
      const T beta = disc > (T)1e-12 ? (f1 - f2) / (e1 - e2) : (T)0.0;
      const T alpha = f1 - beta * e1;
      const T i00 = alpha + beta * quu00;
      const T i01 = beta * quu01;
      const T i11 = alpha + beta * quu11;
      const T k0 = -(i00 * qu0 + i01 * qu1);
      const T k1 = -(i01 * qu0 + i11 * qu1);
      const T kk00 = -(i00 * qux00 + i01 * qux10);
      const T kk01 = -(i00 * qux01 + i01 * qux11);
      const T kk02 = -(i00 * qux02 + i01 * qux12);
      const T kk03 = -(i00 * qux03 + i01 * qux13);
      const T kk10 = -(i01 * qux00 + i11 * qux10);
      const T kk11 = -(i01 * qux01 + i11 * qux11);
      const T kk12 = -(i01 * qux02 + i11 * qux12);
      const T kk13 = -(i01 * qux03 + i11 * qux13);
      const T t0 = quu00 * k0 + quu01 * k1;
      const T t1 = quu01 * k0 + quu11 * k1;
      vx0 = qx0 - (kk00 * t0 + kk10 * t1);
      vx1 = qx1 - (kk01 * t0 + kk11 * t1);
      vx2 = qx2 - (kk02 * t0 + kk12 * t1);
      vx3 = qx3 - (kk03 * t0 + kk13 * t1);
      const T s00 = quu00 * kk00 + quu01 * kk10;
      const T s01 = quu00 * kk01 + quu01 * kk11;
      const T s02 = quu00 * kk02 + quu01 * kk12;
      const T s03 = quu00 * kk03 + quu01 * kk13;
      const T s10 = quu01 * kk00 + quu11 * kk10;
      const T s11 = quu01 * kk01 + quu11 * kk11;
      const T s12 = quu01 * kk02 + quu11 * kk12;
      const T s13 = quu01 * kk03 + quu11 * kk13;
      v00 = m00 - (kk00 * s00 + kk10 * s10);
      v01 = m01 - (kk00 * s01 + kk10 * s11);
      v02 = m02 - (kk00 * s02 + kk10 * s12);
      v03 = m03 - (kk00 * s03 + kk10 * s13);
      v11 = m11 - (kk01 * s01 + kk11 * s11);
      v12 = m12 - (kk01 * s02 + kk11 * s12);
      v13 = m13 - (kk01 * s03 + kk11 * s13);
      v22 = m22 - (kk02 * s02 + kk12 * s12);
      v23 = m23 - (kk02 * s03 + kk12 * s13);
      v33 = m33 - (kk03 * s03 + kk13 * s13);
      ks[i][0] = k0;
      ks[i][1] = k1;
      kk[i][0][0] = kk00; kk[i][0][1] = kk01; kk[i][0][2] = kk02; kk[i][0][3] = kk03;
      kk[i][1][0] = kk10; kk[i][1][1] = kk11; kk[i][1][2] = kk12; kk[i][1][3] = kk13;
    }
  }

  // Clipped forward pass; returns the new cost (stage terms measured
  // against x_term, as the reference does).
  __device__ __forceinline__ T forward(const T (&xs)[N + 1][4],
                                       const T (&us)[N][2],
                                       const T (&ks)[N][2],
                                       const T (&kk)[N][2][4],
                                       T (&us_new)[N][2]) const {
    T x[4], y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = xs[0][c];
    T acc = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T dx[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) dx[c] = x[c] - xs[i][c];
      const T u0 = us[i][0] + ks[i][0] + kk[i][0][0] * dx[0] +
                   kk[i][0][1] * dx[1] + kk[i][0][2] * dx[2] +
                   kk[i][0][3] * dx[3];
      const T u1 = us[i][1] + ks[i][1] + kk[i][1][0] * dx[0] +
                   kk[i][1][1] * dx[1] + kk[i][1][2] * dx[2] +
                   kk[i][1][3] * dx[3];
      us_new[i][0] = clip(u0, C.neg_a_max, C.a_max);
      us_new[i][1] = clip(u1, C.neg_d_max, C.d_max);
      T dxt[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) dxt[c] = x[c] - xt[c];
      acc = acc + quad<T, 4>(C.q, C.q_nz, dxt) +
            quad<T, 2>(C.r, C.r_nz, us_new[i]);
      step(C, x, us_new[i][0], us_new[i][1], y);
#pragma unroll
      for (int c = 0; c < 4; ++c) x[c] = y[c];
    }
    T d[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) d[c] = x[c] - xt[c];
    return acc + quad<T, 4>(C.qt, C.qt_nz, d);
  }

  // The LM loop from `us` (in: initial inputs; out: the solution). A lane
  // that starts `done` runs no iteration. Writes the terminal state of the
  // solution's rollout, its cost and dist = |x_N - x_term|. A counting
  // instantiation (COUNT) also writes the loop's trips into *trips: the
  // iterations until the lane froze, the cap where it never did (the plain
  // version's lane_iters); the others keep the registers they had.
  template <bool COUNT = false>
  __device__ void lm_solve(T (&us)[N][2], bool done, T* x_last, T& cost_out,
                           T& dist_out, int* trips = nullptr) const {
    T xs[N + 1][4];
    T lamb = C.lamb0;
    int it = 0;
    for (; it < C.max_iter && !done; ++it) done = lm_iter(us, lamb, xs);
    if constexpr (COUNT) *trips = it;
    lm_finish(us, xs, x_last, cost_out, dist_out);
  }

  // One LM iteration from `us` (updated where it accepts) with damping
  // `lamb` (updated); xs: scratch. Returns whether the solve is done.
  __device__ __forceinline__ bool lm_iter(T (&us)[N][2], T& lamb,
                                          T (&xs)[N + 1][4]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      us[i][0] = clip(us[i][0], C.neg_a_max, C.a_max);
      us[i][1] = clip(us[i][1], C.neg_d_max, C.d_max);
    }
    rollout(us, xs);
    const T cost = cost_of(xs, us);
    T ks[N][2], kk[N][2][4], us_new[N][2];
    backward(xs, us, lamb, ks, kk);
    const T cost_new = forward(xs, us, ks, kk, us_new);
    const bool accept = cost_new < cost;
    if (accept) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        us[i][0] = us_new[i][0];
        us[i][1] = us_new[i][1];
      }
    }
    lamb = accept ? lamb / C.lamb_factor : lamb * C.lamb_factor;
    const bool converged = accept && fabs((cost_new - cost) / cost) < C.eps;
    const bool diverged = !accept && lamb > C.max_lamb;
    return converged || diverged;
  }

  // The solution's clipped inputs, its terminal state, cost and distance.
  __device__ __forceinline__ void lm_finish(T (&us)[N][2], T (&xs)[N + 1][4],
                                            T* x_last, T& cost_out,
                                            T& dist_out) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      us[i][0] = clip(us[i][0], C.neg_a_max, C.a_max);
      us[i][1] = clip(us[i][1], C.neg_d_max, C.d_max);
    }
    rollout(us, xs);
    cost_out = cost_of(xs, us);
    T d[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x_last[c] = xs[N][c];
      d[c] = xs[N][c] - xt[c];
    }
    dist_out = sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + d[3] * d[3]);
  }
};

// One LM iteration of one member of lm_solve_multi (us: its 2N inputs,
// lamb: its damping, both updated), and a member's finish (its clipped
// inputs, terminal state and distance): functions of their own, never
// inlined, so that the LM body is compiled once a type whatever group
// kernels are instantiated (a copy in each made their build ten minutes
// long).
template <typename T, int N>
__device__ __noinline__ bool lm_member_iter(const Consts<T>& C, const T* x0,
                                            const T* xt, const Obs<T>& o,
                                            T* us, T* lamb) {
  T u[N][2], xs[N + 1][4];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    u[i][0] = us[2 * i];
    u[i][1] = us[2 * i + 1];
  }
  const Solve<T, N> S{C, x0, xt, o};
  const bool done = S.lm_iter(u, *lamb, xs);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    us[2 * i] = u[i][0];
    us[2 * i + 1] = u[i][1];
  }
  return done;
}

template <typename T, int N>
__device__ __noinline__ void lm_member_finish(const Consts<T>& C,
                                              const T* x0, const T* xt,
                                              const Obs<T>& o, T* us,
                                              T* x_last, T* dist) {
  T u[N][2], xs[N + 1][4], xl[4], cost;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    u[i][0] = us[2 * i];
    u[i][1] = us[2 * i + 1];
  }
  const Solve<T, N> S{C, x0, xt, o};
  S.lm_finish(u, xs, xl, cost, *dist);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    us[2 * i] = u[i][0];
    us[2 * i + 1] = u[i][1];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) x_last[c] = xl[c];
}

// The zeros-initialised solves of M candidates of one lane (terminal
// states xt, done0 as lm_solve's `done`) in one interleaved LM loop: the
// counterpart of the TPU's lm_solve_multi (_pallas_lm_core.py:418). An
// iteration steps every member not yet done, so the loop runs to the
// longest member and a converged member stays frozen: each member's result
// is lm_solve's bit for bit. Writes each member's us, terminal state and
// distance.
template <typename T, int N, int M>
__device__ __forceinline__ void lm_solve_multi(
    const Consts<T>& C, const T* x0, const T (&xt)[M][4], const Obs<T>& o,
    const bool (&done0)[M], T (&us)[M][N][2], T (&x_last)[M][4],
    T (&dist)[M]) {
  T lamb[M];
  bool done[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    lamb[m] = C.lamb0;
    done[m] = done0[m];
#pragma unroll
    for (int i = 0; i < N; ++i) us[m][i][0] = us[m][i][1] = (T)0;
  }
  for (int it = 0; it < C.max_iter; ++it) {
    bool any = false;
#pragma unroll 1
    for (int m = 0; m < M; ++m) {
      if (done[m]) continue;
      done[m] = lm_member_iter<T, N>(C, x0, xt[m], o, &us[m][0][0],
                                     &lamb[m]);
      any = true;
    }
    if (!any) break;
  }
#pragma unroll 1
  for (int m = 0; m < M; ++m)
    lm_member_finish<T, N>(C, x0, xt[m], o, &us[m][0][0], x_last[m],
                           &dist[m]);
}

// Whether the guess xg equals the previous pass's xp on every component
// (float ==: K1's reuse_extract test).
template <typename T>
__device__ __forceinline__ bool same_guess(const T* xg, const T* xp) {
  return xg[0] == xp[0] && xg[1] == xp[1] && xg[2] == xp[2] &&
         xg[3] == xp[3];
}

// Lane b's obstacle from the (6, B) packed rows.
template <typename T>
__device__ __forceinline__ Obs<T> load_obs(const T* obs, int B, int b) {
  Obs<T> o;
  o.ox = obs[b];
  o.oy = obs[B + b];
  o.inv_a2 = obs[2 * B + b];
  o.inv_b2 = obs[3 * B + b];
  o.spd_up = obs[4 * B + b];
  o.spd_left = obs[5 * B + b];
  o.present = o.inv_a2 > (T)0.0 ? (T)1.0 : (T)0.0;
  return o;
}

// Row t's L1 distance d to `xg` into the ascending list (dk, ik):
// insert at the end and bubble down; strict < keeps earlier rows first.
template <typename T, int K>
__device__ __forceinline__ void knn_insert(T (&dk)[K], int (&ik)[K], T d,
                                           int t) {
  if (d < dk[K - 1]) {
    dk[K - 1] = d;
    ik[K - 1] = t;
#pragma unroll
    for (int s = K - 1; s > 0; --s) {
      if (dk[s] < dk[s - 1]) {
        const T td = dk[s];
        dk[s] = dk[s - 1];
        dk[s - 1] = td;
        const int ti = ik[s];
        ik[s] = ik[s - 1];
        ik[s - 1] = ti;
      }
    }
  }
}

// Row t's L1 distance to `xg` (rows `row_stride` apart, components B apart).
template <typename T>
__device__ __forceinline__ T row_dist(const T* st, size_t row_stride, int B,
                                      int t, const T* xg) {
  const T* p = st + t * row_stride;
  return fabs(p[0] - xg[0]) + fabs(p[B] - xg[1]) + fabs(p[2 * B] - xg[2]) +
         fabs(p[3 * B] - xg[3]);
}

// The K nearest rows, by L1 distance to `xg`, among rows [0, rows) of one
// stored lap of a batch-trailing safe set: `st` points at row 0 of this
// lane, rows lie `row_stride` apart and components B apart, so a warp's
// reads of one row are coalesced. Ascending distance with ties to the lower
// row (insertion with a strict <, rows in ascending order); a slot left
// empty is row 0 at +inf. U rows' loads are issued before the first of
// them is inserted, so that a thread keeps 4U loads in flight.
template <typename T, int K, int U>
__device__ __forceinline__ void knn_rows(const T* st, size_t row_stride,
                                         int B, int rows, const T* xg,
                                         T (&dk)[K], int (&ik)[K]) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    dk[s] = (T)INFINITY;
    ik[s] = 0;
  }
  int t = 0;
  for (; t + U <= rows; t += U) {
    T d[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      d[u] = row_dist(st, row_stride, B, t + u, xg);
#pragma unroll
    for (int u = 0; u < U; ++u) knn_insert(dk, ik, d[u], t + u);
  }
  for (; t < rows; ++t)
    knn_insert(dk, ik, row_dist(st, row_stride, B, t, xg), t);
}

// The rows knn_rows finds, by a group of K threads of a tile (K divides G,
// the group starts at a multiple of K; s: this thread's rank in it): thread
// s scans rows s, s + K, ... into its own list of depth D, kept as
// knn_rows keeps its list, then K rounds of a min-reduction over the lists'
// heads by the key (distance, row) take the K smallest in ascending order.
// Rows are unique, so the key orders ties to the lower row, as knn_rows'
// strict < does, and the K nearest rows of a lap are the K smallest keys.
// Round q's row and distance go to thread q; a slot left empty is row 0 at
// +inf. Every thread of the group must call it. A list of depth D = K
// holds every row a thread could contribute; a shallower one is exact only
// while a thread scans at most D rows (rows <= K * D), which the caller
// guarantees: it spares the registers of rows a thread never sees.
template <typename T, int K, int G, int D = K>
__device__ __forceinline__ void knn_rows_group(const Tile<G>& tl, int s,
                                               const T* st, size_t row_stride,
                                               int B, int rows, const T* xg,
                                               T& d_out, int& i_out) {
  static_assert(G % K == 0 && (K & (K - 1)) == 0, "K: a power of two");
  static_assert(D >= 1 && D <= K, "D: 1 .. K");
  T dk[D];
  int ik[D];
#pragma unroll
  for (int q = 0; q < D; ++q) {
    dk[q] = (T)INFINITY;
    ik[q] = 0;
  }
  for (int t = s; t < rows; t += K) {
    const T* p = st + t * row_stride;
    const T d = fabs(p[0] - xg[0]) + fabs(p[B] - xg[1]) +
                fabs(p[2 * B] - xg[2]) + fabs(p[3 * B] - xg[3]);
    if (d < dk[D - 1]) {
      dk[D - 1] = d;
      ik[D - 1] = t;
#pragma unroll
      for (int q = D - 1; q > 0; --q) {
        if (dk[q] < dk[q - 1]) {
          const T td = dk[q];
          dk[q] = dk[q - 1];
          dk[q - 1] = td;
          const int ti = ik[q];
          ik[q] = ik[q - 1];
          ik[q - 1] = ti;
        }
      }
    }
  }
  d_out = (T)INFINITY;
  i_out = 0;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    T md = dk[0];
    int mi = ik[0];
#pragma unroll
    for (int off = K / 2; off > 0; off >>= 1) {
      const T od = tl.shfl_xor(md, off);
      const int oi = tl.shfl_xor(mi, off);
      if (od < md || (od == md && oi < mi)) {
        md = od;
        mi = oi;
      }
    }
    // an empty head is (+inf, 0): once the minimum is +inf every list is
    // empty and the slot is row 0 at +inf; otherwise one thread owns it
    if (md < (T)INFINITY && dk[0] == md && ik[0] == mi) {
#pragma unroll
      for (int u = 0; u < D - 1; ++u) {
        dk[u] = dk[u + 1];
        ik[u] = ik[u + 1];
      }
      dk[D - 1] = (T)INFINITY;
      ik[D - 1] = 0;
    }
    if (q == s) {
      d_out = md;
      i_out = mi;
    }
  }
}

// Candidate selection of a whole step: the lexicographic row-min over NSI
// rows of K compare values (Python's min() over per-lap cost lists, with
// the ragged -inf / +inf ranks already in `cmp`), then the first-min
// argmin over the winning row's costs. Returns row * K + col. The tables
// are NSI * K values each: arrays in registers, or pointers (to shared
// memory).
template <typename T, int NSI, int K, typename Table>
__device__ __forceinline__ int lex_select(const Table& cmp, const Table& cost,
                                          int& row) {
  int best = 0;
#pragma unroll
  for (int r = 1; r < NSI; ++r) {
    bool decided = false, less = false;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const T a = cmp[r * K + s];
      const T bb = cmp[best * K + s];
      if (!decided && a != bb) {
        decided = true;
        less = a < bb;
      }
    }
    if (less) best = r;
  }
  int col = 0;
  T bc = cost[best * K];
#pragma unroll
  for (int s = 1; s < K; ++s)
    if (cost[best * K + s] < bc) {
      bc = cost[best * K + s];
      col = s;
    }
  row = best;
  return best * K + col;
}

}  // namespace ilqr
