// K5: one generic-system LM-iLQR solve per lane, for the model the caller
// gives.
//
// Replaces ilqr_iterative_tasks_tpu/ops/pallas_generic_ilqr.py::
// build_generic_ilqr_pallas (kernel :64, pallas_call :119), whose body is
// the shared scalarized core of ops/generic_ilqr_soa.py::make_generic_core.
// Contract: (x0 (n,B), x_term (n,B), u_init (N,m,B)) -> (us (N,m,B),
// x_last (n,B), cost (B,), n_iters (B,) i32) for a quadratic cost about
// x_term, box bounds on u, full-step clipped forward passes and the LM
// accept/reject ladder; n_iters is the lane's own trip count. The TPU
// kernel runs a tile of lanes in lockstep until all are done; here each
// lane runs its own trips, which gives every lane the same result because
// done lanes freeze in the lockstep loop.
//
// Dynamics: the TPU factory compiles whatever step the caller passes, and
// so does this header. A model is a struct with NX, NU, the state whose
// sin and cos its step takes (ANGLE, -1 for none) and a step templated
// over its scalar type that takes them:
//
//   struct Unicycle {
//     static constexpr int NX = 3, NU = 2, ANGLE = 2;
//     template <typename S, typename T>
//     ILQR_HD static void step(const S* x, const S* u, T dt, T sn, T cs,
//                              S* y) {
//       y[0] = x[0] + u[0] * mcos(x[2], sn, cs) * dt;
//       y[1] = x[1] + u[0] * msin(x[2], sn, cs) * dt;
//       y[2] = x[2] + u[1] * dt;
//     }
//   };
//
// ops/fused_generic_ilqr.py writes one translation unit a (model, N): this
// header, the model's struct (its CUDA_STEP) and ILQR_K5_EXPORT(Model, N),
// the C launcher and attributes function of the f32 and f64 kernels, built
// by nvcc into a library of its own. A step is +, - and * of its states,
// inputs and constants (dual.cuh defines no other operation) and
// msin / mcos of x[ANGLE], which return the sin and cos of x[ANGLE]
// whatever their argument. Jacobian columns come from running
// the step on forward-mode dual numbers (dual.cuh) with a one-hot tangent,
// one pass per state or input component, as the plain version's one-hot
// torch.func.jvp columns do; the sin and cos of the stage's angle are
// those of the rollout's step from the same state, so the dual passes
// evaluate none (and a step can take no other transcendental of its
// state).
//
// Arithmetic follows the plain torch version (ops/generic_ilqr_soa.py)
// operation by operation, in its order, with constants folded in double on
// the host where the torch code folds Python floats. Zero weights of Q, R
// and Qterminal are skipped by branches uniform across the card (the
// plain version skips them in Python). Quu is inverted in closed form for
// m <= 2 and by a damped Cholesky factor for m > 2, as the plain version
// does. Built with -fmad=false and without fast math (IEEE sqrt and
// division), the float kernel rounds as the torch ops do.
//
// One thread a lane, blocks of 128. Lanes are refilled as they finish: the
// grid holds as many blocks as the card keeps resident (launch_lanes,
// tile.cuh), a thread takes its first lane by its index and, when that
// lane's LM loop ends, writes its outputs and takes the next lane from a
// counter (next_lane). A warp reconverges where its lanes' LM loops end, so
// it takes new lanes when its slowest lane is done. What bounds it on the
// card: the per-lane dependency chain of the LM loop (per iteration
// (n+m)*N dual step passes, the N-step Riccati recursion and two rollouts)
// times the trips of each warp's slowest lane, summed over the lanes a warp
// takes; a lane reads (2n + N*m) values and writes (N*m + n + 2), so
// memory traffic is negligible. Its state lives in registers, N*m*(n+1)
// gains and N+1 states a lane; where they exceed the register file (n 6,
// m 3) they spill to local memory.
#pragma once

#include <cuda_runtime.h>

#include "dual.cuh"
#include "tile.cuh"

namespace ilqr {

// ---- solver constants, passed by value ----

template <typename T, int NX, int NU>
struct GConsts {
  T q[NX][NX], two_q[NX][NX];     // symmetrized running state weight, 2x
  T r[NU][NU], two_r[NU][NU];     // symmetrized running input weight, 2x
  T qt[NX][NX], two_qt[NX][NX];   // symmetrized terminal weight, 2x
  bool q_nz[NX][NX], r_nz[NU][NU], qt_nz[NX][NX];
  T u_lo[NU], u_hi[NU];
  T dt, eps, lamb0, lamb_factor, max_lamb;
  int max_iter;
};

// `c` holds the doubles of ops/_build.py::generic_consts_array: q (NX x
// NX), r (NU x NU), qt (NX x NX) row-major, u_lo (NU), u_hi (NU), dt, eps,
// lamb0, lamb_factor, max_lamb.
template <typename T, int NX, int NU>
GConsts<T, NX, NU> make_generic_consts(const double* c, int max_iter) {
  GConsts<T, NX, NU> k;
  const double* q = c;
  const double* r = q + NX * NX;
  const double* qt = r + NU * NU;
  const double* lo = qt + NX * NX;
  const double* hi = lo + NU;
  const double* s = hi + NU;
  for (int i = 0; i < NX; ++i)
    for (int j = 0; j < NX; ++j) {
      k.q[i][j] = (T)q[NX * i + j];
      k.two_q[i][j] = (T)(2.0 * q[NX * i + j]);
      k.q_nz[i][j] = q[NX * i + j] != 0.0;
      k.qt[i][j] = (T)qt[NX * i + j];
      k.two_qt[i][j] = (T)(2.0 * qt[NX * i + j]);
      k.qt_nz[i][j] = qt[NX * i + j] != 0.0;
    }
  for (int i = 0; i < NU; ++i) {
    for (int j = 0; j < NU; ++j) {
      k.r[i][j] = (T)r[NU * i + j];
      k.two_r[i][j] = (T)(2.0 * r[NU * i + j]);
      k.r_nz[i][j] = r[NU * i + j] != 0.0;
    }
    k.u_lo[i] = (T)lo[i];
    k.u_hi[i] = (T)hi[i];
  }
  k.dt = (T)s[0];
  k.eps = (T)s[1];
  k.lamb0 = (T)s[2];
  k.lamb_factor = (T)s[3];
  k.max_lamb = (T)s[4];
  k.max_iter = max_iter;
  return k;
}

template <typename T>
ILQR_HD T clip(T v, T lo, T hi) {
  return fmin(fmax(v, lo), hi);
}

// sum_ij m_ij d_i d_j over the nonzero weights, row-major (generic core's
// quad)
template <typename T, int D>
ILQR_HD T quad(const T (&m)[D][D], const bool (&nz)[D][D], const T* d) {
  T acc = 0;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (nz[i][j]) acc = acc + m[i][j] * d[i] * d[j];
  return acc;
}

// sum_j 2 m_row,j d_j over the nonzero weights (generic core's lin_row)
template <typename T, int D>
ILQR_HD T lin_row(const T (&two_m)[D][D], const bool (&nz)[D][D], int row,
                  const T* d) {
  T acc = 0;
#pragma unroll
  for (int j = 0; j < D; ++j)
    if (nz[row][j]) acc = acc + two_m[row][j] * d[j];
  return acc;
}

template <typename T, class Model, int N>
struct GenericSolve {
  static constexpr int NX = Model::NX, NU = Model::NU;
  const GConsts<T, NX, NU>& C;
  const T* x0;  // (NX)
  const T* xt;  // (NX)

  // the sin and cos of x[ANGLE] (zeros, unused, for a model without one)
  ILQR_HD void trig(const T* x, T& sn, T& cs) const {
    if constexpr (Model::ANGLE >= 0) {
      sn = msin(x[Model::ANGLE]);
      cs = mcos(x[Model::ANGLE]);
    } else {
      sn = cs = (T)0;
    }
  }

  ILQR_HD void step(const T* x, const T* u, T* y) const {
    T sn, cs;
    trig(x, sn, cs);
    Model::step(x, u, C.dt, sn, cs, y);
  }

  ILQR_HD void clip_u(T* u) const {
#pragma unroll
    for (int a = 0; a < NU; ++a) u[a] = clip(u[a], C.u_lo[a], C.u_hi[a]);
  }

  // the rollout of us, with the sin and cos of each step's angle
  ILQR_HD void rollout(const T (&us)[N][NU], T (&xs)[N + 1][NX],
                       T (&sn)[N], T (&cs)[N]) const {
#pragma unroll
    for (int c = 0; c < NX; ++c) xs[0][c] = x0[c];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      trig(xs[i], sn[i], cs[i]);
      Model::step(xs[i], us[i], C.dt, sn[i], cs[i], xs[i + 1]);
    }
  }

  ILQR_HD T cost_of(const T (&xs)[N + 1][NX], const T (&us)[N][NU]) const {
    T acc = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T d[NX];
#pragma unroll
      for (int c = 0; c < NX; ++c) d[c] = xs[i][c] - xt[c];
      acc = acc + quad<T, NX>(C.q, C.q_nz, d) +
            quad<T, NU>(C.r, C.r_nz, us[i]);
    }
    T d[NX];
#pragma unroll
    for (int c = 0; c < NX; ++c) d[c] = xs[N][c] - xt[c];
    return acc + quad<T, NX>(C.qt, C.qt_nz, d);
  }

  // A[i][j] = d x'_i / d x_j, Bm[i][a] = d x'_i / d u_a: one dual pass of
  // the step per column, the tangent one-hot on that component; sn, cs:
  // the sin and cos of x[ANGLE]
  ILQR_HD void jacobians(const T* x, const T* u, T sn, T cs, T (&A)[NX][NX],
                         T (&Bm)[NX][NU]) const {
#pragma unroll
    for (int j = 0; j < NX + NU; ++j) {
      Dual<T> xd[NX], ud[NU], yd[NX];
#pragma unroll
      for (int c = 0; c < NX; ++c) xd[c] = {x[c], (T)(c == j ? 1 : 0)};
#pragma unroll
      for (int a = 0; a < NU; ++a) ud[a] = {u[a], (T)(NX + a == j ? 1 : 0)};
      Model::step(xd, ud, C.dt, sn, cs, yd);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        if (j < NX)
          A[i][j] = yd[i].t;
        else
          Bm[i][j - NX] = yd[i].t;
      }
    }
  }

  // The regularized inverse of the symmetric Quu q, in the form apply_inv
  // takes (the generic core's quu_solve). m <= 2: f(Quu), f(e) =
  // 1/(max(e,0)+lamb), in closed form. m > 2: the scalar Cholesky factor L
  // of Quu + lamb I, each pivot clamped at 1e-30 before its sqrt, L's
  // entries below the diagonal and 1/L_cc on it.
  ILQR_HD void quu_inv(const T (&q)[NU][NU], T lamb, T (&inv)[NU][NU]) const {
    if constexpr (NU == 1) {
      inv[0][0] = (T)1.0 / (fmax(q[0][0], (T)0.0) + lamb);
    } else if constexpr (NU == 2) {
      const T q00 = q[0][0], q01 = q[0][1], q11 = q[1][1];
      const T mean = (T)0.5 * (q00 + q11);
      const T disc = sqrt(
          fmax((T)0.25 * ((q00 - q11) * (q00 - q11)) + q01 * q01, (T)0.0));
      const T e1 = mean + disc, e2 = mean - disc;
      const T f1 = (T)1.0 / (fmax(e1, (T)0.0) + lamb);
      const T f2 = (T)1.0 / (fmax(e2, (T)0.0) + lamb);
      const T beta = disc > (T)1e-12 ? (f1 - f2) / (e1 - e2) : (T)0.0;
      const T alpha = f1 - beta * e1;
      inv[0][0] = alpha + beta * q00;
      inv[0][1] = beta * q01;
      inv[1][0] = beta * q01;
      inv[1][1] = alpha + beta * q11;
    } else {
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        T dv = q[c][c] + lamb;
#pragma unroll
        for (int t = 0; t < c; ++t) dv = dv - inv[c][t] * inv[c][t];
        // torch.clamp_min keeps a NaN
        const T ld = sqrt(dv != dv ? dv : fmax(dv, (T)1e-30));
        inv[c][c] = (T)1.0 / ld;
#pragma unroll
        for (int r = c + 1; r < NU; ++r) {
          T v = q[c][r];
#pragma unroll
          for (int t = 0; t < c; ++t) v = v - inv[r][t] * inv[c][t];
          inv[r][c] = v * inv[c][c];
        }
      }
    }
  }

  // Quu_reg^{-1} rhs as the generic core's quu_solve writes it out: m <= 2
  // the product with quu_inv's matrix, m > 2 forward then back
  // substitution through its factor
  ILQR_HD void apply_inv(const T (&inv)[NU][NU], const T* rhs,
                         T* out) const {
    if constexpr (NU == 1) {
      out[0] = inv[0][0] * rhs[0];
    } else if constexpr (NU == 2) {
      out[0] = inv[0][0] * rhs[0] + inv[0][1] * rhs[1];
      out[1] = inv[0][1] * rhs[0] + inv[1][1] * rhs[1];
    } else {
      T y[NU];
#pragma unroll
      for (int r = 0; r < NU; ++r) {
        T v = rhs[r];
#pragma unroll
        for (int t = 0; t < r; ++t) v = v - inv[r][t] * y[t];
        y[r] = v * inv[r][r];
      }
#pragma unroll
      for (int r = NU - 1; r >= 0; --r) {
        T v = y[r];
#pragma unroll
        for (int t = r + 1; t < NU; ++t) v = v - inv[t][r] * out[t];
        out[r] = v * inv[r][r];
      }
    }
  }

  // Backward Riccati pass, Jacobians at the pre-step state
  // (generic_ilqr_soa.py make_generic_core.backward). Symmetric matrices
  // are updated on the upper triangle and mirrored. sn, cs: the rollout's.
  ILQR_HD void backward(const T (&xs)[N + 1][NX], const T (&sn)[N],
                        const T (&cs)[N], const T (&us)[N][NU], T lamb,
                        T (&ks)[N][NU], T (&Ks)[N][NU][NX]) const {
    T dterm[NX];
#pragma unroll
    for (int c = 0; c < NX; ++c) dterm[c] = xs[N][c] - xt[c];
    T v_x[NX], v_xx[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      v_x[i] = lin_row<T, NX>(C.two_qt, C.qt_nz, i, dterm);
#pragma unroll
      for (int j = 0; j < NX; ++j) v_xx[i][j] = C.two_qt[i][j];
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      T A[NX][NX], Bm[NX][NU];
      jacobians(xs[i], us[i], sn[i], cs[i], A, Bm);
      T dx[NX];
#pragma unroll
      for (int c = 0; c < NX; ++c) dx[c] = xs[i][c] - xt[c];
      T q_x[NX], q_u[NU];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T s = A[0][j] * v_x[0];
#pragma unroll
        for (int i2 = 1; i2 < NX; ++i2) s = s + A[i2][j] * v_x[i2];
        q_x[j] = lin_row<T, NX>(C.two_q, C.q_nz, j, dx) + s;
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        T s = Bm[0][a] * v_x[0];
#pragma unroll
        for (int i2 = 1; i2 < NX; ++i2) s = s + Bm[i2][a] * v_x[i2];
        q_u[a] = lin_row<T, NU>(C.two_r, C.r_nz, a, us[i]) + s;
      }
      // W = V_xx A, q_xx = l_xx + A' W
      T W[NX][NX];
#pragma unroll
      for (int i2 = 0; i2 < NX; ++i2)
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T s = v_xx[i2][0] * A[0][j];
#pragma unroll
          for (int k2 = 1; k2 < NX; ++k2) s = s + v_xx[i2][k2] * A[k2][j];
          W[i2][j] = s;
        }
      T q_xx[NX][NX];
#pragma unroll
      for (int i2 = 0; i2 < NX; ++i2)
#pragma unroll
        for (int j2 = i2; j2 < NX; ++j2) {
          T s = A[0][i2] * W[0][j2];
#pragma unroll
          for (int k2 = 1; k2 < NX; ++k2) s = s + A[k2][i2] * W[k2][j2];
          q_xx[i2][j2] = C.two_q[i2][j2] + s;
        }
      // Wu = V_xx B; q_uu = l_uu + B' Wu; q_ux = B' W
      T Wu[NX][NU];
#pragma unroll
      for (int i2 = 0; i2 < NX; ++i2)
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          T s = v_xx[i2][0] * Bm[0][a];
#pragma unroll
          for (int k2 = 1; k2 < NX; ++k2) s = s + v_xx[i2][k2] * Bm[k2][a];
          Wu[i2][a] = s;
        }
      T q_uu[NU][NU];
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int b = a; b < NU; ++b) {
          T s = Bm[0][a] * Wu[0][b];
#pragma unroll
          for (int k2 = 1; k2 < NX; ++k2) s = s + Bm[k2][a] * Wu[k2][b];
          q_uu[a][b] = C.two_r[a][b] + s;
          q_uu[b][a] = q_uu[a][b];
        }
      T q_ux[NU][NX];
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T s = Bm[0][a] * W[0][j];
#pragma unroll
          for (int k2 = 1; k2 < NX; ++k2) s = s + Bm[k2][a] * W[k2][j];
          q_ux[a][j] = s;
        }
      // gains: k = -Quu_reg^{-1} q_u, K = -Quu_reg^{-1} q_ux
      T inv[NU][NU];
      quu_inv(q_uu, lamb, inv);
      T sol[NU];
      apply_inv(inv, q_u, sol);
      T k_t[NU], K_t[NU][NX];
#pragma unroll
      for (int a = 0; a < NU; ++a) k_t[a] = -sol[a];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T rhs[NU];
#pragma unroll
        for (int a = 0; a < NU; ++a) rhs[a] = q_ux[a][j];
        apply_inv(inv, rhs, sol);
#pragma unroll
        for (int a = 0; a < NU; ++a) K_t[a][j] = -sol[a];
      }
      // V_x = q_x - K' Quu k; V_xx = q_xx - K' Quu K
      T qk[NU], qK[NU][NX];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        T s = q_uu[a][0] * k_t[0];
#pragma unroll
        for (int b = 1; b < NU; ++b) s = s + q_uu[a][b] * k_t[b];
        qk[a] = s;
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T s2 = q_uu[a][0] * K_t[0][j];
#pragma unroll
          for (int b = 1; b < NU; ++b) s2 = s2 + q_uu[a][b] * K_t[b][j];
          qK[a][j] = s2;
        }
      }
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T s = K_t[0][j] * qk[0];
#pragma unroll
        for (int a = 1; a < NU; ++a) s = s + K_t[a][j] * qk[a];
        v_x[j] = q_x[j] - s;
      }
#pragma unroll
      for (int i2 = 0; i2 < NX; ++i2)
#pragma unroll
        for (int j2 = i2; j2 < NX; ++j2) {
          T s = K_t[0][i2] * qK[0][j2];
#pragma unroll
          for (int a = 1; a < NU; ++a) s = s + K_t[a][i2] * qK[a][j2];
          v_xx[i2][j2] = q_xx[i2][j2] - s;
          v_xx[j2][i2] = v_xx[i2][j2];
        }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        ks[i][a] = k_t[a];
#pragma unroll
        for (int j = 0; j < NX; ++j) Ks[i][a][j] = K_t[a][j];
      }
    }
  }

  // Clipped full-step forward pass; returns the new cost
  ILQR_HD T forward(const T (&xs)[N + 1][NX], const T (&us)[N][NU],
                    const T (&ks)[N][NU], const T (&Ks)[N][NU][NX],
                    T (&us_new)[N][NU]) const {
    T x[NX], y[NX];
#pragma unroll
    for (int c = 0; c < NX; ++c) x[c] = xs[0][c];
    T acc = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T dx[NX], dxt[NX];
#pragma unroll
      for (int c = 0; c < NX; ++c) dx[c] = x[c] - xs[i][c];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        T s = Ks[i][a][0] * dx[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) s = s + Ks[i][a][j] * dx[j];
        us_new[i][a] = us[i][a] + ks[i][a] + s;
      }
      clip_u(us_new[i]);
#pragma unroll
      for (int c = 0; c < NX; ++c) dxt[c] = x[c] - xt[c];
      acc = acc + quad<T, NX>(C.q, C.q_nz, dxt) +
            quad<T, NU>(C.r, C.r_nz, us_new[i]);
      step(x, us_new[i], y);
#pragma unroll
      for (int c = 0; c < NX; ++c) x[c] = y[c];
    }
    T d[NX];
#pragma unroll
    for (int c = 0; c < NX; ++c) d[c] = x[c] - xt[c];
    return acc + quad<T, NX>(C.qt, C.qt_nz, d);
  }

  // The LM loop from `us` (in: initial inputs; out: the solution). Writes
  // the terminal state of the solution's rollout and its cost; returns the
  // lane's trip count.
  ILQR_HD int lm_solve(T (&us)[N][NU], T* x_last, T& cost_out) const {
    T xs[N + 1][NX], sn[N], cs[N];
    T lamb = C.lamb0;
    bool done = false;
    int it = 0;
    for (; it < C.max_iter && !done; ++it) {
#pragma unroll
      for (int i = 0; i < N; ++i) clip_u(us[i]);
      rollout(us, xs, sn, cs);
      const T cost = cost_of(xs, us);
      T ks[N][NU], Ks[N][NU][NX], us_new[N][NU];
      backward(xs, sn, cs, us, lamb, ks, Ks);
      const T cost_new = forward(xs, us, ks, Ks, us_new);
      const bool accept = cost_new < cost;
      if (accept) {
#pragma unroll
        for (int i = 0; i < N; ++i)
#pragma unroll
          for (int a = 0; a < NU; ++a) us[i][a] = us_new[i][a];
      }
      lamb = accept ? lamb / C.lamb_factor : lamb * C.lamb_factor;
      const bool converged = accept && fabs((cost_new - cost) / cost) < C.eps;
      const bool diverged = !accept && lamb > C.max_lamb;
      done = converged || diverged;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) clip_u(us[i]);
    rollout(us, xs, sn, cs);
    cost_out = cost_of(xs, us);
#pragma unroll
    for (int c = 0; c < NX; ++c) x_last[c] = xs[N][c];
    return it;
  }
};

template <typename T, class Model, int N>
__global__ void __launch_bounds__(128)
    generic_ilqr_kernel(const GConsts<T, Model::NX, Model::NU> C, int B,
                        const T* __restrict__ x0, const T* __restrict__ xt,
                        const T* __restrict__ u_init, T* __restrict__ us_out,
                        T* __restrict__ xl_out, T* __restrict__ cost_out,
                        int* __restrict__ iters_out, int* __restrict__ counter,
                        int n_threads) {
  constexpr int NX = Model::NX, NU = Model::NU;
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b = next_lane(counter, n_threads)) {
    T x0l[NX], xtl[NX];
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      x0l[c] = x0[c * B + b];
      xtl[c] = xt[c * B + b];
    }
    T us[N][NU];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int a = 0; a < NU; ++a) us[i][a] = u_init[(NU * i + a) * B + b];
    const GenericSolve<T, Model, N> S{C, x0l, xtl};
    T xl[NX], cost;
    const int iters = S.lm_solve(us, xl, cost);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int a = 0; a < NU; ++a) us_out[(NU * i + a) * B + b] = us[i][a];
#pragma unroll
    for (int c = 0; c < NX; ++c) xl_out[c * B + b] = xl[c];
    cost_out[b] = cost;
    iters_out[b] = iters;
  }
}

template <typename T, class Model, int N>
int launch_generic_ilqr(const double* consts, int max_iter, int B,
                        const void* x0, const void* xt, const void* u_init,
                        void* us, void* xl, void* cost, void* iters,
                        void* counter, cudaStream_t stream) {
  const GConsts<T, Model::NX, Model::NU> C =
      make_generic_consts<T, Model::NX, Model::NU>(consts, max_iter);
  return launch_lanes<generic_ilqr_kernel<T, Model, N>>(
      B, (int*)counter, stream, C, B, (const T*)x0, (const T*)xt,
      (const T*)u_init, (T*)us, (T*)xl, (T*)cost, (int*)iters);
}

template <class Model, int N>
int launch_dtype(int dtype, const double* consts, int max_iter, int B,
                 const void* x0, const void* xt, const void* u_init, void* us,
                 void* xl, void* cost, void* iters, void* counter,
                 cudaStream_t s) {
  if (dtype == 0)
    return launch_generic_ilqr<float, Model, N>(consts, max_iter, B, x0, xt,
                                                u_init, us, xl, cost, iters,
                                                counter, s);
  if (dtype == 1)
    return launch_generic_ilqr<double, Model, N>(consts, max_iter, B, x0, xt,
                                                 u_init, us, xl, cost, iters,
                                                 counter, s);
  return -1;
}

template <class Model, int N>
int attributes_dtype(int dtype, int* out) {
  if (dtype == 0)
    return kernel_attributes(generic_ilqr_kernel<float, Model, N>, 128, out);
  if (dtype == 1)
    return kernel_attributes(generic_ilqr_kernel<double, Model, N>, 128,
                             out);
  return -1;
}

}  // namespace ilqr

// The C interface of K5 for MODEL (a struct of namespace ilqr) at horizon
// HORIZON, one line of a generated translation unit
// (ops/fused_generic_ilqr.py::k5_source):
//   k5_launch(dtype, consts, max_iter, B, x0, x_term, u_init, us, x_last,
//             cost, n_iters, stream, counter): dtype 0 float32, 1 float64;
//     counter: one int of device memory the launch takes its lanes from
//     (launch_lanes, tile.cuh). Returns the cudaError_t of the launch, or
//     -1 for another dtype.
//   k5_attributes(dtype, out): the loaded kernel's resources, as the
//     runtime reports them (kernel_attributes, tile.cuh); -1 for another
//     dtype.
#define ILQR_K5_EXPORT(MODEL, HORIZON)                                      \
  extern "C" int k5_launch(int dtype, const double* consts, int max_iter,   \
                           int B, const void* x0, const void* xt,           \
                           const void* u_init, void* us, void* xl,          \
                           void* cost, void* iters, void* stream,           \
                           void* counter) {                                 \
    if (B <= 0) return 0;                                                   \
    return ilqr::launch_dtype<ilqr::MODEL, HORIZON>(                        \
        dtype, consts, max_iter, B, x0, xt, u_init, us, xl, cost, iters,    \
        counter, (cudaStream_t)stream);                                     \
  }                                                                         \
  extern "C" int k5_attributes(int dtype, int* out) {                       \
    return ilqr::attributes_dtype<ilqr::MODEL, HORIZON>(dtype, out);        \
  }
