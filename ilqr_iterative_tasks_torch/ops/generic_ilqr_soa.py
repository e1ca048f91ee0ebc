"""Generic-system SoA (batch-trailing, scalarized) iLQR in plain torch ops:
the plain version of the K5 kernel (ops/fused_generic_ilqr.py).

Port of ilqr_iterative_tasks_tpu/ops/generic_ilqr_soa.py (``_quu_inv_1x1``
:53, ``_quu_inv_2x2`` :57, ``make_generic_core`` :89,
``build_generic_ilqr_soa`` :330). For any discrete dynamics
``step_comps(x_tuple, u_tuple, dt) -> x_tuple`` with (n, m) components:

- the solve batch ``*S`` trails every tensor; states and inputs are Python
  tuples of (*S) tensors, and the small matrix algebra (Riccati recursion,
  gain solves) is written out per component by Python loops, in the JAX
  module's order of operations;
- Jacobians are ``torch.func.jvp`` columns with one-hot tangents over the
  (x, u) component tuple, taken at the pre-step state; one jvp call per LM
  iteration takes every column of every stage (stacked along leading axes);
- cost matrices, bounds and dt are Python floats from numpy; quadratic
  forms skip zero weights, and ``sum_nonzero`` skips only Python-float
  zeros, as the JAX module does.

The LM loop: clip inputs, rollout + quadratic cost about x_terminal,
backward Riccati with the spectral clamp-and-shift of Quu (closed form for
m <= 2, damped Cholesky for m > 2), full-step clipped forward pass,
accept/reject lambda ladder, |dcost/cost| < eps convergence or lambda >
max_lamb divergence. Lanes run in lockstep while any lane is not done and
the count is under max_iter; a done lane freezes its inputs and lambda.
Besides the JAX solution's scalar lockstep count ``n_iters``, the solution
carries each lane's own count ``lane_iters``: the iteration after which the
lane turned done, else the lockstep count. Its maximum is ``n_iters``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ilqr_iterative_tasks_torch.ops.ilqr_soa import _quu_inv_comps, true_div


class GenericSoaSolution(NamedTuple):
    us: torch.Tensor  # (N, m, *S) optimized (clipped) inputs
    xs: torch.Tensor  # (N+1, n, *S) rollout of ``us`` from x0
    cost: torch.Tensor  # (*S,)
    n_iters: int  # lockstep trip count
    lane_iters: torch.Tensor  # (*S,) i32: each lane's own trip count


def _quu_inv_1x1(q00, lamb):
    return (1.0 / (torch.clamp_min(q00, 0.0) + lamb),)


def numpy_f64(a) -> np.ndarray:
    """A numpy-convertible array or a tensor (on any device) as float64."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, dtype=np.float64)


def symmetrize(a) -> np.ndarray:
    a = numpy_f64(a)
    return 0.5 * (a + a.T)


class _GenericCore(NamedTuple):
    """The solver pieces shared by the lockstep solve below; every function
    takes tuples of per-component tensors of any shape."""
    clip_u: Callable
    step_t: Callable
    rollout: Callable
    cost_of: Callable
    backward: Callable
    forward: Callable
    flatten: Callable
    unflatten: Callable


def sum_nonzero(terms):
    """Left-to-right sum that skips Python-float zeros (0.0 if empty)."""
    acc = None
    for t in terms:
        if isinstance(t, float) and t == 0.0:
            continue
        acc = t if acc is None else acc + t
    return 0.0 if acc is None else acc


def make_generic_core(step_comps: Callable, *, n: int, m: int,
                      matrix_Q, matrix_R, matrix_Qterminal,
                      u_lower, u_upper, dt,
                      num_horizon: int = 6) -> _GenericCore:
    """The scalarized solver core for a user system ``step_comps``."""
    q_np = symmetrize(matrix_Q)
    r_np = symmetrize(matrix_R)
    qt_np = symmetrize(matrix_Qterminal)
    u_lo = [float(v) for v in numpy_f64(u_lower).reshape(m)]
    u_hi = [float(v) for v in numpy_f64(u_upper).reshape(m)]
    dtf = float(dt)
    nh = num_horizon

    def quad(mat, d):
        acc = 0.0
        for i in range(mat.shape[0]):
            for j in range(mat.shape[0]):
                if mat[i, j] != 0.0:
                    acc = acc + float(mat[i, j]) * d[i] * d[j]
        return acc

    def lin_row(mat, row, d):
        acc = 0.0
        for j in range(mat.shape[0]):
            if mat[row, j] != 0.0:
                acc = acc + 2.0 * float(mat[row, j]) * d[j]
        return acc

    def clip_u(u):
        return tuple(torch.clamp(u[a], u_lo[a], u_hi[a]) for a in range(m))

    def step_t(x, u):
        return tuple(step_comps(x, u, dtf))

    def jacobians(xs, us):
        """For every stage t, A[t][i][j] = d x'_i / d x_j and Bm[t][i][a] =
        d x'_i / d u_a at (xs[t], us[t]): one-hot jvp columns on the
        component tuples. One jvp call takes all n + m columns of all N
        stages: the primals are stacked along a leading column axis and a
        stage axis, the tangents one-hot along the column axis, so each
        entry sees the arithmetic of its own one-hot column jvp."""
        k = n + m
        comps = ([torch.stack([xs[t][c] for t in range(nh)])
                  for c in range(n)]
                 + [torch.stack([us[t][a] for t in range(nh)])
                    for a in range(m)])
        shape = (k,) + comps[0].shape
        # contiguous: forward-mode AD takes no stride-0 (expanded) primals
        primals = tuple(c.expand(shape).contiguous() for c in comps)
        eye = torch.eye(k, dtype=comps[0].dtype, device=comps[0].device)
        one_hot = (k,) + (1,) * comps[0].dim()
        tangents = tuple(eye[j].view(one_hot).expand(shape).contiguous()
                         for j in range(k))
        _, cols = torch.func.jvp(lambda *xu: step_t(xu[:n], xu[n:]),
                                 primals, tangents)
        A = [[[cols[i][j, t] for j in range(n)] for i in range(n)]
             for t in range(nh)]
        Bm = [[[cols[i][n + a, t] for a in range(m)] for i in range(n)]
              for t in range(nh)]
        return A, Bm

    def rollout(x0c, us):
        xs = [tuple(x0c)]
        for i in range(nh):
            xs.append(step_t(xs[-1], us[i]))
        return xs

    def cost_of(xs, us, xt):
        acc = 0.0
        for i in range(nh):
            d = tuple(xs[i][c] - xt[c] for c in range(n))
            acc = acc + quad(q_np, d) + quad(r_np, us[i])
        dterm = tuple(xs[nh][c] - xt[c] for c in range(n))
        acc = acc + quad(qt_np, dterm)
        return acc if not isinstance(acc, float) else torch.full_like(
            xt[0], acc)

    def quu_solve(quu, lamb, rhs_list):
        """[Quu_reg^{-1} r for r in rhs_list]; quu: dict[(a,b)] upper-tri.

        m <= 2: closed-form spectral clamp-and-shift. m > 2: scalar
        Cholesky of (Quu + lamb I) with clamped pivots."""
        if m == 1:
            (i00,) = _quu_inv_1x1(quu[(0, 0)], lamb)
            return [(i00 * r[0],) for r in rhs_list]
        if m == 2:
            i00, i01, i11 = _quu_inv_comps(quu[(0, 0)], quu[(0, 1)],
                                           quu[(1, 1)], lamb)
            return [(i00 * r[0] + i01 * r[1], i01 * r[0] + i11 * r[1])
                    for r in rhs_list]
        low = {}
        inv_d = [None] * m
        for c in range(m):
            dv = quu[(c, c)] + lamb
            for t in range(c):
                dv = dv - low[(c, t)] * low[(c, t)]
            ld = torch.sqrt(torch.clamp_min(dv, 1e-30))
            low[(c, c)] = ld
            inv_d[c] = 1.0 / ld
            for r in range(c + 1, m):
                v = quu[(c, r)]
                for t in range(c):
                    v = v - low[(r, t)] * low[(c, t)]
                low[(r, c)] = v * inv_d[c]
        outs = []
        for rhs in rhs_list:
            y = [None] * m
            for r in range(m):
                v = rhs[r]
                for t in range(r):
                    v = v - low[(r, t)] * y[t]
                y[r] = v * inv_d[r]
            z = [None] * m
            for r in range(m - 1, -1, -1):
                v = y[r]
                for t in range(r + 1, m):
                    v = v - low[(t, r)] * z[t]
                z[r] = v * inv_d[r]
            outs.append(tuple(z))
        return outs

    def _quu(q_uu, a, b):
        return q_uu[(min(a, b), max(a, b))]

    def backward(xs, us, lamb, xt):
        dterm = tuple(xs[nh][c] - xt[c] for c in range(n))
        v_x = [lin_row(qt_np, i, dterm) for i in range(n)]
        v_xx = {(i, j): 2.0 * float(qt_np[i, j])
                for i in range(n) for j in range(i, n)}

        def vxx(i, j):
            return v_xx[(min(i, j), max(i, j))]

        ks = [None] * nh
        Ks = [None] * nh
        A_all, Bm_all = jacobians(xs, us)
        for i in range(nh - 1, -1, -1):
            A, Bm = A_all[i], Bm_all[i]
            dx = tuple(xs[i][c] - xt[c] for c in range(n))
            l_x = [lin_row(q_np, c, dx) for c in range(n)]
            l_u = [lin_row(r_np, a, us[i]) for a in range(m)]
            # q_x = l_x + A' v_x ; q_u = l_u + B' v_x
            q_x = [l_x[j] + sum_nonzero([A[i2][j] * v_x[i2]
                                         for i2 in range(n)])
                   for j in range(n)]
            q_u = [l_u[a] + sum_nonzero([Bm[i2][a] * v_x[i2]
                                         for i2 in range(n)])
                   for a in range(m)]
            # W = V_xx A (n x n), then q_xx = l_xx + A' W
            W = [[sum_nonzero([vxx(i2, k2) * A[k2][j] for k2 in range(n)])
                  for j in range(n)] for i2 in range(n)]
            q_xx = {}
            for i2 in range(n):
                for j2 in range(i2, n):
                    q_xx[(i2, j2)] = (2.0 * float(q_np[i2, j2])
                                      + sum_nonzero([A[k2][i2] * W[k2][j2]
                                                     for k2 in range(n)]))
            # Wu = V_xx B (n x m); q_uu = l_uu + B' Wu ; q_ux = B' W
            Wu = [[sum_nonzero([vxx(i2, k2) * Bm[k2][a] for k2 in range(n)])
                   for a in range(m)] for i2 in range(n)]
            q_uu = {}
            for a in range(m):
                for bq in range(a, m):
                    q_uu[(a, bq)] = (2.0 * float(r_np[a, bq])
                                     + sum_nonzero([Bm[k2][a] * Wu[k2][bq]
                                                    for k2 in range(n)]))
            q_ux = [[sum_nonzero([Bm[k2][a] * W[k2][j] for k2 in range(n)])
                     for j in range(n)] for a in range(m)]
            sols = quu_solve(q_uu, lamb,
                             [tuple(q_u)]
                             + [tuple(q_ux[a][j] for a in range(m))
                                for j in range(n)])
            k_t = tuple(-sols[0][a] for a in range(m))
            K_t = [[-sols[1 + j][a] for j in range(n)] for a in range(m)]
            # V_x = q_x - K' Quu k ; V_xx = q_xx - K' Quu K
            qk = [sum_nonzero([_quu(q_uu, a, bq) * k_t[bq]
                               for bq in range(m)]) for a in range(m)]
            qK = [[sum_nonzero([_quu(q_uu, a, bq) * K_t[bq][j]
                                for bq in range(m)]) for j in range(n)]
                  for a in range(m)]
            v_x = [q_x[j] - sum_nonzero([K_t[a][j] * qk[a]
                                         for a in range(m)])
                   for j in range(n)]
            v_xx = {}
            for i2 in range(n):
                for j2 in range(i2, n):
                    v_xx[(i2, j2)] = (q_xx[(i2, j2)]
                                      - sum_nonzero([K_t[a][i2] * qK[a][j2]
                                                     for a in range(m)]))
            ks[i] = k_t
            Ks[i] = K_t
        return ks, Ks

    def forward(xs, us, ks, Ks, xt):
        x_new = xs[0]
        us_new = []
        acc = 0.0
        for i in range(nh):
            dx = tuple(x_new[c] - xs[i][c] for c in range(n))
            u = tuple(
                us[i][a] + ks[i][a]
                + sum_nonzero([Ks[i][a][j] * dx[j] for j in range(n)])
                for a in range(m))
            u = clip_u(u)
            dxt = tuple(x_new[c] - xt[c] for c in range(n))
            acc = acc + quad(q_np, dxt) + quad(r_np, u)
            x_new = step_t(x_new, u)
            us_new.append(u)
        dterm = tuple(x_new[c] - xt[c] for c in range(n))
        return us_new, acc + quad(qt_np, dterm)

    def flatten(us):
        return tuple(c for u in us for c in u)

    def unflatten(flat):
        return [tuple(flat[i * m + a] for a in range(m)) for i in range(nh)]

    return _GenericCore(clip_u=clip_u, step_t=step_t, rollout=rollout,
                        cost_of=cost_of, backward=backward, forward=forward,
                        flatten=flatten, unflatten=unflatten)


def build_generic_ilqr_soa(step_comps: Callable, *, n: int, m: int,
                           matrix_Q, matrix_R, matrix_Qterminal,
                           u_lower, u_upper, dt,
                           eps: float = 1e-2, lamb_factor: float = 10.0,
                           max_lamb: float = 1000.0, max_iter: int = 150,
                           num_horizon: int = 6):
    """Factory: returns
    ``solve(x0 (n,*S) or (n,), x_terminal (n,*S), u_init (N,m,*S), lamb0)``
    -> GenericSoaSolution for the user system."""
    core = make_generic_core(step_comps, n=n, m=m, matrix_Q=matrix_Q,
                             matrix_R=matrix_R,
                             matrix_Qterminal=matrix_Qterminal,
                             u_lower=u_lower, u_upper=u_upper, dt=dt,
                             num_horizon=num_horizon)
    clip_u, rollout, cost_of = core.clip_u, core.rollout, core.cost_of
    backward, forward = core.backward, core.forward
    flatten, unflatten = core.flatten, core.unflatten
    nh = num_horizon
    eps, lamb_factor, max_lamb = float(eps), float(lamb_factor), float(
        max_lamb)

    def solve(x0, x_terminal, u_init, lamb0) -> GenericSoaSolution:
        dtype, dev = x_terminal.dtype, x_terminal.device
        s_shape = x_terminal.shape[1:]
        x0c = tuple(x0[c].expand(s_shape) for c in range(n))
        xt = tuple(x_terminal[c] for c in range(n))
        flat = flatten([clip_u(tuple(u_init[i, a] for a in range(m)))
                        for i in range(nh)])
        done = torch.zeros(s_shape, dtype=torch.bool, device=dev)
        lamb = torch.full(s_shape, float(lamb0), dtype=dtype, device=dev)
        lane_iters = torch.zeros(s_shape, dtype=torch.int32, device=dev)
        it = 0
        while it < max_iter and not bool(done.all()):
            us = [clip_u(u) for u in unflatten(flat)]
            xs = rollout(x0c, us)
            cost = cost_of(xs, us, xt)
            ks, Ks = backward(xs, us, lamb, xt)
            us_new, cost_new = forward(xs, us, ks, Ks, xt)
            accept = cost_new < cost
            upd = accept & ~done
            flat = tuple(torch.where(upd, a, b)
                         for a, b in zip(flatten(us_new), flatten(us)))
            lamb_next = torch.where(
                done, lamb, torch.where(accept, true_div(lamb, lamb_factor),
                                        lamb * lamb_factor))
            converged = accept & (torch.abs((cost_new - cost) / cost) < eps)
            diverged = (~accept) & (lamb_next > max_lamb)
            lane_iters = torch.where(done, lane_iters, it + 1)
            done = done | converged | diverged
            lamb = lamb_next
            it += 1
        us = [clip_u(u) for u in unflatten(flat)]
        xs = rollout(x0c, us)
        cost = cost_of(xs, us, xt)
        return GenericSoaSolution(
            us=torch.stack([torch.stack(u) for u in us]),
            xs=torch.stack([torch.stack(x) for x in xs]),
            cost=cost, n_iters=it, lane_iters=lane_iters)

    return solve
