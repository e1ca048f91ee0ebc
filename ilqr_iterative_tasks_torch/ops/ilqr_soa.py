"""Structure-of-arrays (batch-trailing) LM-iLQR solver in plain torch ops.

Port of ilqr_iterative_tasks_tpu/ops/ilqr_soa.py (``step_soa`` :40,
``_quu_inv_comps`` :49, ``ilqr_solve_soa`` :72). Every tensor keeps the tiny
structural dims leading and the solve batch ``*S`` trailing; the 4x4 / 2x4 /
2x2 Riccati algebra is written out per component, in the JAX module's
operation order, so the f64 results agree lane for lane.

This is the plain version of the candidate solve inside the whole-step
kernel (ops/i2lqr_step.py) and of the per-candidate kernel
(ops/fused_ilqr.py). Differences from the JAX function:

- the obstacle arrives packed as lanes, ``obs`` (6, *S) =
  [cx, cy, present/w^2, present/h^2, spd_up, spd_left]
  (ops/fused_ilqr.py::obstacle_to_lanes); the barrier is gated on
  ``present/w^2 > 0``;
- ``done0`` lets lanes start frozen (the per-candidate kernel's ``skip``);
- the lockstep LM loop stops as soon as every lane is done, as JAX's
  ``any(~done)`` condition does;
- ``precision_islands`` is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ilqr_iterative_tasks_torch.models.kinetic_bicycle import (
    step_comps as step_soa)
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, SystemLimits, solver_consts)


def _quu_inv_comps(q00, q01, q11, lamb):
    """Closed-form spectral f(Quu), f(e) = 1/(max(e,0)+lamb); component form."""
    mean = 0.5 * (q00 + q11)
    disc = torch.sqrt(torch.clamp_min(
        0.25 * ((q00 - q11) * (q00 - q11)) + q01 * q01, 0.0))
    e1, e2 = mean + disc, mean - disc
    f1 = 1.0 / (torch.clamp_min(e1, 0.0) + lamb)
    f2 = 1.0 / (torch.clamp_min(e2, 0.0) + lamb)
    safe = disc > 1e-12
    beta = torch.where(safe, (f1 - f2) / torch.where(safe, e1 - e2, 1.0), 0.0)
    alpha = f1 - beta * e1
    return alpha + beta * q00, beta * q01, alpha + beta * q11


def true_div(a, b: float):
    """``a / b`` by true division on every device (a CUDA tensor divided by
    a Python scalar is computed as a multiplication by its reciprocal)."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


class IlqrSoaSolution(NamedTuple):
    us: torch.Tensor  # (N, 2, *S)
    xs: torch.Tensor  # (N+1, 4, *S)
    lamb: torch.Tensor  # (*S)
    n_iters: int  # lockstep iterations run
    cost: torch.Tensor  # (*S)
    lane_iters: torch.Tensor  # (*S) i32: iterations each lane ran undone


def _quad(m, d):
    """sum_ij m[i, j] d_i d_j over the nonzero weights (zero terms add
    exact zeros in the JAX module's order, so skipping them is exact)."""
    acc = 0.0
    for i in range(len(d)):
        for j in range(len(d)):
            if m[i, j] != 0.0:
                acc = acc + m[i, j] * d[i] * d[j]
    return acc


def _lin(m, row, d):
    """sum_j 2 m[row, j] d_j over the nonzero weights."""
    acc = 0.0
    for j in range(len(d)):
        if m[row, j] != 0.0:
            acc = acc + 2.0 * m[row, j] * d[j]
    return acc


def ilqr_solve_soa(params: IlqrParams, limits: SystemLimits, obs, x0,
                   x_terminal, u_init, lamb0, dt, *, num_horizon: int,
                   max_iter: int | None = None,
                   done0: torch.Tensor | None = None) -> IlqrSoaSolution:
    """Batched LM-iLQR solve, batch-trailing layout.

    obs: (6, *S) or (6,) obstacle lanes; x0: (4, *S) or (4,);
    x_terminal: (4, *S); u_init: (N, 2, *S); lamb0: scalar or (*S);
    done0: optional (*S) bool, lanes that start (and stay) frozen.
    ``max_iter`` caps params.max_ilqr_iter.
    """
    C = solver_consts(params, limits, dt)
    n = num_horizon
    dtype = x_terminal.dtype
    dev = x_terminal.device
    bshape = x_terminal.shape[1:]
    dt = C.dt
    if max_iter is None:
        max_iter = params.max_ilqr_iter
    if x0.dim() == 1:
        x0 = x0.reshape((4,) + (1,) * len(bshape)).expand((4,) + bshape)
    x0c = tuple(x0[i] for i in range(4))
    xt = tuple(x_terminal[i] for i in range(4))
    ox, oy, inv_a2, inv_b2, spd_up, spd_left = (obs[i] for i in range(6))
    present = (inv_a2 > 0.0).to(dtype)
    q_m, r_m, qt_m = C.q_m, C.r_m, C.qt_m
    q1c, q2c, q1o, q2o = C.q1c, C.q2c, C.q1o, C.q2o
    zeros = torch.zeros(bshape, dtype=dtype, device=dev)

    def clip_u(u):
        return (torch.clamp(u[0], -C.a_max, C.a_max),
                torch.clamp(u[1], -C.d_max, C.d_max))

    def rollout(us):
        xs = [x0c]
        for i in range(n):
            xs.append(step_soa(xs[-1], us[i], dt))
        return xs

    def loop_cost(xs, us):
        cost = zeros
        for i in range(n):
            cost = cost + _quad(q_m, xs[i]) + _quad(r_m, us[i])
        dterm = tuple(xs[n][i] - xt[i] for i in range(4))
        return cost + _quad(qt_m, dterm)

    def obs_terms(px, py, off):
        """(e_scaled_grad, e_scaled_hess, hd0, hd1) at extrapolation ``off``."""
        dz = px - (ox - spd_left * off)
        dy = py - (oy + spd_up * off)
        hval = 1.0 + C.margin - (dz * dz * inv_a2 + dy * dy * inv_b2)
        e = present * torch.exp(q2o * hval)
        hd0 = -2.0 * inv_a2 * dz
        hd1 = -2.0 * inv_b2 * dy
        return q1o * q2o * e, q1o * q2o * q2o * e, hd0, hd1

    def backward(xs, us, lamb):
        # terminal value seed; the obstacle is extrapolated by the PARAM
        # horizon (reference quirk, ilqr_helper.py:136-138)
        dterm = tuple(xs[n][i] - xt[i] for i in range(4))
        ge, he, hd0, hd1 = obs_terms(xs[n][0], xs[n][1], C.param_horizon)
        vx0 = _lin(qt_m, 0, dterm) + ge * hd0
        vx1 = _lin(qt_m, 1, dterm) + ge * hd1
        vx2 = _lin(qt_m, 2, dterm)
        vx3 = _lin(qt_m, 3, dterm)
        v00 = 2.0 * qt_m[0, 0] + he * hd0 * hd0
        v01 = 2.0 * qt_m[0, 1] + he * hd0 * hd1
        v02 = 2.0 * qt_m[0, 2] + zeros
        v03 = 2.0 * qt_m[0, 3] + zeros
        v11 = 2.0 * qt_m[1, 1] + he * hd1 * hd1
        v12 = 2.0 * qt_m[1, 2] + zeros
        v13 = 2.0 * qt_m[1, 3] + zeros
        v22 = 2.0 * qt_m[2, 2] + zeros
        v23 = 2.0 * qt_m[2, 3] + zeros
        v33 = 2.0 * qt_m[3, 3] + zeros
        ks = [None] * n
        big_ks = [None] * n
        for i in range(n - 1, -1, -1):
            # Jacobian entries at the successor state (reference quirk)
            v_nx = xs[i + 1][2]
            th_n = xs[i + 1][3]
            ua, ud = us[i]
            arc = v_nx * dt + 0.5 * ua * dt * dt
            sin_t, cos_t = torch.sin(th_n), torch.cos(th_n)
            a02 = cos_t * dt
            a03 = -arc * sin_t
            a12 = sin_t * dt
            a13 = arc * cos_t
            b00 = 0.5 * dt * dt * cos_t
            b10 = 0.5 * dt * dt * sin_t
            ea_hi = torch.exp(q2c * (ua - C.a_max))
            ea_lo = torch.exp(q2c * (-C.a_max - ua))
            ed_hi = torch.exp(q2c * (ud - C.d_max))
            ed_lo = torch.exp(q2c * (-C.d_max - ud))
            lu0 = (2.0 * (r_m[0, 0] * ua + r_m[0, 1] * ud)
                   + q1c * q2c * (ea_hi - ea_lo))
            lu1 = (2.0 * (r_m[1, 0] * ua + r_m[1, 1] * ud)
                   + q1c * q2c * (ed_hi - ed_lo))
            luu00 = 2.0 * r_m[0, 0] + q1c * q2c * q2c * (ea_hi + ea_lo)
            luu01 = 2.0 * r_m[0, 1] + zeros
            luu11 = 2.0 * r_m[1, 1] + q1c * q2c * q2c * (ed_hi + ed_lo)
            gei, hei, h0, h1 = obs_terms(xs[i][0], xs[i][1], float(i))
            lx0 = _lin(q_m, 0, xs[i]) + gei * h0
            lx1 = _lin(q_m, 1, xs[i]) + gei * h1
            lx2 = _lin(q_m, 2, xs[i])
            lx3 = _lin(q_m, 3, xs[i])
            gn00 = hei * h0 * h0
            gn01 = hei * h0 * h1
            gn11 = hei * h1 * h1
            # q_x = l_x + A^T v_x ; q_u = l_u + B^T v_x
            qx0 = lx0 + vx0
            qx1 = lx1 + vx1
            qx2 = lx2 + a02 * vx0 + a12 * vx1 + vx2
            qx3 = lx3 + a03 * vx0 + a13 * vx1 + vx3
            qu0 = lu0 + b00 * vx0 + b10 * vx1 + dt * vx2
            qu1 = lu1 + dt * vx3
            # W = V A (V symmetric); columns 2, 3 are the nontrivial ones
            w02 = a02 * v00 + a12 * v01 + v02
            w12 = a02 * v01 + a12 * v11 + v12
            w22 = a02 * v02 + a12 * v12 + v22
            w32 = a02 * v03 + a12 * v13 + v23
            w03 = a03 * v00 + a13 * v01 + v03
            w13 = a03 * v01 + a13 * v11 + v13
            w23 = a03 * v02 + a13 * v12 + v23
            w33 = a03 * v03 + a13 * v13 + v33
            # q_xx = l_xx + A^T V A (symmetric components)
            m00 = 2.0 * q_m[0, 0] + gn00 + v00
            m01 = 2.0 * q_m[0, 1] + gn01 + v01
            m02 = 2.0 * q_m[0, 2] + w02
            m03 = 2.0 * q_m[0, 3] + w03
            m11 = 2.0 * q_m[1, 1] + gn11 + v11
            m12 = 2.0 * q_m[1, 2] + w12
            m13 = 2.0 * q_m[1, 3] + w13
            m22 = 2.0 * q_m[2, 2] + a02 * w02 + a12 * w12 + w22
            m23 = 2.0 * q_m[2, 3] + a02 * w03 + a12 * w13 + w23
            m33 = 2.0 * q_m[3, 3] + a03 * w03 + a13 * w13 + w33
            # q_uu = l_uu + B^T V B ; q_ux = B^T W
            quu00 = (luu00 + b00 * (b00 * v00 + b10 * v01 + dt * v02)
                     + b10 * (b00 * v01 + b10 * v11 + dt * v12)
                     + dt * (b00 * v02 + b10 * v12 + dt * v22))
            quu01 = luu01 + dt * (b00 * v03 + b10 * v13 + dt * v23)
            quu11 = luu11 + dt * dt * v33
            qux00 = b00 * v00 + b10 * v01 + dt * v02
            qux01 = b00 * v01 + b10 * v11 + dt * v12
            qux02 = b00 * w02 + b10 * w12 + dt * w22
            qux03 = b00 * w03 + b10 * w13 + dt * w23
            qux10 = dt * v03
            qux11 = dt * v13
            qux12 = dt * w32
            qux13 = dt * w33
            i00, i01, i11 = _quu_inv_comps(quu00, quu01, quu11, lamb)
            k0 = -(i00 * qu0 + i01 * qu1)
            k1 = -(i01 * qu0 + i11 * qu1)
            kk00 = -(i00 * qux00 + i01 * qux10)
            kk01 = -(i00 * qux01 + i01 * qux11)
            kk02 = -(i00 * qux02 + i01 * qux12)
            kk03 = -(i00 * qux03 + i01 * qux13)
            kk10 = -(i01 * qux00 + i11 * qux10)
            kk11 = -(i01 * qux01 + i11 * qux11)
            kk12 = -(i01 * qux02 + i11 * qux12)
            kk13 = -(i01 * qux03 + i11 * qux13)
            # V_x = q_x - K^T (Quu k); V = q_xx - K^T Quu K
            t0 = quu00 * k0 + quu01 * k1
            t1 = quu01 * k0 + quu11 * k1
            vx0 = qx0 - (kk00 * t0 + kk10 * t1)
            vx1 = qx1 - (kk01 * t0 + kk11 * t1)
            vx2 = qx2 - (kk02 * t0 + kk12 * t1)
            vx3 = qx3 - (kk03 * t0 + kk13 * t1)
            s00 = quu00 * kk00 + quu01 * kk10
            s01 = quu00 * kk01 + quu01 * kk11
            s02 = quu00 * kk02 + quu01 * kk12
            s03 = quu00 * kk03 + quu01 * kk13
            s10 = quu01 * kk00 + quu11 * kk10
            s11 = quu01 * kk01 + quu11 * kk11
            s12 = quu01 * kk02 + quu11 * kk12
            s13 = quu01 * kk03 + quu11 * kk13
            v00 = m00 - (kk00 * s00 + kk10 * s10)
            v01 = m01 - (kk00 * s01 + kk10 * s11)
            v02 = m02 - (kk00 * s02 + kk10 * s12)
            v03 = m03 - (kk00 * s03 + kk10 * s13)
            v11 = m11 - (kk01 * s01 + kk11 * s11)
            v12 = m12 - (kk01 * s02 + kk11 * s12)
            v13 = m13 - (kk01 * s03 + kk11 * s13)
            v22 = m22 - (kk02 * s02 + kk12 * s12)
            v23 = m23 - (kk02 * s03 + kk12 * s13)
            v33 = m33 - (kk03 * s03 + kk13 * s13)
            ks[i] = (k0, k1)
            big_ks[i] = ((kk00, kk01, kk02, kk03), (kk10, kk11, kk12, kk13))
        return ks, big_ks

    def forward(xs, us, ks, big_ks):
        x_new = xs[0]
        us_new = []
        cost = zeros
        for i in range(n):
            dx = tuple(x_new[j] - xs[i][j] for j in range(4))
            kr0, kr1 = big_ks[i]
            u0 = (us[i][0] + ks[i][0] + kr0[0] * dx[0] + kr0[1] * dx[1]
                  + kr0[2] * dx[2] + kr0[3] * dx[3])
            u1 = (us[i][1] + ks[i][1] + kr1[0] * dx[0] + kr1[1] * dx[1]
                  + kr1[2] * dx[2] + kr1[3] * dx[3])
            u_new = clip_u((u0, u1))
            dxt = tuple(x_new[j] - xt[j] for j in range(4))
            cost = cost + _quad(q_m, dxt) + _quad(r_m, u_new)
            x_new = step_soa(x_new, u_new, dt)
            us_new.append(u_new)
        dterm = tuple(x_new[j] - xt[j] for j in range(4))
        return us_new, cost + _quad(qt_m, dterm)

    us_arr = u_init
    lamb = torch.as_tensor(lamb0, dtype=dtype, device=dev).expand(
        bshape).clone()
    done = (torch.zeros(bshape, dtype=torch.bool, device=dev) if done0 is None
            else done0.expand(bshape).clone())
    lane_iters = torch.zeros(bshape, dtype=torch.int32, device=dev)
    it = 0
    while it < max_iter and not bool(done.all()):
        us = [clip_u((us_arr[i, 0], us_arr[i, 1])) for i in range(n)]
        xs = rollout(us)
        cost = loop_cost(xs, us)
        ks, big_ks = backward(xs, us, lamb)
        us_new, cost_new = forward(xs, us, ks, big_ks)
        accept = cost_new < cost
        upd = accept & ~done
        us_arr = torch.where(
            upd, torch.stack([torch.stack(u) for u in us_new]),
            torch.stack([torch.stack(u) for u in us]))
        lamb_next = torch.where(
            done, lamb, torch.where(accept, true_div(lamb, C.lamb_factor),
                                    lamb * C.lamb_factor))
        converged = accept & (torch.abs((cost_new - cost) / cost) < C.eps)
        diverged = (~accept) & (lamb_next > C.max_lamb)
        lane_iters = torch.where(done, lane_iters, it + 1)
        done = done | converged | diverged
        lamb = lamb_next
        it += 1
    us = [clip_u((us_arr[i, 0], us_arr[i, 1])) for i in range(n)]
    xs = rollout(us)
    cost = loop_cost(xs, us)
    return IlqrSoaSolution(
        us=torch.stack([torch.stack(u) for u in us]),
        xs=torch.stack([torch.stack(x) for x in xs]),
        lamb=lamb, n_iters=it, cost=cost, lane_iters=lane_iters)
