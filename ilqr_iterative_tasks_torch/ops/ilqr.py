"""Core LM-iLQR trajectory solve in array-of-structures form (one
trajectory, state last), as plain loops on tensors.

Port of ilqr_iterative_tasks_tpu/ops/ilqr.py:

- ``ilqr_solve``: the Levenberg-Marquardt outer loop (clip, rollout and
  cost, backward Riccati pass, full-step forward pass, accept with
  lambda / factor, reject with lambda * factor; converged when
  |dcost / cost| < eps, given up when lambda > max_lamb);
- ``backward_pass``: Jacobians at the SUCCESSOR state's (v, theta) with
  the current input's accel (reference quirk), the closed-form spectral
  clamp-and-shift inverse of the 2x2 Quu (``_reg_inv_2x2``);
- ``forward_pass``: clipped full-step rollout, its running cost measured
  against ``x_terminal`` (reference asymmetry, moot at matrix_Q = 0);
- ``ilqr_solve_candidates``: the i2LQR candidate sweep, lambda reset per
  candidate. It delegates to the batched plain solve
  (ops/ilqr_soa.py::ilqr_solve_soa), the plain version of the K3 kernel,
  which the JAX package holds equal to its vmap of ``ilqr_solve``;
- ``ilqr_solve_candidates_seq``: the reference's exact sweep, candidate
  j's final lambda seeding candidate j+1 (a loop of ``ilqr_solve``).

The JAX package's ``jit`` / ``lax.while_loop`` become Python loops; the
parameter tensors must lie on the inputs' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ilqr_iterative_tasks_torch.models import kinetic_bicycle as dyn
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops import costs
from ilqr_iterative_tasks_torch.ops.fused_ilqr import obstacle_to_lanes
from ilqr_iterative_tasks_torch.ops.ilqr_soa import ilqr_solve_soa
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits


class IlqrSolution(NamedTuple):
    us: torch.Tensor  # (N, 2) optimized (clipped) inputs
    xs: torch.Tensor  # (N+1, 4) rollout of ``us`` from x0
    lamb: torch.Tensor  # final LM regularization
    n_iters: torch.Tensor  # iterations executed
    cost: torch.Tensor  # cost of the returned trajectory


def clip_inputs(us: torch.Tensor, limits: SystemLimits) -> torch.Tensor:
    """Hard input clip; delta at the rounded ``delta_max_r``."""
    a = torch.clamp(us[..., 0], -limits.a_max, limits.a_max)
    d = torch.clamp(us[..., 1], -limits.delta_max_r, limits.delta_max_r)
    return torch.stack([a, d], dim=-1)


def rollout(x0: torch.Tensor, us: torch.Tensor, dt) -> torch.Tensor:
    """Open-loop rollout: (..., 4), (..., N, 2) -> (..., N+1, 4)."""
    xs = [x0]
    for i in range(us.shape[-2]):
        xs.append(dyn.step(xs[-1], us[..., i, :], dt))
    return torch.stack(xs, dim=-2)


def _reg_inv_2x2(quu: torch.Tensor, lamb) -> torch.Tensor:
    """Spectral f(Quu) with f(e) = 1 / (max(e, 0) + lamb) for a symmetric
    2x2: alpha I + beta A, alpha / beta interpolating f on the two
    eigenvalues (beta 0 where they coincide)."""
    a = quu[..., 0, 0]
    b = 0.5 * (quu[..., 0, 1] + quu[..., 1, 0])
    c = quu[..., 1, 1]
    mean = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(0.25 * (a - c) ** 2 + b * b, 0.0))
    e1 = mean + disc
    e2 = mean - disc
    f1 = 1.0 / (torch.clamp_min(e1, 0.0) + lamb)
    f2 = 1.0 / (torch.clamp_min(e2, 0.0) + lamb)
    safe = disc > 1e-12
    beta = torch.where(safe, (f1 - f2) / torch.where(safe, e1 - e2, 1.0), 0.0)
    alpha = f1 - beta * e1
    eye = torch.eye(2, dtype=quu.dtype, device=quu.device)
    sym = quu.clone()
    sym[..., 0, 1] = b
    sym[..., 1, 0] = b
    return alpha[..., None, None] * eye + beta[..., None, None] * sym


def backward_pass(xs, us, x_terminal, xtarget, lamb, obstacle: Obstacle,
                  params: IlqrParams, limits: SystemLimits, dt):
    """Riccati recursion. xs (N+1, 4), us (N, 2) -> k (N, 2), K (N, 2, 4)."""
    f_x = dyn.jacobian_A(xs[1:, 2], xs[1:, 3], us[:, 0], dt)  # (N, 4, 4)
    f_u = dyn.jacobian_B(xs[1:, 3], dt)  # (N, 4, 2)
    l_u, l_uu, l_x, l_xx = costs.stage_cost_derivs(
        xs[:-1], us, xtarget, obstacle, params, limits)
    v_x, v_xx = costs.terminal_cost_derivs(xs[-1], x_terminal, obstacle,
                                           params)
    n = us.shape[0]
    ks, big_ks = [None] * n, [None] * n
    for i in range(n - 1, -1, -1):
        fx, fu = f_x[i], f_u[i]
        q_x = l_x[i] + fx.T @ v_x
        q_u = l_u[i] + fu.T @ v_x
        q_xx = l_xx[i] + fx.T @ v_xx @ fx
        q_uu = l_uu[i] + fu.T @ v_xx @ fu
        q_ux = fu.T @ v_xx @ fx
        quu_inv = _reg_inv_2x2(q_uu, lamb)
        k_t = -quu_inv @ q_u
        big_k = -quu_inv @ q_ux
        v_x = q_x - big_k.T @ q_uu @ k_t
        v_xx = q_xx - big_k.T @ q_uu @ big_k
        ks[i], big_ks[i] = k_t, big_k
    return torch.stack(ks), torch.stack(big_ks)


def forward_pass(xs, us, ks, big_ks, x_terminal, params: IlqrParams,
                 limits: SystemLimits, dt):
    """Clipped full-step rollout u + k + K (x_new - x) -> (xs_new, us_new,
    cost_new); the running state cost is against ``x_terminal``."""
    x_new = xs[0]
    xs_new, us_new, stage = [x_new], [], []
    for i in range(us.shape[0]):
        u_new = us[i] + ks[i] + big_ks[i] @ (x_new - xs[i])
        u_new = clip_inputs(u_new, limits)
        dx = x_new - x_terminal
        l_state = dx @ params.matrix_Q @ dx
        l_ctrl = u_new @ params.matrix_R @ u_new
        stage.append(l_state + l_ctrl)
        x_new = dyn.step(x_new, u_new, dt)
        xs_new.append(x_new)
        us_new.append(u_new)
    dterm = x_new - x_terminal
    cost_new = torch.sum(torch.stack(stage)) + (
        dterm @ params.matrix_Qterminal @ dterm)
    return torch.stack(xs_new), torch.stack(us_new), cost_new


def ilqr_solve(params: IlqrParams, limits: SystemLimits, obstacle: Obstacle,
               x0: torch.Tensor, x_terminal: torch.Tensor,
               u_init: torch.Tensor, lamb0, dt, xtarget=None, *,
               num_horizon: int) -> IlqrSolution:
    """Full LM-regularized iLQR solve of one trajectory; ``num_horizon`` is
    u_init.shape[0]."""
    if u_init.shape[0] != num_horizon:
        raise ValueError(f"u_init has {u_init.shape[0]} steps, expected "
                         f"{num_horizon}")
    dtype, dev = x0.dtype, x0.device
    if xtarget is None:
        xtarget = torch.zeros_like(x0)

    def loop_cost(xs, us):
        return costs.trajectory_cost(xs, us, x_terminal, xtarget, params)

    us = clip_inputs(u_init, limits)
    lamb = torch.as_tensor(lamb0, dtype=dtype, device=dev)
    it, done = 0, False
    while it < params.max_ilqr_iter and not done:
        us_c = clip_inputs(us, limits)
        xs = rollout(x0, us_c, dt)
        cost = loop_cost(xs, us_c)
        ks, big_ks = backward_pass(xs, us_c, x_terminal, xtarget, lamb,
                                   obstacle, params, limits, dt)
        _, us_new, cost_new = forward_pass(xs, us_c, ks, big_ks, x_terminal,
                                           params, limits, dt)
        accept = bool(cost_new < cost)
        us = us_new if accept else us_c
        lamb_next = (lamb / params.lamb_factor if accept
                     else lamb * params.lamb_factor)
        converged = accept and bool(
            torch.abs((cost_new - cost) / cost) < params.eps)
        diverged = (not accept) and bool(lamb_next > params.max_lamb)
        lamb, it, done = lamb_next, it + 1, converged or diverged
    us = clip_inputs(us, limits)
    xs = rollout(x0, us, dt)
    return IlqrSolution(us=us, xs=xs, lamb=lamb,
                        n_iters=torch.tensor(it, device=dev),
                        cost=loop_cost(xs, us))


def ilqr_solve_candidates(params: IlqrParams, limits: SystemLimits,
                          obstacle: Obstacle, x0: torch.Tensor,
                          x_terminals: torch.Tensor, u_init: torch.Tensor,
                          lamb0, dt, *, num_horizon: int) -> IlqrSolution:
    """Independent solves of a batch of terminal candidates (lambda reset
    per candidate). x_terminals: (B, 4); u_init: (N, 2) shared. Outputs
    carry the candidate axis first, as the JAX vmap's do."""
    b, n = x_terminals.shape[0], num_horizon
    sol = ilqr_solve_soa(
        params, limits, obstacle_to_lanes(obstacle, b),
        x0[:, None].expand(4, b), x_terminals.T,
        u_init[:, :, None].expand(n, 2, b), lamb0, dt, num_horizon=n)
    return IlqrSolution(us=sol.us.permute(2, 0, 1),
                        xs=sol.xs.permute(2, 0, 1), lamb=sol.lamb,
                        n_iters=sol.lane_iters, cost=sol.cost)


def ilqr_solve_candidates_seq(params: IlqrParams, limits: SystemLimits,
                              obstacle: Obstacle, x0: torch.Tensor,
                              x_terminals: torch.Tensor,
                              u_init: torch.Tensor, lamb0, dt, *,
                              num_horizon: int) -> IlqrSolution:
    """The reference's sequential-lambda sweep: candidate j's final lambda
    (after the last accept's division or the past-max_lamb inflation)
    seeds candidate j+1; the caller resets it by passing ``lamb0``.
    Stacked outputs as ``ilqr_solve_candidates``."""
    lamb, sols = lamb0, []
    for xt in x_terminals:
        sol = ilqr_solve(params, limits, obstacle, x0, xt, u_init, lamb, dt,
                         num_horizon=num_horizon)
        lamb = sol.lamb
        sols.append(sol)
    return IlqrSolution(*(torch.stack(f) for f in zip(*sols)))
