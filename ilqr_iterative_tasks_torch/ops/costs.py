"""Cost stack of the AoS iLQR solve: quadratic terms and exponential
repelling barriers, vectorised over the horizon.

Port of ilqr_iterative_tasks_tpu/ops/costs.py:

- input-bound barriers b = q1 e^{q2 c} on [accel, delta] (rounded
  ``delta_max_r``), gradient q1 q2 e^{q2 c} c', Gauss-Newton Hessian;
- the obstacle ellipse barrier at the horizon-extrapolated centre;
- per-step derivatives l_u, l_uu, l_x, l_xx and the terminal value seed,
  whose obstacle is extrapolated by the PARAM horizon whatever the solve's
  horizon (reference quirk);
- ``trajectory_cost``, the accept/reject cost (no barriers).

Every function broadcasts over leading batch dims; the dtype and device
follow the inputs. The parameter tensors must lie on the inputs' device.
"""

from __future__ import annotations

import torch

from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits


def control_barrier_derivs(u: torch.Tensor, params: IlqrParams,
                           limits: SystemLimits):
    """u: (..., 2) -> (b_dot (..., 2), b_ddot (..., 2, 2)); the Hessian is
    diagonal (accel barriers touch [0, 0], steering ones [1, 1])."""
    q1, q2 = params.tuning_ctrl_q1, params.tuning_ctrl_q2
    a, d = u[..., 0], u[..., 1]
    ea_hi = torch.exp(q2 * (a - limits.a_max))
    ea_lo = torch.exp(q2 * (-limits.a_max - a))
    ed_hi = torch.exp(q2 * (d - limits.delta_max_r))
    ed_lo = torch.exp(q2 * (-limits.delta_max_r - d))
    g = q1 * q2
    h = q1 * q2 * q2
    b_dot = torch.stack([g * (ea_hi - ea_lo), g * (ed_hi - ed_lo)], dim=-1)
    z = torch.zeros_like(a)
    b_ddot = torch.stack([
        torch.stack([h * (ea_hi + ea_lo), z], dim=-1),
        torch.stack([z, h * (ed_hi + ed_lo)], dim=-1)], dim=-2)
    return b_dot, b_ddot


def obstacle_barrier_derivs(px, py, step_offset, obstacle: Obstacle,
                            params: IlqrParams):
    """Gradient / Gauss-Newton Hessian of the ellipse barrier at horizon
    offset(s): h = 1 + margin - diff^T P diff, P = diag(1/a^2, 1/b^2, 0, 0).
    px, py, step_offset (...,) -> (b_dot (..., 4), b_ddot (..., 4, 4)),
    scaled by ``obstacle.present``."""
    q1, q2 = params.tuning_obs_q1, params.tuning_obs_q2
    cx, cy = obstacle.center_at(step_offset)
    dz = px - cx
    dy = py - cy
    inv_a2 = 1.0 / (obstacle.width ** 2)
    inv_b2 = 1.0 / (obstacle.height ** 2)
    hval = 1.0 + params.safety_margin - (dz * dz * inv_a2 + dy * dy * inv_b2)
    e = obstacle.present * torch.exp(q2 * hval)
    hd0 = -2.0 * inv_a2 * dz
    hd1 = -2.0 * inv_b2 * dy
    z = torch.zeros_like(dz)
    h_dot = torch.stack([hd0, hd1, z, z], dim=-1)
    b_dot = (q1 * q2 * e)[..., None] * h_dot
    b_ddot = (q1 * q2 * q2 * e)[..., None, None] * (
        h_dot[..., :, None] * h_dot[..., None, :])
    return b_dot, b_ddot


def stage_cost_derivs(xs, us, xtarget, obstacle: Obstacle, params: IlqrParams,
                      limits: SystemLimits):
    """xs: (N, 4) states x_0..x_{N-1}; us: (N, 2) clipped inputs ->
    l_u (N, 2), l_uu (N, 2, 2), l_x (N, 4), l_xx (N, 4, 4)."""
    n = us.shape[-2]
    dX = xs - xtarget
    bd_u, bdd_u = control_barrier_derivs(us, params, limits)
    l_u = 2.0 * (us @ params.matrix_R.T) + bd_u
    l_uu = 2.0 * params.matrix_R + bdd_u
    offsets = torch.arange(n, dtype=xs.dtype, device=xs.device)
    bd_x, bdd_x = obstacle_barrier_derivs(
        xs[..., 0], xs[..., 1], offsets, obstacle, params)
    l_x = 2.0 * (dX @ params.matrix_Q.T) + bd_x
    l_xx = 2.0 * params.matrix_Q + bdd_x
    return l_u, l_uu, l_x, l_xx


def terminal_cost_derivs(x_last, x_terminal, obstacle: Obstacle,
                         params: IlqrParams):
    """Terminal value seed (v_x (..., 4), v_xx (..., 4, 4)); the obstacle is
    extrapolated by ``params.num_horizon`` (reference quirk)."""
    diff = x_last - x_terminal
    v_x = 2.0 * (diff @ params.matrix_Qterminal.T)
    v_xx = 2.0 * params.matrix_Qterminal + torch.zeros(
        diff.shape[:-1] + (4, 4), dtype=diff.dtype, device=diff.device)
    off = torch.as_tensor(params.num_horizon, dtype=x_last.dtype,
                          device=x_last.device)
    bd, bdd = obstacle_barrier_derivs(
        x_last[..., 0], x_last[..., 1], off, obstacle, params)
    return v_x + bd, v_xx + bdd


def trajectory_cost(xs, us, x_terminal, xtarget, params: IlqrParams):
    """Scalar rollout cost: running x_0..x_{N-1} against ``xtarget`` plus
    u^T R u, terminal quadratic against ``x_terminal``. xs: (N+1, 4),
    us: (N, 2)."""
    dxs = xs[..., :-1, :] - xtarget
    l_state = torch.einsum("...ni,ij,...nj->...", dxs, params.matrix_Q, dxs)
    l_ctrl = torch.einsum("...ni,ij,...nj->...", us, params.matrix_R, us)
    dterm = xs[..., -1, :] - x_terminal
    l_term = torch.einsum("...i,ij,...j->...", dterm,
                          params.matrix_Qterminal, dterm)
    return l_state + l_ctrl + l_term
