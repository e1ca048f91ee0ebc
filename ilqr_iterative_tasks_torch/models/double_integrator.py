"""Planar double-integrator dynamics: a second system for the generic
solvers.

Port of ilqr_iterative_tasks_tpu/models/double_integrator.py. State
x = [px, py, vx, vy]; input u = [ax, ay]; exact discrete (2nd-order)
position update, in the bicycle model's integration order. ``step`` takes
state-last tensors (..., 4); ``step_comps`` takes tuples of per-component
tensors, the form of the generic SoA solver; ``CUDA_STEP`` is the same step
as the K5 kernel takes it (csrc/generic_ilqr.cuh), in the same expressions
and order.
"""

from __future__ import annotations

import torch

X_DIM = 4
U_DIM = 2
CUDA_STEP = """
struct DoubleIntegrator {
  static constexpr int NX = 4, NU = 2, ANGLE = -1;
  template <typename S, typename T>
  ILQR_HD static void step(const S* x, const S* u, T dt, T, T, S* y) {
    y[0] = x[0] + x[2] * dt + (T)0.5 * u[0] * dt * dt;
    y[1] = x[1] + x[3] * dt + (T)0.5 * u[1] * dt * dt;
    y[2] = x[2] + u[0] * dt;
    y[3] = x[3] + u[1] * dt;
  }
};
"""


def step(x: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """One discrete step. x: (..., 4), u: (..., 2) -> (..., 4)."""
    px, py, vx, vy = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    ax, ay = u[..., 0], u[..., 1]
    return torch.stack(
        [px + vx * dt + 0.5 * ax * dt * dt,
         py + vy * dt + 0.5 * ay * dt * dt,
         vx + ax * dt,
         vy + ay * dt], dim=-1)


def step_comps(x, u, dt):
    """x = (px, py, vx, vy), u = (ax, ay) as batch-trailing tensors."""
    px, py, vx, vy = x
    ax, ay = u
    return (px + vx * dt + 0.5 * ax * dt * dt,
            py + vy * dt + 0.5 * ay * dt * dt,
            vx + ax * dt,
            vy + ay * dt)
