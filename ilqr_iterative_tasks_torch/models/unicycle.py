"""Unicycle (differential-drive) dynamics: a nonlinear 3-state system for
the generic solvers.

Port of ilqr_iterative_tasks_tpu/models/unicycle.py. State
x = [px, py, theta]; input u = [v, omega]. ``step`` takes state-last
tensors (..., 3); ``step_comps`` takes tuples of per-component tensors, the
form of the generic SoA solver; ``CUDA_STEP`` is the same step as the K5
kernel takes it (csrc/generic_ilqr.cuh; sn, cs the sin and cos of theta).
"""

from __future__ import annotations

import torch

X_DIM = 3
U_DIM = 2
CUDA_STEP = """
struct Unicycle {
  static constexpr int NX = 3, NU = 2, ANGLE = 2;
  template <typename S, typename T>
  ILQR_HD static void step(const S* x, const S* u, T dt, T sn, T cs, S* y) {
    y[0] = x[0] + u[0] * mcos(x[2], sn, cs) * dt;
    y[1] = x[1] + u[0] * msin(x[2], sn, cs) * dt;
    y[2] = x[2] + u[1] * dt;
  }
};
"""


def step(x: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """One discrete step. x: (..., 3), u: (..., 2) -> (..., 3)."""
    px, py, theta = x[..., 0], x[..., 1], x[..., 2]
    v, omega = u[..., 0], u[..., 1]
    return torch.stack(
        [px + v * torch.cos(theta) * dt,
         py + v * torch.sin(theta) * dt,
         theta + omega * dt], dim=-1)


def step_comps(x, u, dt):
    """x = (px, py, theta), u = (v, omega) as batch-trailing tensors."""
    px, py, theta = x
    v, omega = u
    return (px + v * torch.cos(theta) * dt,
            py + v * torch.sin(theta) * dt,
            theta + omega * dt)
