"""Unicycle (differential-drive) dynamics: a nonlinear 3-state system for
the generic solvers.

Port of ilqr_iterative_tasks_tpu/models/unicycle.py. State
x = [px, py, theta]; input u = [v, omega]. ``step`` takes state-last
tensors (..., 3); ``step_comps`` takes tuples of per-component tensors, the
form of the generic SoA solver and of the K5 kernel, whose CUDA
instantiation of this model is ``CUDA_MODEL``.
"""

from __future__ import annotations

import torch

X_DIM = 3
U_DIM = 2
CUDA_MODEL = "unicycle"  # csrc/generic_ilqr.cu Unicycle


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
