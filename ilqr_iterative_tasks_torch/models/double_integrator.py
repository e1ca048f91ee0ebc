"""Planar double-integrator dynamics: a second system for the generic
solvers.

Port of ilqr_iterative_tasks_tpu/models/double_integrator.py. State
x = [px, py, vx, vy]; input u = [ax, ay]; exact discrete (2nd-order)
position update, in the bicycle model's integration order. ``step`` takes
state-last tensors (..., 4); ``step_comps`` takes tuples of per-component
tensors, the form of the generic SoA solver and of the K5 kernel, whose
CUDA instantiation of this model is ``CUDA_MODEL``.
"""

from __future__ import annotations

import torch

X_DIM = 4
U_DIM = 2
CUDA_MODEL = "double_integrator"  # csrc/generic_ilqr.cu DoubleIntegrator


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
