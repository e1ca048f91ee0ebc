"""Kinematic bicycle dynamics and analytic Jacobians (torch).

Port of ilqr_iterative_tasks_tpu/models/kinetic_bicycle.py:

    x'     = x + cos(theta) * (v*dt + a*dt^2/2)
    y'     = y + sin(theta) * (v*dt + a*dt^2/2)
    v'     = v + a*dt
    theta' = theta + delta*dt

``step`` and the Jacobians broadcast over leading batch dimensions (state
last, as in the JAX module). The solvers evaluate the Jacobians at the
SUCCESSOR state's (v, theta) with the current input's accel (reference
quirk); these functions are evaluation-point agnostic. ``step_comps`` takes
tuples of per-component tensors (ops/ilqr_soa.py's ``step_soa``), the form
of the generic SoA solver and of the K5 kernel, whose CUDA instantiation of
this model is ``CUDA_MODEL``.
"""

from __future__ import annotations

import torch

X_DIM = 4
U_DIM = 2
CUDA_MODEL = "bicycle"  # csrc/generic_ilqr.cu Bicycle


def step_comps(x, u, dt):
    """x: tuple of 4 (*S) tensors, u: tuple of 2 -> tuple of 4."""
    px, py, v, th = x
    ua, ud = u
    arc = v * dt + 0.5 * ua * dt * dt
    return (px + torch.cos(th) * arc, py + torch.sin(th) * arc,
            v + ua * dt, th + ud * dt)


def step(x: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """One discrete dynamics step. x: (..., 4), u: (..., 2) -> (..., 4)."""
    px, py, v, theta = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    accel, delta = u[..., 0], u[..., 1]
    arc = v * dt + 0.5 * accel * dt * dt
    return torch.stack([px + torch.cos(theta) * arc,
                        py + torch.sin(theta) * arc,
                        v + accel * dt,
                        theta + delta * dt], dim=-1)


def jacobian_A(v, theta, accel, dt) -> torch.Tensor:
    """df/dx at (v, theta, accel). Inputs (...,) -> (..., 4, 4)."""
    z = torch.zeros_like(v)
    o = torch.ones_like(v)
    arc = v * dt + 0.5 * accel * dt * dt
    row0 = torch.stack([o, z, torch.cos(theta) * dt, -arc * torch.sin(theta)],
                       dim=-1)
    row1 = torch.stack([z, o, torch.sin(theta) * dt, arc * torch.cos(theta)],
                       dim=-1)
    row2 = torch.stack([z, z, o, z], dim=-1)
    row3 = torch.stack([z, z, z, o], dim=-1)
    return torch.stack([row0, row1, row2, row3], dim=-2)


def jacobian_B(theta, dt) -> torch.Tensor:
    """df/du at theta. Inputs (...,) -> (..., 4, 2)."""
    z = torch.zeros_like(theta)
    o = torch.ones_like(theta)
    half_dt2 = 0.5 * dt * dt
    row0 = torch.stack([half_dt2 * torch.cos(theta), z], dim=-1)
    row1 = torch.stack([half_dt2 * torch.sin(theta), z], dim=-1)
    row2 = torch.stack([dt * o, z], dim=-1)
    row3 = torch.stack([z, dt * o], dim=-1)
    return torch.stack([row0, row1, row2, row3], dim=-2)
