"""Seed (iteration-0) lap: the scripted 120 s open-loop maneuver.

Port of ilqr_iterative_tasks_tpu/sim/seed.py::seed_trajectory: accelerate
1 s at a=1, steer +pi/6 for 1 s, opposite steer at mid-trajectory,
decelerate near the end, integrated with the bicycle dynamics in float64.
The goal of the task is the last state (~[201.45, 0, 0, -0.5236] at dt=1).
"""

from __future__ import annotations

import numpy as np
import torch

from ilqr_iterative_tasks_torch.constants import U_DIM, X_DIM
from ilqr_iterative_tasks_torch.models import kinetic_bicycle as dyn


def seed_trajectory(dt: float):
    """Returns numpy (xcl (T+1, 4), ucl (T, 2)) float64 with T = int(120/dt)."""
    angle = np.pi / 6
    total = int(120 / dt)
    xs = [np.zeros(X_DIM)]
    us = []
    for i in range(total):
        u = np.zeros(U_DIM)
        if i <= 1 / dt:
            u[0] = 1.0
        elif total - 4 / dt <= i <= total - 3 / dt:
            u[0] = -1.0
        if 0 < i <= 1 / dt:
            u[1] = angle
        elif total / 2 - 2 / dt <= i <= total / 2 - 1 / dt:
            u[1] = -angle
        xs.append(dyn.step(torch.from_numpy(xs[-1]), torch.from_numpy(u),
                           dt).numpy())
        us.append(u)
    return np.stack(xs), np.stack(us)
