"""Closed-loop plant of the host controllers: the true bicycle, its noise
and the per-lap records, and the host-side obstacle.

Port of ilqr_iterative_tasks_tpu/sim/plant.py (``ObstacleSim``,
``BicyclePlant``). The plant's state, records and noise draws are numpy
float64; the true dynamics step is the port's ``kinetic_bicycle.step`` on
float64 CPU tensors (the host-side bookkeeping of one robot, not a solve).
Noise: v += 0.5 clip(0.01 z, -0.05, 0.05), theta += 0.5 clip(0.005 z,
-0.05, 0.05), z standard normal from the plant's ``numpy`` Generator (the
same draws as the JAX package's plant on the same seed), off under
``set_zero_noise``.

One deliberate difference from the JAX plant: a controller says "this
step is infeasible" by raising ``InfeasibleStep``, and the plant catches
that class only. The step is then recorded infeasible (feasibility 0) and
the previous input is held. Every other exception (a kernel's launch
failure, a failed build, a missing nvcc, CUDA's own errors, all of them
``RuntimeError``s) propagates and fails the run.
"""

from __future__ import annotations

import time as _time
from typing import List, Optional

import numpy as np
import torch

from ilqr_iterative_tasks_torch.constants import X_DIM
from ilqr_iterative_tasks_torch.models import kinetic_bicycle as dyn
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle


class InfeasibleStep(RuntimeError):
    """A controller found no feasible candidate this step. The only
    exception ``BicyclePlant.calc_ctrl_input`` catches."""


def true_step(x: np.ndarray, u: np.ndarray, dt) -> np.ndarray:
    """One step of the true bicycle in float64 on the host."""
    return dyn.step(torch.as_tensor(np.asarray(x, np.float64)),
                    torch.as_tensor(np.asarray(u, np.float64)), dt).numpy()


class ObstacleSim:
    """Host-side moving obstacle: per-step motion (option 1: +y, option 2:
    -x), per-lap trajectory records, reset to the initial centre at a
    lap's end."""

    def __init__(self, x, y, width, height, spd=None, timestep=None,
                 moving_option=None):
        self.x0, self.y0 = float(x), float(y)
        self.x, self.y = float(x), float(y)
        self.width, self.height = float(width), float(height)
        self.spd = spd
        self.timestep = timestep
        self.moving_option = moving_option
        self.lap_states: List[np.ndarray] = []
        self._states = [np.array([self.x0, self.y0])]

    def as_pytree(self, dtype=torch.float32, device=None) -> Obstacle:
        """The obstacle at its current position as the port's ``Obstacle``
        (on the current CUDA device unless ``device`` is named)."""
        return Obstacle.make(
            x=self.x, y=self.y, width=self.width, height=self.height,
            spd=self.spd, moving_option=self.moving_option, present=True,
            dtype=dtype, device=device)

    def update(self):
        """One closed-loop motion step."""
        if self.spd is not None and self.spd != 0:
            if self.moving_option == 1:
                self.y += self.spd * self.timestep
            elif self.moving_option == 2:
                self.x -= self.spd * self.timestep
        self._states.append(np.array([self.x, self.y]))

    def reset(self):
        """Lap-end reset."""
        self.x, self.y = self.x0, self.y0
        self.lap_states.append(np.stack(self._states))
        self._states = [np.array([self.x0, self.y0])]


class BicyclePlant:
    """True plant with recording (the reference's KineticBicycle)."""

    def __init__(self, limits=None, rng: Optional[np.random.Generator] = None):
        self.limits = limits
        self.timestep: Optional[float] = None
        self.x: Optional[np.ndarray] = None
        self.u: Optional[np.ndarray] = None
        self.time = 0.0
        self.zero_noise_flag = False
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.ctrl_policy = None
        self.feasible = None
        self.delta_timer = None
        # the InfeasibleStep of every step recorded infeasible, in order
        self.infeasible_errors: List[InfeasibleStep] = []
        # per-lap records
        self.states = None
        self.inputs: List[np.ndarray] = []
        self.timestamps: List[float] = []
        self.solver_times: List[float] = []
        self.feasibility: List[int] = []
        self.data = {"state": [], "input": [], "timestamp": []}
        self.diagnostics = {"solver_time": [], "feasibility": []}

    def set_zero_noise(self):
        self.zero_noise_flag = True

    def set_timestep(self, dt: float):
        self.timestep = dt

    def set_state(self, x):
        self.x = np.asarray(x, dtype=np.float64).copy()
        self.states = [self.x.copy()]
        self.inputs = []
        self.timestamps = []
        self.solver_times = []
        self.feasibility = []

    def set_ctrl_policy(self, policy):
        self.ctrl_policy = policy

    def calc_ctrl_input(self):
        """Ask the controller for the next input, wall-clock timed.

        ``InfeasibleStep`` from the controller records the step infeasible
        (feasibility 0) and holds the previous input; nothing else is
        caught, so a kernel, build or CUDA error fails the run."""
        self.ctrl_policy.set_state(self.x)
        t0 = _time.perf_counter()
        try:
            self.ctrl_policy.calc_input()
            self.u = np.asarray(self.ctrl_policy.get_input(), dtype=np.float64)
            self.delta_timer = _time.perf_counter() - t0
            self.feasible = 1
        except InfeasibleStep as err:
            self.feasible = 0
            self.delta_timer = _time.perf_counter() - t0
            self.infeasible_errors.append(err)

    def forward_dynamics(self):
        """True dynamics step with clipped Gaussian noise on v and theta."""
        x_next = true_step(self.x, self.u, self.timestep)
        if not self.zero_noise_flag:
            noise_v = np.clip(self.rng.standard_normal() * 0.01, -0.05, 0.05)
            noise_theta = np.clip(self.rng.standard_normal() * 0.005, -0.05, 0.05)
            x_next[2] += 0.5 * noise_v
            x_next[3] += 0.5 * noise_theta
        self.x = x_next
        self.time += self.timestep

    def forward_one_step(self):
        """Solve -> step -> record."""
        self.calc_ctrl_input()
        self.forward_dynamics()
        self.ctrl_policy.set_state(self.x)
        self.update_memory()

    def update_memory(self):
        self.states.append(self.x.copy())
        self.inputs.append(self.u.copy())
        self.timestamps.append(self.time)
        self.solver_times.append(self.delta_timer)
        self.feasibility.append(self.feasible)

    def update_memory_post_iter(self):
        """Lap-end bookkeeping and state reset."""
        self.data["state"].append(np.stack(self.states))
        self.data["input"].append(np.stack(self.inputs) if self.inputs
                                  else np.zeros((0, 2)))
        self.data["timestamp"].append(np.asarray(self.timestamps))
        self.diagnostics["solver_time"].append(np.asarray(self.solver_times))
        self.diagnostics["feasibility"].append(np.asarray(self.feasibility))
        self.set_state(np.zeros((X_DIM,)))
