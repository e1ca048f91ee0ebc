"""i2LQR learning controller, step by step on the host (the reference's
iLqr), with its candidate sweeps through the K3 kernel.

Port of ilqr_iterative_tasks_tpu/control/i2lqr.py. Per control step:

- three relaxation passes (the reference loops up to max_outloop_iter =
  50 times and breaks at pass 2);
- in each pass, for every stored lap of the last ``num_ss_iter``, the
  ``num_ss_points`` L1-nearest states around the terminal guess (pass 0
  guesses the current state, later passes the previous winner's x_N), each
  a candidate terminal state of one fixed-horizon LM-iLQR solve;
- the relaxed reach cost of each candidate (``relaxed_reach_cost``), the
  lexicographic list-min over the laps' ragged cost lists and the argmin
  within;
- the terminal guess re-centred, the horizon shrunk when the winner is its
  lap's last point, then the stored inputs replayed (shrinking horizon).

The host logic (kNN, costs, list-min, replay) is numpy, as in the JAX
controller. The candidate sweep of a pass is ONE launch of K3
(ops/fused_ilqr.py::build_fused_ilqr), whose lanes are every candidate of
every lap in the window, each from the current state with zero initial
inputs and the obstacle at its current position; solves are independent,
lambda reset per candidate, so the launch computes what JAX's vmap a lap
computes. K3 runs its plain version (ops/ilqr_soa.py) for CPU tensors and
the kernel for CUDA ones, so the controller calls it the same way on both
devices. A winner's predicted states are the rollout of its clipped inputs,
with K3's own x_N as the last column (the next pass's guess).

``sequential_lambda=True`` runs the reference's exact sweep instead
(candidate j's final LM lambda seeds candidate j+1 within a lap,
ops/ilqr.py::ilqr_solve_candidates_seq), a tool for f64 parity studies
that reproduces the reference's [54, 27, 24, 24, 24]. K3 returns no lambda,
so this mode runs on the CPU only: on another device the constructor
raises.

The controller never raises an infeasible step (a pass whose candidates
all cost Inf still picks the first); whatever it raises is an error that
fails the run (sim/plant.py).
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch

from ilqr_iterative_tasks_torch.constants import U_DIM, X_DIM
from ilqr_iterative_tasks_torch.control.safe_set import SafeSet
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops import ilqr as ilqr_ops
from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
    FusedIlqr, build_fused_ilqr, obstacle_to_lanes)
from ilqr_iterative_tasks_torch.sim.plant import true_step
from ilqr_iterative_tasks_torch.utils.device import resolve
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits


def relaxed_reach_cost(dist: float, cost_terminal: float, num_horizon: int,
                       outer_iter: int, max_relax_iter: int) -> float:
    """The smallest i >= 1 with dist <= 80 i / 10^outer_iter gives
    cost_terminal + num_horizon + 100 i; Inf past ``max_relax_iter``."""
    unit = 80.0 / (10 ** outer_iter)
    if dist > unit * max_relax_iter:
        return float("inf")
    i = max(1, int(math.ceil(dist / unit - 1e-12)))
    return float(cost_terminal) + float(num_horizon) + 100.0 * i


class I2LqrController:
    """Host-driven i2LQR controller whose candidate sweeps run through K3.

    ``device``: where the candidate lanes live (the current CUDA device
    unless the caller names one, utils/device.py). ``dtype``: the solves'
    dtype. ``solve_seconds`` holds the wall seconds of every step that
    solved (host clock, after the last pass's outputs reached the host) and
    ``launch_lanes`` the lanes of every K3 call; replay and horizon-1 steps
    do not solve.
    """

    def __init__(self, params: IlqrParams, obstacle: Optional[object] = None,
                 limits: Optional[SystemLimits] = None, dtype=torch.float32,
                 sequential_lambda: bool = False, device=None):
        self.device = resolve(device)
        if sequential_lambda and self.device.type != "cpu":
            raise ValueError(
                "sequential_lambda runs on the CPU only (device='cpu'): the "
                "K3 kernel returns no LM lambda to thread between candidates")
        self.sequential_lambda = sequential_lambda
        self.params = params
        self.limits = (limits if limits is not None
                       else SystemLimits.make(dtype=dtype, device=self.device))
        self.obstacle = obstacle  # sim.plant.ObstacleSim or None
        self.safe_set = SafeSet()
        self.dtype = dtype
        self.timestep: Optional[float] = None
        self.time = 0.0
        self.x: Optional[np.ndarray] = None
        self.u: Optional[np.ndarray] = None
        self.num_horizon = params.num_horizon
        self.x_terminal_guess: Optional[np.ndarray] = None
        self.x_pred: Optional[np.ndarray] = None
        self.u_pred: Optional[np.ndarray] = None
        self.u_old: Optional[np.ndarray] = None
        self._k3 = {}  # (dtype, dt) -> FusedIlqr
        self.solve_seconds: List[float] = []
        self.launch_lanes: List[int] = []

    # -- ControlBase API --
    def set_timestep(self, dt: float):
        self.timestep = dt

    def set_state(self, x):
        self.x = np.asarray(x, dtype=np.float64)

    def get_input(self):
        return self.u

    @property
    def iter(self) -> int:
        return self.safe_set.num_laps

    def add_trajectory(self, x: np.ndarray, u: np.ndarray):
        """Store a completed lap and reset the per-lap solver state."""
        self.safe_set.add_trajectory(x, u)
        self.num_horizon = self.params.num_horizon
        self.x_terminal_guess = self.safe_set.ss[-1][:, self.num_horizon].copy()

    def k3(self) -> FusedIlqr:
        """The K3 at the params' horizon, the only one a step solves at
        (built once per dtype and dt)."""
        key = (self.dtype, float(self.timestep))
        if key not in self._k3:
            self._k3[key] = build_fused_ilqr(
                self.params, self.limits, self.timestep,
                num_horizon=self.params.num_horizon,
                max_iter=self.params.max_ilqr_iter)
        return self._k3[key]

    def _obstacle(self) -> Obstacle:
        if self.obstacle is None:
            return Obstacle.absent(dtype=self.dtype, device=self.device)
        return self.obstacle.as_pytree(dtype=self.dtype, device=self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a), dtype=self.dtype,
                            device=self.device)

    def _sweep_k3(self, x_terms: np.ndarray, obstacle: Obstacle, n: int):
        """One K3 launch over candidates x_terms (4, B) -> host (us (N, 2,
        B), x_last (4, B), dist (B,)) in the solve's dtype."""
        b = x_terms.shape[1]
        lanes = obstacle_to_lanes(obstacle, b).contiguous()
        x0 = self._tensor(self.x)[:, None].expand(X_DIM, b).contiguous()
        us, x_last, _, dist = self.k3()(
            x0, self._tensor(x_terms),
            torch.zeros((n, U_DIM, b), dtype=self.dtype, device=self.device),
            lanes)
        self.launch_lanes.append(b)
        out = torch.cat([us.reshape(n * U_DIM, b), x_last, dist[None]]).cpu()
        return (out[:n * U_DIM].reshape(n, U_DIM, b),
                out[n * U_DIM:n * U_DIM + X_DIM], out[-1])

    def _winner_pred(self, us: torch.Tensor, x_last: torch.Tensor):
        """(x_pred (4, N+1), u_pred (2, N)) float64 of one K3 lane: the
        rollout of its clipped inputs, K3's x_N as the last column."""
        x0 = torch.tensor(self.x, dtype=self.dtype)
        xs = ilqr_ops.rollout(x0, us, self.timestep)
        xs[-1] = x_last
        return (xs.T.to(torch.float64).numpy(),
                us.T.to(torch.float64).numpy())

    def calc_input(self):
        p = self.params
        if self.num_horizon < p.num_horizon:
            # shrinking-horizon replay of the stored inputs
            if self.u_old.shape[1] == 0:
                # the replay buffer is exhausted (plant noise kept the lap
                # alive past the last stored input, where the reference
                # would index an empty buffer): hold the last input until
                # the lap ends, as the batched simulators' clipped replay
                self.u_pred = np.asarray(self.u, dtype=np.float64).reshape(
                    U_DIM, 1)
                self.time += self.timestep
                return
            self.u_pred = self.u_old
            self.u = self.u_pred[:, 0]
            self.u_old = self.u_pred[:, 1:]
            self.num_horizon -= 1
            self.time += self.timestep
            return

        t0 = time.perf_counter()
        min_iter = max(0, self.iter - p.num_ss_iter)
        obstacle = self._obstacle()
        n = self.num_horizon
        through_k3 = n > 1 and not self.sequential_lambda
        for outer in range(3):
            cost_list, id_list, pred_list = [], [], []
            x_guess = self.x if outer == 0 else self.x_pred[:, -1]
            idxs = [self.safe_set.select_close(lap_id, x_guess,
                                               p.num_ss_points)
                    for lap_id in range(min_iter, self.iter)]
            if through_k3:
                x_terms = np.concatenate(
                    [self.safe_set.ss[lap_id][:, idx] for lap_id, idx in
                     zip(range(min_iter, self.iter), idxs)], axis=1)
                us_b, x_last_b, dist_b = self._sweep_k3(x_terms, obstacle, n)
                col = 0
            for lap_id, idx in zip(range(min_iter, self.iter), idxs):
                x_terms = self.safe_set.ss[lap_id][:, idx].T  # (k, 4)
                q_terms = self.safe_set.Qfun[lap_id][idx]
                if through_k3:
                    cols = range(col, col + len(idx))
                    col += len(idx)
                    cost_iter = [
                        relaxed_reach_cost(float(dist_b[c]), q_terms[j], n,
                                           outer, p.max_relax_iter)
                        for j, c in enumerate(cols)]
                    pred_iter = [
                        lambda c=c: self._winner_pred(us_b[..., c],
                                                      x_last_b[:, c])
                        for c in cols]
                elif n > 1:
                    sols = ilqr_ops.ilqr_solve_candidates_seq(
                        p, self.limits, obstacle,
                        self._tensor(self.x), self._tensor(x_terms),
                        torch.zeros((n, U_DIM), dtype=self.dtype,
                                    device=self.device),
                        p.lamb, self.timestep, num_horizon=n)
                    xs_b = sols.xs.to(torch.float64).cpu().numpy()
                    us_b_seq = sols.us.to(torch.float64).cpu().numpy()
                    dists = np.linalg.norm(xs_b[:, -1, :] - x_terms, axis=1)
                    cost_iter = [
                        relaxed_reach_cost(dists[j], q_terms[j], n, outer,
                                           p.max_relax_iter)
                        for j in range(len(idx))]
                    pred_iter = [lambda j=j: (xs_b[j].T, us_b_seq[j].T)
                                 for j in range(len(idx))]
                else:
                    # horizon 1: a reach check of the next stored input
                    x_next = true_step(self.x, self.u_old[:, 0],
                                       self.timestep)
                    reach_error = float(p.reach_error)
                    cost_iter = [
                        1.0 + float(q_terms[j])
                        if np.linalg.norm(x_next - x_terms[j]) <= reach_error
                        else float("inf") for j in range(len(idx))]
                    xv = np.zeros((X_DIM, 2))
                    xv[:, 0] = self.x
                    xv[:, -1] = x_next
                    uv = self.u_old[:, :1].copy()
                    pred_iter = [lambda: (xv, uv)] * len(idx)
                id_list.append(idx)
                cost_list.append(cost_iter)
                pred_list.append(pred_iter)

            # lexicographic list-min across laps, argmin within
            best_lap_loc = cost_list.index(min(cost_list))
            cost_vec = cost_list[best_lap_loc]
            best_time = cost_vec.index(min(cost_vec))
            best_lap = best_lap_loc + min_iter
            self.x_pred, self.u_pred = pred_list[best_lap_loc][best_time]()
            self.u = self.u_pred[:, 0]
            self.x_terminal_guess = self.x_pred[:, -1]
            if self.num_horizon > 1:
                self.u_old = self.u_pred[:, 1:]
            if outer == 2:
                chosen = int(id_list[best_lap_loc][best_time])
                if chosen + 1 > self.safe_set.ss[best_lap].shape[1] - 1:
                    self.num_horizon -= 1
        if n > 1:
            self.solve_seconds.append(time.perf_counter() - t0)
        self.time += self.timestep
