"""NLMPC learning controller (the nonlinear learning-MPC baseline), step by
step on the host, with its candidate solves through the K4 kernel.

Port of ilqr_iterative_tasks_tpu/control/nlmpc.py. Per control step:

- candidate terminal states from the last ``num_ss_iter`` laps (every lap
  with ``all_ss_iter``) by one of three safe-set options: advancing
  time-varying windows, L1 kNN around the terminal guess (spaceVarying),
  or every stored point (``all_ss_point``);
- one constrained min-time feasibility solve per candidate, cost
  N + Qfun(x_term) where feasible, else Inf; the lexicographic list-min
  across laps and the argmin within;
- the warm start shifted one step, with the successor safe-set point and
  its stored input appended; the horizon shrunk when the winner is its
  lap's last point (floored at 1);
- at horizon 1, a reach check of the warm start's first input on the host.

The host logic is numpy, as in the JAX controller. The solves of a step
are ONE launch of K4 (ops/fused_lm_shooting.py::build_fused_lm_shooting,
built once at the params' horizon N with the host's LM cap of 80
iterations), whose lanes are every candidate of every lap in the window,
each with the warm start's inputs (zero past the current horizon n), skip
0 and hzn = n: a lane's solve at horizon n, as the batched simulators
shrink it. (K4 built at num_horizon = n gives the same decisions on the
CPU, but the kernel is instantiated at N = 6 only.) K4 runs its plain
version (ops/lm_shooting_soa.py) for CPU tensors and the kernel for CUDA
ones. The winner's predicted states are the rollout of its first n inputs
with K4's own x_n as the last column.

With ``mesh=`` (a parallel/mesh.py mesh; its first axis is used) every
rank of the mesh runs the controller alike, step by step: the
spaceVarying kNN goes through parallel/sharded_safe_set.py::sharded_knn
(each lap's rows padded so that every rank holds at least k and the mesh
divides them, a local top-k a rank, the tuples gathered, the global top-k
ordered by distance and row), and the step's one K4 launch becomes one
launch a rank over its share of the candidates (padded to a multiple of
the mesh by repeating the last one), whose outputs are gathered and the
padding dropped. K4 is lane-local, so the solves are those of the
unmeshed launch; the kNN orders ties by row where ``np.argsort`` keeps its
own order.

A step whose candidates are all infeasible raises ``InfeasibleStep``
(sim/plant.py), the one exception the plant records as an infeasible step
(holding the previous input); the reference pauses there instead. Every
other exception, a kernel's or CUDA's own among them, is an error.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ilqr_iterative_tasks_torch.constants import U_DIM, X_DIM
from ilqr_iterative_tasks_torch.control.safe_set import SafeSet
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    FusedLmShooting, build_fused_lm_shooting, obstacle_to_lanes_nlmpc)
from ilqr_iterative_tasks_torch.ops.ilqr import rollout
from ilqr_iterative_tasks_torch.parallel.distributed import build_kernels
from ilqr_iterative_tasks_torch.sim.plant import InfeasibleStep, true_step
from ilqr_iterative_tasks_torch.utils.device import resolve
from ilqr_iterative_tasks_torch.utils.params import LmpcParams, SystemLimits

HOST_LM_ITERS = 80  # the host solve's LM cap (ops/lm_shooting.py)


class NlmpcController:
    """Host-driven NLMPC controller whose candidate solves run through K4.

    ``device``: where the candidate lanes live (the current CUDA device
    unless the caller names one). ``solve_seconds`` holds the wall seconds
    of every step that solved (n > 1; host clock, after K4's outputs
    reached the host) and ``launch_lanes`` the lanes of every K4 call.
    ``calc_input`` raises ``InfeasibleStep`` when no candidate is feasible.
    ``mesh``: run meshed over its ranks (module docstring); every rank of
    the mesh drives its own copy of the controller on the same states.
    """

    def __init__(self, params: LmpcParams, obstacle: Optional[object] = None,
                 limits: Optional[SystemLimits] = None, dtype=torch.float32,
                 device=None, mesh=None):
        self.device = resolve(device)
        self.mesh = mesh
        self.mesh_axis = mesh.axis_names[0] if mesh is not None else None
        if mesh is not None and self.device.type == "cuda":
            build_kernels(mesh)  # nvcc on one rank of the mesh
        self.params = params
        self.limits = (limits if limits is not None
                       else SystemLimits.make(dtype=dtype, device=self.device))
        self.obstacle = obstacle
        self.safe_set = SafeSet()
        self.dtype = dtype
        self.timestep: Optional[float] = None
        self.time = 0.0
        self.x: Optional[np.ndarray] = None
        self.u: Optional[np.ndarray] = None
        self.num_horizon = params.num_horizon
        self.x_terminal_guess = None
        self.x_guess = None  # flat warm start: (N+1)*X states then N*U inputs
        self.x_sol = None
        self.u_sol = None
        self.x_pred = None
        self.u_pred = None
        self.cost = None
        self.old_cost = None
        self.cost_improve = None
        self.ss_windows = []  # advancing time-varying windows, one per lap
        self._k4 = {}  # (dtype, dt) -> FusedLmShooting
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
        """Store a lap and reset the warm starts and windows."""
        p = self.params
        self.safe_set.add_trajectory(x, u)
        self.num_horizon = p.num_horizon
        n = self.num_horizon
        x = np.asarray(x, dtype=np.float64)
        u = np.asarray(u, dtype=np.float64)
        self.x_terminal_guess = x.T[:, n].copy()
        self.x_guess = np.concatenate(
            [x[: n + 1, :].flatten(), u[:n, :].flatten()])
        self.cost = float(self.safe_set.Qfun[-1][0])
        self.old_cost = self.cost + 1
        self.x_sol = x.T[:, : n + 1].copy()
        self.u_sol = u.T[:, :n].copy()
        self.cost_improve = -1
        self.ss_windows = self.safe_set.time_varying_windows(
            n, p.num_ss_points, p.all_ss_point)

    def _select_time_varying(self, lap_id: int) -> np.ndarray:
        """Advancing window selection; moves the window one step on."""
        sel = self.ss_windows[lap_id]
        lap_len = self.safe_set.ss[lap_id].shape[1]
        valid = sel[(sel > 0) & (sel < lap_len)]
        self.ss_windows[lap_id] = sel + 1
        if valid.shape[0] < 1:
            valid = np.array([lap_len - 1])
        return valid

    def k4(self) -> FusedLmShooting:
        """The K4 at the params' horizon (built once per dtype and dt)."""
        key = (self.dtype, float(self.timestep))
        if key not in self._k4:
            self._k4[key] = build_fused_lm_shooting(
                self.limits, self.timestep,
                num_horizon=self.params.num_horizon, max_iters=HOST_LM_ITERS)
        return self._k4[key]

    def _obstacle(self) -> Obstacle:
        if self.obstacle is None:
            return Obstacle.absent(dtype=self.dtype, device=self.device)
        return self.obstacle.as_pytree(dtype=self.dtype, device=self.device)

    def _warm_u_init(self, n: int) -> np.ndarray:
        """Input section of the flat warm-start vector -> (n, 2)."""
        flat = self.x_guess[X_DIM * (n + 1): X_DIM * (n + 1) + U_DIM * n]
        return flat.reshape(n, U_DIM)

    def _select_close_sharded(self, lap_id: int, k: int) -> np.ndarray:
        """``select_close`` through the mesh's global top-k: the lap's rows
        padded so that every rank holds at least k and the mesh divides
        them; fewer than k where the lap is shorter."""
        from ilqr_iterative_tasks_torch.parallel.sharded_safe_set import (
            sharded_knn)

        x, q = self.safe_set.ss[lap_id], self.safe_set.Qfun[lap_id]
        t, ndev = x.shape[1], self.mesh.axis_size(self.mesh_axis)
        tp = max(-(-t // ndev), k) * ndev
        states = np.zeros((tp, X_DIM))
        states[:t] = x.T
        qfun = np.zeros(tp)
        qfun[:t] = q
        f = lambda a: torch.tensor(a, dtype=torch.float64, device=self.device)
        idx, _, _, _ = sharded_knn(
            f(states), torch.arange(tp, device=self.device) < t, f(qfun),
            f(self.x_terminal_guess), k, self.mesh, self.mesh_axis)
        return idx.cpu().numpy()

    def _solve_k4(self, x_terms: np.ndarray, n: int):
        """K4 over candidates x_terms (4, B) at horizon n -> host (us (n,
        2, B), x_last (4, B), feasible (B,) bool) in the solve's dtype: one
        launch, or under a mesh one a rank over its share of the lanes."""
        b = x_terms.shape[1]
        if self.mesh is None:
            out = self._launch_k4(x_terms, n).cpu()
        else:
            size = self.mesh.axis_size(self.mesh_axis)
            # repeat the last candidate; the padded lanes are dropped
            xt = np.concatenate([x_terms, np.repeat(
                x_terms[:, -1:], (-b) % size, axis=1)], axis=1)
            per = xt.shape[1] // size
            i = self.mesh.axis_index(self.mesh_axis)
            out = self._launch_k4(xt[:, i * per:(i + 1) * per], n)
            out = torch.cat(self.mesh.all_gather(out, self.mesh_axis),
                            dim=1)[:, :b].cpu()
        return (out[:n * U_DIM].reshape(n, U_DIM, b),
                out[n * U_DIM:n * U_DIM + X_DIM], out[-1] > 0.5)

    def _launch_k4(self, x_terms: np.ndarray, n: int) -> torch.Tensor:
        """One K4 launch over candidates x_terms (4, B) at horizon n -> its
        outputs on the device, stacked: us rows (n * 2), x_last (4) and
        feasible (1), each (B,)."""
        b, big_n = x_terms.shape[1], self.params.num_horizon
        f = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=self.dtype,
                                   device=self.device)
        x0 = f(self.x)[:, None].expand(X_DIM, b).contiguous()
        warm = np.zeros((big_n, U_DIM))
        warm[:n] = self._warm_u_init(n)
        u_warm = f(warm)[:, :, None].expand(big_n, U_DIM, b).contiguous()
        lanes = obstacle_to_lanes_nlmpc(self._obstacle(), b).contiguous()
        skip = torch.zeros((b,), dtype=torch.float32, device=self.device)
        hzn = torch.full((b,), n, dtype=torch.int32, device=self.device)
        us, x_last, _, feasible = self.k4()(x0, f(x_terms), u_warm, lanes,
                                            skip, hzn)
        self.launch_lanes.append(b)
        return torch.cat([us[:n].reshape(n * U_DIM, b), x_last,
                          feasible[None]])

    def _winner_pred(self, us: torch.Tensor, x_last: torch.Tensor):
        """(x_pred (4, n+1), u_pred (2, n)) float64 of one K4 lane."""
        xs = rollout(torch.tensor(self.x, dtype=self.dtype), us,
                     self.timestep)
        xs[-1] = x_last
        return (xs.T.to(torch.float64).numpy(),
                us.T.to(torch.float64).numpy())

    def calc_input(self):
        """One control step; raises ``InfeasibleStep`` when every
        candidate is infeasible."""
        t0 = time.perf_counter()
        p = self.params
        n = self.num_horizon
        min_iter = 0 if p.all_ss_iter else max(0, self.iter - p.num_ss_iter)
        laps = range(min_iter, self.iter)
        idxs = []
        for lap_id in laps:
            if p.all_ss_point:
                idxs.append(np.arange(0, self.safe_set.ss[lap_id].shape[1]))
            elif p.ss_option == "timeVarying":
                idxs.append(self._select_time_varying(lap_id))
            elif self.mesh is not None:  # kNN through the mesh's top-k
                idxs.append(self._select_close_sharded(lap_id,
                                                       p.num_ss_points))
            else:  # spaceVarying: kNN around the terminal guess
                idxs.append(self.safe_set.select_close(
                    lap_id, self.x_terminal_guess, p.num_ss_points))
        if n > 1:
            us_b, x_last_b, feas_b = self._solve_k4(np.concatenate(
                [self.safe_set.ss[lap_id][:, idx]
                 for lap_id, idx in zip(laps, idxs)], axis=1), n)
            col = 0
        else:
            # horizon 1: a reach check of the warm start's first input
            u0 = self.x_guess[X_DIM * (n + 1): X_DIM * (n + 1) + U_DIM]
            x_next = true_step(self.x, u0, self.timestep)
        cost_list, pred_list = [], []
        for lap_id, idx in zip(laps, idxs):
            x_terms = self.safe_set.ss[lap_id][:, idx].T  # (k, 4)
            q_terms = self.safe_set.Qfun[lap_id][idx]
            if n > 1:
                cols = range(col, col + len(idx))
                col += len(idx)
                cost_list.append([n + float(q_terms[j]) if feas_b[c]
                                  else float("inf")
                                  for j, c in enumerate(cols)])
                pred_list.append([
                    lambda c=c: self._winner_pred(us_b[..., c], x_last_b[:, c])
                    for c in cols])
            else:
                reach = [np.linalg.norm(x_next - x_terms[j]) <= 1e-3
                         for j in range(len(idx))]
                cost_list.append([1.0 + float(q_terms[j]) if reach[j]
                                  else float("inf")
                                  for j in range(len(idx))])
                pred_list.append([
                    lambda j=j: (np.vstack([self.x, x_terms[j]]).T,
                                 np.array(u0, np.float64).reshape(U_DIM, 1))
                    for j in range(len(idx))])

        best_lap_loc = cost_list.index(min(cost_list))
        cost_vec = cost_list[best_lap_loc]
        if min(cost_vec) == float("inf"):
            raise InfeasibleStep("NLMPC: all safe-set candidates infeasible")
        best_time = cost_vec.index(min(cost_vec))
        best_lap = best_lap_loc + min_iter
        self.x_pred, self.u_pred = pred_list[best_lap_loc][best_time]()
        # at horizon 1 the input is a view of the warm start, which the
        # shift below overwrites with the chosen point's stored input, as
        # in the JAX controller
        self.u = self.u_pred[:, 0].copy() if n > 1 else u0
        self.cost = cost_list[best_lap_loc][best_time]
        self.cost_improve = self.cost_improve + self.old_cost - self.cost - 1
        self.old_cost = self.cost

        # warm-start shift and horizon bookkeeping
        x_pred_flat = self.x_pred[:, : n + 1].T.flatten()
        u_pred_flat = self.u_pred[:, :n].T.flatten()
        chosen = int(idxs[best_lap_loc][best_time])
        if chosen + 1 <= self.safe_set.ss[best_lap].shape[1] - 1:
            self.x_terminal_guess = self.safe_set.ss[best_lap][:, chosen + 1].copy()
            self.x_guess[0: X_DIM * n] = x_pred_flat[X_DIM: X_DIM * (n + 1)]
            self.x_guess[X_DIM * n: X_DIM * (n + 1)] = self.x_terminal_guess
            self.x_guess[X_DIM * (n + 1): X_DIM * (n + 1) + U_DIM * (n - 1)] = (
                u_pred_flat[U_DIM: U_DIM * n])
            self.x_guess[X_DIM * (n + 1) + U_DIM * (n - 1):
                         X_DIM * (n + 1) + U_DIM * n] = (
                self.safe_set.u_ss[best_lap][:, chosen])
        elif n > 1:
            self.x_terminal_guess = x_pred_flat[
                X_DIM * n: X_DIM * (n + 1)].copy()
            new_guess = np.zeros(n * X_DIM + (n - 1) * U_DIM)
            new_guess[0: X_DIM * n] = x_pred_flat[X_DIM: X_DIM * (n + 1)]
            new_guess[X_DIM * n: X_DIM * n + U_DIM * (n - 1)] = (
                u_pred_flat[U_DIM: U_DIM * n])
            self.x_guess = new_guess
            self.num_horizon = n - 1
        else:
            # horizon floor: the reference decrements unguarded into a
            # horizon 0 its solve cannot represent; keep n = 1 and re-centre
            # the guess on the predicted terminal state
            self.x_terminal_guess = x_pred_flat[
                X_DIM * n: X_DIM * (n + 1)].copy()
        if n > 1:
            self.solve_seconds.append(time.perf_counter() - t0)
        self.time += self.timestep
