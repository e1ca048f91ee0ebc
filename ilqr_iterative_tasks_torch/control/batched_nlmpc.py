"""The vmap NLMPC tier: whole NLMPC learning runs of B scenarios in
lockstep, batch leading.

Port of ilqr_iterative_tasks_tpu/control/batched_nlmpc.py
(``simulate_nlmpc_run`` :52, ``simulate_nlmpc_batch`` :181), the NLMPC
counterpart of control/batched.py, run as that module runs the vmapped
loop. A control step of each scenario, spaceVarying (JAX ``solve_step``
:67-117):

- the L1-kNN of its terminal guess in each of its last nsi stored laps;
- ONE launch of the K4 kernel (ops/fused_lm_shooting.py) over B * nsi * k
  lanes at ``max_lm_iters`` and horizon N, two starts (the warm start, its
  previous solution shifted, and zeros), scenarios that are done entering
  with ``skip`` set;
- candidate cost N + Qfun where feasible, else +inf, and the lexicographic
  selection across laps with ragged-list semantics;
- the terminal guess advanced to the chosen point's successor, the warm
  start shifted with the chosen point's STORED input appended (:102-113);
  a step with no feasible candidate freezes both and holds the previous
  input (:114-116, :129).

Each lap warm-starts from the newest stored lap (:157-161), and a lap's
records take the goal on their last row, or one past it with
``goal_append`` (:162-170). The horizon never shrinks (JAX's documented
deviation from the host path, :20-24): laps end by goal proximity.

JAX's tier solves with the AoS ``ops/lm_shooting.py``; K4 (and its plain
version on CPU tensors, ops/lm_shooting_soa.py) is the SoA solve, which
agrees with it in every decision in f64 but not bit for bit. K4's wrapper
runs on both devices: its plain version for CPU tensors, the kernel for
CUDA ones. Noise and scenarios are control/batched.py's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ilqr_iterative_tasks_torch.control.batched import (
    ScenarioSpec, draw_lane_noise, knn_candidates, lanes_of, lap_rows, plant,
    seed_safe_set, select_candidate)
from ilqr_iterative_tasks_torch.control.batched_soa import check_budget
from ilqr_iterative_tasks_torch.control.safe_set import DeviceSafeSet
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    build_fused_lm_shooting, obstacle_to_lanes_nlmpc)
from ilqr_iterative_tasks_torch.utils.params import LmpcParams, SystemLimits


class NlmpcRunResult(NamedTuple):
    lap_steps: torch.Tensor  # (B, num_laps) i32
    lap_done: torch.Tensor  # (B, num_laps) bool
    safe_set: DeviceSafeSet


def _solve_step(params: LmpcParams, k4, ss: DeviceSafeSet, lap_count: int,
                x, guess, u_warm, obs_l, skip_l, max_laps: int):
    """(u (B, 2), feasible_any (B,), new guess (B, 4), new warm start
    (B, n, 2)) of every scenario; one K4 launch."""
    n, k, nsi = params.num_horizon, params.num_ss_points, params.num_ss_iter
    b, dev = x.shape[0], x.device
    lanes = torch.arange(b, device=dev)
    rows = lap_rows(lap_count, nsi, max_laps, dev)
    idx, xt, q = knn_candidates(ss, rows, guess, k)
    c = nsi * k
    uw_l = u_warm.reshape(b, 2 * n).T[:, :, None].expand(2 * n, b, c)
    us, _, _, feasible = k4(
        lanes_of(x, c), xt.reshape(-1, 4).T.contiguous(),
        uw_l.reshape(n, 2, b * c).contiguous(), obs_l, skip_l,
        torch.full((b * c,), n, dtype=torch.int32, device=dev))
    feas = feasible.reshape(b, nsi, k) > 0.5
    cost = torch.where(feas & rows.valid[:, None], float(n) + q,
                       float("inf"))
    win, cost_sel, idx_sel, lap_sel = select_candidate(cost, q, idx, rows)
    us_sel = us[:, :, win].permute(2, 0, 1)  # (B, n, 2)
    feasible_any = torch.isfinite(cost_sel)
    last = ss.lap_len[lanes, lap_sel].long() - 1
    # the guess to the successor safe-set point, the chosen point where it
    # is its lap's last (JAX :100-104)
    new_guess = ss.states[lanes, lap_sel, torch.minimum(
        torch.clamp_min(idx_sel + 1, 0), last)]
    # the warm start shifted, the chosen point's stored input appended where
    # a successor exists, else the last predicted input repeated (:105-113)
    succ = (idx_sel + 1) <= last
    u_last = torch.where(succ[:, None], ss.inputs[lanes, lap_sel, idx_sel],
                         us_sel[:, -1])
    u_warm_new = torch.cat([us_sel[:, 1:], u_last[:, None]], dim=1)
    new_guess = torch.where(feasible_any[:, None], new_guess, guess)
    u_warm_new = torch.where(feasible_any[:, None, None], u_warm_new, u_warm)
    return us_sel[:, 0], feasible_any, new_guess, u_warm_new


def simulate_nlmpc_batch(params: LmpcParams, limits: SystemLimits,
                         scenarios: ScenarioSpec, seed_xs, seed_us, seed_len,
                         dt, *, num_laps: int, max_steps: int = 128,
                         max_laps: int = 16, goal_append: bool = False,
                         sim_step_budget: int = 121, max_lm_iters: int = 60,
                         candidate_solver=None,
                         noise: torch.Tensor | None = None) -> NlmpcRunResult:
    """Seed the safe set, then run ``num_laps`` closed-loop NLMPC learning
    laps of every scenario (JAX ``vmap(simulate_nlmpc_run)``).

    ``candidate_solver``: the K4 to launch (``build_fused_lm_shooting`` at
    ``max_iters=max_lm_iters``), else one is built. Build ``limits`` in
    f64 for an f64 run (the solve clips at the raw ``delta_max``).
    ``noise`` as control/batched.py's ``simulate_learning_batch``."""
    n = params.num_horizon
    check_budget(max_steps, sim_step_budget, goal_append)
    if 1 + num_laps > max_laps:
        raise ValueError(f"max_laps={max_laps} cannot hold the seed and "
                         f"{num_laps} laps")
    k4 = candidate_solver
    if k4 is None:
        k4 = build_fused_lm_shooting(limits, dt, num_horizon=n,
                                     max_iters=max_lm_iters)
    elif (k4.max_iters, k4.num_horizon) != (max_lm_iters, n):
        raise ValueError(
            f"candidate_solver was built for (max_iters, num_horizon)="
            f"({k4.max_iters}, {k4.num_horizon}); the tier solves at "
            f"({max_lm_iters}, {n})")
    x0, goal = scenarios.x0, scenarios.goal
    b, dtype, dev = x0.shape[0], x0.dtype, x0.device
    c = params.num_ss_iter * params.num_ss_points
    lanes = torch.arange(b, device=dev)
    ss = seed_safe_set(b, seed_xs, seed_us, seed_len, max_laps, max_steps,
                       dtype, dev)
    count = torch.zeros(b, dtype=torch.int64, device=dev)
    lap_steps = torch.zeros((b, num_laps), dtype=torch.int32, device=dev)
    lap_done = torch.zeros((b, num_laps), dtype=torch.bool, device=dev)
    for lap_i in range(num_laps):
        newest = lap_i  # the newest stored lap's slot
        guess = ss.states[:, newest, n].clone()
        u_warm = ss.inputs[:, newest, :n].clone()
        x, obstacle = x0, scenarios.obstacle
        t = torch.zeros(b, dtype=torch.int64, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        u_prev = torch.zeros((b, 2), dtype=dtype, device=dev)
        xs_rec = torch.zeros((b, max_steps, 4), dtype=dtype, device=dev)
        xs_rec[:, 0] = x0
        us_rec = torch.zeros((b, max_steps, 2), dtype=dtype, device=dev)
        while True:
            running = (t < sim_step_budget) & ~done
            if not bool(running.any()):
                break
            u_s, feas, guess_n, u_warm_n = _solve_step(
                params, k4, ss, 1 + lap_i, x, guess, u_warm,
                lanes_of(obstacle_to_lanes_nlmpc(obstacle, b).T, c),
                lanes_of((~running).to(torch.float32)[:, None], c)[0],
                max_laps)
            u = torch.where(feas[:, None], u_s, u_prev)  # held input
            z = draw_lane_noise(noise, scenarios.noise_key, count, dtype)
            run2 = running[:, None]
            us_rec[lanes, t] = torch.where(run2, u, us_rec[lanes, t])
            x, obstacle, reach = plant(x, u, dt, z, scenarios, running,
                                       obstacle)
            t = torch.where(running, t + 1, t)
            xs_rec[lanes, t] = x  # a frozen scenario rewrites its row t
            guess = torch.where(run2, guess_n, guess)
            u_warm = torch.where(run2[..., None], u_warm_n, u_warm)
            u_prev = torch.where(run2, u, u_prev)
            done = torch.where(running, reach, done)
            count = count + running
        row = t + 1 if goal_append else t
        xs_rec[lanes, row] = goal
        ss.add_lap(xs_rec, us_rec, row + 1)
        lap_steps[:, lap_i] = t.to(torch.int32)
        lap_done[:, lap_i] = done
    return NlmpcRunResult(lap_steps=lap_steps, lap_done=lap_done,
                          safe_set=ss)


def simulate_nlmpc_run(params: LmpcParams, limits: SystemLimits,
                       scenario: ScenarioSpec, seed_xs, seed_us, seed_len,
                       dt, **kw) -> NlmpcRunResult:
    """One scenario's run (its leaves without the batch axis): the batch
    of one, with the batch axis taken off every output."""
    res = simulate_nlmpc_batch(
        params, limits, scenario.map(lambda t: t[None]), seed_xs, seed_us,
        seed_len, dt, **{key: (v[None] if key == "noise" and v is not None
                               else v) for key, v in kw.items()})
    return NlmpcRunResult(res.lap_steps[0], res.lap_done[0],
                          res.safe_set.map(lambda t: t[0]))
