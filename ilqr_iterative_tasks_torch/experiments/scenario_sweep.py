"""Randomized batched scenario sweep: BASELINE config 4.

Port of ilqr_iterative_tasks_tpu/experiments/scenario_sweep.py
(``run_sweep``, ``main``). Runs a batch of i2LQR learning simulations with
per-lane randomized initial states and obstacle positions / speeds (the
obstacle is per-lane data of the simulator and of K1) and reports robust
statistics: lap completion, lap-step percentiles, the final lap's mean
steps. On the card every step is one K1 launch, for every candidate set
(k, nsi) the kernel is instantiated for; on the CPU the plain step runs.

    python -m ilqr_iterative_tasks_torch.experiments.scenario_sweep \\
        --batch 4096 --laps 4 --moving \\
        [--num-ss-points 32 --num-ss-iters 4] [--stall-reseed 3] \\
        [--device cpu]

The jitter draws come from a ``torch.Generator`` seeded with ``seed`` and
the plant noise from one seeded with ``seed + 1`` (the JAX sweep's keys
are PRNGKey(seed) and PRNGKey(seed + 1)); a test injects both instead.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ilqr_iterative_tasks_torch.control.batched_soa import (
    SoaScenarios, simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.device import resolve
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits

MAX_STEPS, MAX_LAPS = 128, 8


def run_sweep(batch: int, num_laps: int, moving: bool = False,
              x0_jitter=(0.5, 0.5, 0.0, 0.0), obs_pos_jitter: float = 4.0,
              seed: int = 0, solver_max_iter: int = 16,
              num_ss_iter: int = 1, num_ss_points: int = 8,
              quiet: bool = False, stall_reseed: int | None = None, *,
              device=None, draws=None, noise=None, result: list | None = None,
              sim_step_budget: int = 121):
    """The sweep's report (the JAX sweep's keys; ``backend`` is the
    device's type). ``draws``: the scenarios' injected jitter draws
    (``SoaScenarios.randomized``), ``noise``: the injected plant-noise
    draws (steps, 2, B). If ``result`` is a list, the run's
    ``SoaRunResult`` is appended to it. ``sim_step_budget``: a lap's
    step budget (the simulator's; small runs cut it)."""
    dev = resolve(device)
    dtype = torch.float32
    params = IlqrParams.make(num_ss_iter=num_ss_iter,
                             num_ss_points=num_ss_points, dtype=dtype,
                             device=dev)
    limits = SystemLimits.make(dtype=dtype, device=dev)
    xcl, _ = seed_trajectory(1.0)
    seed_xs = np.zeros((MAX_STEPS, 4))
    seed_xs[:121] = xcl
    if moving:
        obstacle = Obstacle.make(35.0, -16.0, 20.0, 20.0, spd=1.0,
                                 moving_option=1, dtype=dtype, device=dev)
        spd_jitter = 0.3
    else:
        obstacle = Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=dtype,
                                 device=dev)
        spd_jitter = 0.0
    scenarios = SoaScenarios.randomized(
        np.zeros(4), xcl[-1], obstacle, batch,
        None if draws is not None else torch.Generator(dev).manual_seed(seed),
        x0_jitter=x0_jitter, obs_pos_jitter=obs_pos_jitter,
        obs_spd_jitter=spd_jitter, noise_on=True, dtype=dtype, device=dev,
        draws=draws)
    noise_gen = (None if noise is not None
                 else torch.Generator(dev).manual_seed(seed + 1))
    t0 = time.time()
    res = simulate_learning_runs_soa(
        params, limits, scenarios, seed_xs, None, 121, 1.0,
        num_laps=num_laps, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
        solver_max_iter=solver_max_iter, stall_reseed=stall_reseed,
        noise=noise, generator=noise_gen, sim_step_budget=sim_step_budget)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    if result is not None:
        result.append(res)
    steps = res.lap_steps.cpu().numpy().astype(np.float64)  # (L, B)
    done = res.lap_done.cpu().numpy()
    report = {
        "batch": batch, "num_laps": num_laps, "moving": moving,
        "num_ss_iter": num_ss_iter, "num_ss_points": num_ss_points,
        "x0_jitter": (list(x0_jitter) if hasattr(x0_jitter, "__len__")
                      else x0_jitter),
        "obs_pos_jitter": obs_pos_jitter,
        "stall_reseed": stall_reseed,
        "completion_rate": round(float(done.mean()), 4),
        "lap_steps_p50": [float(np.percentile(steps[i], 50))
                          for i in range(num_laps)],
        "lap_steps_p95": [float(np.percentile(steps[i], 95))
                          for i in range(num_laps)],
        "final_lap_mean": round(float(steps[-1].mean()), 2),
        "wall_s": round(wall, 2),
        "lap_sims_per_s": round(batch * num_laps / wall, 1),
        "backend": dev.type,
    }
    if not quiet:
        print(json.dumps(report), flush=True)
    return report


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--laps", type=int, default=3)
    parser.add_argument("--moving", action="store_true")
    parser.add_argument("--x0-jitter", type=str, default="0.5,0.5,0,0",
                        help="scalar or 4 comma-separated per-state sigmas")
    parser.add_argument("--obs-pos-jitter", type=float, default=4.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num-ss-iters", type=int, default=1)
    parser.add_argument("--num-ss-points", type=int, default=8)
    parser.add_argument("--stall-reseed", type=int, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="cpu or cuda[:i] (default: the current CUDA "
                             "device)")
    args = parser.parse_args(argv)
    xj = [float(v) for v in str(args.x0_jitter).split(",")]
    return run_sweep(args.batch, args.laps, moving=args.moving,
                     x0_jitter=xj[0] if len(xj) == 1 else tuple(xj),
                     obs_pos_jitter=args.obs_pos_jitter,
                     seed=args.seed, num_ss_iter=args.num_ss_iters,
                     num_ss_points=args.num_ss_points,
                     stall_reseed=args.stall_reseed, device=args.device)


if __name__ == "__main__":
    main()
