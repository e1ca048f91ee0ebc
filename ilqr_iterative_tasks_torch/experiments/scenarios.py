"""The 8 paper scenarios: {i2LQR, NLMPC} x {no_obstacle, static_obstacle,
add_static_obstacle, add_moving_obstacle}, the moving one in two
geometries.

Port of ilqr_iterative_tasks_tpu/experiments/scenarios.py:
- "static": the obstacle is present the whole run;
- "add_static" / "add_moving": the obstacle is injected before lap 5 and
  removed before lap 6 (``build_schedule``, through ``run_closed_loop``'s
  ``obstacle_schedule``);
- the moving geometries (``MOVING_GEOMETRY``): up, centre (35, -16),
  34 x 34, speed 1 along +y; left, centre (50, -1), 35 x 35, speed 0.2
  along -x.

The controllers' candidate solves run on the current CUDA device (K3 for
i2LQR, K4 for NLMPC) unless ``device`` names another. Each run is saved as
``ego_{controller}_ss_{k}_{scenario}[_{option}].npz`` (utils/checkpoint.py's
``save_run``), by default into ``data/torch/`` of the repository, apart
from the JAX package's files in ``data/``.

Run:  python -m ilqr_iterative_tasks_torch.experiments.scenarios \\
          --controller ilqr --scenario add_moving_obstacle --moving-option up \\
          --lap-number 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import os

from ilqr_iterative_tasks_torch.control.i2lqr import I2LqrController
from ilqr_iterative_tasks_torch.control.nlmpc import NlmpcController
from ilqr_iterative_tasks_torch.experiments.runner import run_closed_loop
from ilqr_iterative_tasks_torch.sim.plant import ObstacleSim
from ilqr_iterative_tasks_torch.utils.checkpoint import (
    load_run, restore_safe_set, save_run)
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, LmpcParams

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SAVE_DIR = os.path.join(REPO, "data", "torch")

MOVING_GEOMETRY = {
    # moving option "up" (1): +y
    "up": dict(x=35.0, y=-16.0, width=34.0, height=34.0, spd=1.0,
               moving_option=1),
    # moving option "left" (2): -x
    "left": dict(x=50.0, y=-1.0, width=35.0, height=35.0, spd=0.2,
                 moving_option=2),
}

SCENARIOS = ("no_obstacle", "static_obstacle", "add_static_obstacle",
             "add_moving_obstacle")

INJECT_LAP, REMOVE_LAP = 5, 6


def build_schedule(scenario: str, dt: float, moving_option: str = "up"):
    """(initial obstacle, obstacle_schedule or None) of a scenario."""
    if scenario == "no_obstacle":
        return None, None
    if scenario == "static_obstacle":
        return ObstacleSim(31.0, -2.0, 8.0, 6.0, spd=0, timestep=dt), None
    if scenario == "add_static_obstacle":
        make = lambda: ObstacleSim(31.0, -2.0, 8.0, 6.0, spd=0, timestep=dt)
    elif scenario == "add_moving_obstacle":
        geom = MOVING_GEOMETRY[moving_option]
        make = lambda: ObstacleSim(timestep=dt, **geom)
    else:
        raise ValueError(f"unknown scenario {scenario!r}")

    def schedule(lap, controller):
        if lap == INJECT_LAP:
            controller.obstacle = make()
        if lap == REMOVE_LAP:
            controller.obstacle = None
    return None, schedule


def scenario_tag(controller_kind: str, scenario: str, num_ss_points: int,
                 moving_option: str = "up") -> str:
    """The file tag of a run: ``ego_{tag}.npz``."""
    tag = f"{controller_kind}_ss_{num_ss_points}_{scenario}"
    if scenario == "add_moving_obstacle":
        tag += f"_{moving_option}"
    return tag


def run_scenario(controller_kind: str, scenario: str, lap_number: int = 8,
                 num_ss_points: int = 8, num_ss_iters: int = 1,
                 moving_option: str = "up", save_dir: str | None = SAVE_DIR,
                 verbose: bool = False, device=None):
    """One scenario run in the JAX package's configuration (f32, zero
    noise, dt = 1; i2LQR snaps the last state to the goal, NLMPC runs
    spaceVarying without a fix-up), saved into ``save_dir`` unless it is
    None."""
    dt = 1.0
    obstacle, schedule = build_schedule(scenario, dt, moving_option)
    if controller_kind == "ilqr":
        params = IlqrParams.make(num_ss_points=num_ss_points,
                                 num_ss_iter=num_ss_iters, device=device)
        controller = I2LqrController(params, obstacle=obstacle, device=device)
        goal_fixup = "snap"
    elif controller_kind == "nlmpc":
        params = LmpcParams.make(num_ss_points=num_ss_points,
                                 num_ss_iter=num_ss_iters,
                                 ss_option="spaceVarying", device=device)
        controller = NlmpcController(params, obstacle=obstacle, device=device)
        goal_fixup = None
    else:
        raise ValueError(f"unknown controller {controller_kind!r}")
    result = run_closed_loop(controller, lap_number=lap_number, dt=dt,
                             zero_noise=True, goal_fixup=goal_fixup,
                             obstacle_schedule=schedule, verbose=verbose)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        tag = scenario_tag(controller_kind, scenario, num_ss_points,
                           moving_option)
        save_run(os.path.join(save_dir, f"ego_{tag}.npz"), result, controller)
    return result


def replay_lockstep(controller, path: str, first_lap: int,
                    obstacle_schedule, steps: int | None = None):
    """Drive ``controller`` through the states of a recorded run (a file
    ``save_run`` wrote, by either package) in lockstep: it holds the
    recorded seed lap and learning laps before ``first_lap``, and at every
    step of the laps from ``first_lap`` on it is given the recorded state
    and makes its own decision, which is held against the recorded input.
    After each lap the recorded lap joins its safe set, as in
    ``run_closed_loop``; ``obstacle_schedule`` (or None) is called and the
    obstacle moved and reset as there; dt = 1, the scenarios'. ``steps``
    stops after that many steps in all. Returns, a lap, the largest
    |u - recorded u| over its steps."""
    data = load_run(path)
    safe_set = restore_safe_set(path)
    for x, u in safe_set[:first_lap + 1]:
        controller.add_trajectory(x, u)
    controller.set_timestep(1.0)
    worst, done = [], 0
    for lap in range(first_lap, int(data["num_laps"]) - 1):
        if obstacle_schedule is not None:
            obstacle_schedule(lap, controller)
        gaps = []
        for x, u in zip(data[f"lap_state_{lap}"], data[f"lap_input_{lap}"]):
            if done == steps:
                break
            controller.set_state(x)
            controller.calc_input()
            gaps.append(float(abs(controller.get_input() - u).max()))
            if controller.obstacle is not None:
                controller.obstacle.update()
            done += 1
        worst.append(max(gaps))
        if done == steps:
            break
        if controller.obstacle is not None:
            controller.obstacle.reset()
        controller.add_trajectory(*safe_set[lap + 1])
    return worst


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller", choices=["ilqr", "nlmpc"],
                        default="ilqr")
    parser.add_argument("--scenario", choices=SCENARIOS,
                        default="static_obstacle")
    parser.add_argument("--lap-number", type=int, default=8)
    parser.add_argument("--num-ss-points", type=int, default=8)
    parser.add_argument("--num-ss-iters", type=int, default=1)
    parser.add_argument("--moving-option", choices=["up", "left"],
                        default="up")
    parser.add_argument("--no-save", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="where the candidate solves run (default: the "
                             "current CUDA device)")
    args = parser.parse_args(argv)
    result = run_scenario(
        args.controller, args.scenario, lap_number=args.lap_number,
        num_ss_points=args.num_ss_points, num_ss_iters=args.num_ss_iters,
        moving_option=args.moving_option,
        save_dir=None if args.no_save else SAVE_DIR, verbose=True,
        device=args.device)
    print("lap times:", result.all_lap_times)
    return result


if __name__ == "__main__":
    main()
