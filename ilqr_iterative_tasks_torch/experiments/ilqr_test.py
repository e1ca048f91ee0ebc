"""i2LQR closed-loop demo CLI of the host controller.

Port of ilqr_iterative_tasks_tpu/experiments/ilqr_test.py (the reference's
entry point): flags --lap-number --num-ss-points --num-ss-iters
--direct-ilqr --save-trajectory --plotting; N = 6, dt = 1, obstacle
ellipse (31, -3) 8 x 6, zero noise, the last recorded state snapped to the
goal after each lap. ``--device`` names where the candidate solves run
(the current CUDA device by default, through the K3 kernel; ``cpu`` for
its plain version). ``--plotting`` shows the inputs and the last lap's
trajectory (utils/viz.py).

Run:  python -m ilqr_iterative_tasks_torch.experiments.ilqr_test \\
          --lap-number 3 --num-ss-iters 2 --num-ss-points 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ilqr_iterative_tasks_torch.control.i2lqr import I2LqrController
from ilqr_iterative_tasks_torch.experiments.runner import run_closed_loop
from ilqr_iterative_tasks_torch.sim.plant import ObstacleSim
from ilqr_iterative_tasks_torch.sim.seed import load_recorded_trajectory
from ilqr_iterative_tasks_torch.utils.params import IlqrParams

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def add_common_flags(parser: argparse.ArgumentParser):
    """The flags both demo CLIs share."""
    parser.add_argument("--num-ss-points", type=int, default=8)
    parser.add_argument("--num-ss-iters", type=int, default=1)
    parser.add_argument("--plotting", action="store_true")
    parser.add_argument("--save-trajectory", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="where the candidate solves run (default: the "
                             "current CUDA device)")


def report(result, args, prefix: str):
    """Print the lap times; write the last lap's states and inputs into
    data/ under ``--save-trajectory``; plot the run under ``--plotting``."""
    print(f"time at iteration 0 is {result.seed_time:.0f} s")
    for lap, t in enumerate(result.lap_times, start=1):
        print(f"time at iteration {lap} is {t:.0f} s")
    if args.get("save_trajectory"):
        data = os.path.join(REPO, "data")
        np.savetxt(os.path.join(data, f"{prefix}_closed_loop_multi_laps.txt"),
                   np.round(result.plant.data["state"][-1], 5), fmt="%f")
        np.savetxt(os.path.join(data, f"{prefix}_input_multi_laps.txt"),
                   np.round(result.plant.data["input"][-1], 5), fmt="%f")
    if args.get("plotting"):
        from ilqr_iterative_tasks_torch.utils import viz
        viz.plot_inputs(result.plant)
        viz.plot_closed_loop(result.plant, result.plant.ctrl_policy)


def test_ilqr(args):
    dt = 1.0
    device = args.get("device")
    params = IlqrParams.make(
        num_ss_points=args["num_ss_points"],
        num_ss_iter=args["num_ss_iters"],
        num_horizon=6, device=device)
    # the demo CLI's obstacle: y = -3
    obstacle = ObstacleSim(31.0, -3.0, 8.0, 6.0, spd=0, timestep=dt)
    controller = I2LqrController(params, obstacle=obstacle, device=device)
    seed = None
    if args.get("direct_ilqr"):
        # seed from the recorded lap files
        seed = load_recorded_trajectory(
            os.path.join(REPO, "data", "closed_loop_multi_laps.txt"),
            os.path.join(REPO, "data", "input_multi_laps.txt"))
    result = run_closed_loop(
        controller, lap_number=args["lap_number"], dt=dt, zero_noise=True,
        goal_fixup="snap", seed=seed, verbose=True)
    report(result, args, "ilqr")
    return result


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--lap-number", type=int, default=3)
    parser.add_argument("--direct-ilqr", action="store_true")
    add_common_flags(parser)
    return test_ilqr(vars(parser.parse_args(argv)))


if __name__ == "__main__":
    main()
