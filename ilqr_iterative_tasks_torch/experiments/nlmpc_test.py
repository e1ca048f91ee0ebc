"""NLMPC closed-loop demo CLI of the host controller.

Port of ilqr_iterative_tasks_tpu/experiments/nlmpc_test.py (the
reference's entry point): flags --lap-number --num-ss-points
--num-ss-iters --ss-option {space,time,all} --save-trajectory; N = 6,
dt = 1, obstacle (31, -2) 8 x 6, zero noise. ``--device`` names where the
candidate solves run (the current CUDA device by default, through the K4
kernel; ``cpu`` for its plain version). ``--plotting`` shows the inputs
and the last lap's trajectory (utils/viz.py).

Run:  python -m ilqr_iterative_tasks_torch.experiments.nlmpc_test \\
          --lap-number 5 --num-ss-iters 2 --num-ss-points 8 --ss-option space
"""

from __future__ import annotations

import argparse

from ilqr_iterative_tasks_torch.control.nlmpc import NlmpcController
from ilqr_iterative_tasks_torch.experiments.ilqr_test import (
    add_common_flags, report)
from ilqr_iterative_tasks_torch.experiments.runner import run_closed_loop
from ilqr_iterative_tasks_torch.sim.plant import ObstacleSim
from ilqr_iterative_tasks_torch.utils.params import LmpcParams


def nlmpc_test(args):
    dt = 1.0
    device = args.get("device")
    if args["ss_option"] == "all":
        mode = dict(all_ss_point=True, all_ss_iter=True)
    else:
        mode = dict(ss_option="spaceVarying" if args["ss_option"] == "space"
                    else "timeVarying")
    params = LmpcParams.make(num_ss_points=args["num_ss_points"],
                             num_ss_iter=args["num_ss_iters"], num_horizon=6,
                             device=device, **mode)
    obstacle = ObstacleSim(31.0, -2.0, 8.0, 6.0, spd=0, timestep=dt)
    controller = NlmpcController(params, obstacle=obstacle, device=device)
    result = run_closed_loop(
        controller, lap_number=args["lap_number"], dt=dt, zero_noise=True,
        goal_fixup=None, verbose=True)
    report(result, args, "lmpc")
    return result


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--lap-number", type=int, default=5)
    parser.add_argument("--ss-option", type=str, default="space",
                        choices=["space", "time", "all"])
    add_common_flags(parser)
    return nlmpc_test(vars(parser.parse_args(argv)))


if __name__ == "__main__":
    main()
