"""Closed-loop experiment runner of the host controllers.

Port of ilqr_iterative_tasks_tpu/experiments/runner.py: build the plant
and the simulator, seed the controller's safe set with the scripted lap
(or a recorded one), run ``lap_number`` closed-loop laps and report the lap
times. After each lap the demo CLI snaps the last recorded state to the
goal (``goal_fixup="snap"``) and the CI test appends it (``"append"``).
An ``obstacle_schedule`` injects or removes obstacles between laps (the
paper scenarios, experiments/scenarios.py), and ``seed_safe_set=False``
runs a controller resumed from a checkpoint (utils/checkpoint.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ilqr_iterative_tasks_torch.sim.plant import BicyclePlant, ObstacleSim
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.sim.simulator import Simulator


@dataclass
class RunResult:
    lap_times: List[float]  # seconds per closed-loop lap (excl. seed lap)
    seed_time: float
    lap_finished: List[bool]
    plant: BicyclePlant = field(repr=False)
    simulator: Simulator = field(repr=False)

    @property
    def all_lap_times(self):
        return [self.seed_time] + list(self.lap_times)


def run_closed_loop(controller, lap_number: int, dt: float = 1.0,
                    zero_noise: bool = True, goal_fixup: str = "snap",
                    obstacle_schedule=None,
                    rng: Optional[np.random.Generator] = None,
                    seed_safe_set: bool = True,
                    seed: Optional[tuple] = None,
                    verbose: bool = False) -> RunResult:
    """Seed lap + ``lap_number`` learning laps with any controller of the
    ControlBase API (set_timestep, set_state, calc_input, get_input) with
    ``add_trajectory``.

    ``obstacle_schedule``: optional callable (lap_index, controller) ->
    None, called before each lap, that may replace ``controller.obstacle``
    (the controllers read it at every step). ``seed_safe_set=False`` skips
    the seed lap's ``add_trajectory``, for a controller resumed from a
    checkpoint whose safe set is already filled. ``seed``: optional (xcl,
    ucl) replacing the scripted seed lap.
    """
    xcl, ucl = seed if seed is not None else seed_trajectory(dt)
    xcl = np.asarray(xcl, dtype=np.float64)
    ucl = np.asarray(ucl, dtype=np.float64)
    plant = BicyclePlant(rng=rng)
    plant.set_state(np.zeros(4))
    plant.set_timestep(dt)
    if zero_noise:
        plant.set_zero_noise()
    if seed_safe_set:
        controller.add_trajectory(xcl, ucl)
    controller.set_timestep(dt)
    plant.set_ctrl_policy(controller)

    simulator = Simulator()
    simulator.set_robotic(plant)
    simulator.set_timestep(dt)
    simulator.set_goal(xcl[-1, :])

    for lap in range(lap_number):
        if obstacle_schedule is not None:
            obstacle_schedule(lap, controller)
        if verbose:
            print(f"iteration {lap} begins")
        simulator.sim(lap)
        lap_states = plant.data["state"][-1]
        if goal_fixup == "snap":
            lap_states = lap_states.copy()
            lap_states[-1, :] = xcl[-1, :]
        elif goal_fixup == "append":
            lap_states = np.vstack((lap_states, xcl[-1, :]))
        plant.data["state"][-1] = lap_states
        controller.add_trajectory(lap_states, plant.data["input"][-1])
        if verbose:
            print(f"iteration {lap} done: "
                  f"{len(plant.data['timestamp'][-1]) * dt:.0f} s")

    lap_times = simulator.lap_times(dt)
    return RunResult(
        lap_times=lap_times,
        seed_time=len(ucl) * dt,
        lap_finished=list(simulator.lap_finished),
        plant=plant,
        simulator=simulator,
    )


def default_obstacle(dt: float = 1.0, for_nlmpc: bool = False) -> ObstacleSim:
    """The standard test obstacle: x = 31, y = -2, an 8 x 6 ellipse (the
    demo CLIs use y = -3 for i2LQR). ``for_nlmpc`` is accepted for the JAX
    signature; both controllers take the same obstacle."""
    return ObstacleSim(31.0, -2.0, 8.0, 6.0, spd=0, timestep=dt)
