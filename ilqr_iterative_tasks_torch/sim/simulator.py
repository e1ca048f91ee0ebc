"""Closed-loop lap simulator of the host controllers.

The port's own copy of ilqr_iterative_tasks_tpu/sim/simulator.py (numpy
only): step the plant and the obstacle until |x - x_goal| <= 0.8 or the
step budget runs out. The budget is ``max_sim_time`` (121 s) whatever
``sim`` is passed, as in the reference, which hard-codes it.
"""

from __future__ import annotations

import numpy as np


class Simulator:
    def __init__(self, goal_tol: float = 0.8, max_sim_time: float = 121.0):
        self.plant = None
        self.timestep = None
        self.goal = None
        self.goal_tol = goal_tol
        self.max_sim_time = max_sim_time
        self.lap_finished = []

    def set_robotic(self, plant):
        self.plant = plant

    def set_timestep(self, dt):
        self.timestep = dt

    def set_goal(self, goal):
        self.goal = np.asarray(goal, dtype=np.float64)

    def sim(self, lap_index: int, sim_time: float = 121.0):
        """Run one closed-loop lap; ``sim_time`` is accepted for the
        reference's signature, the budget is ``max_sim_time``."""
        del sim_time
        steps = int(self.max_sim_time / self.timestep)
        finished = False
        for i in range(steps):
            self.plant.forward_one_step()
            obstacle = getattr(self.plant.ctrl_policy, "obstacle", None)
            if obstacle is not None:
                obstacle.update()
            if np.linalg.norm(self.plant.x - self.goal) <= self.goal_tol:
                finished = True
                self.plant.update_memory_post_iter()
                if obstacle is not None:
                    obstacle.reset()
                break
            if i == steps - 1:
                self.plant.update_memory_post_iter()
                if obstacle is not None:
                    obstacle.reset()
        self.lap_finished.append(finished)
        return finished

    def lap_times(self, dt: float):
        """Per-lap closed-loop times in seconds (len(timestamps) * dt)."""
        return [len(t) * dt for t in self.plant.data["timestamp"]]
