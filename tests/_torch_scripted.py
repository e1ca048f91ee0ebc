"""A scripted controller for the host tier's tests: the ControlBase API
(set_timestep, set_state, calc_input, get_input, add_trajectory) with
inputs given in advance, so a run through either package's runner costs
no solve."""

import numpy as np


class Scripted:
    """Applies ``us`` in turn (the last one after they run out), keeps the
    obstacle it is given (a scenario's schedule may replace it), and
    stores every lap it is given in ``laps`` and, where it has one, in
    ``safe_set``."""

    def __init__(self, us, obstacle=None, safe_set=None):
        self.us, self.k, self.obstacle, self.safe_set = us, 0, obstacle, safe_set
        self.u, self.laps = None, []

    def set_timestep(self, dt):
        self.dt = dt

    def set_state(self, x):
        self.x = np.asarray(x)

    def calc_input(self):
        self.u = np.asarray(self.us[min(self.k, len(self.us) - 1)])
        self.k += 1

    def get_input(self):
        return self.u

    def add_trajectory(self, x, u):
        self.laps.append((np.asarray(x).copy(), np.asarray(u).copy()))
        if self.safe_set is not None:
            self.safe_set.add_trajectory(x, u)
