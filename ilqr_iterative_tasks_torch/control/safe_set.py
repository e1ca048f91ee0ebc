"""Host-side ragged safe set: sampled safe states and their time-to-go.

The port's own copy of ilqr_iterative_tasks_tpu/control/safe_set.py::SafeSet
(:28-78), numpy only. It serves the step-by-step host controllers
(control/i2lqr.py, control/nlmpc.py): one entry per completed lap, the
space-varying L1 kNN (``np.argsort``, whose tie order is part of the
result) and the time-varying windows. The JAX module's ``DeviceSafeSet``
is not ported: only its pod-scale batched simulators use it.
"""

from __future__ import annotations

from typing import List

import numpy as np


class SafeSet:
    """Host-side ragged safe set: one entry per completed lap ("iteration")."""

    def __init__(self):
        self.ss: List[np.ndarray] = []  # each (4, T+1) states, column-major
        self.u_ss: List[np.ndarray] = []  # each (2, T)
        self.Qfun: List[np.ndarray] = []  # each (T+1,) time-to-go in steps
        self.iter_cost: List[float] = []

    @property
    def num_laps(self) -> int:
        return len(self.ss)

    def add_trajectory(self, x: np.ndarray, u: np.ndarray):
        """x: (T+1, 4) row-major lap states; u: (T, 2). Qfun counts the
        steps to go, T down to 0."""
        x = np.asarray(x, dtype=np.float64)
        u = np.asarray(u, dtype=np.float64)
        self.ss.append(x.T.copy())
        self.u_ss.append(u.T.copy())
        self.Qfun.append(np.arange(x.shape[0] - 1, -1, -1))
        self.iter_cost.append(float(self.Qfun[-1][0]))

    def select_close(self, lap_id: int, x_guess: np.ndarray, k: int) -> np.ndarray:
        """Indices of the ``k`` states of lap ``lap_id`` nearest ``x_guess``
        in the L1 norm (fewer where the lap is shorter)."""
        x = self.ss[lap_id]
        diff = x - np.asarray(x_guess).reshape(-1, 1)
        norm = np.linalg.norm(diff, 1, axis=0)
        return np.argsort(norm)[:k]

    def select_points(self, lap_id: int, x0, k: int):
        """(points (4, k), Qfun values (k,), indices) of ``select_close``."""
        idx = self.select_close(lap_id, x0, k)
        return self.ss[lap_id][:, idx], self.Qfun[lap_id][idx], idx

    def time_varying_windows(self, num_horizon: int, k: int,
                             all_ss_point: bool) -> List[np.ndarray]:
        """Initial per-lap candidate index windows, recomputed after each
        lap: a window starts at (lap_cost - best_cost + horizon) into each
        stored lap; with ``all_ss_point`` it is the whole lap."""
        min_cost = int(np.min(self.iter_cost))
        windows = []
        for lap_id in range(self.num_laps):
            lap_cost = self.ss[lap_id].shape[1] - 1
            if all_ss_point:
                windows.append(np.arange(0, self.ss[lap_id].shape[1]))
            else:
                start = lap_cost - min_cost + num_horizon
                windows.append(np.arange(start, start + k))
        return windows
