"""Host-side ragged safe set: sampled safe states and their time-to-go.

The port's own copy of ilqr_iterative_tasks_tpu/control/safe_set.py, in
two representations:

1. ``SafeSet`` (:28-78), numpy only. It serves the step-by-step host
   controllers (control/i2lqr.py, control/nlmpc.py): one entry per
   completed lap, the space-varying L1 kNN (``np.argsort``, whose tie order
   is part of the result) and the time-varying windows.
2. ``DeviceSafeSet`` (:80-140): fixed-capacity padded tensors with validity
   masks for the vmap tiers (control/batched.py, control/batched_nlmpc.py),
   batch leading: the JAX pytree of one scenario with the vmapped batch
   axis in front.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ilqr_iterative_tasks_torch.utils.device import resolve


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


@dataclass
class DeviceSafeSet:
    """Fixed-capacity padded safe set of B scenarios, batch leading.

    states: (B, L, T, 4); inputs: (B, L, T, 2); qfun: (B, L, T); valid:
    (B, L, T) bool; lap_len: (B, L) i32, the valid rows of each lap;
    num_laps: (B,) i32. ``add_lap`` writes in place (the JAX pytree's
    functional update, without a copy of the whole set a lap)."""

    states: torch.Tensor
    inputs: torch.Tensor
    qfun: torch.Tensor
    valid: torch.Tensor
    lap_len: torch.Tensor
    num_laps: torch.Tensor

    @classmethod
    def empty(cls, batch: int, max_laps: int, max_steps: int, *,
              dtype=torch.float32, device=None) -> "DeviceSafeSet":
        """An empty set of ``batch`` scenarios, on the current CUDA device
        unless ``device`` is named."""
        dev = resolve(device)
        z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)
        return cls(states=z(batch, max_laps, max_steps, 4),
                   inputs=z(batch, max_laps, max_steps, 2),
                   qfun=z(batch, max_laps, max_steps),
                   valid=z(batch, max_laps, max_steps, dt=torch.bool),
                   lap_len=z(batch, max_laps, dt=torch.int32),
                   num_laps=z(batch, dt=torch.int32))

    def __iter__(self):
        """The fields in order (states, inputs, qfun, valid, lap_len,
        num_laps)."""
        return iter((self.states, self.inputs, self.qfun, self.valid,
                     self.lap_len, self.num_laps))

    def map(self, fn) -> "DeviceSafeSet":
        """``fn`` applied to every field (``res.safe_set.map(lambda t:
        t[rows])`` takes some scenarios)."""
        return DeviceSafeSet(*(fn(t) for t in self))

    def add_lap(self, xs: torch.Tensor, us: torch.Tensor,
                n_valid) -> "DeviceSafeSet":
        """Store each scenario's lap in its next slot: padded xs (B, T, 4),
        us (B, T, 2) and ``n_valid`` (B,) or a scalar, the lap's states.
        Qfun = time-to-go = max(n_valid - 1 - i, 0). Returns self."""
        b, _, t = self.qfun.shape
        lanes = torch.arange(b, device=self.states.device)
        slot = self.num_laps.long()
        n_valid = torch.as_tensor(n_valid, device=self.states.device)
        n_valid = n_valid.expand(b).to(torch.int32)
        idx = torch.arange(t, device=self.states.device)
        self.states[lanes, slot] = xs.to(self.states.dtype)
        self.inputs[lanes, slot] = us.to(self.inputs.dtype)
        self.qfun[lanes, slot] = torch.clamp_min(
            n_valid[:, None].to(self.qfun.dtype) - 1.0
            - idx[None].to(self.qfun.dtype), 0.0)
        self.valid[lanes, slot] = idx[None] < n_valid[:, None]
        self.lap_len[lanes, slot] = n_valid
        self.num_laps += 1
        return self

    def knn(self, lap_id, x_guess: torch.Tensor, k: int):
        """Masked L1-kNN in one lap of each scenario -> (indices (B, k)
        i64, states (B, k, 4), qfun (B, k)).

        ``lap_id``: an int or (B,) lap slots; x_guess: (B, 4). Invalid
        (padded) rows are +inf away. The order is ``lax.top_k(-d, k)``'s:
        ascending distance, ties to the lower row, and where k exceeds the
        lap's valid rows the invalid rows follow in row order; their states
        are the padding and their Qfun is poisoned to +inf, so every
        candidate cost they make is +inf (the host path returns fewer
        candidates instead)."""
        b = x_guess.shape[0]
        dev = self.states.device
        lanes = torch.arange(b, device=dev)
        lap = torch.as_tensor(lap_id, device=dev).long().expand(b)
        st = self.states[lanes, lap]  # (B, T, 4)
        d = ((st[..., 0] - x_guess[:, None, 0]).abs()
             + (st[..., 1] - x_guess[:, None, 1]).abs()
             + (st[..., 2] - x_guess[:, None, 2]).abs()
             + (st[..., 3] - x_guess[:, None, 3]).abs())
        d = torch.where(self.valid[lanes, lap], d, float("inf"))
        d_sel, idx = torch.sort(d, dim=1, stable=True)
        d_sel, idx = d_sel[:, :k], idx[:, :k]
        q = torch.where(torch.isfinite(d_sel),
                        self.qfun[lanes, lap].gather(1, idx), float("inf"))
        return idx, st.gather(1, idx[..., None].expand(b, k, 4)), q
