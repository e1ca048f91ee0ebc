"""Elliptical obstacle as a small dataclass of tensors.

Port of ilqr_iterative_tasks_tpu/models/obstacle.py. An obstacle is always
present as data; ``present`` (0.0 or 1.0) masks its cost contribution.
``moving_option``: 0 static, 1 moving +y, 2 moving -x (used arithmetically).
Leaves are scalars or per-lane (B,) tensors; ``make`` puts them on the
current CUDA device unless the caller names a device.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

from ilqr_iterative_tasks_torch.utils.device import resolve


@dataclass(frozen=True)
class Obstacle:
    x: torch.Tensor  # center x
    y: torch.Tensor  # center y
    width: torch.Tensor  # semi-axis a
    height: torch.Tensor  # semi-axis b
    spd: torch.Tensor  # per-step speed (0 for static)
    moving_option: torch.Tensor  # 0 static, 1 +y, 2 -x
    present: torch.Tensor  # 1.0 active, 0.0 no cost contribution

    @classmethod
    def make(cls, x=0.0, y=0.0, width=1.0, height=1.0, spd=0.0,
             moving_option=0, present=True, *, dtype=torch.float32,
             device=None):
        device = resolve(device)
        f = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return cls(x=f(x), y=f(y), width=f(width), height=f(height),
                   spd=f(0.0 if spd is None else spd),
                   moving_option=f(0 if moving_option is None
                                   else moving_option),
                   present=f(1.0 if present else 0.0))

    @classmethod
    def absent(cls, *, dtype=torch.float32, device=None):
        return cls.make(present=False, dtype=dtype, device=device)

    def map(self, fn) -> "Obstacle":
        """Apply ``fn`` to every leaf."""
        return Obstacle(**{f.name: fn(getattr(self, f.name))
                           for f in fields(self)})

    def center_at(self, i):
        """Extrapolated center ``i`` steps ahead: option 1 -> y + i*spd,
        option 2 -> x - i*spd, otherwise static."""
        i = torch.as_tensor(i, dtype=self.x.dtype, device=self.x.device)
        up = (self.moving_option == 1).to(self.x.dtype)
        left = (self.moving_option == 2).to(self.x.dtype)
        return self.x - left * self.spd * i, self.y + up * self.spd * i

    def advance(self, dt) -> "Obstacle":
        """One closed-loop step of obstacle motion."""
        up = (self.moving_option == 1).to(self.x.dtype)
        left = (self.moving_option == 2).to(self.x.dtype)
        return replace(self, x=self.x - left * self.spd * dt,
                       y=self.y + up * self.spd * dt)
