"""Per-candidate LM-iLQR solve: the K3 kernel (csrc/fused_ilqr.cu) and its
plain version.

Port of ilqr_iterative_tasks_tpu/ops/pallas_ilqr.py (``obstacle_to_lanes``
:42, ``build_fused_ilqr`` :64). One lane is one candidate solve:
``(x0 (4,B), x_term (4,B), u_init (N,2,B), obs (6,B)[, skip (B,)])
-> (us (N,2,B), x_last (4,B), cost (B,), dist (B,))``. Lanes with skip=1
start done: their outputs are the rollout of u_init.

The wrapper runs the plain version (ops/ilqr_soa.py) only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops import _build
from ilqr_iterative_tasks_torch.ops.ilqr_soa import ilqr_solve_soa
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, SystemLimits, solver_consts)

DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def obstacle_to_lanes(obstacle: Obstacle, batch: int) -> torch.Tensor:
    """Pack per-lane obstacle parameters -> (6, batch):
    [cx, cy, present/w^2, present/h^2, spd*up, spd*left]."""
    up = (obstacle.moving_option == 1).to(obstacle.x.dtype)
    left = (obstacle.moving_option == 2).to(obstacle.x.dtype)
    rows = [obstacle.x, obstacle.y,
            obstacle.present / (obstacle.width * obstacle.width),
            obstacle.present / (obstacle.height * obstacle.height),
            obstacle.spd * up, obstacle.spd * left]
    return torch.stack([r.expand(batch) for r in rows])


def fused_ilqr_reference(params, limits, dt, x0, x_term, u_init, obs,
                         skip=None, *, num_horizon: int, max_iter: int):
    """Plain version of the K3 kernel (same signature and outputs)."""
    sol = ilqr_solve_soa(params, limits, obs, x0, x_term, u_init,
                         float(params.lamb), dt, num_horizon=num_horizon,
                         max_iter=max_iter,
                         done0=None if skip is None else skip > 0.5)
    x_last = sol.xs[-1]
    d = [x_last[i] - x_term[i] for i in range(4)]
    dist = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + d[3] * d[3])
    return sol.us, x_last, sol.cost, dist


def check_lanes(name: str, t: torch.Tensor, shape, dtype, device):
    """Raise unless ``t`` is a contiguous tensor of this shape/dtype/device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


class FusedIlqr:
    """K3: one LM-iLQR candidate solve per lane. ``max_iter`` is the LM cap
    it was built with; ``with_skip`` is always true (the JAX factory's flag:
    ``skip`` is an input); ``launches`` counts kernel launches (not plain
    CPU calls)."""

    with_skip = True

    def __init__(self, params: IlqrParams, limits: SystemLimits, dt, *,
                 num_horizon: int, max_iter: int = 150):
        self.params, self.limits, self.dt = params, limits, float(dt)
        self.num_horizon = num_horizon
        self.max_iter = max_iter
        self._consts = _build.consts_array(solver_consts(params, limits, dt))
        self.launches = 0

    def __call__(self, x0, x_term, u_init, obs, skip=None):
        n = self.num_horizon
        if x_term.device.type == "cpu":
            return fused_ilqr_reference(
                self.params, self.limits, self.dt, x0, x_term, u_init, obs,
                skip, num_horizon=n, max_iter=self.max_iter)
        if x_term.device.type != "cuda":
            raise ValueError(f"unsupported device {x_term.device}")
        dev, dtype = x_term.device, x_term.dtype
        if dtype not in DTYPE_CODES:
            raise TypeError(f"unsupported dtype {dtype}")
        b = x_term.shape[-1]
        check_lanes("x0", x0, (4, b), dtype, dev)
        check_lanes("x_term", x_term, (4, b), dtype, dev)
        check_lanes("u_init", u_init, (n, 2, b), dtype, dev)
        check_lanes("obs", obs, (6, b), dtype, dev)
        if skip is not None:
            check_lanes("skip", skip, (b,), torch.float32, dev)
        us = torch.empty((n, 2, b), dtype=dtype, device=dev)
        x_last = torch.empty((4, b), dtype=dtype, device=dev)
        cost = torch.empty((b,), dtype=dtype, device=dev)
        dist = torch.empty((b,), dtype=dtype, device=dev)
        counter = torch.empty((1,), dtype=torch.int32, device=dev)
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.fused_ilqr_launch(
                DTYPE_CODES[dtype], n, self._consts, self.max_iter, b,
                x0.data_ptr(), x_term.data_ptr(), u_init.data_ptr(),
                obs.data_ptr(), None if skip is None else skip.data_ptr(),
                us.data_ptr(), x_last.data_ptr(), cost.data_ptr(),
                dist.data_ptr(), stream, counter.data_ptr())
        _build.check_launch(rc, "fused_ilqr")
        self.launches += 1
        return us, x_last, cost, dist


def build_fused_ilqr(params: IlqrParams, limits: SystemLimits, dt, *,
                     num_horizon: int, max_iter: int = 150) -> FusedIlqr:
    """Factory mirroring the JAX package's ``build_fused_ilqr``."""
    return FusedIlqr(params, limits, dt, num_horizon=num_horizon,
                     max_iter=max_iter)
