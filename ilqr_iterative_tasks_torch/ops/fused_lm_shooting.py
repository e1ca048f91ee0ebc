"""Per-candidate projected-LM feasibility solve: the K4 kernel
(csrc/fused_lm_shooting.cu) and its plain version.

Port of ilqr_iterative_tasks_tpu/ops/pallas_lm_shooting.py
(``obstacle_to_lanes_nlmpc`` :45, ``build_fused_lm_shooting`` :59, built
with ``with_skip=True, with_hzn=True``). One lane is one candidate solve:

    (x0 (4,B), x_term (4,B), u_warm (N,2,B), obs (7,B), skip (B,) f32,
     hzn (B,) i32) -> (us (N,2,B), x_last (4,B), term_err (B,), feasible (B,))

``hzn`` is clipped to [2, N] and is the lane's horizon m: ``x_last`` is
x_m, and ``term_err`` / ``feasible`` are judged there. Lanes with skip=1
run no LM iteration in either start. ``feasible`` is 0/1 in the input's
dtype.

The wrapper runs the plain version (ops/lm_shooting_soa.py) only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops import _build
from ilqr_iterative_tasks_torch.ops.fused_ilqr import DTYPE_CODES, check_lanes
from ilqr_iterative_tasks_torch.ops.lm_shooting_soa import (
    lm_feasibility_solve_soa)
from ilqr_iterative_tasks_torch.utils.params import SystemLimits, nlmpc_consts


def obstacle_to_lanes_nlmpc(obstacle: Obstacle, batch: int) -> torch.Tensor:
    """Pack per-lane obstacle parameters -> (7, batch):
    [cx, cy, 1/w^2, 1/h^2, spd*up, spd*left, present]."""
    up = (obstacle.moving_option == 1).to(obstacle.x.dtype)
    left = (obstacle.moving_option == 2).to(obstacle.x.dtype)
    rows = [obstacle.x, obstacle.y,
            1.0 / (obstacle.width * obstacle.width),
            1.0 / (obstacle.height * obstacle.height),
            obstacle.spd * up, obstacle.spd * left, obstacle.present]
    return torch.stack([r.expand(batch) for r in rows])


def fused_lm_shooting_reference(limits, dt, x0, x_term, u_warm, obs, skip,
                                hzn, *, num_horizon: int, max_iters: int,
                                trips: list | None = None):
    """Plain version of the K4 kernel (same signature and outputs). If
    ``trips`` is a list, it receives each lane's LM iterations of both
    starts (B,)."""
    n = num_horizon
    mm = torch.clamp(hzn.to(torch.int64), 2, n)
    sol = lm_feasibility_solve_soa(
        limits, obs, x0, x_term, u_warm, dt, num_horizon=n,
        max_iters=max_iters, m_lanes=mm,
        done0=skip > 0.5)
    if trips is not None:
        trips.append(sol.n_iters)
    x_last = sol.xs.gather(0, mm[None, None].expand(1, 4, -1))[0]
    return (sol.us, x_last, sol.term_err,
            sol.feasible.to(x_term.dtype))


class FusedLmShooting:
    """K4: one NLMPC candidate feasibility solve per lane. ``max_iters`` is
    the LM cap it was built with; ``with_skip`` and ``with_hzn`` are always
    true (the JAX factory's flags: ``skip`` and ``hzn`` are inputs);
    ``launches`` counts kernel launches (not plain CPU calls)."""

    with_skip = with_hzn = True

    def __init__(self, limits: SystemLimits, dt, *, num_horizon: int,
                 max_iters: int = 60):
        if num_horizon < 2:
            raise ValueError("horizon-1 is a pure reach check handled by the "
                             "controller (nonlinear_lmpc.py:199-213)")
        self.limits, self.dt = limits, float(dt)
        self.num_horizon = num_horizon
        self.max_iters = max_iters
        self._consts = _build.nlmpc_consts_array(nlmpc_consts(limits, dt))
        self.launches = 0

    def __call__(self, x0, x_term, u_warm, obs, skip, hzn):
        n = self.num_horizon
        if x_term.device.type == "cpu":
            return fused_lm_shooting_reference(
                self.limits, self.dt, x0, x_term, u_warm, obs, skip, hzn,
                num_horizon=n, max_iters=self.max_iters)
        if x_term.device.type != "cuda":
            raise ValueError(f"unsupported device {x_term.device}")
        dev, dtype = x_term.device, x_term.dtype
        if dtype not in DTYPE_CODES:
            raise TypeError(f"unsupported dtype {dtype}")
        b = x_term.shape[-1]
        check_lanes("x0", x0, (4, b), dtype, dev)
        check_lanes("x_term", x_term, (4, b), dtype, dev)
        check_lanes("u_warm", u_warm, (n, 2, b), dtype, dev)
        check_lanes("obs", obs, (7, b), dtype, dev)
        check_lanes("skip", skip, (b,), torch.float32, dev)
        check_lanes("hzn", hzn, (b,), torch.int32, dev)
        us = torch.empty((n, 2, b), dtype=dtype, device=dev)
        x_last = torch.empty((4, b), dtype=dtype, device=dev)
        term_err = torch.empty((b,), dtype=dtype, device=dev)
        feasible = torch.empty((b,), dtype=dtype, device=dev)
        counter = torch.empty((1,), dtype=torch.int32, device=dev)
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.fused_lm_shooting_launch(
                DTYPE_CODES[dtype], n, self._consts, self.max_iters, b,
                x0.data_ptr(), x_term.data_ptr(),
                u_warm.data_ptr(), obs.data_ptr(), skip.data_ptr(),
                hzn.data_ptr(), us.data_ptr(), x_last.data_ptr(),
                term_err.data_ptr(), feasible.data_ptr(), stream,
                counter.data_ptr())
        _build.check_launch(rc, "fused_lm_shooting")
        self.launches += 1
        return us, x_last, term_err, feasible


def build_fused_lm_shooting(limits: SystemLimits, dt, *, num_horizon: int,
                            max_iters: int = 60) -> FusedLmShooting:
    """Factory mirroring the JAX package's ``build_fused_lm_shooting`` with
    ``with_skip=True, with_hzn=True`` (both inputs always present) and two
    starts (clipped warm, zeros)."""
    return FusedLmShooting(limits, dt, num_horizon=num_horizon,
                           max_iters=max_iters)
