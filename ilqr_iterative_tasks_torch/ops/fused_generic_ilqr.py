"""Generic-system LM-iLQR, one solve per lane: the K5 kernel
(csrc/generic_ilqr.cu) and its plain version.

Port of ilqr_iterative_tasks_tpu/ops/pallas_generic_ilqr.py
(``build_generic_ilqr_pallas``, kernel :64, ``pl.pallas_call`` :119):

    solve(x0 (n,B) or (n,), x_terminal (n,B), u_init (N,m,B))
    -> (us (N,m,B), x_last (n,B), cost (B,), n_iters (B,) i32)

for a model module of models/ (``X_DIM``, ``U_DIM``, ``step_comps`` and
``CUDA_MODEL``, the name of its instantiation in the kernel) with a
quadratic cost about x_terminal, box bounds on u and the LM ladder of
ops/generic_ilqr_soa.py. Any B; the kernel masks the ragged edge.

``n_iters`` is each lane's own trip count: the LM iteration after which the
lane turned done (converged or diverged), else max_iter. The TPU kernel
reports the lockstep trip count of its tile instead, and the JAX SoA solver
one count for the batch: the maximum of the port's counts over the lanes of
a tile or of the batch. Done lanes freeze, so us, x_last and cost do not
depend on the convention.

The wrapper runs the plain version (ops/generic_ilqr_soa.py, which takes any
``step_comps``) only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises. The kernel is instantiated for the double integrator
(N 6 and 10), the unicycle (N 6 and 8) and the bicycle (N 6), f32 and f64.
"""

from __future__ import annotations

import torch

from ilqr_iterative_tasks_torch.ops import _build
from ilqr_iterative_tasks_torch.ops.fused_ilqr import DTYPE_CODES, check_lanes
from ilqr_iterative_tasks_torch.ops.generic_ilqr_soa import (
    build_generic_ilqr_soa, numpy_f64, symmetrize)

# csrc/generic_ilqr.cu model codes
MODEL_CODES = {"double_integrator": 0, "unicycle": 1, "bicycle": 2}


def fused_generic_ilqr_reference(model, x0, x_terminal, u_init, **kw):
    """Plain version of the K5 kernel (same outputs; ``kw`` are the
    settings of ``build_fused_generic_ilqr``)."""
    return build_fused_generic_ilqr(model, **kw).plain(x0, x_terminal,
                                                       u_init)


class FusedGenericIlqr:
    """K5: one generic LM-iLQR solve per lane. ``launches`` counts kernel
    launches (not plain CPU calls)."""

    def __init__(self, model, *, n: int, m: int, matrix_Q, matrix_R,
                 matrix_Qterminal, u_lower, u_upper, dt, eps: float = 1e-2,
                 lamb_factor: float = 10.0, max_lamb: float = 1000.0,
                 max_iter: int = 150, num_horizon: int = 6,
                 lamb0: float = 1.0):
        if (n, m) != (model.X_DIM, model.U_DIM):
            raise ValueError(f"(n, m)=({n}, {m}) but the model has "
                             f"({model.X_DIM}, {model.U_DIM})")
        self.model, self.n, self.m = model, n, m
        self.num_horizon, self.max_iter = num_horizon, max_iter
        self.lamb0 = float(lamb0)
        self._plain = build_generic_ilqr_soa(
            model.step_comps, n=n, m=m, matrix_Q=matrix_Q,
            matrix_R=matrix_R, matrix_Qterminal=matrix_Qterminal,
            u_lower=u_lower, u_upper=u_upper, dt=dt, eps=eps,
            lamb_factor=lamb_factor, max_lamb=max_lamb, max_iter=max_iter,
            num_horizon=num_horizon)
        self._consts = _build.generic_consts_array(
            symmetrize(matrix_Q), symmetrize(matrix_R),
            symmetrize(matrix_Qterminal), numpy_f64(u_lower).reshape(m),
            numpy_f64(u_upper).reshape(m), dt, eps, lamb0, lamb_factor,
            max_lamb)
        self.launches = 0

    def plain(self, x0, x_terminal, u_init):
        """The plain version on any device: (us, x_last, cost, n_iters)."""
        sol = self._plain(x0, x_terminal, u_init, self.lamb0)
        return sol.us, sol.xs[-1], sol.cost, sol.lane_iters

    def __call__(self, x0, x_terminal, u_init):
        n, m, nh = self.n, self.m, self.num_horizon
        if x_terminal.device.type == "cpu":
            return self.plain(x0, x_terminal, u_init)
        if x_terminal.device.type != "cuda":
            raise ValueError(f"unsupported device {x_terminal.device}")
        dev, dtype = x_terminal.device, x_terminal.dtype
        if dtype not in DTYPE_CODES:
            raise TypeError(f"unsupported dtype {dtype}")
        code = MODEL_CODES.get(getattr(self.model, "CUDA_MODEL", None))
        if code is None:
            raise ValueError(f"{self.model.__name__} has no CUDA "
                             f"instantiation in csrc/generic_ilqr.cu")
        b = x_terminal.shape[-1]
        if x0.dim() == 1:
            x0 = x0[:, None].expand(n, b).contiguous()
        check_lanes("x0", x0, (n, b), dtype, dev)
        check_lanes("x_terminal", x_terminal, (n, b), dtype, dev)
        check_lanes("u_init", u_init, (nh, m, b), dtype, dev)
        us = torch.empty((nh, m, b), dtype=dtype, device=dev)
        x_last = torch.empty((n, b), dtype=dtype, device=dev)
        cost = torch.empty((b,), dtype=dtype, device=dev)
        n_iters = torch.empty((b,), dtype=torch.int32, device=dev)
        counter = torch.empty((1,), dtype=torch.int32, device=dev)
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.generic_ilqr_launch(
                DTYPE_CODES[dtype], code, nh, self._consts, self.max_iter, b,
                x0.data_ptr(), x_terminal.data_ptr(), u_init.data_ptr(),
                us.data_ptr(), x_last.data_ptr(), cost.data_ptr(),
                n_iters.data_ptr(), stream, counter.data_ptr())
        _build.check_launch(rc, "generic_ilqr")
        self.launches += 1
        return us, x_last, cost, n_iters


def build_fused_generic_ilqr(model, *, n: int, m: int, matrix_Q, matrix_R,
                             matrix_Qterminal, u_lower, u_upper, dt,
                             eps: float = 1e-2, lamb_factor: float = 10.0,
                             max_lamb: float = 1000.0, max_iter: int = 150,
                             num_horizon: int = 6,
                             lamb0: float = 1.0) -> FusedGenericIlqr:
    """Factory mirroring the JAX package's ``build_generic_ilqr_pallas``
    (a model module in place of its ``step_comps``; no tile_rows)."""
    return FusedGenericIlqr(
        model, n=n, m=m, matrix_Q=matrix_Q, matrix_R=matrix_R,
        matrix_Qterminal=matrix_Qterminal, u_lower=u_lower, u_upper=u_upper,
        dt=dt, eps=eps, lamb_factor=lamb_factor, max_lamb=max_lamb,
        max_iter=max_iter, num_horizon=num_horizon, lamb0=lamb0)
