"""Generic-system LM-iLQR, one solve per lane: the K5 kernel
(csrc/generic_ilqr.cuh) and its plain version.

Port of ilqr_iterative_tasks_tpu/ops/pallas_generic_ilqr.py
(``build_generic_ilqr_pallas``, kernel :64, ``pl.pallas_call`` :119):

    solve(x0 (n,B) or (n,), x_terminal (n,B), u_init (N,m,B))
    -> (us (N,m,B), x_last (n,B), cost (B,), n_iters (B,) i32)

for the caller's model, any object with ``X_DIM``, ``U_DIM``,
``step_comps`` (the plain version's dynamics) and ``CUDA_STEP``: the C++
text of the same step as a struct of namespace ``ilqr`` (the form of
csrc/generic_ilqr.cuh's header comment; models/ holds three), with a
quadratic cost about x_terminal, box bounds on u and the LM ladder of
ops/generic_ilqr_soa.py, at any horizon and for any number of inputs
(closed-form Quu inverse for m <= 2, damped Cholesky for m > 2). Any B; the
kernel masks the ragged edge.

``n_iters`` is each lane's own trip count: the LM iteration after which the
lane turned done (converged or diverged), else max_iter. The TPU kernel
reports the lockstep trip count of its tile instead, and the JAX SoA solver
one count for the batch: the maximum of the port's counts over the lanes of
a tile or of the batch. Done lanes freeze, so us, x_last and cost do not
depend on the convention.

The wrapper runs the plain version (ops/generic_ilqr_soa.py, which takes any
``step_comps``) only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises (a model without ``CUDA_STEP`` raises). The kernel of
a (model, horizon) is the translation unit ``k5_source`` writes, built by
nvcc into a library of its own at first use (ops/_build.py
``generic_library``), f32 and f64.
"""

from __future__ import annotations

import re

import torch

from ilqr_iterative_tasks_torch.ops import _build
from ilqr_iterative_tasks_torch.ops.fused_ilqr import DTYPE_CODES, check_lanes
from ilqr_iterative_tasks_torch.ops.generic_ilqr_soa import (
    build_generic_ilqr_soa, numpy_f64, symmetrize)


def k5_source(model, num_horizon: int) -> str:
    """The translation unit of K5 for ``model`` at ``num_horizon``:
    csrc/generic_ilqr.cuh, the model's ``CUDA_STEP`` (its struct, named by
    the text's first ``struct``) and the C launcher of that struct and
    horizon. ValueError for a model without ``CUDA_STEP`` or a struct in
    it."""
    step = getattr(model, "CUDA_STEP", None)
    if step is None:
        raise ValueError(f"{getattr(model, '__name__', model)} has no "
                         f"CUDA_STEP: K5 cannot run it on the card")
    name = re.search(r"\bstruct\s+(\w+)", step)
    if name is None:
        raise ValueError("CUDA_STEP holds no struct")
    name = name.group(1)
    return (f"// K5 for {name} at N = {num_horizon}, written by "
            f"ops/fused_generic_ilqr.py::k5_source\n"
            f"#include \"generic_ilqr.cuh\"\n\nnamespace ilqr {{\n"
            f"{step.strip()}\n}}  // namespace ilqr\n\n"
            f"ILQR_K5_EXPORT({name}, {int(num_horizon)})\n")


def k5_library(model, num_horizon: int):
    """The loaded K5 library of (model, horizon), built on first use."""
    return _build.generic_library(k5_source(model, num_horizon))


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
        lib = k5_library(self.model, nh)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.k5_launch(
                DTYPE_CODES[dtype], self._consts, self.max_iter, b,
                x0.data_ptr(), x_terminal.data_ptr(), u_init.data_ptr(),
                us.data_ptr(), x_last.data_ptr(), cost.data_ptr(),
                n_iters.data_ptr(), stream, counter.data_ptr())
        _build.check_launch(rc, "k5")
        self.launches += 1
        return us, x_last, cost, n_iters


def build_fused_generic_ilqr(model, *, n: int, m: int, matrix_Q, matrix_R,
                             matrix_Qterminal, u_lower, u_upper, dt,
                             eps: float = 1e-2, lamb_factor: float = 10.0,
                             max_lamb: float = 1000.0, max_iter: int = 150,
                             num_horizon: int = 6,
                             lamb0: float = 1.0) -> FusedGenericIlqr:
    """Factory mirroring the JAX package's ``build_generic_ilqr_pallas``
    (a model object in place of its ``step_comps``; no tile_rows)."""
    return FusedGenericIlqr(
        model, n=n, m=m, matrix_Q=matrix_Q, matrix_R=matrix_R,
        matrix_Qterminal=matrix_Qterminal, u_lower=u_lower, u_upper=u_upper,
        dt=dt, eps=eps, lamb_factor=lamb_factor, max_lamb=max_lamb,
        max_iter=max_iter, num_horizon=num_horizon, lamb0=lamb0)
