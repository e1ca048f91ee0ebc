"""i2LQR / NLMPC hyperparameters and plant limits as small dataclasses of
tensors.

Port of ilqr_iterative_tasks_tpu/utils/params.py (``IlqrParams``,
``LmpcParams``, ``SystemLimits``). Numeric weights are 0-d (or 4x4 / 2x2)
tensors of the requested dtype on the requested device (the current CUDA
device when none is named, utils/device.py); the structural
fields (horizon, candidate counts, iteration caps) are plain ints. i2LQR's
``delta_max_r`` keeps the reference's ``round(delta_max, 2)`` quirk:
clipping and the input barriers use the rounded value (params.py:42). The
NLMPC solve clips at the raw ``delta_max`` (``nlmpc_consts``).
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from ilqr_iterative_tasks_torch.utils.device import resolve


def _diag4(a, b, c, d):
    return np.diag([a, b, c, d]).astype(np.float64)


@dataclass(frozen=True)
class SystemLimits:
    """Input/state limits; ``delta_max_r`` = round(delta_max, 2)."""

    a_max: torch.Tensor
    delta_max: torch.Tensor
    delta_max_r: torch.Tensor
    v_max: torch.Tensor
    v_min: torch.Tensor

    @classmethod
    def make(cls, a_max=2.0, delta_max=np.pi / 2, v_max=10.0, v_min=0.0, *,
             dtype=torch.float32, device=None):
        device = resolve(device)
        f = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return cls(a_max=f(a_max), delta_max=f(delta_max),
                   delta_max_r=f(round(float(delta_max), 2)),
                   v_max=f(v_max), v_min=f(v_min))


@dataclass(frozen=True)
class IlqrParams:
    """i2LQR hyperparameters (same fields and defaults as the JAX package)."""

    matrix_Q: torch.Tensor  # (4,4) running state weight (default 0)
    matrix_R: torch.Tensor  # (2,2) running input weight (default 0)
    matrix_Qterminal: torch.Tensor  # (4,4) terminal weight
    tuning_state_q1: torch.Tensor
    tuning_state_q2: torch.Tensor
    tuning_ctrl_q1: torch.Tensor
    tuning_ctrl_q2: torch.Tensor
    tuning_obs_q1: torch.Tensor
    tuning_obs_q2: torch.Tensor
    safety_margin: torch.Tensor
    eps: torch.Tensor  # relative-cost convergence tolerance
    lamb: torch.Tensor  # initial LM regularization
    lamb_factor: torch.Tensor
    max_lamb: torch.Tensor
    reach_error: torch.Tensor

    num_ss_points: int = 8
    num_ss_iter: int = 1
    num_horizon: int = 6
    max_ilqr_iter: int = 150
    max_relax_iter: int = 55

    @classmethod
    def make(cls, *, matrix_Q=None, matrix_R=None, matrix_Qterminal=None,
             tuning_state_q1=1.0, tuning_state_q2=1.0,
             tuning_ctrl_q1=1.0, tuning_ctrl_q2=1.0,
             tuning_obs_q1=2.74, tuning_obs_q2=2.74, safety_margin=0.0,
             eps=1e-2, lamb=1.0, lamb_factor=10.0, max_lamb=1000.0,
             reach_error=1.0, dtype=torch.float32, device=None, **static):
        device = resolve(device)
        f = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype,
                                      device=device)
        if matrix_Q is None:
            matrix_Q = 0.0 * _diag4(0.0, 0.0, 0.0, 0.0)
        if matrix_R is None:
            matrix_R = 0.0 * np.diag([0.05, 0.05])
        if matrix_Qterminal is None:
            matrix_Qterminal = 2.0 * _diag4(1.0, 1.0, 20.0, 0.02)
        return cls(
            matrix_Q=f(matrix_Q), matrix_R=f(matrix_R),
            matrix_Qterminal=f(matrix_Qterminal),
            tuning_state_q1=f(tuning_state_q1),
            tuning_state_q2=f(tuning_state_q2),
            tuning_ctrl_q1=f(tuning_ctrl_q1), tuning_ctrl_q2=f(tuning_ctrl_q2),
            tuning_obs_q1=f(tuning_obs_q1), tuning_obs_q2=f(tuning_obs_q2),
            safety_margin=f(safety_margin), eps=f(eps), lamb=f(lamb),
            lamb_factor=f(lamb_factor), max_lamb=f(max_lamb),
            reach_error=f(reach_error), **static)


@dataclass(frozen=True)
class LmpcParams:
    """NLMPC hyperparameters (same fields and defaults as the JAX package).
    The weight matrices are carried for API parity; the reference's solve
    is a pure min-time feasibility solve and does not read them."""

    matrix_Q: torch.Tensor  # (6,6)
    matrix_R: torch.Tensor  # (2,2)
    matrix_Qslack: torch.Tensor  # (6,6)
    matrix_dR: torch.Tensor  # (2,2)

    num_ss_points: int = 8
    num_ss_iter: int = 1
    num_horizon: int = 6
    all_ss_point: bool = False
    all_ss_iter: bool = False
    ss_option: str = "spaceVarying"

    @classmethod
    def make(cls, *, dtype=torch.float32, device=None, **static):
        device = resolve(device)
        f = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype,
                                      device=device)
        return cls(matrix_Q=f(np.zeros((6, 6))),
                   matrix_R=f(np.diag([1.0, 0.25])),
                   matrix_Qslack=f(5.0 * np.diag([10, 0, 0, 1, 10, 0])),
                   matrix_dR=f(5.0 * np.diag([0.8, 0.0])), **static)

    @property
    def ss_mode(self) -> str:
        """The safe-set candidate mode: ``all_ss_point`` overrides
        ``ss_option`` (control/batched_nlmpc_soa.py:157-164)."""
        mode = "all" if self.all_ss_point else str(self.ss_option)
        if mode not in ("all", "timeVarying", "spaceVarying"):
            raise ValueError(f"unknown ss_option {mode!r}")
        return mode


def nlmpc_consts(limits: SystemLimits, dt) -> SimpleNamespace:
    """The NLMPC solve's constants as Python floats (port of
    ``bake_nlmpc_consts``, ops/_pallas_nlmpc_core.py:25, at its defaults:
    obstacle weight 10, margin 1e-3, tolerances 1e-4). ``d_max`` is the raw
    ``delta_max``, not the rounded ``delta_max_r`` of i2LQR."""
    f = lambda v: float(v.detach().cpu().double())
    return SimpleNamespace(dt=float(dt), a_max=f(limits.a_max),
                           d_max=f(limits.delta_max),
                           sqrt_w=float(np.sqrt(10.0)), margin=1e-3,
                           term_tol=1e-4, viol_tol=1e-4)


def solver_consts(params: IlqrParams, limits: SystemLimits, dt) -> SimpleNamespace:
    """Hyperparameters as Python floats plus symmetrized numpy weight matrices.

    Both the plain solver and the CUDA kernels compute from these values, so
    they see the same constants (the role of ``bake_consts`` in the JAX
    package, ops/_pallas_lm_core.py:29). Floats hold the parameter tensors'
    exact values.
    """
    f = lambda v: float(v.detach().cpu().double())

    def sym(m):
        """Symmetrized matrix as {(i, j): float}, indexable as ``m[i, j]``."""
        a = m.detach().cpu().double().numpy()
        a = 0.5 * (a + a.T)
        return {(i, j): float(a[i, j]) for i in range(a.shape[0])
                for j in range(a.shape[1])}

    return SimpleNamespace(
        q_m=sym(params.matrix_Q), r_m=sym(params.matrix_R),
        qt_m=sym(params.matrix_Qterminal),
        q1c=f(params.tuning_ctrl_q1), q2c=f(params.tuning_ctrl_q2),
        q1o=f(params.tuning_obs_q1), q2o=f(params.tuning_obs_q2),
        margin=f(params.safety_margin), eps=f(params.eps),
        lamb0=f(params.lamb), lamb_factor=f(params.lamb_factor),
        max_lamb=f(params.max_lamb),
        max_relax_iter=float(params.max_relax_iter),
        a_max=f(limits.a_max), d_max=f(limits.delta_max_r),
        param_horizon=float(params.num_horizon), dt=float(dt))
