"""Projected Levenberg-Marquardt shooting solve of the NLMPC candidate
feasibility problem, array-of-structures form.

Port of ilqr_iterative_tasks_tpu/ops/lm_shooting.py. Find bounded inputs
whose rollout hits ``x_terminal`` (|x_N - x_term| <= 1e-4) while the states
x_1..x_{N-1} stay outside the obstacle ellipse, by LM on the zero-residual
least squares

    r(u) = [ x_N(clip(u)) - x_term ;  sqrt(w) * present * max(0, g(u) + margin) ]

with the Jacobian by forward-mode autodiff (``torch.func.jacfwd``, as
``jax.jacfwd``), the primal normal equations (J^T J + lam I) du = -J^T r
solved by LU, a 5-point line search over alphas (1, 0.5, 0.25, 0.1, 0.02),
and two starts (the clipped warm start and zeros, the warm one winning
ties).

The clip and the relu are ``torch.minimum`` / ``torch.maximum``: at a tie
their derivative is split in halves, as JAX's min / max split it, where
``torch.clamp`` would pass it whole. Every warm start is clipped first, so
inputs do sit exactly on a bound.

The JAX vmap of a ``lax.while_loop`` becomes one lockstep loop over every
(candidate, start) with per-lane done masks, which computes what the vmap
computes. The NLMPC controller's candidate sweep runs the structure-of-
arrays version (ops/lm_shooting_soa.py, the plain version of the K4
kernel), not this module.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.ilqr import rollout
from ilqr_iterative_tasks_torch.utils.params import SystemLimits

ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.02)


class LmSolution(NamedTuple):
    us: torch.Tensor
    xs: torch.Tensor
    term_err: torch.Tensor
    max_violation: torch.Tensor
    feasible: torch.Tensor
    n_iters: torch.Tensor


def _clip(v, m):
    """clip(v, -m, m) as JAX computes it: min(max(v, -m), m)."""
    return torch.minimum(torch.maximum(v, -m), m)


def _solve_batch(limits: SystemLimits, obstacle: Obstacle, x0, x_terminal,
                 u_init, dt, *, num_horizon: int, max_iters: int,
                 num_starts: int, w_obs: float, g_margin: float,
                 term_tol: float, viol_tol: float) -> LmSolution:
    """x0, x_terminal (B, 4); u_init (B, N, 2) -> LmSolution over B."""
    if num_horizon < 2:
        raise ValueError("horizon-1 is a pure reach check handled by the "
                         "controller (nonlinear_lmpc.py:199-213)")
    n = num_horizon
    nvar = 2 * n
    dtype, dev = x_terminal.dtype, x_terminal.device
    a_max = limits.a_max.to(dtype)
    # raw bounds, per nonlinear_lmpc.py:123,147 (no delta rounding)
    d_max = limits.delta_max.to(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    offs = torch.arange(1, n, dtype=dtype, device=dev)
    cx, cy = obstacle.center_at(offs)
    sqrt_w = torch.sqrt(torch.as_tensor(w_obs, dtype=dtype, device=dev))

    def clip_u(us):
        return torch.stack([_clip(us[..., 0], a_max),
                            _clip(us[..., 1], d_max)], dim=-1)

    def g_of(xs):
        mid = xs[..., 1:n, :]
        return 1.0 - ((mid[..., 0] - cx) ** 2 / obstacle.width ** 2
                      + (mid[..., 1] - cy) ** 2 / obstacle.height ** 2)

    def resid(uf, x0_, xt_):
        us = clip_u(uf.reshape(n, 2))
        xs = rollout(x0_, us, dt)
        d = xs[-1] - xt_
        act = obstacle.present * torch.maximum(g_of(xs) + g_margin, zero)
        return torch.cat([d, sqrt_w * act])

    def sq(r):
        return (r[..., None, :] @ r[..., :, None])[..., 0, 0]

    b = x_terminal.shape[0]
    starts = [clip_u(u_init).reshape(b, nvar),
              torch.zeros((b, nvar), dtype=dtype, device=dev)][:num_starts]
    s = len(starts)
    # lanes: (candidate, start) pairs, candidate-major
    uf = torch.stack(starts, dim=1).reshape(b * s, nvar)
    x0_l = x0.repeat_interleave(s, dim=0)
    xt_l = x_terminal.repeat_interleave(s, dim=0)
    v_resid = torch.func.vmap(resid)
    v_jac = torch.func.vmap(torch.func.jacfwd(resid))
    alphas = torch.tensor(ALPHAS, dtype=dtype, device=dev)
    eye = torch.eye(nvar, dtype=dtype, device=dev)
    lam = torch.full((b * s,), 1e-3, dtype=dtype, device=dev)
    done = torch.zeros((b * s,), dtype=torch.bool, device=dev)
    its = torch.zeros((b * s,), dtype=torch.int64, device=dev)
    for _ in range(max_iters):
        if bool(done.all()):
            break
        r = v_resid(uf, x0_l, xt_l)
        f0 = sq(r)
        jac = v_jac(uf, x0_l, xt_l)
        h = jac.mT @ jac + lam[:, None, None] * eye
        du = -torch.linalg.solve(h, (jac.mT @ r[:, :, None]))[..., 0]
        cand = uf[:, None, :] + alphas[None, :, None] * du[:, None, :]
        fc = sq(v_resid(cand.reshape(-1, nvar),
                        x0_l.repeat_interleave(len(ALPHAS), dim=0),
                        xt_l.repeat_interleave(len(ALPHAS), dim=0))
                ).reshape(-1, len(ALPHAS))
        best = torch.argmin(fc, dim=1)
        f_best = fc.gather(1, best[:, None])[:, 0]
        cand_best = cand.gather(1, best[:, None, None].expand(-1, 1, nvar))[:, 0]
        accept = f_best < f0
        uf = torch.where((accept & ~done)[:, None], cand_best, uf)
        lam_next = torch.where(done, lam, torch.where(
            accept, torch.clamp_min(lam * 0.33, 1e-12), lam * 4.0))
        f_new = torch.where(accept, f_best, f0)
        its = its + (~done).to(torch.int64)
        done = done | (f_new < 1e-14) | (~accept & (lam_next > 1e10))
        lam = lam_next
    fs = sq(v_resid(uf, x0_l, xt_l)).reshape(b, s)
    pick = torch.argmin(fs, dim=1)  # the first start wins ties
    uf_best = uf.reshape(b, s, nvar).gather(
        1, pick[:, None, None].expand(-1, 1, nvar))[:, 0]
    us = clip_u(uf_best.reshape(b, n, 2))
    xs = rollout(x0, us, dt)
    d = xs[:, -1] - x_terminal
    term_err = torch.sqrt(torch.clamp_min(sq(d), 0.0))
    viol = torch.amax(obstacle.present * g_of(xs), dim=-1)
    feasible = (term_err <= term_tol) & (viol <= viol_tol)
    return LmSolution(us=us, xs=xs, term_err=term_err, max_violation=viol,
                      feasible=feasible,
                      n_iters=its.reshape(b, s).sum(dim=1))


def lm_feasibility_solve(limits: SystemLimits, obstacle: Obstacle,
                         x0: torch.Tensor, x_terminal: torch.Tensor,
                         u_init: torch.Tensor, dt, *, num_horizon: int,
                         max_iters: int = 80, num_starts: int = 2,
                         w_obs: float = 10.0, g_margin: float = 1e-3,
                         term_tol: float = 1e-4,
                         viol_tol: float = 1e-4) -> LmSolution:
    """One candidate: x0, x_terminal (4,), u_init (N, 2). Feasible when the
    terminal error is <= 1e-4 and no interior state is inside the
    ellipse by more than ``viol_tol``."""
    sol = _solve_batch(limits, obstacle, x0[None], x_terminal[None],
                       u_init[None], dt, num_horizon=num_horizon,
                       max_iters=max_iters, num_starts=num_starts,
                       w_obs=w_obs, g_margin=g_margin, term_tol=term_tol,
                       viol_tol=viol_tol)
    return LmSolution(*(t[0] for t in sol))


def lm_feasibility_solve_candidates(limits: SystemLimits, obstacle: Obstacle,
                                    x0: torch.Tensor,
                                    x_terminals: torch.Tensor,
                                    u_inits: torch.Tensor, dt, *,
                                    num_horizon: int, max_iters: int = 80,
                                    num_starts: int = 2) -> LmSolution:
    """Independent solves of candidates x_terminals (B, 4) with warm starts
    u_inits (B, N, 2) from the shared x0 (4,); outputs over B first."""
    b = x_terminals.shape[0]
    return _solve_batch(limits, obstacle, x0[None].expand(b, 4), x_terminals,
                        u_inits, dt, num_horizon=num_horizon,
                        max_iters=max_iters, num_starts=num_starts,
                        w_obs=10.0, g_margin=1e-3, term_tol=1e-4,
                        viol_tol=1e-4)
