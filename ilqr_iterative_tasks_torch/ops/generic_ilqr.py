"""Generic-system iLQR, host tier: the LM-regularized iLQR loop for any
discrete dynamics ``step_fn(x, u, dt) -> x_next`` on state-last tensors.

Port of ilqr_iterative_tasks_tpu/ops/generic_ilqr.py (``GenericIlqrConfig``
:34, ``_reg_inv_sym`` :68, ``generic_ilqr_solve`` :80,
``generic_ilqr_solve_candidates`` :234). Plain torch, no kernel:

- Jacobians are ``torch.func.jacfwd`` of the step, batched over the horizon
  (and the candidates) with ``torch.func.vmap``, at the pre-step state;
- the Quu regularization is the spectral clamp f(e) = 1/(max(e,0)+lamb)
  through ``torch.linalg.eigh``;
- ``lax.scan`` becomes a Python loop over the horizon;
- ``backward="parallel"`` takes the suffix-scan Riccati of
  ops/parallel_riccati.py (control Tikhonov in place of the eigen clamp).

``generic_ilqr_solve_candidates`` is a vmap of a while_loop in JAX: every
candidate iterates until all are done, each frozen once done. Here that is
one batched solve over a leading candidate axis with per-candidate done
masks; ``generic_ilqr_solve`` is the same solve with one candidate.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ilqr_iterative_tasks_torch.ops.ilqr_soa import true_div
from ilqr_iterative_tasks_torch.ops.parallel_riccati import (
    parallel_lqr_gains)
from ilqr_iterative_tasks_torch.utils.device import resolve


class GenericIlqrConfig(NamedTuple):
    """Quadratic-cost iLQR problem data for an arbitrary system."""

    matrix_Q: torch.Tensor  # (n, n) running state cost (about x_terminal)
    matrix_R: torch.Tensor  # (m, m) running input cost
    matrix_Qterminal: torch.Tensor  # (n, n) terminal cost
    u_lower: torch.Tensor  # (m,) input box lower bounds
    u_upper: torch.Tensor  # (m,) input box upper bounds
    eps: torch.Tensor  # relative-cost convergence tolerance
    lamb_factor: torch.Tensor  # LM ladder factor (reference: 10)
    max_lamb: torch.Tensor  # LM divergence abort (reference: 1000)
    max_iter: int  # iteration cap (reference: 150)

    @classmethod
    def make(cls, matrix_Q, matrix_R, matrix_Qterminal, u_lower, u_upper,
             eps=1e-2, lamb_factor=10.0, max_lamb=1000.0, max_iter=150, *,
             dtype=torch.float32, device=None):
        device = resolve(device)
        f = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return cls(f(matrix_Q), f(matrix_R), f(matrix_Qterminal), f(u_lower),
                   f(u_upper), f(eps), f(lamb_factor), f(max_lamb),
                   int(max_iter))


class GenericIlqrSolution(NamedTuple):
    us: torch.Tensor  # (N, m) optimized (clipped) inputs
    xs: torch.Tensor  # (N+1, n) rollout of ``us`` from x0
    lamb: torch.Tensor  # final LM regularization
    n_iters: torch.Tensor  # iterations executed
    cost: torch.Tensor  # cost of the returned trajectory


def _reg_inv_sym(quu: torch.Tensor, lamb) -> torch.Tensor:
    """Spectral f(Quu), f(e) = 1/(max(e,0) + lamb), for symmetric m x m
    (``lamb`` broadcasts against the batch dims)."""
    sym = 0.5 * (quu + quu.transpose(-1, -2))
    evals, evecs = torch.linalg.eigh(sym)
    f = 1.0 / (torch.clamp_min(evals, 0.0) + lamb[..., None])
    return (evecs * f[..., None, :]) @ evecs.transpose(-1, -2)


def _solve_batched(step_fn: Callable, cfg: GenericIlqrConfig, x0, x_term,
                   u_init, lamb0, dt, backward: str) -> GenericIlqrSolution:
    """The LM loop for K candidates at once: x0 (n,) or (K, n), x_term
    (K, n), u_init (N, m) or (K, N, m). Outputs carry the leading K."""
    if backward not in ("sequential", "parallel"):
        raise ValueError(f"unknown backward mode {backward!r}")
    dtype, dev = x_term.dtype, x_term.device
    k_c, n = x_term.shape
    nh, m = u_init.shape[-2:]
    x0 = x0.expand(k_c, n)
    u_init = u_init.expand(k_c, nh, m)
    dt = torch.as_tensor(dt, dtype=dtype, device=dev)
    Q, R, Qt = cfg.matrix_Q, cfg.matrix_R, cfg.matrix_Qterminal

    def clip_u(us):
        return torch.clamp(us, cfg.u_lower, cfg.u_upper)

    def rollout(us):
        xs = [x0]
        for i in range(nh):
            xs.append(step_fn(xs[-1], us[:, i], dt))
        return torch.stack(xs, dim=1)  # (K, N+1, n)

    def traj_cost(xs, us):
        dxs = xs[:, :-1] - x_term[:, None]
        run = ((dxs @ Q) * dxs).sum(dim=(1, 2)) + ((us @ R) * us).sum(
            dim=(1, 2))
        dterm = xs[:, -1] - x_term
        return run + ((dterm @ Qt) * dterm).sum(dim=1)

    jac = torch.func.vmap(torch.func.jacfwd(step_fn, argnums=(0, 1)),
                          in_dims=(0, 0, None))

    def stage_data(xs, us):
        f_x, f_u = jac(xs[:, :-1].reshape(-1, n), us.reshape(-1, m), dt)
        # jacfwd of a step that indexes its state returns float64 here
        f_x, f_u = f_x.to(dtype), f_u.to(dtype)
        dxs = xs[:, :-1] - x_term[:, None]
        return (f_x.reshape(k_c, nh, n, n), f_u.reshape(k_c, nh, n, m),
                2.0 * dxs @ Q, 2.0 * us @ R,
                ((xs[:, -1] - x_term) @ (2.0 * Qt).T))  # v_x = 2 Qt dterm

    def backward_sequential(xs, us, lamb):
        f_x, f_u, l_x, l_u, v_x = stage_data(xs, us)
        v_xx = (2.0 * Qt).expand(k_c, n, n)
        ks = [None] * nh
        big_ks = [None] * nh
        for i in range(nh - 1, -1, -1):
            fx, fu = f_x[:, i], f_u[:, i]
            fxt, fut = fx.transpose(-1, -2), fu.transpose(-1, -2)
            q_x = l_x[:, i] + (fxt @ v_x[..., None])[..., 0]
            q_u = l_u[:, i] + (fut @ v_x[..., None])[..., 0]
            q_xx = 2.0 * Q + fxt @ v_xx @ fx
            q_uu = 2.0 * R + fut @ v_xx @ fu
            q_ux = fut @ v_xx @ fx
            quu_inv = _reg_inv_sym(q_uu, lamb)
            k_t = -(quu_inv @ q_u[..., None])[..., 0]
            big_k = -quu_inv @ q_ux
            big_kt = big_k.transpose(-1, -2)
            v_x = q_x - (big_kt @ q_uu @ k_t[..., None])[..., 0]
            v_xx = q_xx - big_kt @ q_uu @ big_k
            ks[i], big_ks[i] = k_t, big_k
        return torch.stack(ks, dim=1), torch.stack(big_ks, dim=1)

    def backward_parallel(xs, us, lamb):
        """Zero-drift deviation dynamics mapped onto the parallel_riccati
        element convention (V = 0.5 x'Px + p'x), horizon leading."""
        f_x, f_u, l_x, l_u, v_x = stage_data(xs, us)
        tr = lambda a: a.transpose(0, 1)
        kff, big_k, _P, _p = parallel_lqr_gains(
            tr(f_x), torch.zeros_like(tr(l_x)), tr(f_u),
            (2.0 * Q).expand(nh, k_c, n, n), tr(l_x),
            (2.0 * R).expand(nh, k_c, m, m), tr(l_u),
            (2.0 * Qt).expand(k_c, n, n), v_x, lamb=lamb[:, None, None])
        return tr(kff), tr(big_k)

    def forward(xs, us, ks, big_ks):
        x_new = xs[:, 0]
        xs_new, us_new = [x_new], []
        for i in range(nh):
            u_new = clip_u(us[:, i] + ks[:, i] + (
                big_ks[:, i] @ (x_new - xs[:, i])[..., None])[..., 0])
            x_new = step_fn(x_new, u_new, dt)
            xs_new.append(x_new)
            us_new.append(u_new)
        xs_new = torch.stack(xs_new, dim=1)
        us_new = torch.stack(us_new, dim=1)
        return xs_new, us_new, traj_cost(xs_new, us_new)

    bw = backward_sequential if backward == "sequential" else (
        backward_parallel)
    us = clip_u(u_init)
    lamb = torch.full((k_c,), float(lamb0), dtype=dtype, device=dev)
    n_iters = torch.zeros((k_c,), dtype=torch.int64, device=dev)
    done = torch.zeros((k_c,), dtype=torch.bool, device=dev)
    lamb_factor = float(cfg.lamb_factor)
    while not bool(done.all()):
        active = ~done & (n_iters < cfg.max_iter)
        if not bool(active.any()):
            break
        us_c = clip_u(us)
        xs = rollout(us_c)
        cost = traj_cost(xs, us_c)
        ks, big_ks = bw(xs, us_c, lamb)
        _, us_new, cost_new = forward(xs, us_c, ks, big_ks)
        accept = cost_new < cost
        lamb_next = torch.where(accept, true_div(lamb, lamb_factor),
                                lamb * lamb_factor)
        converged = accept & (torch.abs((cost_new - cost) / cost) < cfg.eps)
        diverged = (~accept) & (lamb_next > cfg.max_lamb)
        # a candidate that is done or at the cap keeps its carry
        upd = active[:, None, None]
        us = torch.where(upd, torch.where(accept[:, None, None], us_new, us_c),
                         us)
        lamb = torch.where(active, lamb_next, lamb)
        n_iters = torch.where(active, n_iters + 1, n_iters)
        done = done | (active & (converged | diverged))
    us = clip_u(us)
    xs = rollout(us)
    return GenericIlqrSolution(us=us, xs=xs, lamb=lamb, n_iters=n_iters,
                               cost=traj_cost(xs, us))


def generic_ilqr_solve(step_fn: Callable, cfg: GenericIlqrConfig,
                       x0: torch.Tensor, x_terminal: torch.Tensor,
                       u_init: torch.Tensor, lamb0, dt,
                       backward: str = "sequential") -> GenericIlqrSolution:
    """LM-regularized iLQR for a user dynamics ``step_fn(x, u, dt) -> x'``
    on x0 (n,), x_terminal (n,), u_init (N, m): clip inputs, rollout +
    quadratic cost about ``x_terminal``, backward Riccati pass with
    eigenvalue-clamp Quu regularization ("sequential") or the suffix-scan
    Riccati with control Tikhonov ("parallel"), full-step clipped forward
    pass, accept/reject with the lambda ladder, stop on |dcost/cost| < eps
    or lambda > max_lamb."""
    sol = _solve_batched(step_fn, cfg, x0, x_terminal[None], u_init, lamb0,
                         dt, backward)
    return GenericIlqrSolution(*(t[0] for t in sol))


def generic_ilqr_solve_candidates(step_fn: Callable, cfg: GenericIlqrConfig,
                                  x0: torch.Tensor, x_terminals: torch.Tensor,
                                  u_init: torch.Tensor, lamb0, dt,
                                  backward: str = "sequential"
                                  ) -> GenericIlqrSolution:
    """``generic_ilqr_solve`` over terminal-state candidates
    ``x_terminals`` (k, n), with ``u_init`` (N, m) shared; outputs carry a
    leading k."""
    return _solve_batched(step_fn, cfg, x0, x_terminals, u_init, lamb0, dt,
                          backward)
