"""Augmented-Lagrangian constrained iLQR: the long-horizon solve of the
NLMPC candidate feasibility problem.

Port of ilqr_iterative_tasks_tpu/ops/al_ilqr.py. The problem is that of
ops/lm_shooting.py (hit ``x_terminal`` to 1e-4, keep x_1..x_{N-1} outside
the obstacle ellipse, bounded inputs; the min-time cost is constant):

- terminal equality  -> lam^T d + (mu / 2) |d|^2, d = x_N - x_term;
- ellipse keep-out   -> (mu_g / 2) max(0, g + lam_g / mu_g)^2, g_i = 1 -
  ellipse value at x_i with the moving obstacle extrapolated i steps;
- input bounds       -> clipping in the forward pass (raw ``delta_max``);
- a control regularisation of 1e-6 for Quu's conditioning.

An outer AL loop (multiplier steps, penalties times 8 when the constraint
norm did not shrink to a quarter) around an inner LM-iLQR on the AL
objective with a 5-point line search (alphas 1, 1/2, 1/4, 1/16, 1/64).
The exact 2x2 box QP of control-limited DDP (``_boxqp_2x2``,
``_free_gains``) is kept beside it, as in the JAX module.

The JAX package's ``lax.while_loop``s become Python loops; the candidate
vmap becomes a loop over candidates (independent solves).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ilqr_iterative_tasks_torch.models import kinetic_bicycle as dyn
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.ilqr import _reg_inv_2x2, rollout
from ilqr_iterative_tasks_torch.utils.params import SystemLimits


def _reg_pd_2x2(quu: torch.Tensor, lamb) -> torch.Tensor:
    """Spectral clamp-and-shift returning the matrix itself: eigenvalues
    e -> max(e, 0) + lamb, eigenvectors kept."""
    a = quu[..., 0, 0]
    b = 0.5 * (quu[..., 0, 1] + quu[..., 1, 0])
    c = quu[..., 1, 1]
    mean = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(0.25 * (a - c) ** 2 + b * b, 0.0))
    e1, e2 = mean + disc, mean - disc
    f1 = torch.clamp_min(e1, 0.0) + lamb
    f2 = torch.clamp_min(e2, 0.0) + lamb
    safe = disc > 1e-12
    beta = torch.where(safe, (f1 - f2) / torch.where(safe, e1 - e2, 1.0), 1.0)
    alpha = f1 - beta * e1
    eye = torch.eye(2, dtype=quu.dtype, device=quu.device)
    sym = quu.clone()
    sym[..., 0, 1] = b
    sym[..., 1, 0] = b
    return alpha[..., None, None] * eye + beta[..., None, None] * sym


def _boxqp_2x2(quu: torch.Tensor, qu: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor):
    """Exact box-constrained 2x2 QP  min 0.5 du' Quu du + qu' du,
    lo <= du <= hi, Quu positive definite: of the interior point, the 4
    faces' 1-D minimizers and the 4 corners, the feasible one with the
    least objective. Returns (du (2,), free (2,) bool of unclamped dims)."""
    a = quu[0, 0]
    b = 0.5 * (quu[0, 1] + quu[1, 0])
    c = quu[1, 1]
    det = a * c - b * b
    du_ff = torch.stack([(-qu[0] * c + qu[1] * b) / det,
                         (qu[0] * b - qu[1] * a) / det])
    f10 = lambda d1: -(qu[0] + b * d1) / a  # dim 0 free given dim 1 clamped
    f01 = lambda d0: -(qu[1] + b * d0) / c  # dim 1 free given dim 0 clamped
    s = torch.stack
    cand = s([
        du_ff,
        s([lo[0], f01(lo[0])]), s([hi[0], f01(hi[0])]),
        s([f10(lo[1]), lo[1]]), s([f10(hi[1]), hi[1]]),
        s([lo[0], lo[1]]), s([lo[0], hi[1]]),
        s([hi[0], lo[1]]), s([hi[0], hi[1]]),
    ])  # (9, 2)
    free = torch.tensor([[1, 1], [0, 1], [0, 1], [1, 0], [1, 0],
                         [0, 0], [0, 0], [0, 0], [0, 0]], dtype=torch.bool,
                        device=quu.device)
    tol = 1e-9
    feas = torch.all((cand >= lo - tol) & (cand <= hi + tol), dim=1)
    obj = 0.5 * torch.einsum("ki,ij,kj->k", cand, quu, cand) + cand @ qu
    obj = torch.where(feas, obj, torch.inf)
    best = torch.argmin(obj)
    return cand[best], free[best]


def _free_gains(quu: torch.Tensor, qux: torch.Tensor, free: torch.Tensor):
    """Feedback gains over the free input dims, -inv(Quu_ff) Qux_f, zero
    rows for clamped dims."""
    a = quu[0, 0]
    b = 0.5 * (quu[0, 1] + quu[1, 0])
    c = quu[1, 1]
    det = a * c - b * b
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    inv_both = torch.stack([torch.stack([c, -b]), torch.stack([-b, a])]) / det
    inv_0 = torch.stack([torch.stack([one, zero]),
                         torch.stack([zero, zero])]) / a
    inv_1 = torch.stack([torch.stack([zero, zero]),
                         torch.stack([zero, one])]) / c
    f0 = free[0].to(quu.dtype)
    f1 = free[1].to(quu.dtype)
    both = f0 * f1
    inv_eff = (both * inv_both + f0 * (1 - f1) * inv_0
               + (1 - f0) * f1 * inv_1)
    return -inv_eff @ qux


class AlIlqrSolution(NamedTuple):
    us: torch.Tensor  # (N, 2)
    xs: torch.Tensor  # (N+1, 4)
    term_err: torch.Tensor  # |x_N - x_term|_2
    max_violation: torch.Tensor  # max obstacle constraint value (<= 0 ok)
    feasible: torch.Tensor  # bool: terminal error <= 1e-4 and keep-out
    n_outer: torch.Tensor


def _obstacle_g(xs_mid, obstacle: Obstacle):
    """g_i = 1 - ellipse value at x_1..x_{N-1} (offsets i), present-masked."""
    n_mid = xs_mid.shape[0]
    offs = torch.arange(1, n_mid + 1, dtype=xs_mid.dtype,
                        device=xs_mid.device)
    cx, cy = obstacle.center_at(offs)
    val = ((xs_mid[:, 0] - cx) ** 2 / obstacle.width ** 2
           + (xs_mid[:, 1] - cy) ** 2 / obstacle.height ** 2)
    return obstacle.present * (1.0 - val)


def _al_terms(xs, x_terminal, lam_eq, mu_eq, lam_g, mu_g, obstacle):
    """The AL objective of a rollout (without the input regularisation)."""
    d = xs[-1] - x_terminal
    term = lam_eq @ d + 0.5 * mu_eq * (d @ d)
    g = _obstacle_g(xs[1:-1], obstacle)
    act = torch.clamp_min(g + lam_g / mu_g, 0.0)
    ineq = 0.5 * mu_g * torch.sum(act * act)
    return term + ineq


def al_ilqr_solve(limits: SystemLimits, obstacle: Obstacle, x0: torch.Tensor,
                  x_terminal: torch.Tensor, u_init: torch.Tensor, dt,
                  *, num_horizon: int, max_outer: int = 25,
                  max_inner: int = 60, u_reg: float = 1e-6,
                  term_tol: float = 1e-4, viol_tol: float = 1e-6,
                  mu0: float = 10.0, mu_factor: float = 8.0,
                  mu_max: float = 1e8) -> AlIlqrSolution:
    """Solve one candidate's feasibility problem by AL-iLQR."""
    if num_horizon < 2:
        raise ValueError("al_ilqr_solve requires num_horizon >= 2; the "
                         "horizon-1 case is a pure reach check handled by the "
                         "controller (nonlinear_lmpc.py:199-213).")
    n = num_horizon
    dtype, dev = x0.dtype, x0.device
    n_mid = max(n - 1, 1)
    a_max = limits.a_max.to(dtype)
    d_max = limits.delta_max.to(dtype)
    eye2 = torch.eye(2, dtype=dtype, device=dev)
    eye4 = torch.eye(4, dtype=dtype, device=dev)

    def clip_u(us):
        a = torch.clamp(us[..., 0], -a_max, a_max)
        d = torch.clamp(us[..., 1], -d_max, d_max)
        return torch.stack([a, d], dim=-1)

    def al_objective(us, lam_eq, mu_eq, lam_g, mu_g):
        xs = rollout(x0, us, dt)
        obj = _al_terms(xs, x_terminal, lam_eq, mu_eq, lam_g, mu_g, obstacle)
        return obj + u_reg * torch.sum(us * us), xs

    def backward(xs, us, lam_eq, mu_eq, lam_g, mu_g, lamb):
        f_x = dyn.jacobian_A(xs[1:, 2], xs[1:, 3], us[:, 0], dt)
        f_u = dyn.jacobian_B(xs[1:, 3], dt)
        # stages indexed by the state they start from; the obstacle term
        # of x_i (i >= 1) is charged to stage i
        offs = torch.arange(n, dtype=dtype, device=dev)
        cx, cy = obstacle.center_at(offs)
        dz = xs[:-1, 0] - cx
        dy_ = xs[:-1, 1] - cy
        inv_w2 = 1.0 / obstacle.width ** 2
        inv_h2 = 1.0 / obstacle.height ** 2
        g = obstacle.present * (1.0 - (dz * dz * inv_w2 + dy_ * dy_ * inv_h2))
        lam_full = torch.cat([torch.zeros((1,), dtype=dtype, device=dev),
                              lam_g])
        mask = torch.cat([torch.zeros((1,), dtype=dtype, device=dev),
                          torch.ones((n - 1,), dtype=dtype, device=dev)]
                         ) * obstacle.present
        act = torch.clamp_min(g + lam_full / mu_g, 0.0) * mask
        zz = torch.zeros_like(dz)
        g_x = torch.stack([-2.0 * inv_w2 * dz, -2.0 * inv_h2 * dy_, zz, zz],
                          dim=-1)
        l_x = (mu_g * act)[:, None] * g_x
        l_xx = (mu_g * (act > 0))[:, None, None] * (
            g_x[:, :, None] * g_x[:, None, :])  # Gauss-Newton
        l_u = 2.0 * u_reg * us
        l_uu = (2.0 * u_reg * eye2).expand(n, 2, 2)
        d = xs[-1] - x_terminal
        v_x = lam_eq + mu_eq * d
        v_xx = mu_eq * eye4
        ks, big_ks = [None] * n, [None] * n
        for i in range(n - 1, -1, -1):
            fx, fu = f_x[i], f_u[i]
            q_x = l_x[i] + fx.T @ v_x
            q_u = l_u[i] + fu.T @ v_x
            q_xx = l_xx[i] + fx.T @ v_xx @ fx
            q_uu = l_uu[i] + fu.T @ v_xx @ fu
            q_ux = fu.T @ v_xx @ fx
            quu_inv = _reg_inv_2x2(q_uu, lamb)
            k_t = -quu_inv @ q_u
            big_k = -quu_inv @ q_ux
            v_x = q_x - big_k.T @ q_uu @ k_t
            v_xx = q_xx - big_k.T @ q_uu @ big_k
            ks[i], big_ks[i] = k_t, big_k
        return torch.stack(ks), torch.stack(big_ks)

    def forward(xs, us, ks, big_ks, alpha):
        """Line-searched closed-loop rollout u + alpha k + K (x_new - x)."""
        x_new, us_new = xs[0], []
        for i in range(n):
            u_new = clip_u(us[i] + alpha * ks[i] + big_ks[i] @ (x_new - xs[i]))
            x_new = dyn.step(x_new, u_new, dt)
            us_new.append(u_new)
        return torch.stack(us_new)

    alphas = torch.tensor([1.0, 0.5, 0.25, 0.0625, 0.015625], dtype=dtype,
                          device=dev)

    def inner_solve(us, lam_eq, mu_eq, lam_g, mu_g):
        lamb = torch.tensor(1.0, dtype=dtype, device=dev)
        for _ in range(max_inner):
            obj, xs = al_objective(us, lam_eq, mu_eq, lam_g, mu_g)
            ks, big_ks = backward(xs, us, lam_eq, mu_eq, lam_g, mu_g, lamb)
            us_cands = [forward(xs, us, ks, big_ks, a) for a in alphas]
            objs = torch.stack([al_objective(u, lam_eq, mu_eq, lam_g, mu_g)[0]
                                for u in us_cands])
            best = int(torch.argmin(objs))
            obj_new = objs[best]
            accept = bool(obj_new < obj)
            if accept:
                us = us_cands[best]
            lamb = lamb * 0.5 if accept else lamb * 4.0
            rel = torch.abs(obj_new - obj) / torch.clamp_min(torch.abs(obj),
                                                             1e-12)
            if (accept and bool(rel < 1e-9)) or (not accept
                                                 and bool(lamb > 1e8)):
                break
        return us

    def metrics(us):
        xs = rollout(x0, us, dt)
        d = xs[-1] - x_terminal
        term_err = torch.sqrt(torch.clamp_min(d @ d, 0.0))
        g = _obstacle_g(xs[1:-1], obstacle)
        return xs, term_err, torch.max(g)

    def constraint_norm(us):
        xs = rollout(x0, us, dt)
        d = xs[-1] - x_terminal
        g = _obstacle_g(xs[1:-1], obstacle)
        return torch.sqrt(d @ d + torch.sum(torch.clamp_min(g, 0.0) ** 2))

    us = clip_u(u_init)
    lam_eq = torch.zeros((4,), dtype=dtype, device=dev)
    lam_g = torch.zeros((n_mid,), dtype=dtype, device=dev)
    mu_eq = mu_g = torch.tensor(mu0, dtype=dtype, device=dev)
    prev_norm = torch.tensor(torch.inf, dtype=dtype, device=dev)
    k = 0
    while k < max_outer:
        _, term_err, viol = metrics(us)
        if bool(term_err <= 0.5 * term_tol) and bool(viol <= viol_tol):
            break
        us = inner_solve(us, lam_eq, mu_eq, lam_g, mu_g)
        xs = rollout(x0, us, dt)
        d = xs[-1] - x_terminal
        g = _obstacle_g(xs[1:-1], obstacle)
        lam_eq = lam_eq + mu_eq * d
        lam_g = torch.clamp_min(lam_g + mu_g * g, 0.0)
        norm = constraint_norm(us)
        factor = mu_factor if bool(norm > 0.25 * prev_norm) else 1.0
        mu_eq = torch.clamp_max(mu_eq * factor, mu_max)
        mu_g = torch.clamp_max(mu_g * factor, mu_max)
        prev_norm = norm
        k += 1
    xs, term_err, viol = metrics(us)
    feasible = (term_err <= term_tol) & (viol <= 1e-4)
    return AlIlqrSolution(us=us, xs=xs, term_err=term_err,
                          max_violation=viol, feasible=feasible,
                          n_outer=torch.tensor(k, device=dev))


def al_ilqr_solve_candidates(limits: SystemLimits, obstacle: Obstacle,
                             x0: torch.Tensor, x_terminals: torch.Tensor,
                             u_inits: torch.Tensor, dt, *, num_horizon: int,
                             max_outer: int = 25,
                             max_inner: int = 60) -> AlIlqrSolution:
    """Independent solves of candidates x_terminals (B, 4) with warm starts
    u_inits (B, N, 2); outputs over B first."""
    sols = [al_ilqr_solve(limits, obstacle, x0, xt, ui, dt,
                          num_horizon=num_horizon, max_outer=max_outer,
                          max_inner=max_inner)
            for xt, ui in zip(x_terminals, u_inits)]
    return AlIlqrSolution(*(torch.stack(f) for f in zip(*sols)))
