"""Structure-of-arrays (batch-trailing) projected LM shooting solve in plain
torch ops: the NLMPC candidate feasibility NLP.

Port of ilqr_iterative_tasks_tpu/ops/lm_shooting_soa.py
(``lm_feasibility_solve_soa`` :76, ``_clip_grad`` / ``_relu_grad`` :61-73).
Per lane: minimise |r(u)|^2 over the clipped inputs, where r stacks the
terminal error at the lane's horizon m and the obstacle rows
sqrt(w) * present * max(g_k + margin, 0), k = 1..n-1, by projected LM with
the closed-form prefix-sum Jacobian, the dual (n+3)x(n+3) Cholesky solve
du = -J^T (J J^T + lam I)^-1 r (pivots floored at sqrt(max(d, tiny))), a
5-point line search over alphas (1, 0.5, 0.25, 0.1, 0.02) keeping strictly
better points, lam from 1e-3, max(0.33 lam, 1e-12) on accept and 4 lam on
reject, and stop at f < 1e-14 or a reject with lam > 1e10; from the clipped
warm start and from zeros, the warm start winning ties. The verdict is
taken at x_m: term_err <= 1e-4 and every obstacle row k < m violated by at
most 1e-4.

Each entry is computed as the JAX function computes it, operation by
operation, so f64 results agree lane for lane; the small algebra is
vectorised over leading axes (Jacobian entries, Cholesky columns, line
search alphas) without changing any lane's sequence of roundings. Sums
that the JAX function takes over the non-zero entries only (gram entries,
J^T z) add the structural zeros here, which adds exact zeros. The CUDA
kernels (csrc/nlmpc_core.cuh) compute the same per lane.

Differences from the JAX function:

- the obstacle arrives packed as lanes, ``obs`` (7, *S) =
  [cx, cy, 1/w^2, 1/h^2, spd_up, spd_left, present]
  (ops/fused_lm_shooting.py::obstacle_to_lanes_nlmpc);
- ``done0`` lets lanes start frozen in both starts (the kernels' ``skip``);
- the lockstep loop stops as soon as every lane is done, as JAX's
  ``any(~done)`` condition does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ilqr_iterative_tasks_torch.ops.ilqr_soa import step_soa
from ilqr_iterative_tasks_torch.utils.params import SystemLimits, nlmpc_consts

ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.02)  # line search, ops/lm_shooting.py:88


class LmSoaSolution(NamedTuple):
    us: torch.Tensor  # (N, 2, *S)
    xs: torch.Tensor  # (N+1, 4, *S)
    term_err: torch.Tensor  # (*S)
    max_violation: torch.Tensor  # (*S)
    feasible: torch.Tensor  # (*S) bool
    n_iters: torch.Tensor  # (*S) summed over starts


def _clip_grad(z, m):
    """d/dz clip(z, -m, m) with JAX's 0.5 tie convention at |z| == m."""
    a = torch.abs(z)
    return (a < m).to(z.dtype) + 0.5 * (a == m).to(z.dtype)


def _relu_grad(z):
    """d/dz max(z, 0) with JAX's 0.5 tie convention at z == 0."""
    return (z > 0).to(z.dtype) + 0.5 * (z == 0).to(z.dtype)


def _to_lanes(t, lead, s_shape):
    """(*lead dims, *S') -> (*lead dims, *S): S' is a trailing part of S."""
    head, tail = tuple(t.shape[:lead]), tuple(t.shape[lead:])
    pad = (1,) * (len(s_shape) - len(tail))
    return t.reshape(head + pad + tail).expand(head + s_shape)


def _at(stacked, idx):
    """stacked[idx] per lane: stacked (L, *A), idx (*A-broadcastable) i64."""
    idx = idx.expand(stacked.shape[1:])[None]
    return stacked.gather(0, idx)[0]


def lm_feasibility_solve_soa(limits: SystemLimits, obs, x0, x_terminal,
                             u_init, dt, *, num_horizon: int, max_iters: int,
                             m_lanes, done0,
                             zeros_skip: bool = False) -> LmSoaSolution:
    """Batched candidate-feasibility solve, batch-trailing layout.

    obs: (7, *S) obstacle lanes; x0: (4, *S); x_terminal: (4, *S);
    u_init: (N, 2, *S) warm start (clipped here). obs, x0 and u_init may
    drop leading lane axes of *S (broadcast over them);
    m_lanes: (*S) integer effective horizon in [2, N] (terminal rows read
    x_m, obstacle rows k >= m and input columns j >= m drop out);
    done0: (*S) bool lanes that run no iteration.
    ``zeros_skip`` (the JAX kernels' ``skip_converged_starts``,
    _pallas_nlmpc_core.py:306-345): the warm start is solved first, and a
    lane whose warm residual is < 1e-14 enters the zeros start done (its
    unsolved zeros residual then loses the strict f_z < f_w). It changes
    results: the zeros start may land on a smaller residual.
    """
    n = num_horizon
    if n < 2:
        raise ValueError("horizon-1 is a pure reach check handled by the "
                         "controller (nonlinear_lmpc.py:199-213)")
    C = nlmpc_consts(limits, dt)
    nvar, m = 2 * n, n + 3
    dtype, dev = x_terminal.dtype, x_terminal.device
    s_shape = tuple(x_terminal.shape[1:])
    dt, a_max, d_max = C.dt, C.a_max, C.d_max
    floor = 1e-300 if dtype == torch.float64 else 1e-38
    x0 = _to_lanes(x0, 1, s_shape)
    obs = _to_lanes(obs, 1, s_shape)
    u_init = _to_lanes(u_init, 2, s_shape)
    mm_s = torch.as_tensor(m_lanes, device=dev).to(torch.int64).expand(s_shape)

    # Iterates carry two leading axes (alpha, start) ahead of the lanes;
    # per-lane values get singleton axes there, so every rank is fixed.
    lane = lambda t: t.reshape((1, 1) + s_shape)
    x0c = [lane(x0[i]) for i in range(4)]
    xt = [lane(x_terminal[i]) for i in range(4)]
    ox, oy, iw, ih, su, sl, present = (lane(obs[i]) for i in range(7))
    mm = lane(mm_s)
    one = (1,) * (2 + len(s_shape))
    kv = torch.arange(1, n, dtype=dtype, device=dev).reshape((n - 1,) + one)
    ki = torch.arange(1, n, device=dev)
    ji = torch.arange(n, device=dev)
    row_on = ki.reshape((n - 1,) + one) < mm  # obstacle row k exists at m
    col_on = ji.reshape((n,) + one) < mm  # input column j is a variable
    below = (ji[None] < ki[:, None]).reshape((n - 1, n) + one)  # j < k
    cx = ox - sl * kv  # obstacle centre k steps ahead
    cy = oy + su * kv
    sw_p = C.sqrt_w * present
    zero = torch.zeros((), dtype=dtype, device=dev)

    def clip_u(uf):
        return (torch.clamp(uf[0::2], -a_max, a_max),
                torch.clamp(uf[1::2], -d_max, d_max))

    def rollout(ua, ud, start):
        xs = [tuple(c.expand(ua.shape[1:]) for c in start)]
        for j in range(n):
            xs.append(step_soa(xs[-1], (ua[j], ud[j]), dt))
        return [torch.stack([x[i] for x in xs]) for i in range(4)]

    def obstacle_g(px, py):
        """g_k = 1 - (dx^2/w^2 + dy^2/h^2) for k = 1..n-1, and dx, dy."""
        dx = px[1:n] - cx
        dy = py[1:n] - cy
        return 1.0 - (dx * dx * iw + dy * dy * ih), dx, dy

    def residual(uf):
        """uf (nvar, A, S, *S) -> (f, rows (m, A, S, *S), xs components)."""
        ua, ud = clip_u(uf)
        px, py, v, th = xs = rollout(ua, ud, x0c)
        term = [_at(xs[i], mm) - xt[i] for i in range(4)]
        g, _, _ = obstacle_g(px, py)
        r = sw_p * torch.clamp_min(g + C.margin, 0.0)
        r = torch.where(row_on, r, zero)
        rows = torch.cat([torch.stack(term), r])
        rr = rows * rows
        f = rr[0]
        for i in range(1, m):
            f = f + rr[i]
        return f, rows, xs

    def jacobian(uf, xs):
        """Closed-form J (m, nvar, A, S, *S), structural zeros included."""
        ua, _ = clip_u(uf)
        px, py, v, th = xs
        cos_t, sin_t = torch.cos(th[:n]), torch.sin(th[:n])
        arc = v[:n] * dt + 0.5 * ua * dt * dt
        inc = torch.stack([cos_t * dt * dt, (-arc * sin_t) * dt,
                           sin_t * dt * dt, arc * cos_t * dt])
        cum = [torch.zeros_like(inc[:, 0])] * 2  # cum[k] = sum_{i=1}^{k-1}
        for i in range(1, n):
            cum.append(cum[-1] + inc[:, i])
        cum = torch.stack(cum, dim=1)  # (4, n+1, ...)
        b00 = 0.5 * dt * dt * cos_t
        b10 = 0.5 * dt * dt * sin_t
        mask_a = torch.where(col_on, _clip_grad(uf[0::2], a_max), zero)
        mask_d = torch.where(col_on, _clip_grad(uf[1::2], d_max), zero)
        cum_m = _at(cum.transpose(0, 1), mm)  # (4, ...): cum_q[m]
        nxt = cum[:, 1:]  # cum_q[j+1]
        # terminal rows: d (x_m - xt) / d u
        sa0 = b00 + cum_m[0] - nxt[0]
        sd0 = cum_m[1] - nxt[1]
        sa1 = b10 + cum_m[2] - nxt[2]
        sd1 = cum_m[3] - nxt[3]
        z = torch.zeros_like(mask_a)
        pair = lambda a, d: torch.stack([a, d], dim=1).reshape(
            (nvar,) + a.shape[1:])
        term = torch.stack([pair(sa0 * mask_a, sd0 * mask_d),
                            pair(sa1 * mask_a, sd1 * mask_d),
                            pair(dt * mask_a, z), pair(z, dt * mask_d)])
        # obstacle rows k = 1..n-1 over columns j < k
        g, dx, dy = obstacle_g(px, py)
        gate = torch.where(row_on, sw_p * _relu_grad(g + C.margin), zero)
        gx = gate * (-2.0 * iw) * dx
        gy = gate * (-2.0 * ih) * dy
        ck = cum[:, 1:n, None]  # cum_q[k] (4, n-1, 1, ...)
        ka0 = b00[None] + ck[0] - nxt[0][None]
        kd0 = ck[1] - nxt[1][None]
        ka1 = b10[None] + ck[2] - nxt[2][None]
        kd1 = ck[3] - nxt[3][None]
        oa = (gx[:, None] * ka0 + gy[:, None] * ka1) * mask_a[None]
        od = (gx[:, None] * kd0 + gy[:, None] * kd1) * mask_d[None]
        oa = torch.where(below, oa, zero)
        od = torch.where(below, od, zero)
        obst = torch.stack([oa, od], dim=2).reshape((n - 1, nvar)
                                                    + oa.shape[2:])
        return torch.cat([term, obst])

    def lm_step(uf, rows, xs, lam):
        """du = -J^T (J J^T + lam I)^-1 r by a scalar Cholesky."""
        jac = jacobian(uf, xs)
        gram = jac[:, None, 0] * jac[None, :, 0]
        for j in range(1, nvar):
            gram = gram + jac[:, None, j] * jac[None, :, j]
        a = gram.clone()
        diag = torch.arange(m, device=dev)
        a[diag, diag] = a[diag, diag] + lam
        inv = []
        for t in range(m):  # right-looking: entry (r, c) sees t = 0..c-1
            ld = torch.sqrt(torch.clamp_min(a[t, t], floor))
            inv.append(1.0 / ld)
            a[t + 1:, t] = a[t + 1:, t] * inv[t]
            a[t + 1:, t + 1:] = (a[t + 1:, t + 1:]
                                 - a[t + 1:, None, t] * a[None, t + 1:, t])
        v = rows.clone()
        y = []
        for t in range(m):
            y.append(v[t] * inv[t])
            v[t + 1:] = v[t + 1:] - a[t + 1:, t] * y[t]
        zs = [None] * m
        for r in range(m - 1, -1, -1):
            acc = y[r]
            for t in range(r + 1, m):
                acc = acc - a[t, r] * zs[t]
            zs[r] = acc * inv[r]
        acc = jac[0] * zs[0]
        for r in range(1, m):
            acc = acc + jac[r] * zs[r]
        return -acc

    alphas = torch.tensor(ALPHAS, dtype=dtype, device=dev).reshape(
        (1, len(ALPHAS), 1) + (1,) * len(s_shape))
    warm = torch.stack([
        torch.clamp(u_init[j // 2, j % 2], -a_max, a_max) if j % 2 == 0
        else torch.clamp(u_init[j // 2, j % 2], -d_max, d_max)
        for j in range(nvar)])

    def lm(uf, done):
        """The LM loop of starts uf (nvar, 1, S, *S) from done (1, S, *S):
        (the iterates, their trips (1, S, *S) i32)."""
        lam = torch.full(done.shape, 1e-3, dtype=dtype, device=dev)
        it_lane = torch.zeros(done.shape, dtype=torch.int32, device=dev)
        for _ in range(max_iters):
            if bool(done.all()):
                break
            f0, rows, xs = residual(uf)
            du = lm_step(uf, rows, xs, lam)
            cand = uf + alphas * du  # (nvar, 5, S, *S)
            fc, _, _ = residual(cand)
            best_f, best_uf = fc[0:1], cand[:, 0:1]
            for i in range(1, len(ALPHAS)):
                better = fc[i:i + 1] < best_f
                best_f = torch.where(better, fc[i:i + 1], best_f)
                best_uf = torch.where(better[None], cand[:, i:i + 1],
                                      best_uf)
            accept = best_f < f0
            upd = accept & ~done
            uf = torch.where(upd[None], best_uf, uf)
            lam_next = torch.where(
                done, lam, torch.where(accept,
                                       torch.clamp_min(lam * 0.33, 1e-12),
                                       lam * 4.0))
            f_new = torch.where(accept, best_f, f0)
            stop = (f_new < 1e-14) | (~accept & (lam_next > 1e10))
            it_lane = it_lane + (~done).to(torch.int32)
            lam = lam_next
            done = done | stop
        return uf, it_lane

    # the two starts: clipped warm, zeros (ops/lm_shooting.py:120-123)
    done = (torch.as_tensor(done0, device=dev).to(torch.bool).expand(s_shape)
            .reshape((1, 1) + s_shape))
    if not zeros_skip:  # both starts in one loop
        uf = torch.stack([warm, torch.zeros_like(warm)], dim=1)[:, None]
        uf, it_lane = lm(uf.contiguous(), done.expand((1, 2) + s_shape))
    else:  # the warm start, then zeros where the warm one did not converge
        uf_w, it_w = lm(warm[:, None, None].contiguous(), done)
        zdone = done | (residual(uf_w)[0] < 1e-14)
        uf_z, it_z = lm(torch.zeros_like(uf_w), zdone)
        uf, it_lane = (torch.cat([uf_w, uf_z], dim=2),
                       torch.cat([it_w, it_z], dim=1))

    f_fin, _, _ = residual(uf)
    better = f_fin[0, 1] < f_fin[0, 0]  # strict: the warm start wins ties
    uf_best = torch.where(better[None], uf[:, 0, 1], uf[:, 0, 0])
    ua, ud = clip_u(uf_best)
    xs = rollout(ua, ud, [x0[i] for i in range(4)])  # 4 x (n+1, *S)
    dd = [_at(xs[i], mm_s) - x_terminal[i] for i in range(4)]
    d2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2] + dd[3] * dd[3]
    term_err = torch.sqrt(torch.clamp_min(d2, 0.0))
    viol = None
    for k in range(1, n):
        ddx = xs[0][k] - cx[k - 1, 0, 0]
        ddy = xs[1][k] - cy[k - 1, 0, 0]
        g = obs[6] * (1.0 - (ddx * ddx * obs[2] + ddy * ddy * obs[3]))
        g = torch.where(k < mm_s, g, -torch.inf)  # row absent at horizon m
        viol = g if viol is None else torch.maximum(viol, g)
    feasible = (term_err <= C.term_tol) & (viol <= C.viol_tol)
    return LmSoaSolution(
        us=torch.stack([ua, ud], dim=1),
        xs=torch.stack([torch.stack([xs[i][k] for i in range(4)])
                        for k in range(n + 1)]),
        term_err=term_err, max_violation=viol, feasible=feasible,
        n_iters=it_lane.sum(dim=(0, 1)))
