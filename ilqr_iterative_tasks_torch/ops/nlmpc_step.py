"""One whole NLMPC control step per lane: the K2 kernel
(csrc/nlmpc_step.cu) and its plain version.

Port of ilqr_iterative_tasks_tpu/ops/pallas_nlmpc_step.py
(``build_fused_nlmpc_step``, mode "spaceVarying"). Per lane, at the lane's
shrinking horizon ``hzn``: an L1-kNN of the terminal guess over the last
nsi stored laps, the k candidates' projected-LM feasibility solves at
m = clip(hzn, 2, n) from the clipped warm start and from zeros (lanes with
hzn <= 1 run no LM iteration and are judged by the pure reach check from
one step of the raw first warm input, |x1 - x_term| <= 1e-3), the
candidate cost hzn + Qfun where feasible, the lexicographic row-min over
laps (absent slots rank -inf in the row compare, laps not yet stored +inf)
with a first-min argmin in the winning row, and the winner's solution.
Signature (batch trailing):

    (x (4,B), guess (4,B), u_warm (n,2,B), states (max_laps,T,4,B),
     qfun (max_laps,T,B), lap_len (max_laps,B) i32, lap_ids (nsi,) i32,
     lap_ok (nsi,) i32, obs (7,B), skip (B,) f32, hzn (B,) i32)
    -> (us (n,2,B), feasible_any (B,), new_guess (4,B), idx_sel (B,) i32,
        row_sel (B,) i32, succ (B,))

``new_guess`` is the pre-freeze guess advance: the chosen point's
successor in its lap when ``succ`` (idx_sel + 1 <= len_sel - 1), else the
winner's horizon-m prediction (x_term for hzn <= 1 lanes). Lanes with
skip=1 return zeros. ``nlmpc_step_reference`` is the plain version: the
JAX package's composed XLA path (control/batched_nlmpc_soa.py
``solve_step_general``, :289-505), with hzn <= 1 lanes entering their
solves frozen as the TPU kernel does (their solutions are never read).
"""

from __future__ import annotations

import torch

from ilqr_iterative_tasks_torch.ops import _build
from ilqr_iterative_tasks_torch.ops.fused_ilqr import DTYPE_CODES, check_lanes
from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
    _lex_argmin_rows, _topk_select)
from ilqr_iterative_tasks_torch.ops.ilqr_soa import step_soa
from ilqr_iterative_tasks_torch.ops.lm_shooting_soa import (
    lm_feasibility_solve_soa)
from ilqr_iterative_tasks_torch.utils.params import (
    LmpcParams, SystemLimits, nlmpc_consts)


def nlmpc_step_reference(params: LmpcParams, limits: SystemLimits, dt, x,
                         guess, u_warm, states, qfun, lap_len, lap_ids,
                         lap_ok, obs, skip, hzn, *, max_iters: int,
                         trips: list | None = None):
    """Plain version of K2 (module docstring). The candidate solves of all
    nsi laps run as one batched solve; the winner's solution is read from
    it (a candidate solve is a pure per-lane function, so this is the
    solution a re-solve would give). If ``trips`` is a list, the solves'
    trip counts are appended to it: (nsi*k, B) i32, summed over the two
    starts, 0 on skipped and horizon-1 lanes."""
    params.check_ported()
    n, k, nsi = params.num_horizon, params.num_ss_points, params.num_ss_iter
    t_rows = states.shape[1]
    b = x.shape[-1]
    dtype, dev = x.dtype, x.device
    inf = float("inf")
    laps = [int(v) for v in lap_ids.tolist()]
    oks = [bool(v) for v in lap_ok.tolist()]
    active = skip <= 0.5
    hzn = hzn.to(torch.int64)
    m2 = torch.clamp(hzn, 2, n)
    h1 = hzn <= 1
    x1 = torch.stack(step_soa(tuple(x[i] for i in range(4)),
                              (u_warm[0, 0], u_warm[0, 1]), dt))
    t_idx = torch.arange(t_rows, device=dev)[:, None]

    idx_rows, q_rows, struct_rows, xt_rows = [], [], [], []
    for off in range(nsi):
        st = states[laps[off]]  # (T, 4, B)
        dist = (torch.abs(st[:, 0] - guess[0][None])
                + torch.abs(st[:, 1] - guess[1][None])
                + torch.abs(st[:, 2] - guess[2][None])
                + torch.abs(st[:, 3] - guess[3][None]))
        dist = torch.where(t_idx < lap_len[laps[off]][None], dist, inf)
        idx, dval, (x0s, x1s, x2s, x3s, q) = _topk_select(
            dist, k, [st[:, 0], st[:, 1], st[:, 2], st[:, 3],
                      qfun[laps[off]]])
        idx_rows.append(idx)
        q_rows.append(q)
        struct_rows.append(torch.isfinite(dval))
        xt_rows.append(torch.stack([x0s, x1s, x2s, x3s]))
    x_terms = torch.cat(xt_rows, dim=1)  # (4, nsi*k, B)
    struct = torch.cat(struct_rows)  # (nsi*k, B): a stored row was found
    sol = lm_feasibility_solve_soa(
        limits, obs, x, x_terms, u_warm, dt, num_horizon=n,
        max_iters=max_iters, m_lanes=m2, done0=~active | h1)
    if trips is not None:
        trips.append(sol.n_iters)
    dr = [x1[i][None] - x_terms[i] for i in range(4)]
    reach = torch.sqrt(dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
                       + dr[3] * dr[3]) <= 1e-3
    feas = torch.where(h1[None], reach, sol.feasible)
    lap_ok_kb = torch.tensor(oks, device=dev).repeat_interleave(k)[:, None]
    cost = torch.where(feas & struct & lap_ok_kb,
                       hzn.to(dtype)[None] + torch.cat(q_rows), inf)
    # ragged Python-list comparison (batched_nlmpc_soa.py:411-422)
    cmp = torch.where(lap_ok_kb, torch.where(struct, cost, -inf), inf)
    best_row = _lex_argmin_rows(cmp.reshape(nsi, k, b))
    row_cost = cost.reshape(nsi, k, b).gather(
        0, best_row[None, None].expand(1, k, b))[0]
    best_col = torch.argmin(row_cost, dim=0)  # first-min
    feasible_any = torch.isfinite(row_cost.gather(0, best_col[None])[0])
    win = best_row * k + best_col  # (B,)
    idx_sel = torch.cat(idx_rows).gather(0, win[None])[0]
    us_w = sol.us.gather(2, win[None, None, None].expand(n, 2, 1, b))[:, :, 0]
    xs_w = sol.xs.gather(2, win[None, None, None].expand(n + 1, 4, 1, b))
    x_pred = xs_w[:, :, 0].gather(0, m2[None, None].expand(1, 4, b))[0]
    xt_sel = x_terms.gather(1, win[None, None].expand(4, 1, b))[:, 0]
    x_pred = torch.where(h1[None], xt_sel, x_pred)
    lap_sel = torch.tensor(laps, device=dev)[best_row]  # (B,)
    len_sel = lap_len.gather(0, lap_sel[None])[0]
    succ = (idx_sel + 1) <= (len_sel - 1)
    nxt = torch.clamp(idx_sel + 1, 0, t_rows - 1)
    lanes = torch.arange(b, device=dev)
    x_succ = states[lap_sel, nxt, :, lanes].T  # (4, B)
    new_guess = torch.where(succ[None], x_succ, x_pred)
    return (torch.where(active, us_w, 0.0),
            torch.where(active, feasible_any, False).to(dtype),
            torch.where(active, new_guess, 0.0),
            torch.where(active, idx_sel, 0).to(torch.int32),
            torch.where(active, best_row, 0).to(torch.int32),
            torch.where(active, succ, False).to(dtype))


class FusedNlmpcStep:
    """K2: one whole NLMPC control step per lane (spaceVarying). Attributes
    k, nsi, num_horizon, max_steps, max_laps and max_iters describe what it
    was built for; ``launches`` counts kernel launches."""

    def __init__(self, params: LmpcParams, limits: SystemLimits, dt, *,
                 num_horizon: int, max_steps: int, max_laps: int,
                 max_iters: int = 60):
        params.check_ported()
        if num_horizon != params.num_horizon:
            raise ValueError(f"num_horizon={num_horizon} differs from "
                             f"params.num_horizon={params.num_horizon}")
        if num_horizon < 2:
            raise ValueError("horizon-1 is a pure reach check handled by the "
                             "controller (nonlinear_lmpc.py:199-213)")
        self.params, self.limits, self.dt = params, limits, float(dt)
        self.k = params.num_ss_points
        self.nsi = params.num_ss_iter
        self.num_horizon = num_horizon
        self.max_steps = max_steps
        self.max_laps = max_laps
        self.max_iters = max_iters
        self._consts = _build.nlmpc_consts_array(nlmpc_consts(limits, dt))
        self.launches = 0

    def __call__(self, x, guess, u_warm, states, qfun, lap_len, lap_ids,
                 lap_ok, obs, skip, hzn):
        if x.device.type == "cpu":
            return nlmpc_step_reference(
                self.params, self.limits, self.dt, x, guess, u_warm, states,
                qfun, lap_len, lap_ids, lap_ok, obs, skip, hzn,
                max_iters=self.max_iters)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        dev, dtype = x.device, x.dtype
        if dtype not in DTYPE_CODES:
            raise TypeError(f"unsupported dtype {dtype}")
        n, nsi, t_rows, ml = (self.num_horizon, self.nsi, self.max_steps,
                              self.max_laps)
        b = x.shape[-1]
        check_lanes("x", x, (4, b), dtype, dev)
        check_lanes("guess", guess, (4, b), dtype, dev)
        check_lanes("u_warm", u_warm, (n, 2, b), dtype, dev)
        check_lanes("states", states, (ml, t_rows, 4, b), dtype, dev)
        check_lanes("qfun", qfun, (ml, t_rows, b), dtype, dev)
        check_lanes("lap_len", lap_len, (ml, b), torch.int32, dev)
        check_lanes("lap_ids", lap_ids, (nsi,), torch.int32, dev)
        check_lanes("lap_ok", lap_ok, (nsi,), torch.int32, dev)
        check_lanes("obs", obs, (7, b), dtype, dev)
        check_lanes("skip", skip, (b,), torch.float32, dev)
        check_lanes("hzn", hzn, (b,), torch.int32, dev)
        us = torch.empty((n, 2, b), dtype=dtype, device=dev)
        feasible_any = torch.empty((b,), dtype=dtype, device=dev)
        new_guess = torch.empty((4, b), dtype=dtype, device=dev)
        idx_sel = torch.empty((b,), dtype=torch.int32, device=dev)
        row_sel = torch.empty((b,), dtype=torch.int32, device=dev)
        succ = torch.empty((b,), dtype=dtype, device=dev)
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.nlmpc_step_launch(
                DTYPE_CODES[dtype], n, self.k, nsi, self._consts,
                self.max_iters, b, t_rows, x.data_ptr(), guess.data_ptr(),
                u_warm.data_ptr(), states.data_ptr(), qfun.data_ptr(),
                lap_len.data_ptr(), lap_ids.data_ptr(), lap_ok.data_ptr(),
                obs.data_ptr(), skip.data_ptr(), hzn.data_ptr(),
                us.data_ptr(), feasible_any.data_ptr(), new_guess.data_ptr(),
                idx_sel.data_ptr(), row_sel.data_ptr(), succ.data_ptr(),
                stream)
        _build.check_launch(rc, "nlmpc_step")
        self.launches += 1
        return us, feasible_any, new_guess, idx_sel, row_sel, succ


def build_fused_nlmpc_step(params: LmpcParams, limits: SystemLimits, dt, *,
                           num_horizon: int, max_steps: int, max_laps: int,
                           max_iters: int = 60) -> FusedNlmpcStep:
    """Factory mirroring the JAX package's ``build_fused_nlmpc_step`` in
    mode "spaceVarying" (none of its kernel options are ported; the
    shipped ``qsort_skip`` is bitwise-neutral for nsi = 1)."""
    return FusedNlmpcStep(params, limits, dt, num_horizon=num_horizon,
                          max_steps=max_steps, max_laps=max_laps,
                          max_iters=max_iters)
