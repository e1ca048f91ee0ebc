"""One whole NLMPC control step per lane: the K2 kernel
(csrc/nlmpc_step.cu, csrc/nlmpc_step_all.cu) and its plain version.

Port of ilqr_iterative_tasks_tpu/ops/pallas_nlmpc_step.py
(``build_fused_nlmpc_step``). Per lane, at the lane's shrinking horizon
``hzn``, the candidates of each lap row of the window (the last nsi stored
laps; with ``all_iter`` every slot), by safe-set mode (``LmpcParams.ss_mode``):

- spaceVarying: the k L1-nearest stored points of the terminal guess;
- timeVarying: the advancing window of k consecutive points from
  (len - 1) - min_cost + n + t, valid iff 0 < idx < len, falling back to
  the lap's last point when none is (min_cost: the least len - 1 over
  every stored lap);
- all: every stored point.

Then the candidates' projected-LM feasibility solves at m = clip(hzn, 2, n)
from the clipped warm start and from zeros (lanes with hzn <= 1 run no LM
iteration and are judged by the pure reach check from one step of the raw
first warm input, |x1 - x_term| <= 1e-3), the candidate cost hzn + Qfun
where feasible, the lexicographic row-min over laps (absent slots rank -inf
in the row compare, laps not yet stored +inf) with a first-min argmin in
the winning row, and the winner's solution. Signature (batch trailing):

    (x (4,B), guess (4,B), u_warm (n,2,B), states (max_laps,T,4,B),
     qfun (max_laps,T,B), lap_len (max_laps,B) i32, lap_ids (rows,) i32,
     lap_ok (rows,) i32, obs (7,B), skip (B,) f32, hzn (B,) i32
     [, t (B,) i32, min_cost (B,) i32: timeVarying only])
    -> (us (n,2,B), feasible_any (B,), new_guess (4,B), idx_sel (B,) i32,
        row_sel (B,) i32, succ (B,))

``new_guess`` is the pre-freeze guess advance: the chosen point's
successor in its lap when ``succ`` (idx_sel + 1 <= len_sel - 1), else the
winner's horizon-m prediction (x_term for hzn <= 1 lanes). Lanes with
skip=1 return zeros. ``nlmpc_step_reference`` is the plain version: the
JAX package's composed XLA path (control/batched_nlmpc_soa.py
``solve_step_general``, :289-505), with hzn <= 1 lanes entering their
solves frozen as the TPU kernel does (their solutions are never read).
Given a ``candidate_solver`` (K4, ops/fused_lm_shooting.py), its
candidate solves are that solver's instead: the JAX per-candidate path
(``pallas_solver``, :313-329, :396-400, :478-484). The plain step also
runs the kNN or the window over every stored lap (``all_ss_iter`` outside
mode all), which no K2 serves: the TPU factory refuses it too
(pallas_nlmpc_step.py:214-215).
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


def _window(ll, min_cost, t, n, k, t_rows):
    """timeVarying candidates of one lap row (batched_nlmpc_soa.py:346-376):
    (idx (k, B) clipped to [0, T-1], valid (k, B)). ll, min_cost, t: (B,)."""
    ij = (ll - 1 - min_cost + n + t)[None] + torch.arange(
        k, device=ll.device)[:, None]
    ok = (ij > 0) & (ij < ll[None])
    none = ~ok.any(dim=0)
    ij[0] = torch.where(none, ll - 1, ij[0])
    ok[0] = ok[0] | none
    return torch.clamp(ij, 0, t_rows - 1), ok


def nlmpc_step_reference(params: LmpcParams, limits: SystemLimits, dt, x,
                         guess, u_warm, states, qfun, lap_len, lap_ids,
                         lap_ok, obs, skip, hzn, t=None, min_cost=None, *,
                         max_iters: int, trips: list | None = None,
                         cands: list | None = None, candidate_solver=None):
    """Plain version of K2 (module docstring). spaceVarying and
    timeVarying: the candidate solves of all rows run as one batched solve
    and the winner's solution is read from it (a candidate solve is a pure
    per-lane function, so this is the solution a re-solve would give).
    all: one batched solve of the T positions a stored lap row (rows of
    laps not yet stored are not solved), then the winner is solved again.
    Candidates that no stored point backs (timeVarying, all) enter their
    solves done. If ``trips`` is a list, each candidate solve's trip counts
    are appended to it: (rows*k, B) or, for all, (T, B) a solved row, i32,
    summed over the two starts, 0 on skipped and horizon-1 lanes. If
    ``cands`` is a list, each candidate solve's candidates are appended to
    it as (Qfun, +inf where no stored point backs the candidate; whether
    its cost is finite), both shaped as its trips: what a kernel's solve
    schedule (qsort_skip, all_rev_skip, the forward all scan) turns on.

    ``candidate_solver``: a K4 built for the same limits, horizon and cap
    (``build_fused_lm_shooting``), called once for each batched candidate
    solve on its lanes (rows*k*B, or T*B a stored row in mode all) and
    once for the winner in mode all: the lane's state, clipped horizon and
    warm start on each of its candidates, and lanes that enter done
    (inactive, horizon 1, no stored point behind the candidate) skipped.
    In spaceVarying and timeVarying the winner's solution is read from the
    candidates' solve, as without it. The trip counts are the plain
    solve's only.

    With ``all_ss_iter`` outside mode all, lap_ids names every slot and the
    rows of laps not yet stored (a suffix: lap_ok is a prefix) are not
    solved at all: their costs are +inf and they rank above every stored
    row, so they never win and drop out with no change to the result."""
    if candidate_solver is not None and trips is not None:
        raise ValueError("trips counts the plain solve's iterations")
    mode = params.ss_mode
    n, k = params.num_horizon, params.num_ss_points
    if mode == "timeVarying" and (t is None or min_cost is None):
        raise ValueError("the timeVarying step needs t and min_cost")
    t_rows = states.shape[1]
    b = x.shape[-1]
    dtype, dev = x.dtype, x.device
    inf = float("inf")
    laps = [int(v) for v in lap_ids.tolist()]
    oks = [bool(v) for v in lap_ok.tolist()]
    if params.all_ss_iter and mode != "all":
        stored = sum(oks)
        if oks != [True] * stored + [False] * (len(oks) - stored):
            raise ValueError(f"all_ss_iter: lap_ok {oks} is not a prefix")
        laps, oks = laps[:stored], oks[:stored]
    rows = len(laps)
    active = skip <= 0.5
    hzn = hzn.to(torch.int64)
    m2 = torch.clamp(hzn, 2, n)
    h1 = hzn <= 1
    x1 = torch.stack(step_soa(tuple(x[i] for i in range(4)),
                              (u_warm[0, 0], u_warm[0, 1]), dt))
    t_idx = torch.arange(t_rows, device=dev)[:, None]
    lanes = torch.arange(b, device=dev)
    lap_t = torch.tensor(laps, device=dev)

    def solve_lanes(x_terms, done0):
        """The feasibility solves of x_terms (4, C, B) with done0 (C, B):
        (us (n, 2, C, B), x_m (4, C, B), feasible (C, B))."""
        c = x_terms.shape[1]
        if candidate_solver is None:
            sol = lm_feasibility_solve_soa(
                limits, obs, x, x_terms, u_warm, dt, num_horizon=n,
                max_iters=max_iters, m_lanes=m2, done0=done0)
            x_m = sol.xs.gather(0, m2[None, None, None].expand(1, 4, c, b))
            return sol.us, x_m[0], sol.feasible, sol.n_iters
        flat = lambda t: t[..., None, :].expand(*t.shape[:-1], c, b).reshape(
            *t.shape[:-1], c * b).contiguous()
        us_l, xm_l, _, fe_l = candidate_solver(
            flat(x), x_terms.reshape(4, c * b).contiguous(), flat(u_warm),
            flat(obs),
            done0.expand(c, b).to(torch.float32).reshape(c * b).contiguous(),
            flat(m2.to(torch.int32)))
        return (us_l.reshape(n, 2, c, b), xm_l.reshape(4, c, b),
                fe_l.reshape(c, b) > 0.5, None)

    def solve(x_terms, done0):
        us, x_m, feasible, n_iters = solve_lanes(x_terms, done0)
        if trips is not None:
            trips.append(n_iters)
        dr = [x1[i] - x_terms[i] for i in range(4)]
        reach = torch.sqrt(dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
                           + dr[3] * dr[3]) <= 1e-3
        return us, x_m, torch.where(h1, reach, feasible)

    if mode == "all":
        cost_rows, cmp_rows = [], []
        for lap, ok in zip(laps, oks):
            if not ok:  # a lap not yet stored: cost +inf, ranks +inf
                cost_rows.append(torch.full((t_rows, b), inf, dtype=dtype,
                                            device=dev))
                cmp_rows.append(cost_rows[-1])
                continue
            struct = t_idx < lap_len[lap][None]  # (T, B)
            _, _, feas = solve(states[lap].permute(1, 0, 2),
                               ~active | h1 | ~struct)
            cost = torch.where(feas & struct, hzn.to(dtype) + qfun[lap], inf)
            if cands is not None:
                cands.append((torch.where(struct, qfun[lap], inf),
                              torch.isfinite(cost)))
            cost_rows.append(cost)
            cmp_rows.append(torch.where(struct, cost, -inf))
        best_row = _lex_argmin_rows(torch.stack(cmp_rows))
        row_cost = torch.stack(cost_rows).gather(
            0, best_row[None, None].expand(1, t_rows, b))[0]
        idx_sel = torch.argmin(row_cost, dim=0)  # first-min
        feasible_any = torch.isfinite(row_cost.gather(0, idx_sel[None])[0])
        lap_sel = lap_t[best_row]
        xt_sel = states[lap_sel, idx_sel, :, lanes].T  # (4, B)
        # the winner again: the same pure per-lane solve
        us_w, x_pred, _, _ = solve_lanes(xt_sel[:, None], (~active | h1)[None])
        us_w, x_pred = us_w[:, :, 0], x_pred[:, 0]
    else:
        idx_rows, q_rows, struct_rows, xt_rows = [], [], [], []
        for lap in laps:
            st, qf = states[lap], qfun[lap]  # (T, 4, B), (T, B)
            if mode == "timeVarying":
                idx, struct = _window(lap_len[lap].to(torch.int64),
                                      min_cost.to(torch.int64),
                                      t.to(torch.int64), n, k, t_rows)
                xt = torch.stack([torch.where(
                    struct, st[:, c].gather(0, idx), 0.0) for c in range(4)])
                q = torch.where(struct, qf.gather(0, idx), 0.0)
            else:
                dist = (torch.abs(st[:, 0] - guess[0][None])
                        + torch.abs(st[:, 1] - guess[1][None])
                        + torch.abs(st[:, 2] - guess[2][None])
                        + torch.abs(st[:, 3] - guess[3][None]))
                dist = torch.where(t_idx < lap_len[lap][None], dist, inf)
                idx, dval, (x0s, x1s, x2s, x3s, q) = _topk_select(
                    dist, k, [st[:, 0], st[:, 1], st[:, 2], st[:, 3], qf])
                struct = torch.isfinite(dval)
                xt = torch.stack([x0s, x1s, x2s, x3s])
            idx_rows.append(idx)
            q_rows.append(q)
            struct_rows.append(struct)
            xt_rows.append(xt)
        x_terms = torch.cat(xt_rows, dim=1)  # (4, rows*k, B)
        struct = torch.cat(struct_rows)  # (rows*k, B): a stored row was found
        done0 = ~active | h1
        if mode == "timeVarying":
            done0 = done0 | ~struct
        sol_us, sol_xm, feas = solve(x_terms, done0)
        lap_ok_kb = torch.tensor(oks, device=dev).repeat_interleave(k)[:, None]
        cost = torch.where(feas & struct & lap_ok_kb,
                           hzn.to(dtype)[None] + torch.cat(q_rows), inf)
        if cands is not None:
            cands.append((torch.where(struct & lap_ok_kb, torch.cat(q_rows),
                                      inf), torch.isfinite(cost)))
        # ragged Python-list comparison (batched_nlmpc_soa.py:411-422)
        cmp = torch.where(lap_ok_kb, torch.where(struct, cost, -inf), inf)
        best_row = _lex_argmin_rows(cmp.reshape(rows, k, b))
        row_cost = cost.reshape(rows, k, b).gather(
            0, best_row[None, None].expand(1, k, b))[0]
        best_col = torch.argmin(row_cost, dim=0)  # first-min
        feasible_any = torch.isfinite(row_cost.gather(0, best_col[None])[0])
        win = best_row * k + best_col  # (B,)
        idx_sel = torch.cat(idx_rows).gather(0, win[None])[0]
        us_w = sol_us.gather(2, win[None, None, None].expand(n, 2, 1, b))[
            :, :, 0]
        x_pred = sol_xm.gather(1, win[None, None].expand(4, 1, b))[:, 0]
        xt_sel = x_terms.gather(1, win[None, None].expand(4, 1, b))[:, 0]
        lap_sel = lap_t[best_row]
    x_pred = torch.where(h1[None], xt_sel, x_pred)
    len_sel = lap_len.gather(0, lap_sel[None])[0]
    succ = (idx_sel + 1) <= (len_sel - 1)
    nxt = torch.clamp(idx_sel + 1, 0, t_rows - 1)
    x_succ = states[lap_sel, nxt, :, lanes].T  # (4, B)
    new_guess = torch.where(succ[None], x_succ, x_pred)
    return (torch.where(active, us_w, 0.0),
            torch.where(active, feasible_any, False).to(dtype),
            torch.where(active, new_guess, 0.0),
            torch.where(active, idx_sel, 0).to(torch.int32),
            torch.where(active, best_row, 0).to(torch.int32),
            torch.where(active, succ, False).to(dtype))


# Kernel options of the TPU factory that the port does not take, and why.
_UNPORTED = {
    "zeros_skip": "retired from the bench (bench.py:140-144)",
    "prox_skip": "on the roadmap's not-to-port list",
    "with_stats": "not ported yet",
    "store_solutions": "the port's K2 keeps no candidate's solution but "
                       "the winner's (held by its thread, or solved again)",
    "stream_safe_set": "the port's K2 always reads the safe set from "
                       "global memory",
}


class FusedNlmpcStep:
    """K2: one whole NLMPC control step per lane. Attributes k, nsi,
    num_horizon, max_steps, max_laps, max_iters, mode, all_iter,
    qsort_skip and all_rev_skip describe what it was built for;
    ``launches`` counts kernel launches. Use ``build_fused_nlmpc_step``."""

    def __init__(self, params: LmpcParams, limits: SystemLimits, dt, *,
                 num_horizon: int, max_steps: int, max_laps: int,
                 max_iters: int, mode: str, all_iter: bool,
                 qsort_skip: bool, all_rev_skip: bool):
        self.params, self.limits, self.dt = params, limits, float(dt)
        self.k = params.num_ss_points
        self.nsi = params.num_ss_iter
        self.num_horizon = num_horizon
        self.max_steps = max_steps
        self.max_laps = max_laps
        self.max_iters = max_iters
        self.mode, self.all_iter = mode, all_iter
        self.qsort_skip, self.all_rev_skip = qsort_skip, all_rev_skip
        self.rows = max_laps if all_iter else self.nsi  # lap rows a step
        self._consts = _build.nlmpc_consts_array(nlmpc_consts(limits, dt))
        self.launches = 0

    def __call__(self, x, guess, u_warm, states, qfun, lap_len, lap_ids,
                 lap_ok, obs, skip, hzn, t=None, min_cost=None):
        time_varying = self.mode == "timeVarying"
        if time_varying and (t is None or min_cost is None):
            raise ValueError("the timeVarying step needs t and min_cost")
        if x.device.type == "cpu":
            return nlmpc_step_reference(
                self.params, self.limits, self.dt, x, guess, u_warm, states,
                qfun, lap_len, lap_ids, lap_ok, obs, skip, hzn, t, min_cost,
                max_iters=self.max_iters)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        dev, dtype = x.device, x.dtype
        if dtype not in DTYPE_CODES:
            raise TypeError(f"unsupported dtype {dtype}")
        n, rows, t_rows, ml = (self.num_horizon, self.rows, self.max_steps,
                               self.max_laps)
        b = x.shape[-1]
        check_lanes("x", x, (4, b), dtype, dev)
        check_lanes("guess", guess, (4, b), dtype, dev)
        check_lanes("u_warm", u_warm, (n, 2, b), dtype, dev)
        check_lanes("states", states, (ml, t_rows, 4, b), dtype, dev)
        check_lanes("qfun", qfun, (ml, t_rows, b), dtype, dev)
        check_lanes("lap_len", lap_len, (ml, b), torch.int32, dev)
        check_lanes("lap_ids", lap_ids, (rows,), torch.int32, dev)
        check_lanes("lap_ok", lap_ok, (rows,), torch.int32, dev)
        check_lanes("obs", obs, (7, b), dtype, dev)
        check_lanes("skip", skip, (b,), torch.float32, dev)
        check_lanes("hzn", hzn, (b,), torch.int32, dev)
        if time_varying:
            check_lanes("t", t, (b,), torch.int32, dev)
            check_lanes("min_cost", min_cost, (b,), torch.int32, dev)
        us = torch.empty((n, 2, b), dtype=dtype, device=dev)
        feasible_any = torch.empty((b,), dtype=dtype, device=dev)
        new_guess = torch.empty((4, b), dtype=dtype, device=dev)
        idx_sel = torch.empty((b,), dtype=torch.int32, device=dev)
        row_sel = torch.empty((b,), dtype=torch.int32, device=dev)
        succ = torch.empty((b,), dtype=dtype, device=dev)
        outs = (us.data_ptr(), feasible_any.data_ptr(), new_guess.data_ptr(),
                idx_sel.data_ptr(), row_sel.data_ptr(), succ.data_ptr())
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if self.mode == "all":
                # the best lap row's compare list, one value a position
                scratch = (torch.empty((t_rows, b), dtype=dtype, device=dev)
                           if rows > 1 else None)
                rc = lib.nlmpc_step_all_launch(
                    DTYPE_CODES[dtype], n, rows, int(self.all_rev_skip),
                    self._consts, self.max_iters, b, t_rows, x.data_ptr(),
                    u_warm.data_ptr(), states.data_ptr(), qfun.data_ptr(),
                    lap_len.data_ptr(), lap_ids.data_ptr(),
                    lap_ok.data_ptr(), obs.data_ptr(), skip.data_ptr(),
                    hzn.data_ptr(),
                    None if scratch is None else scratch.data_ptr(), *outs,
                    stream)
            else:
                rc = lib.nlmpc_step_launch(
                    DTYPE_CODES[dtype], n, self.k, self.nsi,
                    int(time_varying), int(self.qsort_skip), self._consts,
                    self.max_iters, b, t_rows, x.data_ptr(),
                    guess.data_ptr(), u_warm.data_ptr(), states.data_ptr(),
                    qfun.data_ptr(), lap_len.data_ptr(), lap_ids.data_ptr(),
                    lap_ok.data_ptr(), obs.data_ptr(), skip.data_ptr(),
                    hzn.data_ptr(), t.data_ptr() if time_varying else None,
                    min_cost.data_ptr() if time_varying else None, *outs,
                    stream)
        _build.check_launch(rc, "nlmpc_step")
        self.launches += 1
        return us, feasible_any, new_guess, idx_sel, row_sel, succ


def build_fused_nlmpc_step(params: LmpcParams, limits: SystemLimits, dt, *,
                           num_horizon: int, max_steps: int, max_laps: int,
                           max_iters: int = 60, qsort_skip: bool = False,
                           all_rev_skip: bool = False,
                           **unported) -> FusedNlmpcStep:
    """Factory mirroring the JAX package's ``build_fused_nlmpc_step``
    (pallas_nlmpc_step.py:54), with its guards (:172-231). The mode and
    the lap window are the params' (``ss_mode``, ``all_ss_iter``), which the
    plain step on CPU tensors reads too. ``qsort_skip`` (spaceVarying /
    timeVarying, nsi = 1) and ``all_rev_skip`` (all, nsi = 1, no all_iter)
    are bitwise-neutral schedules. The TPU options in ``_UNPORTED``
    raise."""
    for name in unported:
        if name not in _UNPORTED:
            raise TypeError(f"unexpected keyword argument {name!r}")
        raise ValueError(f"{name} is not taken by the port: "
                         f"{_UNPORTED[name]}")
    n, nsi = num_horizon, params.num_ss_iter
    if n != params.num_horizon:
        raise ValueError(f"num_horizon={n} differs from "
                         f"params.num_horizon={params.num_horizon}")
    if n < 2:
        raise ValueError("horizon-1 is a pure reach check handled by the "
                         "controller (nonlinear_lmpc.py:199-213)")
    mode, all_iter = params.ss_mode, bool(params.all_ss_iter)
    if all_iter and mode != "all":
        raise ValueError("all_iter widens the lap window of mode='all' (the "
                         "kNN or window over every stored lap runs through "
                         "the plain step's glue and a candidate solver)")
    if mode == "all" and qsort_skip:
        raise ValueError("qsort_skip is not defined for mode='all' (the "
                         "lexicographic row comparison needs every "
                         "position's cost)")
    if all_rev_skip:
        if mode != "all":
            raise ValueError("all_rev_skip is the mode='all' dominance scan")
        if all_iter or nsi != 1:
            raise ValueError("all_rev_skip requires a single lap row (nsi=1, "
                             "no all_iter)")
    if qsort_skip and nsi != 1:
        raise ValueError("qsort_skip reorders candidates within the single "
                         "safe-set lap; with nsi > 1 the lexicographic row "
                         "comparison depends on every candidate's cost")
    return FusedNlmpcStep(params, limits, dt, num_horizon=n,
                          max_steps=max_steps, max_laps=max_laps,
                          max_iters=max_iters, mode=mode, all_iter=all_iter,
                          qsort_skip=bool(qsort_skip),
                          all_rev_skip=bool(all_rev_skip))
