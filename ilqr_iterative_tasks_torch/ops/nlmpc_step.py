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
from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
    DTYPE_CODES, check_lanes, lane_outputs)
from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
    _lex_argmin_rows, _topk_select, on_prefix, warp_executed)
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
                         cands: list | None = None, candidate_solver=None,
                         qsort_skip: bool = False, with_stats: bool = False,
                         prox_skip: bool = False, zeros_skip: bool = False):
    """Plain version of K2 (module docstring). spaceVarying and
    timeVarying: the candidate solves of all rows run as one batched solve
    and the winner's solution is read from it (a candidate solve is a pure
    per-lane function, so this is the solution a re-solve would give).
    all: one batched solve of the T positions a stored lap row (rows of
    laps not yet stored are not solved), then the winner is solved again.
    Candidates that no stored point backs (timeVarying, all) enter their
    solves done. If ``trips`` is a list, each candidate solve's trip counts
    are appended to it: (rows*k, B) (under ``prox_skip`` (1, B) each slot
    it reaches) or, for all, (T, B) a solved row, i32,
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

    ``prox_skip`` (spaceVarying / timeVarying, nsi = 1; the TPU kernel's
    :137-151, :681-741): the slots in extraction order (the kNN's or the
    window's), one at a time; a slot p > 0 is skipped (not solved, cost
    +inf) when it is invalid or hzn + q >= the best cost so far, and a lane
    stops once hzn + min(q of the slots after p) >= its best. Slot 0 is
    always solved, so the all-infeasible fallback is unchanged; ties keep
    the earlier slot, so the outputs are the plain order's. ``zeros_skip``
    (the TPU kernel's :113-117): each solve's zeros start enters done where
    its warm start converged (``lm_feasibility_solve_soa``); it changes
    results.

    ``with_stats`` (spaceVarying and timeVarying) appends K2's two (B,)
    i32 counts, summed over the step, for the schedule the kernel runs
    (csrc/nlmpc_step.cu): the plain order, one thread a candidate, which
    spaceVarying runs with ``qsort_skip`` too; under timeVarying's
    ``qsort_skip`` one thread a lane that solves the ranks in (Qfun, slot)
    order up to the first feasible one. ``iters_useful``: the trips of the
    solves it runs, both starts (``n_iters``): every candidate a stored row
    of a stored lap backs (the others enter done) or the ranks it solves,
    and a winner whose own solve started done, solved again with done0 =
    h1 where nothing is feasible. ``iters_executed``: every solve round its
    warp runs (one, and that one), the lane's threads times the warp's
    longest solve (``i2lqr_step.warp_executed``); 0 on skipped lanes. The
    outputs do not depend on either option.

    With ``all_ss_iter`` outside mode all, lap_ids names every slot and the
    rows of laps not yet stored (a suffix: lap_ok is a prefix) are not
    solved at all: their costs are +inf and they rank above every stored
    row, so they never win and drop out with no change to the result."""
    if candidate_solver is not None and (trips is not None or with_stats
                                         or prox_skip or zeros_skip):
        raise ValueError("trips counts the plain solve's iterations, and "
                         "the candidate solver takes no schedule option")
    mode = params.ss_mode
    # (the plain step also runs all_ss_iter outside mode all)
    check_options(mode, params.num_ss_iter, False, qsort_skip, False,
                  prox_skip, with_stats)
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
                max_iters=max_iters, m_lanes=m2, done0=done0,
                zeros_skip=zeros_skip)
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

    ran = []  # each candidate solve's trips

    def solve(x_terms, done0):
        us, x_m, feasible, n_iters = solve_lanes(x_terms, done0)
        ran.append(n_iters)
        if trips is not None:
            trips.append(n_iters)
        dr = [x1[i] - x_terms[i] for i in range(4)]
        reach = torch.sqrt(dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
                           + dr[3] * dr[3]) <= 1e-3
        return us, x_m, torch.where(h1, reach, feasible)

    def prox_solves(x_terms, done0, okc, q):
        """prox_skip's solves of the k slots of one row in their order, one
        ``solve`` a slot: (us, x_m, feasible), feasible False where a slot
        is skipped or never reached."""
        hf = hzn.to(dtype)
        q_eff = torch.where(okc, q, inf)
        # the least key after each slot: sufmin[p] = min over j > p
        sufmin = torch.full_like(q_eff, inf)
        for p in range(k - 2, -1, -1):
            sufmin[p] = torch.minimum(q_eff[p + 1], sufmin[p + 1])
        us = torch.zeros((n, 2, k, b), dtype=dtype, device=dev)
        xm = torch.zeros((4, k, b), dtype=dtype, device=dev)
        feas = torch.zeros((k, b), dtype=torch.bool, device=dev)
        best = torch.full((b,), inf, dtype=dtype, device=dev)
        alive = active.clone()
        for p in range(k):
            skip_p = ~alive | ((hf + q_eff[p] >= best) & (p > 0))
            us_p, xm_p, feas_p = solve(x_terms[:, p:p + 1],
                                       (done0[p] | skip_p)[None])
            us[:, :, p], xm[:, p] = us_p[:, :, 0], xm_p[:, 0]
            feas[p] = feas_p[0] & ~skip_p
            best = torch.minimum(best, torch.where(feas[p] & okc[p],
                                                   hf + q[p], inf))
            alive = alive & (hf + sufmin[p] < best)
            if not bool(alive.any()):
                break
        return us, xm, feas

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
        lap_ok_kb = torch.tensor(oks, device=dev).repeat_interleave(k)[:, None]
        if prox_skip:
            sol_us, sol_xm, feas = prox_solves(
                x_terms, done0.expand(k, b), struct & lap_ok_kb,
                torch.cat(q_rows))
        else:
            sol_us, sol_xm, feas = solve(x_terms, done0)
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
        if with_stats:
            stats = _k2_counts(
                ran[0], struct & lap_ok_kb, torch.cat(q_rows), cost, win,
                active, h1, qsort_skip and mode == "timeVarying",
                lambda need: solve_lanes(xt_sel[:, None], ~need[None])[3][0],
                lambda need: solve_lanes(x_terms[:, :1], ~need[None])[3][0])
    x_pred = torch.where(h1[None], xt_sel, x_pred)
    len_sel = lap_len.gather(0, lap_sel[None])[0]
    succ = (idx_sel + 1) <= (len_sel - 1)
    nxt = torch.clamp(idx_sel + 1, 0, t_rows - 1)
    x_succ = states[lap_sel, nxt, :, lanes].T  # (4, B)
    new_guess = torch.where(succ[None], x_succ, x_pred)
    outs = (torch.where(active, us_w, 0.0),
            torch.where(active, feasible_any, False).to(dtype),
            torch.where(active, new_guess, 0.0),
            torch.where(active, idx_sel, 0).to(torch.int32),
            torch.where(active, best_row, 0).to(torch.int32),
            torch.where(active, succ, False).to(dtype))
    return outs + stats if with_stats else outs


# The threads a lane of K2 timeVarying under qsort_skip (K2_TV_G in
# csrc/nlmpc_step.cu).
K2_TV_THREADS = 1


def _k2_counts(n_iters, okc, q, cost, win, active, h1, ranked, solve_win,
               solve_first):
    """K2's (iters_useful, iters_executed) of a block-mode step
    (``nlmpc_step_reference``'s ``with_stats``). n_iters: the candidates'
    trips (C, B); okc: backed by a stored row of a stored lap; q: their
    Qfun; cost: their costs (+inf where infeasible); win: the winner (B,);
    ``ranked``: timeVarying's qsort_skip schedule; solve_win(need) /
    solve_first(need): the trips of the winner's / slot 0's solve with
    done0 = h1 on the lanes of ``need`` (B,)."""
    c, b = n_iters.shape
    inf = float("inf")
    lanes = active & ~h1
    tr = torch.where(okc & lanes[None], n_iters, 0).to(torch.int64)
    if not ranked:
        # one round of every candidate, then the winner again where its
        # cost is +inf and its own solve started done
        found = torch.isfinite(cost.gather(0, win[None])[0])
        held = okc.gather(0, win[None])[0]
        need = lanes & ~found & ~held
        again = (solve_win(need).to(torch.int64) if bool(need.any())
                 else torch.zeros(b, dtype=torch.int64, device=tr.device))
        rounds = [tr.amax(dim=0), again]
        useful = tr.sum(dim=0) + again
        threads = c
    else:  # ranks by (Qfun, slot) up to the first feasible one
        qk = torch.where(okc, q, inf)
        slots = torch.arange(c, device=tr.device)[:, None]
        # ahead[i, j]: slot j ranks before slot i
        ahead = ((qk[None] < qk[:, None])
                 | ((qk[None] == qk[:, None])
                    & (slots[None] < slots[:, None])))
        order = torch.argsort(ahead.sum(dim=1), dim=0)  # rank -> slot
        nsolve = torch.clamp_min(torch.isfinite(qk).sum(dim=0), 1)
        fin_rank = torch.isfinite(cost.gather(0, order))  # (C, B)
        first = torch.where(fin_rank.any(dim=0),
                            torch.argmax(fin_rank.to(torch.int8), dim=0),
                            nsolve - 1)  # the last rank solved
        last = order.gather(0, first[None])[0]
        found = fin_rank.any(dim=0)
        held = (last == 0) & (h1 | okc[0])
        need = active & ~found & ~held
        again = (solve_first(need & ~h1).to(torch.int64)
                 if bool((need & ~h1).any())
                 else torch.zeros(b, dtype=torch.int64, device=tr.device))
        rounds, useful = [], torch.zeros(b, dtype=torch.int64,
                                         device=tr.device)
        for r in range(c + 1):
            t_r = tr.gather(0, order[min(r, c - 1)][None])[0]
            t_r = torch.where(r <= first, t_r, 0) if r < c else 0 * t_r
            t_r = t_r + torch.where(need & (first + 1 == r), again, 0)
            rounds.append(t_r)
            useful += t_r
        threads = K2_TV_THREADS
    return (torch.where(active, useful, 0).to(torch.int32),
            warp_executed(rounds, active, threads))


def check_options(mode, nsi, all_iter, qsort_skip, all_rev_skip, prox_skip,
                  with_stats):
    """The JAX factory's guards of K2's options (pallas_nlmpc_step.py:
    172-231) that the port's options meet."""
    if all_iter and mode != "all":
        raise ValueError("all_iter widens the lap window of mode='all' (the "
                         "kNN or window over every stored lap runs through "
                         "the plain step's glue and a candidate solver)")
    if mode == "all" and with_stats:
        raise ValueError("with_stats is instrumented for the block modes "
                         "(spaceVarying/timeVarying) only")
    if mode == "all" and qsort_skip:
        raise ValueError("qsort_skip is not defined for mode='all' (the "
                         "lexicographic row comparison needs every "
                         "position's cost)")
    if prox_skip:
        if qsort_skip:
            raise ValueError("prox_skip and qsort_skip are alternative "
                             "candidate orderings: enable one")
        if mode == "all":
            raise ValueError("prox_skip orders the extracted candidate "
                             "block; mode='all' has its own dominance scan "
                             "(all_rev_skip)")
        if nsi != 1:
            raise ValueError("prox_skip requires nsi=1 (the lexicographic "
                             "row comparison needs every candidate's cost)")
        if with_stats:
            raise ValueError("with_stats is not instrumented for prox_skip")
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


# The option bits of nlmpc_step_launch's ``opts`` (csrc/nlmpc_step.cu) and,
# of them, ZSKIP beside nlmpc_step_all_launch's all_rev_skip (1)
K2_QSORT, K2_PROX, K2_ZSKIP = 1, 2, 4

# Kernel options of the TPU factory that the port does not take, and why:
# VMEM space trades of the TPU kernel, with no computation to port.
_UNPORTED = {
    "store_solutions": "the port's K2 keeps no candidate's solution but "
                       "the winner's (held by its thread, or solved again)",
    "stream_safe_set": "the port's K2 always reads the safe set from "
                       "global memory",
}


class FusedNlmpcStep:
    """K2: one whole NLMPC control step per lane. Attributes k, nsi,
    num_horizon, max_steps, max_laps, max_iters, mode, all_iter,
    qsort_skip, all_rev_skip, with_stats, prox_skip and zeros_skip
    describe what it was built for; ``launches`` counts kernel launches. Use
    ``build_fused_nlmpc_step``."""

    def __init__(self, params: LmpcParams, limits: SystemLimits, dt, *,
                 num_horizon: int, max_steps: int, max_laps: int,
                 max_iters: int, mode: str, all_iter: bool,
                 qsort_skip: bool, all_rev_skip: bool,
                 with_stats: bool = False, prox_skip: bool = False,
                 zeros_skip: bool = False):
        self.params, self.limits, self.dt = params, limits, float(dt)
        self.k = params.num_ss_points
        self.nsi = params.num_ss_iter
        self.num_horizon = num_horizon
        self.max_steps = max_steps
        self.max_laps = max_laps
        self.max_iters = max_iters
        self.mode, self.all_iter = mode, all_iter
        self.qsort_skip, self.all_rev_skip = qsort_skip, all_rev_skip
        self.with_stats = with_stats
        self.prox_skip, self.zeros_skip = prox_skip, zeros_skip
        self.rows = max_laps if all_iter else self.nsi  # lap rows a step
        self._consts = _build.nlmpc_consts_array(nlmpc_consts(limits, dt))
        self.launches = 0

    def __call__(self, x, guess, u_warm, states, qfun, lap_len, lap_ids,
                 lap_ok, obs, skip, hzn, t=None, min_cost=None, lanes=None):
        """One step of every lane, or with ``lanes`` of the first ``lanes``
        (the arrays keep their B lanes: no copy); the outputs past them
        are zeros, as a skipped lane's."""
        time_varying = self.mode == "timeVarying"
        if time_varying and (t is None or min_cost is None):
            raise ValueError("the timeVarying step needs t and min_cost")
        b = x.shape[-1]
        lanes = b if lanes is None else int(lanes)
        if not 0 <= lanes <= b:
            raise ValueError(f"lanes={lanes} outside a batch of {b}")
        if x.device.type == "cpu":
            return on_prefix(lambda *a: nlmpc_step_reference(
                self.params, self.limits, self.dt, *a,
                max_iters=self.max_iters, qsort_skip=self.qsort_skip,
                with_stats=self.with_stats, prox_skip=self.prox_skip,
                zeros_skip=self.zeros_skip), lanes,
                (x, guess, u_warm, states, qfun, lap_len), (lap_ids, lap_ok),
                (obs, skip, hzn, t, min_cost))
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        dev, dtype = x.device, x.dtype
        if dtype not in DTYPE_CODES:
            raise TypeError(f"unsupported dtype {dtype}")
        n, rows, t_rows, ml = (self.num_horizon, self.rows, self.max_steps,
                               self.max_laps)
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
        i32 = torch.int32
        us, feasible_any, new_guess, idx_sel, row_sel, succ, *stats = \
            lane_outputs([((n, 2, b), dtype), ((b,), dtype), ((4, b), dtype),
                          ((b,), i32), ((b,), i32), ((b,), dtype)]
                         + ([((2, b), i32)] if self.with_stats else []), b,
                         lanes, dev)
        outs = (us.data_ptr(), feasible_any.data_ptr(), new_guess.data_ptr(),
                idx_sel.data_ptr(), row_sel.data_ptr(), succ.data_ptr())
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            zskip = K2_ZSKIP if self.zeros_skip else 0
            if self.mode == "all":
                # the best lap row's compare list, one value a position
                scratch = (torch.empty((t_rows, b), dtype=dtype, device=dev)
                           if rows > 1 else None)
                rc = lib.nlmpc_step_all_launch(
                    DTYPE_CODES[dtype], n, rows,
                    int(self.all_rev_skip) | zskip,
                    self._consts, self.max_iters, b, t_rows, x.data_ptr(),
                    u_warm.data_ptr(), states.data_ptr(), qfun.data_ptr(),
                    lap_len.data_ptr(), lap_ids.data_ptr(),
                    lap_ok.data_ptr(), obs.data_ptr(), skip.data_ptr(),
                    hzn.data_ptr(),
                    None if scratch is None else scratch.data_ptr(), *outs,
                    stream, lanes)
            else:
                args = (DTYPE_CODES[dtype], n, self.k, self.nsi,
                        int(time_varying),
                        (K2_QSORT if self.qsort_skip else 0)
                        | (K2_PROX if self.prox_skip else 0) | zskip,
                        self._consts,
                        self.max_iters, b, t_rows, x.data_ptr(),
                        guess.data_ptr(), u_warm.data_ptr(),
                        states.data_ptr(), qfun.data_ptr(),
                        lap_len.data_ptr(), lap_ids.data_ptr(),
                        lap_ok.data_ptr(), obs.data_ptr(), skip.data_ptr(),
                        hzn.data_ptr(),
                        t.data_ptr() if time_varying else None,
                        min_cost.data_ptr() if time_varying else None, *outs)
                if self.with_stats:
                    stats = stats[0]
                    rc = lib.nlmpc_step_stats_launch(
                        *args, stats[0].data_ptr(), stats[1].data_ptr(),
                        stream, lanes)
                else:
                    rc = lib.nlmpc_step_launch(*args, stream, lanes)
        _build.check_launch(rc, "nlmpc_step")
        self.launches += 1
        outs = us, feasible_any, new_guess, idx_sel, row_sel, succ
        return outs + (stats[0], stats[1]) if self.with_stats else outs


def build_fused_nlmpc_step(params: LmpcParams, limits: SystemLimits, dt, *,
                           num_horizon: int, max_steps: int, max_laps: int,
                           max_iters: int = 60, qsort_skip: bool = False,
                           all_rev_skip: bool = False,
                           with_stats: bool = False, prox_skip: bool = False,
                           zeros_skip: bool = False,
                           **unported) -> FusedNlmpcStep:
    """Factory mirroring the JAX package's ``build_fused_nlmpc_step``
    (pallas_nlmpc_step.py:54), with its guards (:172-231,
    ``check_options``). The mode and the lap window are the params'
    (``ss_mode``, ``all_ss_iter``), which the plain step on CPU tensors
    reads too. ``qsort_skip`` (spaceVarying / timeVarying, nsi = 1),
    ``prox_skip`` (the same; a serial walker of the slots in extraction
    order) and ``all_rev_skip`` (all, nsi = 1, no all_iter) are
    bitwise-neutral schedules. ``zeros_skip`` (every mode) skips a solve's
    zeros start where its warm start converged, which changes results.
    ``with_stats`` (spaceVarying / timeVarying) appends two (B,) i32
    counts to the outputs, ``iters_useful`` and ``iters_executed``
    (``nlmpc_step_reference``). The TPU options in ``_UNPORTED`` raise."""
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
    check_options(mode, nsi, all_iter, qsort_skip, all_rev_skip, prox_skip,
                  with_stats)
    return FusedNlmpcStep(params, limits, dt, num_horizon=n,
                          max_steps=max_steps, max_laps=max_laps,
                          max_iters=max_iters, mode=mode, all_iter=all_iter,
                          qsort_skip=bool(qsort_skip),
                          all_rev_skip=bool(all_rev_skip),
                          with_stats=bool(with_stats),
                          prox_skip=bool(prox_skip),
                          zeros_skip=bool(zeros_skip))
