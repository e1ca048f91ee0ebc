"""One whole i2LQR control step per lane: the K1 kernel
(csrc/i2lqr_step.cu) and its plain version.

Port of ilqr_iterative_tasks_tpu/ops/pallas_i2lqr_step.py
(``build_fused_i2lqr_step``). Per lane, each of 3 relaxation passes runs an
L1-kNN of the guess over the last nsi stored laps, k zeros-initialised
LM-iLQR candidate solves, the relaxed reach cost 80/10^pass, the
lexicographic row-min over laps with a first-min argmin in the winning row,
and re-centres the guess on the winner's terminal state; the step ends with
the horizon-shrink flag. Signature (batch trailing):

    (x (4,B), g0 (4,B), states (max_laps,T,4,B), qfun (max_laps,T,B),
     lap_len (max_laps,B) i32, lap_ids (nsi,) i32, lap_ok (nsi,) i32,
     obs (6,B), skip (B,) f32)
    -> (us (n,2,B), shrink (B,), idx_sel (B,) i32, row_sel (B,) i32)

``g0`` is the pass-0 kNN guess (the current state, or the goal where the
simulator's ``stall_reseed`` guard fires). Lanes with skip=1 return zeros.
``i2lqr_step_reference`` is the plain version: the JAX package's composed
XLA path (control/batched_soa.py ``solve_step`` / ``one_pass``, :513-712),
the bitwise oracle of the TPU kernel. Given a ``candidate_solver`` (K3,
ops/fused_ilqr.py), its candidate solves are that solver's instead: the
JAX per-candidate path (``pallas_solver``, batched_soa.py:553-620).

The kernel is instantiated at horizon 6 for k = 8 (nsi 1 and 2: a tile of
nsi*k threads a lane) and for k = 32 (nsi 2 and 4, the robustness sweep's
candidate sets, max_steps <= 128: a lane a warp, four to a block of 128
threads that solves each distinct (lap, row) candidate of a lane's step
once, pooled over the block), in f32 and f64; any other size raises on a
CUDA tensor. Both compute the plain version bit for bit.
"""

from __future__ import annotations

import torch

from ilqr_iterative_tasks_torch.ops import _build
from ilqr_iterative_tasks_torch.ops.fused_ilqr import DTYPE_CODES, check_lanes
from ilqr_iterative_tasks_torch.ops.ilqr_soa import ilqr_solve_soa, true_div
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, SystemLimits, solver_consts)


def _topk_select(dist, k, arrs):
    """k smallest-distance rows per lane and the rows' values.

    dist: (T, B) with +inf on invalid rows; arrs: (T, B) tensors to read at
    the selected rows. Returns (idx (K, B) i64, dval (K, B), [sel (K, B)]).
    Ascending distance, ties to the lower row (argmin is first-min); once
    every remaining row is +inf the argmin repeats row 0 with dval=inf.
    """
    d = dist
    idxs, dvals, sels = [], [], [[] for _ in arrs]
    for _ in range(k):
        j = torch.argmin(d, dim=0)  # (B,) first-min
        dvals.append(d.gather(0, j[None])[0])
        idxs.append(j)
        for a_i, a in enumerate(arrs):
            sels[a_i].append(a.gather(0, j[None])[0])
        d = d.scatter(0, j[None], float("inf"))
    return (torch.stack(idxs), torch.stack(dvals),
            [torch.stack(s) for s in sels])


def _lex_argmin_rows(cost_rows):
    """Per-lane lexicographic row argmin. cost_rows: (L, K, B) -> (B,) i64.

    Mirrors Python's min() over a list of per-lap cost lists.
    """
    num_rows, k, b = cost_rows.shape
    best = torch.zeros(b, dtype=torch.int64, device=cost_rows.device)
    for i in range(1, num_rows):
        a = cost_rows[i]
        bb = cost_rows.gather(0, best[None, None].expand(1, k, b))[0]
        diff = a != bb
        any_diff = diff.any(dim=0)
        first = torch.argmax(diff.to(torch.int8), dim=0)  # first differing slot
        a_first = a.gather(0, first[None])[0]
        b_first = bb.gather(0, first[None])[0]
        less = any_diff & (a_first < b_first)
        best = torch.where(less, i, best)
    return best


def i2lqr_step_reference(params: IlqrParams, limits: SystemLimits, dt, x, g0,
                         states, qfun, lap_len, lap_ids, lap_ok, obs, skip, *,
                         max_iter: int, trips: list | None = None,
                         cands: list | None = None, candidate_solver=None):
    """Plain version of K1 (module docstring). The candidate solves of all
    nsi laps run as one batched ``ilqr_solve_soa`` per pass (per-lane
    results do not depend on the batching: done lanes freeze). If
    ``trips`` is a list, each pass appends its solves' trip counts to it:
    (nsi*k, B) i32, 0 on skipped lanes. If ``cands`` is a list, each pass
    appends its candidates' kNN rows (nsi*k, B) i64, whether each slot
    holds a row (nsi*k, B) bool (whatever its lap's lap_ok) and the
    winner (B,) i64, row * k + slot.

    ``candidate_solver``: a K3 built for the same constants and cap
    (``build_fused_ilqr``), called once a pass on the pass's nsi*k*B
    lanes: zeros u_init, the lane's obstacle on each of its candidates and
    the skip mask, so skipped lanes enter done. The JAX path compacts the
    active lanes to the batch front first (:514-522), which changes no
    lane's result; this port does not: K3 takes its lanes from a counter
    as it goes, and compaction saved 10 % of K3's time over an i2LQR
    headline run on the card, 64 ms of a 2.2-3.0 s run before the gathers
    it adds (PERF.md). The trip counts are the plain solve's only."""
    if candidate_solver is not None and trips is not None:
        raise ValueError("trips counts the plain solve's iterations")
    n = params.num_horizon
    k = params.num_ss_points
    nsi = params.num_ss_iter
    t_rows = states.shape[1]
    b = x.shape[-1]
    dtype, dev = x.dtype, x.device
    inf = float("inf")
    laps = [int(v) for v in lap_ids.tolist()]
    oks = [bool(v) for v in lap_ok.tolist()]
    frozen = (skip > 0.5)[None].expand(nsi * k, b)
    t_idx = torch.arange(t_rows, device=dev)[:, None]
    x0b = x[:, None, :].expand(4, nsi * k, b)
    zeros_ws = torch.zeros((n, 2, nsi * k, b), dtype=dtype, device=dev)
    obs_kb = obs[:, None, :]
    if candidate_solver is not None:  # the candidates as lanes of K3
        lanes = nsi * k * b
        flat = lambda t: t.expand(t.shape[0], nsi * k, b).reshape(
            t.shape[0], lanes).contiguous()
        cand_args = (flat(x[:, None]), zeros_ws.reshape(n, 2, lanes),
                     flat(obs_kb), flat(skip[None, None])[0])

    def one_pass(outer, xg):
        idx_rows, q_rows, ok_rows, xt_rows, fin_rows = [], [], [], [], []
        for off in range(nsi):
            st = states[laps[off]]  # (T, 4, B)
            dist = (torch.abs(st[:, 0] - xg[0][None])
                    + torch.abs(st[:, 1] - xg[1][None])
                    + torch.abs(st[:, 2] - xg[2][None])
                    + torch.abs(st[:, 3] - xg[3][None]))
            dist = torch.where(t_idx < lap_len[laps[off]][None], dist, inf)
            idx, dval, (x0s, x1s, x2s, x3s, q) = _topk_select(
                dist, k, [st[:, 0], st[:, 1], st[:, 2], st[:, 3],
                          qfun[laps[off]]])
            idx_rows.append(idx)
            q_rows.append(q)
            fin_rows.append(torch.isfinite(dval))
            ok_rows.append(fin_rows[-1] & oks[off])
            xt_rows.append(torch.stack([x0s, x1s, x2s, x3s]))
        x_terms = torch.cat(xt_rows, dim=1)  # (4, nsi*k, B)
        cand_ok = torch.cat(ok_rows)  # (nsi*k, B): valid row of a stored lap
        if candidate_solver is None:
            sol = ilqr_solve_soa(params, limits, obs_kb, x0b, x_terms,
                                 zeros_ws, float(params.lamb), dt,
                                 num_horizon=n, max_iter=max_iter,
                                 done0=frozen)
            if trips is not None:
                trips.append(sol.lane_iters)
            sol_us, x_last = sol.us, sol.xs[-1]
            dd = [x_last[i] - x_terms[i] for i in range(4)]
            d = torch.sqrt(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
                           + dd[3] * dd[3])
        else:
            x0_l, u0_l, obs_l, skip_l = cand_args
            us_l, xl_l, _, d_l = candidate_solver(
                x0_l, x_terms.reshape(4, lanes), u0_l, obs_l, skip_l)
            sol_us = us_l.reshape(n, 2, nsi * k, b)
            x_last = xl_l.reshape(4, nsi * k, b)
            d = d_l.reshape(nsi * k, b)
        unit = 80.0 / (10 ** outer)
        i_rel = torch.clamp_min(torch.ceil(true_div(d, unit) - 1e-12), 1.0)
        cost = torch.where(d <= unit * params.max_relax_iter,
                           torch.cat(q_rows) + float(n) + 100.0 * i_rel, inf)
        cost = torch.where(cand_ok, cost, inf)
        # ragged Python-list comparison: a row shorter than k (k exceeds the
        # stored lap's length) ranks its absent tail slots -inf; rows of
        # laps not yet stored rank above everything (batched_soa.py:656-668)
        lap_ok_kb = torch.tensor(oks, device=dev).repeat_interleave(k)[:, None]
        cmp = torch.where(lap_ok_kb, torch.where(cand_ok, cost, -inf), inf)
        best_row = _lex_argmin_rows(cmp.reshape(nsi, k, b))
        row_cost = cost.reshape(nsi, k, b).gather(
            0, best_row[None, None].expand(1, k, b))[0]
        win = best_row * k + torch.argmin(row_cost, dim=0)  # (B,)
        us_sel = sol_us.gather(2, win[None, None, None].expand(n, 2, 1, b))
        xl_sel = x_last.gather(1, win[None, None].expand(4, 1, b))[:, 0]
        idx_sel = torch.cat(idx_rows).gather(0, win[None])[0]
        if cands is not None:
            cands.append((torch.cat(idx_rows), torch.cat(fin_rows), win))
        return xl_sel, us_sel[:, :, 0], idx_sel, best_row

    xg = g0
    for outer in range(3):
        xg, us_sel, idx_sel, best_row = one_pass(outer, xg)
    lap_sel = torch.tensor(laps, device=dev)[best_row]
    chosen_len = lap_len.gather(0, lap_sel[None])[0]
    shrink = ((idx_sel + 1) > (chosen_len - 1)).to(dtype)
    active = skip <= 0.5
    return (torch.where(active, us_sel, 0.0),
            torch.where(active, shrink, 0.0),
            torch.where(active, idx_sel, 0).to(torch.int32),
            torch.where(active, best_row, 0).to(torch.int32))


class FusedI2lqrStep:
    """K1: one whole i2LQR control step per lane. Attributes k, nsi,
    num_horizon, max_steps, max_laps and max_iter describe what it was
    built for; ``launches`` counts kernel launches."""

    def __init__(self, params: IlqrParams, limits: SystemLimits, dt, *,
                 num_horizon: int, max_steps: int, max_laps: int,
                 max_iter: int = 150):
        self.params, self.limits, self.dt = params, limits, float(dt)
        self.k = params.num_ss_points
        self.nsi = params.num_ss_iter
        self.num_horizon = num_horizon
        self.max_steps = max_steps
        self.max_laps = max_laps
        self.max_iter = max_iter
        if num_horizon != params.num_horizon:
            raise ValueError(f"num_horizon={num_horizon} differs from "
                             f"params.num_horizon={params.num_horizon}")
        self._consts = _build.consts_array(solver_consts(params, limits, dt))
        self.launches = 0

    def __call__(self, x, g0, states, qfun, lap_len, lap_ids, lap_ok, obs,
                 skip):
        if x.device.type == "cpu":
            return i2lqr_step_reference(
                self.params, self.limits, self.dt, x, g0, states, qfun,
                lap_len, lap_ids, lap_ok, obs, skip, max_iter=self.max_iter)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        dev, dtype = x.device, x.dtype
        if dtype not in DTYPE_CODES:
            raise TypeError(f"unsupported dtype {dtype}")
        n, nsi, t_rows, ml = (self.num_horizon, self.nsi, self.max_steps,
                              self.max_laps)
        b = x.shape[-1]
        check_lanes("x", x, (4, b), dtype, dev)
        check_lanes("g0", g0, (4, b), dtype, dev)
        check_lanes("states", states, (ml, t_rows, 4, b), dtype, dev)
        check_lanes("qfun", qfun, (ml, t_rows, b), dtype, dev)
        check_lanes("lap_len", lap_len, (ml, b), torch.int32, dev)
        check_lanes("lap_ids", lap_ids, (nsi,), torch.int32, dev)
        check_lanes("lap_ok", lap_ok, (nsi,), torch.int32, dev)
        check_lanes("obs", obs, (6, b), dtype, dev)
        check_lanes("skip", skip, (b,), torch.float32, dev)
        us = torch.empty((n, 2, b), dtype=dtype, device=dev)
        shrink = torch.empty((b,), dtype=dtype, device=dev)
        idx_sel = torch.empty((b,), dtype=torch.int32, device=dev)
        row_sel = torch.empty((b,), dtype=torch.int32, device=dev)
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.i2lqr_step_launch(
                DTYPE_CODES[dtype], n, self.k, nsi, self._consts,
                self.max_iter, b, t_rows, ml, x.data_ptr(), g0.data_ptr(),
                states.data_ptr(), qfun.data_ptr(), lap_len.data_ptr(),
                lap_ids.data_ptr(), lap_ok.data_ptr(), obs.data_ptr(),
                skip.data_ptr(), us.data_ptr(), shrink.data_ptr(),
                idx_sel.data_ptr(), row_sel.data_ptr(), stream)
        _build.check_launch(rc, "i2lqr_step")
        self.launches += 1
        return us, shrink, idx_sel, row_sel


def build_fused_i2lqr_step(params: IlqrParams, limits: SystemLimits, dt, *,
                           num_horizon: int, max_steps: int, max_laps: int,
                           max_iter: int = 150) -> FusedI2lqrStep:
    """Factory mirroring the JAX package's ``build_fused_i2lqr_step``. It
    takes none of that factory's kernel options: at k = 32 the kernel
    computes what the JAX sweep's ``dedup=True, store_solutions=False``
    build does (each distinct candidate solve of a step once, the winner
    solved again where its solution was not kept; bitwise the plain step),
    and at k = 8 what the plain order does."""
    return FusedI2lqrStep(params, limits, dt, num_horizon=num_horizon,
                          max_steps=max_steps, max_laps=max_laps,
                          max_iter=max_iter)
