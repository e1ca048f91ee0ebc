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
simulator's ``stall_reseed`` guard fires). Lanes with skip=1 return zeros,
and so do the lanes past ``lanes`` where a call names it (a launch over
the first ``lanes`` of the B lanes).
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
CUDA tensor. Both compute the plain version bit for bit. At k = 8 the TPU
kernel's ``dedup``, ``qsort_skip``, ``with_stats``, ``reuse_extract`` and
``dom_skip`` run in kernels of their own (csrc/i2lqr_step_opts.cu) and
``group`` in csrc/i2lqr_step_group.cu, whose outputs are the same bits and
whose counts are the plain version's (``i2lqr_step_reference``). At
k = 32 a counting instantiation of the block kernel counts ``with_stats``;
its ``iters_executed`` the host replays (``block_executed``);
``reuse_extract`` is an instantiation of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from ilqr_iterative_tasks_torch.ops import _build
from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
    DTYPE_CODES, check_lanes, lane_outputs)
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


def queue_floor(upass, width: int):
    """JAX's ``queue_floor`` from the per-pass counts of a step: upass
    (passes, B), each lane's useful trips plus one arrival a visited
    position. Per pass the max over each aligned group of ``width`` lanes,
    summed over the passes, given to every lane of the group: (B,) i32."""
    passes, b = upass.shape
    groups = -(-b // width)
    pad = torch.zeros((passes, groups * width), dtype=torch.int64,
                      device=upass.device)
    pad[:, :b] = upass
    top = pad.view(passes, groups, width).amax(dim=2).sum(dim=0)
    return top.repeat_interleave(width)[:b].to(torch.int32)


def warp_executed(rounds, active, threads: int):
    """``iters_executed`` of a tile layout: ``threads`` threads a lane,
    32 // threads lanes a warp. rounds: each solve round's (B,) trips, the
    most a lane's threads ran in it; every round the warp runs, each of
    its live lanes pays its threads times the warp's most. (B,) i32."""
    width = 32 // threads
    b = active.shape[0]
    total = torch.zeros(b, dtype=torch.int64, device=active.device)
    for r in rounds:
        total += queue_floor(r[None].to(torch.int64), width)
    return torch.where(active, total * threads, 0).to(torch.int32)


# The k = 32 kernel's layout (csrc/i2lqr_step.cu): lanes a block (a warp
# each), the block's threads, and the terminal states a lane keeps
K32_LANES, K32_THREADS, K32_XL = 4, 128, 160


def block_executed(passes, laps, oks, active, t_rows):
    """``iters_executed`` of the k = 32 block kernel (csrc/i2lqr_step.cu,
    ``i2lqr_step_block_kernel``), its schedule replayed on the host: each
    block of 4 lanes, a warp a lane, queues per pass each live lane's
    valid candidates of the distinct laps a stored row reads whose (lap,
    row) the step has not solved, in slot order; the block's 128 threads
    solve the lanes' queues one after the other, entry j on thread
    (solves so far + j) % 128, 128 at a time. A final winner not solved
    (or whose terminal state is past the 160 a lane keeps) is solved in a
    round of its own, and a lane's final winner once more at the end where
    no thread's last solve holds it. Every round of 128 entries costs each
    warp 32 times the longest trips among its threads' entries; a warp is
    its lane's, whichever lane an entry serves (a skipped lane's warp
    included). passes: each pass's (kNN rows (nc, B), whether each slot
    holds a row (nc, B), trips (nc, B), the slots dedup took (nc, B), the
    winner (B,), row * 32 + slot); a solve's trips are those of the slot
    that ran it, wherever its (lap, row) recurs. (B,) i32."""
    k, lanes, threads, xl = 32, K32_LANES, K32_THREADS, K32_XL
    nsi, b = len(laps), active.shape[0]
    first = [laps.index(laps[r]) for r in range(nsi)]
    need = sorted({first[r] for r in range(nsi) if oks[r]})
    act = active.cpu().numpy()
    pss = [[t.cpu().numpy() for t in p] for p in passes]
    trips = np.zeros((b, nsi, t_rows), np.int64)
    for idx, _, ran, hit, _ in pss:
        for r in range(nsi):
            sl = slice(r * k, (r + 1) * k)
            s_, l_ = np.nonzero(~hit[sl] & act[None])
            trips[l_, first[r], idx[sl][s_, l_]] = ran[sl][s_, l_]
    executed = np.zeros(b, np.int64)
    for b0 in range(0, b, lanes):
        own = [b0 + w < b and bool(act[b0 + w]) for w in range(lanes)]
        at = np.full((lanes, nsi, t_rows), -1)  # a solved (u, row)'s entry
        kept, held, state = [0] * lanes, [None] * threads, [0]
        exe = executed[b0:b0 + lanes]

        def run(entries):  # a round: (lane, u, row) in queue order
            base = state[0]
            for m in range(0, len(entries), threads):
                most = [0] * lanes
                for j in range(m, min(len(entries), m + threads)):
                    th = (base + j) % threads
                    w, u, row = entries[j]
                    most[th // 32] = max(most[th // 32],
                                         int(trips[b0 + w, u, row]))
                    held[th] = entries[j]
                for w in range(len(exe)):
                    exe[w] += 32 * most[w]
            state[0] += len(entries)

        final = {}
        for idx, valid, _, _, win in pss:
            entries = []
            for w in range(lanes):
                if not own[w]:
                    continue
                q = 0
                for u in need:
                    for slot in range(u * k, (u + 1) * k):
                        row = int(idx[slot, b0 + w])
                        if valid[slot, b0 + w] and at[w, u, row] < 0:
                            at[w, u, row] = min(kept[w] + q, xl)
                            entries.append((w, u, row))
                            q += 1
                kept[w] += q
            run(entries)
            again = []
            for w in range(lanes):
                if own[w]:
                    wn = int(win[b0 + w])
                    u, row = first[wn // k], int(idx[wn, b0 + w])
                    if at[w, u, row] < 0 or at[w, u, row] == xl:
                        at[w, u, row] = xl
                        again.append((w, u, row))
                    final[w] = (w, u, row)
            if again:
                run(again)
        last = [e for w, e in sorted(final.items()) if e not in held]
        if last:
            run(last)
    return torch.from_numpy(executed).to(device=active.device,
                                         dtype=torch.int32)


def i2lqr_step_reference(params: IlqrParams, limits: SystemLimits, dt, x, g0,
                         states, qfun, lap_len, lap_ids, lap_ok, obs, skip, *,
                         max_iter: int, trips: list | None = None,
                         cands: list | None = None, candidate_solver=None,
                         dedup: bool = False, qsort_skip: bool = False,
                         with_stats: bool = False, floor_width: int = 32,
                         reuse_extract: bool = False, dom_skip: bool = False,
                         group: int = 1, reused: list | None = None,
                         dedup_passes: bool = False,
                         dedup_log: list | None = None,
                         precision_islands: tuple = ()):
    """Plain version of K1 (module docstring). The candidate solves of all
    nsi laps run as one batched ``ilqr_solve_soa`` per pass (per-lane
    results do not depend on the batching: done lanes freeze). If
    ``trips`` is a list, each pass appends its solves' trip counts to it:
    (nsi*k, B) i32, 0 on skipped lanes and on candidates the schedule
    does not solve (and a (1, B) entry for a final winner solved again).
    If ``cands`` is a list, each pass appends its candidates' kNN rows
    (nsi*k, B) i64, whether each slot holds a row (nsi*k, B) bool
    (whatever its lap's lap_ok) and the winner (B,) i64, row * k + slot.

    ``dedup`` and ``qsort_skip`` are the TPU kernel's schedules
    (ops/pallas_i2lqr_step.py:82-95, :153-181), run as it runs them; they
    change which solves run, never the outputs. ``dedup``: a candidate of
    a valid row that a valid candidate of the same lap row solved (and, under
    ``qsort_skip``, did not skip) in an earlier pass of the step, passes 0
    and 1, takes that solve's distance and terminal state and is not
    solved; a final winner so taken is solved again for its ``us`` (the
    same pure solve, bitwise). ``qsort_skip`` (nsi = 1): positions in the
    stable (Qfun, slot) order of each lane, invalid candidates last, solved
    one at a time under the strict skip q + n + 100 > the best cost so far
    (position 0 always solves), the best kept as the lexicographic (cost,
    slot) minimum, which is the plain order's first-min argmin.
    ``dom_skip`` (nsi = 1; :133-147, :380-391, :485-508): the slots in
    their own order, a slot p > 0 skipped (not solved, cost +inf, no cache
    entry) when it is invalid or q + n + 100 >= the best cost so far;
    a skip does not end the pass (q is not monotone in slot order).
    ``group`` (:149-155, :511-537): the slots solved ``group`` at a time
    (JAX's ``lm_solve_multi``), the dominance test of a group reading the
    best cost from before it. ``reuse_extract`` (:182-190, :355-367): in
    passes 1 and 2 a lane whose guess equals the previous pass's (float
    ``==`` on every component) keeps that pass's kNN rows and is not
    scanned again; if ``reused`` is a list, each of those passes appends
    its (B,) bool mask of live lanes so kept.

    ``with_stats`` appends three (B,) i32 counts summed over the step:
    ``iters_useful``, each solve's trips until its lane froze
    (``lane_iters``; 0 for candidates skipped, dominated or taken from the
    cache); ``iters_executed``, the thread-trips the lane pays in the K1
    tile kernel's layout (nsi*k threads a lane, 32 / (nsi*k) lanes a warp:
    every solve round its warp runs, its threads times the warp's longest
    solve of the round; 0 on skipped lanes), under ``qsort_skip`` or
    ``dom_skip`` in a lane queue's taken in lane order (one thread a lane,
    32 lanes a warp, a round a position; the card's queue takes its lanes
    from a counter, so its count is its own), at k = 32 the block kernel's,
    a lane's warp's
    thread-trips over the pooled solves it runs, a skipped lane's too
    (``block_executed``); and ``queue_floor``, JAX's
    (``queue_floor`` above at ``floor_width`` lanes) over the per-pass
    counts: the useful trips plus one arrival at each position a lane
    visits (every candidate in the plain order and under ``dom_skip``;
    under ``qsort_skip`` the positions not skipped), and the final winner's
    solve again where it happens.

    ``candidate_solver``: a K3 built for the same constants and cap
    (``build_fused_ilqr``), called once a pass on the pass's nsi*k*B
    lanes: zeros u_init, the lane's obstacle on each of its candidates and
    the skip mask, so skipped lanes enter done. The JAX path compacts the
    active lanes to the batch front first (:514-522), which changes no
    lane's result; this port does not: K3 takes its lanes from a counter
    as it goes, and compaction saved 10 % of K3's time over an i2LQR
    headline run on the card, 64 ms of a 2.2-3.0 s run before the gathers
    it adds (PERF.md). It takes none of the options (JAX's per-candidate
    path has none). The trip counts are the plain solve's only.

    ``dedup_passes`` (the candidate solver's path only; JAX
    batched_soa.py:268-282, :553-632): a pass-1 or pass-2 candidate of a
    valid row that a valid candidate of the same lap row solved in an
    earlier pass of the step is the same pure solve (x0, x_N target, zeros
    u_init, lamb and obstacle do not change within a step): it takes that
    solve's (us, x_last, d) and enters K3 pre-done through ``skip``. The
    TPU path compacts such lanes to whole tiles first, a Mosaic trade; K3's
    threads take their lanes from a counter, so the flag is all it needs.
    If ``dedup_log`` is a list, each of those passes appends its count of
    live lanes' solves so skipped (a 0-d tensor).

    ``precision_islands`` (the plain solve only): ops/ilqr_soa.py's f64
    islands inside an f32 solve."""
    if candidate_solver is not None and (
            trips is not None or dedup or qsort_skip or with_stats
            or reuse_extract or dom_skip or group != 1):
        raise ValueError("the candidate solver's path counts no trips and "
                         "takes no schedule option")
    if dedup_passes and candidate_solver is None:
        raise ValueError("dedup_passes requires a candidate_solver (K3, "
                         "built with skip as an input)")
    if precision_islands and candidate_solver is not None:
        raise ValueError("precision_islands: the candidate solver (K3) "
                         "computes no island")
    n = params.num_horizon
    k = params.num_ss_points
    nsi = params.num_ss_iter
    nc = nsi * k
    check_options(nsi, k, qsort_skip, dom_skip, group, with_stats)
    t_rows = states.shape[1]
    b = x.shape[-1]
    dtype, dev = x.dtype, x.device
    inf = float("inf")
    laps = [int(v) for v in lap_ids.tolist()]
    oks = [bool(v) for v in lap_ok.tolist()]
    active = skip <= 0.5
    frozen = (~active)[None].expand(nc, b)
    t_idx = torch.arange(t_rows, device=dev)[:, None]
    x0b = x[:, None, :].expand(4, nc, b)
    zeros_ws = torch.zeros((n, 2, nc, b), dtype=dtype, device=dev)
    obs_kb = obs[:, None, :]
    if candidate_solver is not None:  # the candidates as lanes of K3
        lanes = nc * b
        flat = lambda t: t.expand(t.shape[0], nc, b).reshape(
            t.shape[0], lanes).contiguous()
        cand_args = (flat(x[:, None]), zeros_ws.reshape(n, 2, lanes),
                     flat(obs_kb), flat(skip[None, None])[0])
    cache = []  # passes 0 and 1: (idx, ok, d, x_last) of each slot
    solved = []  # dedup_passes, passes 0 and 1: (idx, ok, us, x_last, d)

    def found_in(cand_idx, cand_ok):
        """dedup_passes: (found (nc, B), us, x_last, d) of each slot from
        the first earlier solve of its lap row's row."""
        found = torch.zeros((nc, b), dtype=torch.bool, device=dev)
        us_c = torch.zeros((n, 2, nc, b), dtype=dtype, device=dev)
        xl_c = torch.zeros((4, nc, b), dtype=dtype, device=dev)
        d_c = torch.zeros((nc, b), dtype=dtype, device=dev)
        for r in range(nsi):
            sl = slice(r * k, (r + 1) * k)
            e_idx, e_ok, e_us, e_xl, e_d = (
                torch.cat([e[i][..., sl, :] for e in solved], dim=-2)
                for i in range(5))
            match = ((cand_idx[sl][:, None] == e_idx[None]) & e_ok[None]
                     & cand_ok[sl][:, None])  # (k, entries, B)
            src = torch.argmax(match.to(torch.int8), dim=1)  # the first
            found[sl] = match.any(dim=1)
            us_c[:, :, sl] = e_us.gather(2, src[None, None].expand(
                n, 2, k, b))
            xl_c[:, sl] = e_xl.gather(1, src[None].expand(4, k, b))
            d_c[sl] = e_d.gather(0, src)
        return found, us_c, xl_c, d_c
    rounds, upass = [], []  # with_stats: a round's (B,) trips, a pass's
    # with_stats at k = 32: each pass's slots, for block_executed
    block = [] if with_stats and k == 32 else None

    def solve(x_terms, done0):
        """Zeros-initialised solves of x_terms (4, C, B): (us, x_last, d,
        trips (C, B))."""
        c = x_terms.shape[1]
        sol = ilqr_solve_soa(params, limits, obs_kb, x0b[:, :c],
                             x_terms, zeros_ws[:, :, :c],
                             float(params.lamb), dt, num_horizon=n,
                             max_iter=max_iter, done0=done0,
                             precision_islands=precision_islands)
        x_last = sol.xs[-1]
        dd = [x_last[i] - x_terms[i] for i in range(4)]
        d = torch.sqrt(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
                       + dd[3] * dd[3])
        return sol.us, x_last, d, sol.lane_iters

    def cached(cand_idx, cand_ok):
        """dedup: (hit (nc, B), d (nc, B), x_last (4, nc, B)) of each slot
        from the earlier passes' solves of its lap row."""
        hit = torch.zeros((nc, b), dtype=torch.bool, device=dev)
        d = torch.zeros((nc, b), dtype=dtype, device=dev)
        xl = torch.zeros((4, nc, b), dtype=dtype, device=dev)
        for e_idx, e_ok, e_d, e_xl in cache:
            for r in range(nsi):
                sl = slice(r * k, (r + 1) * k)
                for j in range(r * k, (r + 1) * k):
                    take = ((cand_idx[sl] == e_idx[j]) & e_ok[j]
                            & cand_ok[sl] & ~hit[sl])
                    d[sl] = torch.where(take, e_d[j], d[sl])
                    xl[:, sl] = torch.where(take, e_xl[:, j:j + 1], xl[:, sl])
                    hit[sl] |= take
        return hit, d, xl

    def reach_cost(d, q, unit):
        i_rel = torch.clamp_min(torch.ceil(true_div(d, unit) - 1e-12), 1.0)
        return torch.where(d <= unit * params.max_relax_iter,
                           q + float(n) + 100.0 * i_rel, inf)

    def extract(xg, cols):
        """The kNN of each lap row at the guesses xg of the lanes ``cols``
        (all: None): (x_terms (4, nc, C), whether each slot holds a row
        (nc, C), rows (nc, C), Qfun (nc, C))."""
        at = (lambda t: t) if cols is None else (lambda t: t[..., cols])
        idx_rows, q_rows, xt_rows, fin_rows = [], [], [], []
        for off in range(nsi):
            st = at(states[laps[off]])  # (T, 4, C)
            dist = (torch.abs(st[:, 0] - xg[0][None])
                    + torch.abs(st[:, 1] - xg[1][None])
                    + torch.abs(st[:, 2] - xg[2][None])
                    + torch.abs(st[:, 3] - xg[3][None]))
            dist = torch.where(t_idx < at(lap_len[laps[off]])[None], dist,
                               inf)
            idx, dval, (x0s, x1s, x2s, x3s, q) = _topk_select(
                dist, k, [st[:, 0], st[:, 1], st[:, 2], st[:, 3],
                          at(qfun[laps[off]])])
            idx_rows.append(idx)
            q_rows.append(q)
            fin_rows.append(torch.isfinite(dval))
            xt_rows.append(torch.stack([x0s, x1s, x2s, x3s]))
        return (torch.cat(xt_rows, dim=1), torch.cat(fin_rows),
                torch.cat(idx_rows), torch.cat(q_rows))

    lap_ok_kb = torch.tensor(oks, device=dev).repeat_interleave(k)[:, None]

    def one_pass(outer, xg, prev):
        if prev is None:  # pass 0, or reuse_extract off
            ext = extract(xg, None)
        else:  # keep the kNN of the lanes whose guess did not move
            xg_prev, ext = prev
            same = (xg == xg_prev).all(dim=0)
            if reused is not None:
                reused.append(same & active)
            moved = torch.nonzero(~same).flatten()
            if moved.numel():
                ext = [t.clone() for t in ext]
                for t, v in zip(ext, extract(xg[:, moved], moved)):
                    t[..., moved] = v
        x_terms, fin, cand_idx, cand_q = ext
        cand_ok = fin & lap_ok_kb  # (nc, B): valid row of a stored lap
        unit = 80.0 / (10 ** outer)
        if dedup:
            hit, d_hit, xl_hit = cached(cand_idx, cand_ok)
        else:
            hit = torch.zeros((nc, b), dtype=torch.bool, device=dev)
        arrive = None  # the slots a lane pays an arrival at: those visited
        if candidate_solver is not None:
            x0_l, u0_l, obs_l, skip_l = cand_args
            if solved:  # dedup_passes, passes 1 and 2
                found, us_c, xl_c, d_c = found_in(cand_idx, cand_ok)
                skip_l = torch.maximum(skip_l, found.reshape(lanes).to(
                    torch.float32))
                if dedup_log is not None:
                    dedup_log.append((found & active[None]).sum())
            us_l, xl_l, _, d_l = candidate_solver(
                x0_l, x_terms.reshape(4, lanes), u0_l, obs_l, skip_l)
            sol_us = us_l.reshape(n, 2, nc, b)
            x_last = xl_l.reshape(4, nc, b)
            d = d_l.reshape(nc, b)
            if solved:
                sol_us = torch.where(found, us_c, sol_us)
                x_last = torch.where(found, xl_c, x_last)
                d = torch.where(found, d_c, d)
            if dedup_passes and outer < 2:
                solved.append((cand_idx, cand_ok, sol_us, x_last, d))
            ran = torch.zeros((nc, b), dtype=torch.int32, device=dev)
            visit = torch.ones((nc, b), dtype=torch.bool, device=dev)
        elif dom_skip or group > 1:
            # the slots in their order, ``group`` at a time, under dom_skip
            # a slot p > 0 skipped when invalid or q + n + 100 >= the best
            # cost of the groups before
            sol_us = torch.zeros((n, 2, nc, b), dtype=dtype, device=dev)
            x_last = torch.zeros((4, nc, b), dtype=dtype, device=dev)
            d = torch.zeros((nc, b), dtype=dtype, device=dev)
            ran = torch.zeros((nc, b), dtype=torch.int32, device=dev)
            visit = torch.ones((nc, b), dtype=torch.bool, device=dev)
            arrive = visit.clone()
            best = torch.full((b,), inf, dtype=dtype, device=dev)
            for g in range(0, nc, group):
                sl = slice(g, g + group)
                slots = torch.arange(g, g + group, device=dev)[:, None]
                dom = ((((cand_q[sl] + float(n) + 100.0) >= best)
                        | ~cand_ok[sl]) & (slots > 0) & dom_skip)
                (sol_us[:, :, sl], x_last[:, sl], d[sl],
                 ran[sl]) = solve(x_terms[:, sl], frozen[sl] | hit[sl] | dom)
                visit[sl] = ~dom
                if dom_skip:
                    d_g = torch.where(hit[sl], d_hit[sl], d[sl]) if dedup \
                        else d[sl]
                    cost = torch.where(cand_ok[sl] & ~dom,
                                       reach_cost(d_g, cand_q[sl], unit), inf)
                    best = torch.minimum(best, cost.amin(dim=0))
                rounds.append(ran[sl].amax(dim=0))
        elif not qsort_skip:  # the plain order: one round of every slot
            sol_us, x_last, d, ran = solve(x_terms, frozen | hit)
            visit = torch.ones((nc, b), dtype=torch.bool, device=dev)
            rounds.append(ran.amax(dim=0))
        else:  # positions in (Qfun, slot) order, one round each
            qe = torch.where(cand_ok, cand_q, inf)
            slots = torch.arange(k, device=dev)[:, None]
            # ahead[i, j]: slot j ranks before slot i
            ahead = ((qe[None] < qe[:, None])
                     | ((qe[None] == qe[:, None])
                        & (slots[None] < slots[:, None])))
            order = torch.argsort(ahead.sum(dim=1), dim=0)  # position -> slot
            sol_us = torch.zeros((n, 2, k, b), dtype=dtype, device=dev)
            x_last = torch.zeros((4, k, b), dtype=dtype, device=dev)
            d = torch.zeros((k, b), dtype=dtype, device=dev)
            ran = torch.zeros((k, b), dtype=torch.int32, device=dev)
            visit = torch.zeros((k, b), dtype=torch.bool, device=dev)
            best = torch.full((b,), inf, dtype=dtype, device=dev)
            alive = active.clone()
            for p in range(k):
                slot = order[p]  # (B,)
                q_p = cand_q.gather(0, slot[None])[0]
                ok_p = cand_ok.gather(0, slot[None])[0]
                lb = torch.where(ok_p, q_p, inf) + float(n) + 100.0
                dom = ((lb > best) | ~ok_p) & (p > 0)
                alive = alive & ~dom  # dominance is monotone in position
                hit_p = hit.gather(0, slot[None])[0]
                xt_p = x_terms.gather(1, slot[None, None].expand(4, 1, b))
                us_p, xl_p, d_p, ran_p = solve(xt_p, ~(alive & ~hit_p)[None])
                cost = reach_cost(d_p[0], q_p, unit)
                if dedup:
                    d_c = d_hit.gather(0, slot[None])[0]
                    cost = torch.where(hit_p, reach_cost(d_c, q_p, unit),
                                       cost)
                best = torch.where(alive & ok_p, torch.minimum(best, cost),
                                   best)
                at = (slots == slot[None]) & alive[None]  # (k, B)
                sol_us = torch.where(at, us_p, sol_us)
                x_last = torch.where(at, xl_p, x_last)
                d = torch.where(at, d_p, d)
                ran = torch.where(at, ran_p, ran)
                visit = visit | at
                rounds.append(ran_p[0])
                if not bool(alive.any()):
                    break
        if dedup:
            d = torch.where(hit, d_hit, d)
            x_last = torch.where(hit, xl_hit, x_last)
        cost = torch.where(cand_ok & visit, reach_cost(d, cand_q, unit), inf)
        # ragged Python-list comparison: a row shorter than k (k exceeds the
        # stored lap's length) ranks its absent tail slots -inf; rows of
        # laps not yet stored rank above everything (batched_soa.py:656-668)
        cmp = torch.where(lap_ok_kb, torch.where(cand_ok, cost, -inf), inf)
        best_row = _lex_argmin_rows(cmp.reshape(nsi, k, b))
        row_cost = cost.reshape(nsi, k, b).gather(
            0, best_row[None, None].expand(1, k, b))[0]
        win = best_row * k + torch.argmin(row_cost, dim=0)  # (B,)
        us_sel = sol_us.gather(2, win[None, None, None].expand(n, 2, 1, b))
        xl_sel = x_last.gather(1, win[None, None].expand(4, 1, b))[:, 0]
        idx_sel = cand_idx.gather(0, win[None])[0]
        if dedup and outer < 2:
            cache.append((cand_idx, cand_ok & visit, d, x_last))
        if trips is not None:
            trips.append(ran)
        arrive = visit if arrive is None else arrive
        upass.append((ran.to(torch.int64)
                      + (arrive & active).to(torch.int64)).sum(0))
        if cands is not None:
            cands.append((cand_idx, fin, win))
        if block is not None:
            block.append((cand_idx, fin, ran, hit, win))
        again = active & hit.gather(0, win[None])[0]  # a winner not solved
        xt_sel = x_terms.gather(1, win[None, None].expand(4, 1, b))
        return (xl_sel, us_sel[:, :, 0], idx_sel, best_row, ran, again,
                xt_sel, (xg, ext) if reuse_extract else None)

    xg, prev = g0, None
    useful = torch.zeros(b, dtype=torch.int64, device=dev)
    for outer in range(3):
        (xg, us_sel, idx_sel, best_row, ran, again, xt_sel,
         prev) = one_pass(outer, xg, prev)
        useful += ran.to(torch.int64).sum(0)
    if dedup and bool(again.any()):  # the final winner solved again
        us_w, _, _, ran_w = solve(xt_sel, ~again[None])
        us_sel = torch.where(again, us_w[:, :, 0], us_sel)
        useful += ran_w[0]
        upass[-1] = upass[-1] + ran_w[0] + again.to(torch.int64)
        rounds.append(ran_w[0])
        if trips is not None:
            trips.append(ran_w)
    lap_sel = torch.tensor(laps, device=dev)[best_row]
    chosen_len = lap_len.gather(0, lap_sel[None])[0]
    shrink = ((idx_sel + 1) > (chosen_len - 1)).to(dtype)
    outs = (torch.where(active, us_sel, 0.0),
            torch.where(active, shrink, 0.0),
            torch.where(active, idx_sel, 0).to(torch.int32),
            torch.where(active, best_row, 0).to(torch.int32))
    if not with_stats:
        return outs
    executed = (block_executed(block, laps, oks, active, t_rows)
                if block is not None
                else warp_executed(rounds, active,
                                   1 if qsort_skip or dom_skip else nc))
    return outs + (torch.where(active, useful, 0).to(torch.int32), executed,
                   queue_floor(torch.stack(upass), floor_width))


def check_options(nsi, k, qsort_skip, dom_skip, group, with_stats):
    """The JAX factory's guards of K1's options (pallas_i2lqr_step.py:
    192-208)."""
    if dom_skip and nsi != 1:
        raise ValueError("dom_skip requires num_ss_iter == 1 (the "
                         "lexicographic row-min over laps needs exact "
                         "per-candidate costs, base.py:462)")
    if qsort_skip:
        if nsi != 1:
            raise ValueError("qsort_skip requires num_ss_iter == 1 (the "
                             "lexicographic row-min over laps needs exact "
                             "per-candidate costs, base.py:462)")
        if dom_skip:
            raise ValueError("qsort_skip supersedes dom_skip: enable one")
        if group > 1:
            raise ValueError("qsort_skip supports group=1 only")
    if group < 1 or (nsi * k) % group:
        raise ValueError(f"group={group} must divide nsi*k")
    if group > 1 and with_stats:
        raise ValueError("with_stats is only instrumented for group=1")


# Kernel options of the TPU factory that the port does not take, and why:
# VMEM space trades of the TPU kernel, with no computation to port.
_UNPORTED = {
    "stream_safe_set": "the port's K1 always reads the safe set from "
                       "global memory",
    "store_solutions": "the port's K1 keeps no candidate's solution but "
                       "the ones its threads hold (a winner not held is "
                       "solved again)",
}


# The lanes from which a launch of K1's lane queue (qsort_skip without
# counts) runs it; below them the plain order. Measured
# (experiments/kernel_ab.py --k1, K1's CUDA-event ms a run, the two orders
# in turns; H100 80GB HBM3, 700 W; PERF.md): on the i2LQR headline's
# scenarios the queue wins from 16 384 lanes on, on the sweep's k8_nsi1
# from 40 960 (at 32 768 it is 0.5-2.7 % slower). So B = 4 096 (the
# sweep), 8 192, 16 384 and 32 768 run the plain order, B = 40 960 and
# 49 152 (the headline) the lane queue. The switch reads the launch's
# lanes, so a tail_shrink launch over a 4 096-lane prefix runs the plain
# order (there 0.63 ms against the queue's 1.89). A stall_reseed run,
# whose reseeded lanes visit every position in series, lost in the queue
# at every batch (4 096-49 152: 1.40-2.44 s of K1 a run against
# 0.38-1.50): the simulator builds its K1 without the queue there
# (control/batched_soa.py, default_step_solver's ``reseeded``).
LANE_QUEUE_FROM = 40960


# The option bits of i2lqr_step_opts_launch (csrc/i2lqr_step_opts.cu)
OPT_STATS, OPT_DEDUP, OPT_QSORT, OPT_REUSE, OPT_DOM = 1, 2, 4, 8, 16


class FusedI2lqrStep:
    """K1: one whole i2LQR control step per lane. Attributes k, nsi,
    num_horizon, max_steps, max_laps, max_iter, dedup, qsort_skip,
    with_stats, floor_width, reuse_extract, dom_skip and group describe
    what it was built for; ``launches`` counts kernel launches. Use
    ``build_fused_i2lqr_step``."""

    def __init__(self, params: IlqrParams, limits: SystemLimits, dt, *,
                 num_horizon: int, max_steps: int, max_laps: int,
                 max_iter: int = 150, dedup: bool = False,
                 qsort_skip: bool = False, with_stats: bool = False,
                 floor_width: int = 32, reuse_extract: bool = False,
                 dom_skip: bool = False, group: int = 1):
        self.params, self.limits, self.dt = params, limits, float(dt)
        self.k = params.num_ss_points
        self.nsi = params.num_ss_iter
        self.num_horizon = num_horizon
        self.max_steps = max_steps
        self.max_laps = max_laps
        self.max_iter = max_iter
        self.dedup, self.qsort_skip = dedup, qsort_skip
        self.with_stats, self.floor_width = with_stats, floor_width
        self.reuse_extract, self.dom_skip = reuse_extract, dom_skip
        self.group = group
        if num_horizon != params.num_horizon:
            raise ValueError(f"num_horizon={num_horizon} differs from "
                             f"params.num_horizon={params.num_horizon}")
        self._consts = _build.consts_array(solver_consts(params, limits, dt))
        # the options at k = 8; k = 32 pools its distinct solves whatever
        # dedup says, and reuse_extract is its one option
        self._opts = ((OPT_STATS if with_stats else 0)
                      | (OPT_DEDUP if dedup else 0)
                      | (OPT_QSORT if qsort_skip else 0)
                      | (OPT_REUSE if reuse_extract else 0)
                      | (OPT_DOM if dom_skip else 0))
        if self.k != 8:
            self._opts &= OPT_REUSE
        self.launches = 0

    def lane_queue_runs(self, b) -> bool:
        """Whether a launch of ``b`` lanes runs the lane queue (one thread
        a lane) of qsort_skip or dom_skip: always with counts, else from
        ``LANE_QUEUE_FROM`` lanes (measured for qsort_skip); below it the
        step runs the plain order, the same bits. The same ``b`` always
        runs the same kernel."""
        return bool((self.qsort_skip or (self.dom_skip and self.group == 1))
                    and self.k == 8
                    and (self.with_stats or b >= LANE_QUEUE_FROM))

    def __call__(self, x, g0, states, qfun, lap_len, lap_ids, lap_ok, obs,
                 skip, lanes=None):
        """One step of every lane, or with ``lanes`` of the first ``lanes``
        (the arrays keep their B lanes: no copy); the outputs past them
        are zeros, as a skipped lane's."""
        b = x.shape[-1]
        lanes = b if lanes is None else int(lanes)
        if not 0 <= lanes <= b:
            raise ValueError(f"lanes={lanes} outside a batch of {b}")
        if x.device.type == "cpu":
            return on_prefix(lambda *a: i2lqr_step_reference(
                self.params, self.limits, self.dt, *a, max_iter=self.max_iter,
                dedup=self.dedup, qsort_skip=self.qsort_skip,
                with_stats=self.with_stats, floor_width=self.floor_width,
                reuse_extract=self.reuse_extract, dom_skip=self.dom_skip,
                group=self.group),
                lanes,
                (x, g0, states, qfun, lap_len), (lap_ids, lap_ok),
                (obs, skip))
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        dev, dtype = x.device, x.dtype
        if dtype not in DTYPE_CODES:
            raise TypeError(f"unsupported dtype {dtype}")
        n, nsi, t_rows, ml = (self.num_horizon, self.nsi, self.max_steps,
                              self.max_laps)
        check_lanes("x", x, (4, b), dtype, dev)
        check_lanes("g0", g0, (4, b), dtype, dev)
        check_lanes("states", states, (ml, t_rows, 4, b), dtype, dev)
        check_lanes("qfun", qfun, (ml, t_rows, b), dtype, dev)
        check_lanes("lap_len", lap_len, (ml, b), torch.int32, dev)
        check_lanes("lap_ids", lap_ids, (nsi,), torch.int32, dev)
        check_lanes("lap_ok", lap_ok, (nsi,), torch.int32, dev)
        check_lanes("obs", obs, (6, b), dtype, dev)
        check_lanes("skip", skip, (b,), torch.float32, dev)
        i32 = torch.int32
        us, shrink, idx_sel, row_sel, *stats = lane_outputs(
            [((n, 2, b), dtype), ((b,), dtype), ((b,), i32), ((b,), i32)]
            + ([((5, b), i32)] if self.with_stats else []), b, lanes, dev)
        ins = (x.data_ptr(), g0.data_ptr(), states.data_ptr(),
               qfun.data_ptr(), lap_len.data_ptr(), lap_ids.data_ptr(),
               lap_ok.data_ptr(), obs.data_ptr(), skip.data_ptr(),
               us.data_ptr(), shrink.data_ptr(), idx_sel.data_ptr(),
               row_sel.data_ptr())
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if self.with_stats:
                stats = stats[0]
                counts = (stats[0].data_ptr(), stats[1].data_ptr(),
                          stats[2].data_ptr())
            opts = self._opts
            if not self.lane_queue_runs(lanes):  # the plain order
                opts &= ~(OPT_QSORT | OPT_DOM)
                if opts & OPT_REUSE == 0 and (self.qsort_skip
                                              or self.dom_skip):
                    opts = 0  # the tile kernel without options
            if self.group > 1:
                rc = lib.i2lqr_step_group_launch(
                    DTYPE_CODES[dtype], n, self.k, nsi, self.group,
                    opts & (OPT_DEDUP | OPT_REUSE), self._consts,
                    self.max_iter, b, t_rows, ml, *ins, stream, lanes)
            elif self.with_stats and self.k == 32:
                rc = lib.i2lqr_step_block_stats_launch(
                    DTYPE_CODES[dtype], n, nsi,
                    (OPT_DEDUP if self.dedup else 0) | opts, self._consts,
                    self.max_iter, b, t_rows, ml, *ins, *counts, stream,
                    lanes)
            elif opts and self.k == 32:  # reuse_extract
                rc = lib.i2lqr_step_block_reuse_launch(
                    DTYPE_CODES[dtype], n, nsi, self._consts, self.max_iter,
                    b, t_rows, ml, *ins, stream, lanes)
            elif opts:
                if not self.with_stats:
                    counts = (None,) * 3
                counter = torch.empty(1, dtype=torch.int32, device=dev)
                rc = lib.i2lqr_step_opts_launch(
                    DTYPE_CODES[dtype], n, self.k, nsi, opts,
                    self._consts, self.max_iter, b, t_rows, ml, *ins,
                    *counts, counter.data_ptr(), stream, lanes)
            else:
                rc = lib.i2lqr_step_launch(
                    DTYPE_CODES[dtype], n, self.k, nsi, self._consts,
                    self.max_iter, b, t_rows, ml, *ins, stream, lanes)
        _build.check_launch(rc, "i2lqr_step")
        self.launches += 1
        if not self.with_stats:
            return us, shrink, idx_sel, row_sel
        floor = torch.zeros((b,), dtype=torch.int32, device=dev)
        floor[:lanes] = queue_floor(stats[2:, :lanes], self.floor_width)
        return us, shrink, idx_sel, row_sel, stats[0], stats[1], floor


def on_prefix(plain, lanes, lane_args, shared_args, more_args):
    """``plain`` (a plain step) on the first ``lanes`` lanes of its
    lane-trailing arguments, its outputs padded with zeros to B lanes: the
    CPU route of a kernel launched over a prefix (JAX ``_run_small``,
    batched_soa.py:478-500). Arguments: the lane-trailing ones before the
    shared (unsliced) ones, then the rest, lane-trailing or None."""
    b = lane_args[0].shape[-1]
    if lanes == b:
        return plain(*lane_args, *shared_args, *more_args)
    cut = lambda a: None if a is None else a[..., :lanes]
    out = plain(*map(cut, lane_args), *shared_args, *map(cut, more_args))
    return tuple(torch.cat([o, o.new_zeros(o.shape[:-1] + (b - lanes,))],
                           dim=-1) for o in out)


def build_fused_i2lqr_step(params: IlqrParams, limits: SystemLimits, dt, *,
                           num_horizon: int, max_steps: int, max_laps: int,
                           max_iter: int = 150, dedup: bool = False,
                           qsort_skip: bool = False,
                           with_stats: bool = False, floor_width: int = 32,
                           reuse_extract: bool = False,
                           dom_skip: bool = False, group: int = 1,
                           **unported) -> FusedI2lqrStep:
    """Factory mirroring the JAX package's ``build_fused_i2lqr_step``
    (pallas_i2lqr_step.py:47), with its guards (:192-208,
    ``check_options``). Every option is a bitwise-neutral schedule of
    ``i2lqr_step_reference``. At k = 8, csrc/i2lqr_step_opts.cu runs
    ``dedup``, ``reuse_extract`` and ``with_stats`` on a tile of nsi*k
    threads a lane, and ``qsort_skip`` or ``dom_skip`` (nsi = 1) as a lane
    queue of one thread a lane; ``with_stats`` appends three (B,) i32
    counts (``iters_useful``, ``iters_executed``, ``queue_floor`` at
    ``floor_width`` lanes: 32, a warp of one thread a lane, unless a
    caller asks for JAX's 128) to the four outputs.
    csrc/i2lqr_step_group.cu runs ``group`` > 1 (with ``dedup``,
    ``reuse_extract`` and ``dom_skip``): nsi*k / group threads a lane, each
    solving its group's members in one interleaved LM loop. Without
    options the k = 8 step runs csrc/i2lqr_step.cu's tile kernel, the
    plain order, and so does a ``qsort_skip`` or ``dom_skip`` K1 without
    counts on fewer than ``LANE_QUEUE_FROM`` lanes
    (``FusedI2lqrStep.lane_queue_runs``, a measured switch). At k = 32 the
    kernel pools each step's distinct candidate solves, which is ``dedup``
    in effect (the JAX sweep's ``dedup=True, store_solutions=False``
    build), so ``dedup`` is taken there and changes only the counts;
    ``reuse_extract`` and ``with_stats`` run instantiations of it of their
    own (``iters_executed`` a lane's warp's, ``block_executed``), and
    ``qsort_skip``, ``dom_skip`` (nsi >= 2) and ``group`` raise on the
    card. The TPU options in ``_UNPORTED`` raise."""
    for name in unported:
        if name not in _UNPORTED:
            raise TypeError(f"unexpected keyword argument {name!r}")
        raise ValueError(f"{name} is not taken by the port: "
                         f"{_UNPORTED[name]}")
    check_options(params.num_ss_iter, params.num_ss_points, qsort_skip,
                  dom_skip, group, with_stats)
    return FusedI2lqrStep(params, limits, dt, num_horizon=num_horizon,
                          max_steps=max_steps, max_laps=max_laps,
                          max_iter=max_iter, dedup=dedup,
                          qsort_skip=qsort_skip, with_stats=with_stats,
                          floor_width=floor_width,
                          reuse_extract=reuse_extract, dom_skip=dom_skip,
                          group=int(group))
