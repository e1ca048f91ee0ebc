"""Batch-native (structure-of-arrays) NLMPC learning simulator in torch.

Port of the base path of ilqr_iterative_tasks_tpu/control/batched_nlmpc_soa.py
(``simulate_nlmpc_runs_soa`` :94 with ``resume_from``, ``pallas_solver``
and ``with_streak_stats``, ``_advance_tail`` :254, ``run_lap`` :607,
``lap_loop`` :827), in the safe-set modes spaceVarying, timeVarying and all
(``LmpcParams.ss_mode``), the last num_ss_iter laps a step or, with
``all_ss_iter``, every stored lap. The scenario batch B is the trailing
axis of every tensor; all B lanes run in lockstep and a lane that finishes
its lap freezes. Each control step's ``calc_input`` is one call of a step
solver: the K2 kernel (ops/nlmpc_step.py::build_fused_nlmpc_step), or the
plain step's glue around a per-candidate solver, the K4 kernel
(``candidate_solver``, ops/fused_lm_shooting.py::build_fused_lm_shooting).
On CUDA scenarios with neither given the simulator builds K2 itself, or K4
for the kNN or window over every stored lap, which no K2 serves. The plain
step with its plain solve runs only for scenarios on the CPU. Per lane
the simulator keeps the
terminal guess, the warm start and the shrinking horizon: each lap starts
at horizon n with the newest stored lap's row n as guess and its first n
stored inputs as warm start; choosing a lap's last point shrinks the
horizon by one (to 1 at least), and an all-infeasible step holds the
previous input and freezes every advance.

Plant noise and its sources are as in control/batched_soa.py: one (2, B)
standard-normal row per executed simulator step, from a
``torch.Generator`` or an injected ``noise`` tensor; ``final_key`` and
``resume_from`` continue it as there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ilqr_iterative_tasks_torch.control import batched_soa
from ilqr_iterative_tasks_torch.control.batched_soa import (
    SoaScenarios, _step_solver_inputs, draw_noise, noise_key, plant_step,
    refuse, resume_noise, resumed_safe_set, solver_of)
from ilqr_iterative_tasks_torch.ops import _build
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    FusedLmShooting, build_fused_lm_shooting, obstacle_to_lanes_nlmpc)
from ilqr_iterative_tasks_torch.ops.nlmpc_step import (
    FusedNlmpcStep, build_fused_nlmpc_step, nlmpc_step_reference)
from ilqr_iterative_tasks_torch.utils.params import (
    LmpcParams, SystemLimits, nlmpc_consts)


class NlmpcSoaRunResult(NamedTuple):
    lap_steps: torch.Tensor  # (num_laps, B) i32
    lap_done: torch.Tensor  # (num_laps, B) bool
    final_x: torch.Tensor  # (4, B): the lanes' state at the end of the run
    safe_set: tuple  # (states, inputs, qfun, valid, lap_len), batch-trailing
    lap_count: int  # laps stored, seed included
    # the noise position after the run (batched_soa.noise_key): pass
    # (safe_set, lap_count, final_key) back as ``resume_from``
    final_key: object = None
    # with_streak_stats: (recovered (num_laps, B), terminal (num_laps, B))
    # i32, each lane-lap's longest all-infeasible streak that feasibility
    # ended and its streak at the lap's end
    streaks: tuple = ()


def add_lap(ss, slot, xs_rec, us_rec, n_valid):
    """Store a lap with its inputs in slot ``slot`` of the safe set, in
    place. xs_rec: (T, 4, B); us_rec: (T, 2, B); n_valid: (B,)."""
    states, inputs, qfun, valid, lap_len = ss
    inputs[slot] = us_rec
    batched_soa.add_lap((states, qfun, valid, lap_len), slot, xs_rec,
                        n_valid)


def advance_tail(us_w, u_app, new_guess0, succ, h1, hzn, feasible_any,
                 guess, u_warm):
    """Post-selection bookkeeping (batched_nlmpc_soa.py:254-287): the
    applied input, the warm-start shift with the chosen point's stored
    input at slot hzn-1 when a successor exists, the horizon decrement,
    and the all-infeasible freeze. Returns (u_sel, guess, u_warm, hzn)."""
    n = us_w.shape[0]
    u_sel = torch.where(h1[None], u_warm[0], us_w[0])
    u_shift = torch.cat([us_w[1:], us_w[-1:]])
    pos = torch.clamp(hzn - 1, 0, n - 1)
    oh_pos = torch.arange(n, device=hzn.device)[:, None] == pos[None]
    u_warm_a = torch.where(oh_pos[:, None], u_app[None], u_shift)
    u_warm_new = torch.where(succ[None, None], u_warm_a, u_shift)
    # horizon-1 floor without a successor keeps the warm vector
    u_warm_new = torch.where((h1 & ~succ)[None, None], u_warm, u_warm_new)
    hzn_next = torch.where(succ, hzn, torch.clamp_min(hzn - 1, 1))
    new_guess = torch.where(feasible_any[None], new_guess0, guess)
    u_warm_new = torch.where(feasible_any[None, None], u_warm_new, u_warm)
    hzn_next = torch.where(feasible_any, hzn_next, hzn)
    return u_sel, new_guess, u_warm_new, hzn_next


_K2_CACHE: dict = {}


def default_options(params: LmpcParams) -> dict:
    """The K2 options ``default_step_solver`` builds with, as the JAX bench
    rows ship them: ``qsort_skip`` for timeVarying (bench.py:207-211; on the
    card its step takes an eighth of the plain order's, PERF.md) and
    spaceVarying (bench.py:145-148; on the card it launches the plain-order
    kernel, so it costs nothing there), and ``all_rev_skip``
    for all with one lap row (bench.py:218-221); all with ``all_ss_iter``
    scans forward. Each is bitwise-neutral."""
    one_row = params.num_ss_iter == 1
    if params.ss_mode == "all":
        return dict(all_rev_skip=one_row and not params.all_ss_iter)
    return dict(qsort_skip=one_row)


def default_step_solver(params: LmpcParams, limits: SystemLimits, dt, *,
                        max_steps: int, max_laps: int,
                        max_iters: int) -> FusedNlmpcStep:
    """The K2 that ``simulate_nlmpc_runs_soa`` launches on CUDA scenarios
    when no step_solver is passed, with ``default_options``: built once per
    constants, sizes and safe-set mode, then reused (its ``launches`` keeps
    counting)."""
    key = (tuple(_build.nlmpc_consts_array(nlmpc_consts(limits, dt))),
           params.num_ss_points, params.num_ss_iter, params.num_horizon,
           params.ss_mode, params.all_ss_iter, max_steps, max_laps,
           max_iters)
    if key not in _K2_CACHE:
        _K2_CACHE[key] = build_fused_nlmpc_step(
            params, limits, dt, num_horizon=params.num_horizon,
            max_steps=max_steps, max_laps=max_laps, max_iters=max_iters,
            **default_options(params))
    return _K2_CACHE[key]


_K4_CACHE: dict = {}


def default_candidate_solver(limits: SystemLimits, dt, *, num_horizon: int,
                             max_iters: int) -> FusedLmShooting:
    """The K4 that ``simulate_nlmpc_runs_soa`` launches on CUDA scenarios
    for the options no K2 serves (``all_ss_iter`` outside mode all) when no
    solver is passed: built once per constants, horizon and cap, then
    reused (its ``launches`` keeps counting)."""
    key = (tuple(_build.nlmpc_consts_array(nlmpc_consts(limits, dt))),
           num_horizon, max_iters)
    if key not in _K4_CACHE:
        _K4_CACHE[key] = build_fused_lm_shooting(
            limits, dt, num_horizon=num_horizon, max_iters=max_iters)
    return _K4_CACHE[key]


def k2_serves(params: LmpcParams) -> bool:
    """Whether a K2 runs these safe-set options: all but the kNN or window
    over every stored lap (build_fused_nlmpc_step)."""
    return params.ss_mode == "all" or not params.all_ss_iter


def lap_window(lap_count: int, nsi: int, max_laps: int, all_iter: bool, b,
               device):
    """(lap_ids, lap_ok) of a step: the last nsi stored laps, or with
    ``all_iter`` every slot, flagged stored or not (JAX ``_lap_window``,
    batched_nlmpc_soa.py:244-252)."""
    if all_iter:
        lap_ids = torch.arange(max_laps, dtype=torch.int32, device=device)
        return lap_ids, (lap_ids < lap_count).to(torch.int32)
    lap_ids, lap_ok, _ = _step_solver_inputs(lap_count, nsi, max_laps, None,
                                             b, device)
    return lap_ids, lap_ok


_UNSUPPORTED = ("retile_frac", "tail_shrink")


def simulate_nlmpc_runs_soa(params: LmpcParams, limits: SystemLimits,
                            scenarios: SoaScenarios, seed_xs, seed_us,
                            seed_len: int, dt, *, num_laps: int,
                            max_steps: int = 128, max_laps: int = 16,
                            goal_append: bool = False,
                            sim_step_budget: int = 121,
                            max_lm_iters: int = 60,
                            infeasible_retire: int | None = None,
                            with_streak_stats: bool = False,
                            step_solver=None,
                            candidate_solver=None,
                            noise: torch.Tensor | None = None,
                            generator: torch.Generator | None = None,
                            resume_from=None,
                            **unsupported) -> NlmpcSoaRunResult:
    """Seed lap + ``num_laps`` NLMPC learning laps for B scenarios.

    seed_xs: (max_steps, 4) and seed_us: (max_steps, 2) seed lap, padded;
    seed_len: count of seed states. ``max_lm_iters`` caps the LM
    iterations of every solve. ``infeasible_retire=S`` retires a lane from
    the solver after S consecutive all-infeasible steps (it keeps
    integrating its held input); ``with_streak_stats`` fills the result's
    ``streaks``, the measurement that sizes S. ``step_solver``: a K2 built
    by ``build_fused_nlmpc_step`` for the same sizes and safe-set mode (in
    timeVarying it also takes each lane's step t and the least stored lap
    cost). ``candidate_solver`` (the JAX ``pallas_solver``): a K4 built by
    ``build_fused_lm_shooting`` for the same limits and horizon with
    ``max_iters`` equal to the cap; the plain step's glue then calls it for
    every candidate solve (``nlmpc_step_reference``). With neither: on
    CUDA scenarios ``default_step_solver``'s K2, or
    ``default_candidate_solver``'s K4 where no K2 serves the options
    (``k2_serves``), and on CPU ones the plain step. ``noise`` (steps, 2, B)
    standard-normal draws or ``generator``: the plant-noise source (needed
    where noise_on is set). ``resume_from``: (safe_set, lap_count, key),
    as for ``batched_soa.simulate_learning_runs_soa``.
    """
    refuse(unsupported, _UNSUPPORTED)
    n, k, nsi = params.num_horizon, params.num_ss_points, params.num_ss_iter
    mode, all_iter = params.ss_mode, bool(params.all_ss_iter)

    def default():
        if k2_serves(params):
            return default_step_solver(
                params, limits, dt, max_steps=max_steps, max_laps=max_laps,
                max_iters=max_lm_iters), None
        return None, default_candidate_solver(
            limits, dt, num_horizon=n, max_iters=max_lm_iters)

    step_solver, candidate_solver = solver_of(
        step_solver, candidate_solver, "max_iters", max_lm_iters,
        ("with_skip", "with_hzn"), scenarios.x0.device.type != "cpu",
        default)
    if step_solver is not None:
        s = step_solver
        # a solver without these attributes is taken for spaceVarying over
        # the last nsi laps, as the JAX simulator takes it (:182-187)
        s_mode = getattr(s, "mode", "spaceVarying")
        s_iter = bool(getattr(s, "all_iter", False))
        if (s_mode, s_iter) != (mode, all_iter):
            raise ValueError(
                f"step_solver was built for mode={s_mode!r} (all_iter="
                f"{s_iter}); the simulator was called with ss mode "
                f"{mode!r} (all_ss_iter={all_iter})")
        if ((s.k, s.nsi, s.num_horizon, s.max_steps, s.max_laps, s.max_iters)
                != (k, nsi, n, max_steps, max_laps, max_lm_iters)):
            raise ValueError(
                "step_solver was built for (k, nsi, n, max_steps, max_laps, "
                f"max_iters)=({s.k}, {s.nsi}, {s.num_horizon}, "
                f"{s.max_steps}, {s.max_laps}, {s.max_iters}); the simulator "
                f"was called with ({k}, {nsi}, {n}, {max_steps}, {max_laps}, "
                f"{max_lm_iters})")
        solver = s
    else:
        def solver(*args):
            return nlmpc_step_reference(params, limits, dt, *args,
                                        max_iters=max_lm_iters,
                                        candidate_solver=candidate_solver)
    if max_steps < sim_step_budget + (2 if goal_append else 1):
        raise ValueError(
            f"max_steps={max_steps} too small for sim_step_budget="
            f"{sim_step_budget} (+{2 if goal_append else 1} recorded rows)")
    x0 = scenarios.x0
    dtype, dev = x0.dtype, x0.device
    b = x0.shape[-1]
    if noise is None and generator is None and bool(
            (scenarios.noise_on != 0).any()):
        raise ValueError("noise_on is set: pass a generator or noise draws")
    lanes = torch.arange(b, device=dev)
    t_rows = torch.arange(max_steps, device=dev)[:, None]

    if resume_from is None:
        states = torch.zeros((max_laps, max_steps, 4, b), dtype=dtype,
                             device=dev)
        inputs = torch.zeros((max_laps, max_steps, 2, b), dtype=dtype,
                             device=dev)
        qfun = torch.zeros((max_laps, max_steps, b), dtype=dtype, device=dev)
        valid = torch.zeros((max_laps, max_steps, b), dtype=torch.bool,
                            device=dev)
        lap_len = torch.zeros((max_laps, b), dtype=torch.int32, device=dev)
        ss = (states, inputs, qfun, valid, lap_len)
        seed = lambda a, c: torch.as_tensor(a, dtype=dtype, device=dev)[
            :, :, None].expand(max_steps, c, b)
        add_lap(ss, 0, seed(seed_xs, 4), seed(seed_us, 2),
                torch.full((b,), int(seed_len), dtype=torch.int32,
                           device=dev))
        lap0, sim_step = 1, 0
    else:
        ss, lap0, key = resume_from
        ss, lap0 = resumed_safe_set(ss, (dtype, dtype, dtype, torch.bool,
                                         torch.int32), dev), int(lap0)
        states, inputs, qfun, valid, lap_len = ss
        sim_step = resume_noise(key, noise, generator)
    if lap0 + num_laps > max_laps:
        raise ValueError(f"max_laps={max_laps} cannot hold {lap0} stored "
                         f"and {num_laps} more laps")
    goal, noise_on = scenarios.goal, scenarios.noise_on
    lap_steps = torch.zeros((num_laps, b), dtype=torch.int32, device=dev)
    lap_done = torch.zeros((num_laps, b), dtype=torch.bool, device=dev)
    if with_streak_stats:
        streaks = (torch.zeros((num_laps, b), dtype=torch.int32, device=dev),
                   torch.zeros((num_laps, b), dtype=torch.int32, device=dev))
    # sim_step: executed steps over the run (and the run it resumes), the
    # noise row
    x = x0

    for lap_i in range(num_laps):
        lap_count = lap0 + lap_i  # laps stored so far (seed + learned)
        guess = states[lap_count - 1, n]  # warm start from the newest lap
        u_warm = inputs[lap_count - 1, :n]
        lap_ids, lap_ok = lap_window(lap_count, nsi, max_laps, all_iter, b,
                                     dev)
        # timeVarying: the least stored lap cost over every stored lap
        # (batched_nlmpc_soa.py:529-533), fixed within a lap
        min_cost = (lap_len[:lap_count] - 1).amin(dim=0).to(torch.int32)
        x = x0
        t = torch.zeros((b,), dtype=torch.int32, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        retired = torch.zeros((b,), dtype=torch.bool, device=dev)
        streak = torch.zeros((b,), dtype=torch.int32, device=dev)
        rec_max = torch.zeros((b,), dtype=torch.int32, device=dev)
        hzn = torch.full((b,), n, dtype=torch.int32, device=dev)
        u_prev = torch.zeros((2, b), dtype=dtype, device=dev)
        obstacle = scenarios.obstacle
        xs_rec = torch.zeros((max_steps, 4, b), dtype=dtype, device=dev)
        us_rec = torch.zeros((max_steps, 2, b), dtype=dtype, device=dev)
        xs_rec[0] = x0
        while bool(((t < sim_step_budget) & ~done).any()):
            skip = (done | retired).to(torch.float32)
            if bool((skip < 0.5).any()):
                extra = (t, min_cost) if mode == "timeVarying" else ()
                us_w, feas_f, new_guess0, idx_sel, row_sel, succ_f = solver(
                    x, guess, u_warm, states, qfun, lap_len, lap_ids, lap_ok,
                    obstacle_to_lanes_nlmpc(obstacle, b), skip, hzn, *extra)
            else:  # every lane done or retired: outputs would be zeros
                us_w = torch.zeros((n, 2, b), dtype=dtype, device=dev)
                feas_f = succ_f = torch.zeros((b,), dtype=dtype, device=dev)
                new_guess0 = torch.zeros((4, b), dtype=dtype, device=dev)
                idx_sel = row_sel = torch.zeros((b,), dtype=torch.int32,
                                                device=dev)
            feas = feas_f > 0.5
            # the chosen point's stored input
            lap_sel = lap_ids.to(torch.int64)[row_sel.to(torch.int64)]
            u_app = inputs[lap_sel, idx_sel.to(torch.int64), :, lanes].T
            u_solve, guess_new, u_warm_new, hzn_new = advance_tail(
                us_w, u_app, new_guess0, succ_f > 0.5, hzn <= 1, hzn, feas,
                guess, u_warm)
            # retired lanes: the solver's outputs are skip-lane zeros
            feas = feas & ~retired
            guess_new = torch.where(retired[None], guess, guess_new)
            u_warm_new = torch.where(retired[None, None], u_warm, u_warm_new)
            hzn_new = torch.where(retired, hzn, hzn_new)
            streak_next = torch.where(done, streak,
                                      torch.where(feas, 0, streak + 1))
            if with_streak_stats:  # a streak that feasibility ended
                rec_max = torch.where(~done & feas & (streak > 0),
                                      torch.maximum(rec_max, streak),
                                      rec_max)
            if infeasible_retire is not None:
                retired = retired | ((streak_next >= infeasible_retire)
                                     & ~done)
            u = torch.where(feas[None], u_solve, u_prev)
            z = draw_noise(noise, generator, sim_step, b, dtype, dev)
            sim_step += 1
            x_next, obstacle, reach = plant_step(x, u, dt, z, noise_on, done,
                                                 obstacle, goal)
            # freeze finished lanes
            t_next = torch.where(done, t, t + 1)
            guess = torch.where(done[None], guess, guess_new)
            u_warm = torch.where(done[None, None], u_warm, u_warm_new)
            hzn = torch.where(done, hzn, hzn_new)
            u_prev = torch.where(done[None], u_prev, u)
            streak = streak_next
            # record writes: input row t (zeros for done lanes, whose row t
            # was never written) and state row t_next
            us_rec = torch.where((t_rows == t[None])[:, None],
                                 torch.where(done[None], 0.0, u)[None],
                                 us_rec)
            xs_rec = torch.where((t_rows == t_next[None])[:, None],
                                 x_next[None], xs_rec)
            done = done | reach
            x, t = x_next, t_next
        pos, n_valid = (t + 1, t + 2) if goal_append else (t, t + 1)
        xs_rec[pos.to(torch.int64), :, lanes] = goal.T
        add_lap(ss, lap_count, xs_rec, us_rec, n_valid)
        lap_steps[lap_i] = t
        lap_done[lap_i] = done
        if with_streak_stats:
            streaks[0][lap_i] = rec_max
            streaks[1][lap_i] = streak
    return NlmpcSoaRunResult(
        lap_steps=lap_steps, lap_done=lap_done, final_x=x, safe_set=ss,
        lap_count=lap0 + num_laps,
        final_key=noise_key(noise, generator, sim_step),
        streaks=streaks if with_streak_stats else ())
