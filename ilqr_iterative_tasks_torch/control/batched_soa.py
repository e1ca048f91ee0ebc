"""Batch-native (structure-of-arrays) i2LQR learning simulator in torch.

Port of the base path of ilqr_iterative_tasks_tpu/control/batched_soa.py
(``SoaScenarios.randomized`` :56, ``simulate_learning_runs_soa`` :237 with
its ``stall_reseed`` guard, ``resume_from`` and ``pallas_solver``,
``run_lap`` :717, ``lap_loop`` :924).
The scenario batch B is the trailing axis of every tensor. All B lanes run in
lockstep; a lane that finishes its lap freezes until every lane finishes or
the step budget runs out. Each control step's ``calc_input`` is one call of
a step solver: the K1 kernel (ops/i2lqr_step.py::build_fused_i2lqr_step),
which the simulator builds itself for CUDA scenarios when the caller passes
none, or the plain step's glue around a per-candidate solver, the K3 kernel
(``candidate_solver``, ops/fused_ilqr.py::build_fused_ilqr). The plain
step with its plain solve runs only for scenarios on the CPU.

Plant noise is clipped Gaussian (v: N(0, 0.01^2), theta: N(0, 0.005^2),
both clipped to +-0.05, half of each added), gated per lane by
``scenarios.noise_on``. The standard-normal draws come from an explicit
``torch.Generator`` or from an injected ``noise`` tensor (steps, 2, B) that
is consumed one row per executed simulator step, so a test can feed the
JAX simulator's own draws. ``SoaScenarios.randomized`` takes its jitter
draws the same way: from a generator, or injected. A run's ``final_key``
is what continues its noise in a resumed run (``resume_from``): the
generator's state, or the count of injected rows consumed.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import torch

from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops import _build
from ilqr_iterative_tasks_torch.ops.fused_ilqr import obstacle_to_lanes
from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
    FusedI2lqrStep, build_fused_i2lqr_step, i2lqr_step_reference)
from ilqr_iterative_tasks_torch.ops.ilqr_soa import step_soa
from ilqr_iterative_tasks_torch.utils.device import resolve
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, SystemLimits, solver_consts)

GOAL_TOL = 0.8


@dataclass(frozen=True)
class SoaScenarios:
    """Scenario batch, batch-trailing: x0/goal (4, B); obstacle leaves and
    noise_on (B,)."""

    x0: torch.Tensor
    goal: torch.Tensor
    obstacle: Obstacle
    noise_on: torch.Tensor

    @classmethod
    def broadcast(cls, x0, goal, obstacle: Obstacle, batch: int,
                  noise_on=False, *, dtype=torch.float32, device=None):
        device = resolve(device)
        f = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return cls(
            x0=f(x0)[:, None].expand(4, batch).contiguous(),
            goal=f(goal)[:, None].expand(4, batch).contiguous(),
            obstacle=obstacle.map(lambda a: f(a).expand(batch).contiguous()),
            noise_on=torch.full((batch,), 1.0 if noise_on else 0.0,
                                dtype=dtype, device=device))

    @classmethod
    def randomized(cls, base_x0, goal, obstacle: Obstacle, batch: int,
                   generator: torch.Generator | None = None, *,
                   x0_jitter=0.5, obs_pos_jitter: float = 4.0,
                   obs_spd_jitter: float = 0.0, noise_on=True,
                   dtype=torch.float32, device=None, draws=None):
        """Per-lane randomized scenarios (BASELINE config 4): jittered
        initial states and per-lane obstacle positions and speeds (the
        speed clamped at 0). ``x0_jitter``: a scalar or per-component (4,)
        scale. The standard-normal draws (z_x0 (4, B), z_ox (B,), z_oy (B,),
        z_spd (B,)) come from ``generator``, in that order, or are injected
        as ``draws``. On the current CUDA device unless ``device`` is named.

        i2LQR is brittle to initial heading / velocity offsets: at sigma 0.5
        on theta_0 some lanes park at a stationary point off the track
        (the simulator's ``stall_reseed`` guard is for them); position-only
        jitter is robust."""
        device = resolve(device)
        base = cls.broadcast(base_x0, goal, obstacle, batch,
                             noise_on=noise_on, dtype=dtype, device=device)
        if draws is None:
            if generator is None:
                raise ValueError("pass a generator or the draws")
            draws = (torch.randn((4, batch), generator=generator,
                                 dtype=dtype, device=device),
                     *(torch.randn((batch,), generator=generator,
                                   dtype=dtype, device=device)
                       for _ in range(3)))
        z_x0, z_ox, z_oy, z_spd = (torch.as_tensor(z, dtype=dtype,
                                                   device=device)
                                   for z in draws)
        scale = torch.as_tensor(x0_jitter, dtype=dtype,
                                device=device).reshape(-1, 1).expand(4, batch)
        o = base.obstacle
        return cls(
            x0=base.x0 + scale * z_x0, goal=base.goal,
            obstacle=replace(
                o, x=o.x + obs_pos_jitter * z_ox,
                y=o.y + obs_pos_jitter * z_oy,
                spd=torch.clamp_min(o.spd + obs_spd_jitter * z_spd, 0.0)),
            noise_on=base.noise_on)


class SoaRunResult(NamedTuple):
    lap_steps: torch.Tensor  # (num_laps, B) i32
    lap_done: torch.Tensor  # (num_laps, B) bool
    final_x: torch.Tensor  # (4, B)
    safe_set: tuple  # (states, qfun, valid, lap_len), batch-trailing
    lap_count: int  # laps stored, seed included
    # the noise position after the run (noise_key): pass (safe_set,
    # lap_count, final_key) back as ``resume_from`` to continue the run
    final_key: object = None


def noise_key(noise, generator, rows):
    """What a resumed run needs to continue the noise after ``rows``
    executed steps: the count of injected rows consumed, else the
    generator's state (a CPU uint8 tensor), else None."""
    if noise is not None:
        return rows
    if generator is not None:
        return generator.get_state()
    return None


def resume_noise(key, noise, generator) -> int:
    """The first noise row of a run resumed at ``key`` (noise_key's value):
    the rows consumed for injected draws; a generator is set to its saved
    state. Returns 0 where the key does not name a position."""
    if isinstance(key, torch.Tensor) and key.dtype == torch.uint8:
        if generator is None:
            raise ValueError("resume_from holds a generator state: pass the "
                             "generator to set it on")
        generator.set_state(key)
        return 0
    if key is None:
        return 0
    if noise is None:
        raise ValueError("resume_from holds a count of noise rows: pass the "
                         "injected noise it counts")
    return int(key)


def _step_solver_inputs(lap_count, nsi, max_laps, inactive, b, device):
    """Lap ids / validity flags of the last nsi stored laps and the skip
    mask, as the step kernel takes them."""
    lap_id = torch.arange(nsi, dtype=torch.int32, device=device) + (
        lap_count - nsi)
    lap_ok = (lap_id >= 0).to(torch.int32)
    lap_ids = torch.clamp(lap_id, 0, max_laps - 1).to(torch.int32)
    skip = (inactive.to(torch.float32) if inactive is not None
            else torch.zeros((b,), dtype=torch.float32, device=device))
    return lap_ids, lap_ok, skip


def draw_noise(noise, generator, row, b, dtype, device):
    """The (2, B) standard-normal plant-noise draws of executed step
    ``row``: from the injected ``noise`` (steps, 2, B), else from
    ``generator``, else zeros."""
    if noise is not None:
        if row >= noise.shape[0]:
            raise ValueError(f"noise has {noise.shape[0]} rows; the run "
                             f"needs more")
        return noise[row].to(dtype=dtype, device=device)
    if generator is not None:
        return torch.randn((2, b), generator=generator, dtype=dtype,
                           device=device)
    return torch.zeros((2, b), dtype=dtype, device=device)


def plant_step(x, u, dt, z, noise_on, done, obstacle: Obstacle, goal):
    """One closed-loop plant step of every lane: the bicycle step under
    input u (2, B), the clipped noise of draws z where noise_on, and the
    obstacle's motion; finished lanes stay frozen. Returns (x_next,
    obstacle_next, reach), reach = |x_next - goal| <= GOAL_TOL."""
    x_next = torch.stack(step_soa(tuple(x[i] for i in range(4)),
                                  (u[0], u[1]), dt))
    noise_v = torch.clamp(z[0] * 0.01, -0.05, 0.05)
    noise_th = torch.clamp(z[1] * 0.005, -0.05, 0.05)
    x_next[2] = x_next[2] + 0.5 * noise_v * noise_on
    x_next[3] = x_next[3] + 0.5 * noise_th * noise_on
    x_next = torch.where(done[None], x, x_next)
    moved = obstacle.advance(dt)
    obstacle_next = Obstacle(**{
        f: torch.where(done, getattr(obstacle, f), getattr(moved, f))
        for f in obstacle.__dataclass_fields__})
    dg = [x_next[i] - goal[i] for i in range(4)]
    reach = torch.sqrt(dg[0] * dg[0] + dg[1] * dg[1] + dg[2] * dg[2]
                       + dg[3] * dg[3]) <= GOAL_TOL
    return x_next, obstacle_next, reach


def add_lap(ss, slot, xs_rec, n_valid):
    """Store a lap in slot ``slot`` of the safe set, in place.
    xs_rec: (T, 4, B); n_valid: (B,) recorded rows."""
    states, qfun, valid, lap_len = ss
    t_idx = torch.arange(states.shape[1], device=states.device)[:, None]
    states[slot] = xs_rec
    qfun[slot] = torch.clamp_min(
        n_valid[None].to(qfun.dtype) - 1.0 - t_idx.to(qfun.dtype), 0.0)
    valid[slot] = t_idx < n_valid[None]
    lap_len[slot] = n_valid.to(torch.int32)


def resumed_safe_set(ss, dtypes, device) -> tuple:
    """The safe set of ``resume_from`` as the simulator's own tensors: each
    of ``ss`` (tensors or numpy arrays, batch-trailing) copied to
    ``device`` in its dtype of ``dtypes``, so the resumed run does not
    write into the caller's."""
    if len(ss) != len(dtypes):
        raise ValueError(f"resume_from holds {len(ss)} safe-set tensors; "
                         f"the simulator keeps {len(dtypes)}")
    return tuple(torch.as_tensor(t).to(device=device, dtype=d, copy=True)
                 for t, d in zip(ss, dtypes))


_K1_CACHE: dict = {}


def default_step_solver(params: IlqrParams, limits: SystemLimits, dt, *,
                        max_steps: int, max_laps: int,
                        max_iter: int) -> FusedI2lqrStep:
    """The K1 that ``simulate_learning_runs_soa`` launches on CUDA
    scenarios when no step_solver is passed: built once per constants and
    sizes, then reused (its ``launches`` keeps counting)."""
    key = (tuple(_build.consts_array(solver_consts(params, limits, dt))),
           params.num_ss_points, params.num_ss_iter, params.num_horizon,
           max_steps, max_laps, max_iter)
    if key not in _K1_CACHE:
        _K1_CACHE[key] = build_fused_i2lqr_step(
            params, limits, dt, num_horizon=params.num_horizon,
            max_steps=max_steps, max_laps=max_laps, max_iter=max_iter)
    return _K1_CACHE[key]


_UNSUPPORTED = ("retile_frac", "tail_shrink", "dedup_passes",
                "precision_islands")


def refuse(unsupported: dict, left_out) -> None:
    """Raise TypeError on options the port does not take."""
    if unsupported:
        raise TypeError(f"{sorted(unsupported)} not supported by the torch "
                        f"port (left out: {', '.join(left_out)})")


def solver_of(step_solver, candidate_solver, cap_attr, cap, flags, on_card,
              default):
    """The backend a simulator runs, checked as the JAX simulators check
    ``pallas_step_solver`` and ``pallas_solver``: at most one of the step
    solver and the candidate solver, the latter built with the simulator's
    LM cap ``cap`` (its attribute ``cap_attr``) and with each of ``flags``
    set; where neither is given, ``default()`` on the card. Returns
    (step_solver, candidate_solver)."""
    if step_solver is not None and candidate_solver is not None:
        raise ValueError("step_solver replaces candidate_solver: pass only "
                         "one backend")
    if candidate_solver is not None:
        built = getattr(candidate_solver, cap_attr, cap)
        if built != cap:
            raise ValueError(
                f"candidate_solver was built with {cap_attr}={built}; the "
                f"simulator's LM cap is {cap}")
        for flag in flags:
            if not getattr(candidate_solver, flag, False):
                raise ValueError(f"candidate_solver must be built with "
                                 f"{flag}=True")
    elif step_solver is None and on_card:
        return default()
    return step_solver, candidate_solver


def simulate_learning_runs_soa(params: IlqrParams, limits: SystemLimits,
                               scenarios: SoaScenarios, seed_xs, seed_us,
                               seed_len: int, dt, *, num_laps: int,
                               max_steps: int = 128, max_laps: int = 16,
                               goal_append: bool = True,
                               sim_step_budget: int = 121,
                               solver_max_iter: int | None = None,
                               stall_reseed: int | None = None,
                               step_solver=None,
                               candidate_solver=None,
                               noise: torch.Tensor | None = None,
                               generator: torch.Generator | None = None,
                               resume_from=None,
                               **unsupported) -> SoaRunResult:
    """Seed lap + ``num_laps`` learning laps for B scenarios.

    seed_xs: (max_steps, 4) seed lap, padded; seed_us is unused (kept for
    the JAX signature); seed_len: count of seed states. ``solver_max_iter``
    caps the LM iterations (None = the reference's 150). ``step_solver``:
    a K1 built by ``build_fused_i2lqr_step`` for the same sizes.
    ``candidate_solver`` (the JAX ``pallas_solver``): a K3 built by
    ``build_fused_ilqr`` with the same constants and ``max_iter`` equal to
    the cap; the plain step's glue then calls it once a relaxation pass
    (``i2lqr_step_reference``). With neither: ``default_step_solver``'s K1
    on CUDA scenarios and the plain step on CPU ones. ``noise`` (steps, 2,
    B) standard-normal draws or ``generator``: the plant-noise source
    (needed where noise_on is set).

    ``resume_from``: (safe_set, lap_count, key) of an earlier run (its
    result's fields, or ``utils.checkpoint.load_soa_run``): the run goes on
    from that safe set (the seed arguments are not read) for ``num_laps``
    more laps, and ``key`` (the result's ``final_key``) continues the noise:
    a generator state is set on ``generator``, a row count indexes the
    injected ``noise``, which is then the whole run's. Two laps and a
    resumed two equal four laps in one run bit for bit.

    ``stall_reseed=S`` (default None: the reference's behaviour, and no
    extra work a step): a lane whose chosen candidate's Qfun has not
    strictly decreased for S consecutive active control steps gets its
    pass-0 kNN guess re-seeded to the goal instead of its current state,
    which pulls its candidates toward goal-ward safe-set points and out of
    a parking orbit. The count and the last Qfun restart at each lap.
    """
    refuse(unsupported, _UNSUPPORTED)
    n = params.num_horizon
    k = params.num_ss_points
    nsi = params.num_ss_iter
    cap = 150 if solver_max_iter is None else solver_max_iter
    step_solver, candidate_solver = solver_of(
        step_solver, candidate_solver, "max_iter", cap, (),
        scenarios.x0.device.type != "cpu",
        lambda: (default_step_solver(params, limits, dt, max_steps=max_steps,
                                     max_laps=max_laps, max_iter=cap), None))
    if step_solver is not None:
        s = step_solver
        if ((s.k, s.nsi, s.num_horizon, s.max_steps, s.max_laps, s.max_iter)
                != (k, nsi, n, max_steps, max_laps, cap)):
            raise ValueError(
                "step_solver was built for (k, nsi, n, max_steps, max_laps, "
                f"max_iter)=({s.k}, {s.nsi}, {s.num_horizon}, {s.max_steps}, "
                f"{s.max_laps}, {s.max_iter}); the simulator was called with "
                f"({k}, {nsi}, {n}, {max_steps}, {max_laps}, {cap})")
        solver = s
    else:
        def solver(*args):
            return i2lqr_step_reference(params, limits, dt, *args,
                                        max_iter=cap,
                                        candidate_solver=candidate_solver)
    # the record write reaches row sim_step_budget, goal_append one more
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

    if resume_from is None:
        states = torch.zeros((max_laps, max_steps, 4, b), dtype=dtype,
                             device=dev)
        qfun = torch.zeros((max_laps, max_steps, b), dtype=dtype, device=dev)
        valid = torch.zeros((max_laps, max_steps, b), dtype=torch.bool,
                            device=dev)
        lap_len = torch.zeros((max_laps, b), dtype=torch.int32, device=dev)
        ss = (states, qfun, valid, lap_len)
        add_lap(ss, 0, torch.as_tensor(seed_xs, dtype=dtype,
                                       device=dev)[:, :, None]
                .expand(max_steps, 4, b),
                torch.full((b,), int(seed_len), dtype=torch.int32,
                           device=dev))
        lap0, sim_step = 1, 0
    else:
        ss, lap0, key = resume_from
        ss, lap0 = resumed_safe_set(ss, (dtype, dtype, torch.bool,
                                         torch.int32), dev), int(lap0)
        states, qfun, valid, lap_len = ss
        sim_step = resume_noise(key, noise, generator)
    if lap0 + num_laps > max_laps:
        raise ValueError(f"max_laps={max_laps} cannot hold {lap0} stored "
                         f"and {num_laps} more laps")
    goal = scenarios.goal
    noise_on = scenarios.noise_on
    zero_u = torch.zeros((1, 2, b), dtype=dtype, device=dev)
    lap_steps = torch.zeros((num_laps, b), dtype=torch.int32, device=dev)
    lap_done = torch.zeros((num_laps, b), dtype=torch.bool, device=dev)
    # sim_step: executed steps over the run (and the run it resumes), the
    # noise row

    for lap_i in range(num_laps):
        lap_count = lap0 + lap_i  # laps stored so far (seed + learned)
        x = x0
        t = torch.zeros((b,), dtype=torch.int32, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        obstacle = scenarios.obstacle
        horizon_left = torch.full((b,), n, dtype=torch.int32, device=dev)
        replay_pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        u_old = torch.zeros((n, 2, b), dtype=dtype, device=dev)
        xs_rec = torch.zeros((max_steps, 4, b), dtype=dtype, device=dev)
        xs_rec[0] = x0
        if stall_reseed is not None:  # steps without progress, last Qfun
            stall = torch.zeros((b,), dtype=torch.int32, device=dev)
            q_prev = torch.full((b,), float("inf"), dtype=dtype, device=dev)
        while bool(((t < sim_step_budget) & ~done).any()):
            in_replay = horizon_left < n
            lap_ids, lap_ok, skip = _step_solver_inputs(
                lap_count, nsi, max_laps, done | in_replay, b, dev)
            g0 = x if stall_reseed is None else torch.where(
                (stall >= stall_reseed)[None], goal, x)
            if bool((skip < 0.5).any()):
                us_sel, shrink_f, idx_sel, row_sel = solver(
                    x, g0, states, qfun, lap_len, lap_ids, lap_ok,
                    obstacle_to_lanes(obstacle, b), skip)
                if stall_reseed is not None:
                    # the winner's time-to-go, Qfun at (its lap, its kNN
                    # row); active lanes count the steps it did not
                    # strictly decrease
                    q_win = qfun[lap_ids[row_sel.long()].long(),
                                 torch.clamp(idx_sel.long(), 0,
                                             max_steps - 1), lanes]
                    active = skip < 0.5  # not done, not replaying
                    stall = torch.where(active, torch.where(
                        q_win < q_prev, 0, stall + 1), stall)
                    q_prev = torch.where(active, q_win, q_prev)
            else:  # every lane done or replaying: outputs would be discarded
                us_sel = torch.zeros((n, 2, b), dtype=dtype, device=dev)
                shrink_f = torch.zeros((b,), dtype=dtype, device=dev)
            u_solve = us_sel[0]
            u_old_new = torch.cat([us_sel[1:], zero_u])
            shrink = shrink_f > 0.5
            # replay: the stored input at replay_pos, clipped to the plan
            p = torch.clamp(replay_pos, 0, n - 1).to(torch.int64)
            u_replay = u_old.gather(0, p[None, None].expand(1, 2, b))[0]
            u = torch.where(in_replay[None], u_replay, u_solve)
            u_old_next = torch.where(in_replay[None, None], u_old, u_old_new)
            horizon_next = torch.where(
                in_replay | shrink, horizon_left - 1, horizon_left)
            replay_next = torch.where(in_replay, replay_pos + 1, replay_pos)
            z = draw_noise(noise, generator, sim_step, b, dtype, dev)
            sim_step += 1
            x_next, obstacle, reach = plant_step(x, u, dt, z, noise_on, done,
                                                 obstacle, goal)
            # freeze finished lanes
            t = torch.where(done, t, t + 1)
            horizon_left = torch.where(done, horizon_left, horizon_next)
            replay_pos = torch.where(done, replay_pos, replay_next)
            u_old = torch.where(done[None, None], u_old, u_old_next)
            # record row t of each lane (a done lane rewrites its frozen row)
            xs_rec[t.to(torch.int64), :, lanes] = x_next.T
            done = done | reach
            x = x_next
        if goal_append:  # goal as an extra recorded row
            xs_rec[(t + 1).to(torch.int64), :, lanes] = goal.T
            n_valid = t + 2
        else:  # goal snapped onto the final row
            xs_rec[t.to(torch.int64), :, lanes] = goal.T
            n_valid = t + 1
        add_lap(ss, lap_count, xs_rec, n_valid)
        lap_steps[lap_i] = t
        lap_done[lap_i] = done
    return SoaRunResult(lap_steps=lap_steps, lap_done=lap_done,
                        final_x=goal, safe_set=ss,
                        lap_count=lap0 + num_laps,
                        final_key=noise_key(noise, generator, sim_step))
