"""The vmap i2LQR tier: whole learning runs of B scenarios in lockstep,
batch leading.

Port of ilqr_iterative_tasks_tpu/control/batched.py (``lexicographic_argmin``
:44, ``ScenarioSpec`` :69, ``BatchedRunResult`` :80, ``simulate_learning_run``
:99, ``make_batch_scenarios`` :258, ``simulate_learning_batch`` :278). JAX
vmaps one scenario's jitted run (seed lap, then ``num_laps`` closed-loop
i2LQR laps with safe-set growth) over the batch; under vmap each lane's
``while_loop`` is one loop over B that runs until every lane's lap ends, a
lane's step committed only while the lane runs. This module runs that loop
directly: every per-lane state is (B, ...), a step's results are taken
where the lane runs, and no lane reads another's, so a lane's result does
not depend on B, on its neighbours or on its shard.

A control step (JAX ``solve_step`` :121) is three relaxation passes; each
pass is ONE launch of the K3 kernel (ops/fused_ilqr.py) over B * nsi * k
lanes: each scenario's kNN candidates of its last nsi stored laps
(``DeviceSafeSet.knn``), zeros-initialised, at ``params.lamb``, with the
scenario's own obstacle, at the LM cap ``params.max_ilqr_iter`` (JAX's
``ilqr_solve`` takes no other). Lanes of scenarios that are done or
replaying stored inputs (``horizon_left < n``) enter K3 with ``skip`` set:
JAX's ``lax.cond`` solves them and discards the result (:23-26). A step
where no scenario solves launches nothing. On CPU tensors K3's wrapper runs
its plain version (ops/ilqr_soa.py); on CUDA tensors it launches the
kernel or raises.

Plant noise: JAX gives each scenario its own key chain, split once a step
the scenario takes (``key, k1, k2 = split(key, 3)``), carried across laps
(:212-217, :237-255), so a scenario's n-th draw depends on how many steps
its earlier laps took. Here the n-th draw of a scenario is a function of
(its ``noise_key``, n) alone (``lane_normals``, a counter-based hash), or
row n of its injected ``noise`` (B, steps, 2), which a test fills with the
JAX chains' draws. ``make_batch_scenarios``' x0 jitter draws are injected
the same way or come from a generator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import NamedTuple

import torch

from ilqr_iterative_tasks_torch.control.batched_soa import (
    check_budget, plant_step)
from ilqr_iterative_tasks_torch.control.safe_set import DeviceSafeSet
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
    build_fused_ilqr, obstacle_to_lanes)
from ilqr_iterative_tasks_torch.ops.ilqr_soa import true_div
from ilqr_iterative_tasks_torch.utils.device import resolve
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits

def lexicographic_argmin(cost_rows: torch.Tensor,
                         row_valid: torch.Tensor) -> torch.Tensor:
    """Index of each batch's lexicographically smallest row: Python's
    ``cost_list.index(min(cost_list))`` over lists of per-lap costs.

    cost_rows: (..., L, K); row_valid: (L,) or (..., L) bool, invalid rows
    never win (row 0 where none is valid). Returns (...,) i64."""
    num_rows = cost_rows.shape[-2]
    row_valid = row_valid.expand(cost_rows.shape[:-1])
    best = torch.zeros(cost_rows.shape[:-2], dtype=torch.int64,
                       device=cost_rows.device)
    for i in range(1, num_rows):
        a = cost_rows[..., i, :]
        bb = cost_rows.gather(-2, best[..., None, None].expand(
            *best.shape, 1, cost_rows.shape[-1]))[..., 0, :]
        diff = a != bb
        first = torch.argmax(diff.to(torch.int8), dim=-1, keepdim=True)
        less = diff.any(dim=-1) & (a.gather(-1, first)[..., 0]
                                   < bb.gather(-1, first)[..., 0])
        best_ok = row_valid.gather(-1, best[..., None])[..., 0]
        take = row_valid[..., i] & (~best_ok | less)
        best = torch.where(take, i, best)
    return best


@dataclass(frozen=True)
class ScenarioSpec:
    """Per-scenario randomization, batch leading: x0 and goal (B, 4),
    obstacle leaves (B,), ``noise_key`` (B,) i64, each scenario's noise
    seed (``lane_normals``), and ``noise_on`` (B,) 0.0 / 1.0."""

    x0: torch.Tensor
    obstacle: Obstacle
    goal: torch.Tensor
    noise_key: torch.Tensor
    noise_on: torch.Tensor

    @property
    def batch(self) -> int:
        return self.x0.shape[0]

    def map(self, fn) -> "ScenarioSpec":
        """``fn`` applied to every leaf (rows: ``lambda t: t[rows]``)."""
        return ScenarioSpec(**{
            f.name: (getattr(self, f.name).map(fn) if f.name == "obstacle"
                     else fn(getattr(self, f.name))) for f in fields(self)})


class BatchedRunResult(NamedTuple):
    lap_steps: torch.Tensor  # (B, num_laps) i32 steps of each learning lap
    lap_done: torch.Tensor  # (B, num_laps) bool: the goal within budget
    safe_set: DeviceSafeSet
    final_x: torch.Tensor  # (B, 4) the last lap's last recorded state


# ---- per-scenario noise: a function of (seed, draw index) alone ----
_M1, _M2 = 0x7FEB352D, 0x846CA68B  # the multipliers of a 32-bit mixer
_MASK32 = 0xFFFFFFFF


def _mul32(x, m: int):
    """x * m mod 2**32 for x in [0, 2**32), in int64 without overflow."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & _MASK32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _bits(seed, counter):
    """32 hashed bits of (int64 seed, counter >= 0), as int64 tensors."""
    lo, hi = seed & _MASK32, (seed >> 32) & _MASK32
    return _mix32(_mix32(_mix32(counter & _MASK32) ^ lo) ^ hi)


def _uniform(seed, counter):
    """A float64 in (0, 1) of 53 hashed bits (counters c and c + 1)."""
    a = _bits(seed, counter) >> 5
    b = _bits(seed, counter + 1) >> 6
    return ((a * 67108864 + b).to(torch.float64) + 0.5) / 9007199254740992.0


def lane_normals(seeds: torch.Tensor, counts: torch.Tensor,
                 dtype) -> torch.Tensor:
    """Each scenario's draw number ``counts`` (B,) of its stream ``seeds``
    (B,) i64: two standard normals (B, 2) by Box-Muller from a counter-based
    hash, a function of (seed, count) alone."""
    c = counts.to(torch.int64) * 4
    u1, u2 = _uniform(seeds, c), _uniform(seeds, c + 2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return torch.stack([r * torch.cos(2.0 * math.pi * u2),
                        r * torch.sin(2.0 * math.pi * u2)], dim=1).to(dtype)


def lane_seeds(key: int, batch: int, device) -> torch.Tensor:
    """(B,) i64 noise seeds of ``make_batch_scenarios``: scenario i's is a
    hash of (key, i), so it does not depend on the batch."""
    i = torch.arange(batch, dtype=torch.int64, device=device)
    k = torch.full_like(i, int(key) & 0x7FFFFFFFFFFFFFFF)
    return (_bits(k, 2 * i) << 31) ^ _bits(k, 2 * i + 1)


def draw_lane_noise(noise, seeds, counts, dtype) -> torch.Tensor:
    """(B, 2) draws of each scenario at its own step count: row ``counts``
    of the injected ``noise`` (B, steps, 2), else ``lane_normals``."""
    if noise is None:
        return lane_normals(seeds, counts, dtype)
    if int(counts.max()) >= noise.shape[1]:
        raise ValueError(f"noise has {noise.shape[1]} draws a scenario; "
                         f"the run needs more")
    lanes = torch.arange(noise.shape[0], device=noise.device)
    return noise[lanes, counts.long()].to(dtype)


def make_batch_scenarios(base_x0, goal, obstacle: Obstacle, batch: int,
                         key: int = 0, x0_jitter: float = 0.0,
                         noise_on: bool = False, *, dtype=torch.float32,
                         device=None, draws=None) -> ScenarioSpec:
    """A batch of scenarios: x0 = base_x0 plus ``x0_jitter`` times standard
    normal draws (B, 4), which come from a generator seeded with ``key`` or
    are injected as ``draws``; each scenario's noise seed a hash of (key,
    its index). On the current CUDA device unless ``device`` is named."""
    dev = resolve(device)
    f = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)
    x0 = f(base_x0)[None].expand(batch, 4).clone()
    if x0_jitter > 0:
        if draws is None:
            g = torch.Generator(device=dev).manual_seed(int(key))
            draws = torch.randn((batch, 4), generator=g, dtype=dtype,
                                device=dev)
        x0 = x0 + x0_jitter * f(draws)
    return ScenarioSpec(
        x0=x0, obstacle=obstacle.map(lambda a: f(a).expand(batch).clone()),
        goal=f(goal)[None].expand(batch, 4).clone(),
        noise_key=lane_seeds(key, batch, dev),
        noise_on=torch.full((batch,), 1.0 if noise_on else 0.0, dtype=dtype,
                            device=dev))


def relaxed_cost(dist, q_term, num_horizon: float, outer: int,
                 max_relax: int):
    """The relaxed reach cost of relaxation pass ``outer`` (JAX :91):
    q + N + 100 * max(ceil(d / unit - 1e-12), 1), +inf past max_relax
    units, unit = 80 / 10**outer."""
    unit = 80.0 / (10 ** outer)
    i = torch.clamp_min(torch.ceil(true_div(dist, unit) - 1e-12), 1.0)
    cost = q_term + num_horizon + 100.0 * i
    return torch.where(dist <= unit * max_relax, cost, float("inf"))


def lanes_of(t: torch.Tensor, c: int) -> torch.Tensor:
    """A per-scenario (B, m) tensor as kernel lanes (m, B * c): each
    scenario's row repeated for its c candidates, scenario-major."""
    b, m = t.shape
    return t.T[:, :, None].expand(m, b, c).reshape(m, b * c).contiguous()


def plant(x, u, dt, z, scenarios: ScenarioSpec, running, obstacle):
    """The closed-loop plant step of the scenarios that run (JAX
    :237-250), batch leading: the SoA simulator's ``plant_step`` (the
    bicycle step, the clipped noise of the draws z (B, 2) where noise_on,
    the obstacle's motion; the others frozen). Returns (x, obstacle,
    reach)."""
    x_n, obstacle, reach = plant_step(x.T, u.T, dt, z.T, scenarios.noise_on,
                                      ~running, obstacle, scenarios.goal.T)
    return x_n.T, obstacle, reach


def seed_safe_set(b, seed_xs, seed_us, seed_len, max_laps, max_steps, dtype,
                  dev) -> DeviceSafeSet:
    """The safe set of B scenarios holding the seed lap."""
    ss = DeviceSafeSet.empty(b, max_laps, max_steps, dtype=dtype, device=dev)
    f = lambda a, m: torch.as_tensor(a, dtype=dtype, device=dev)[None].expand(
        b, max_steps, m)
    return ss.add_lap(f(seed_xs, 4), f(seed_us, 2), int(seed_len))


class LapRows(NamedTuple):
    """A step's candidate laps, the last nsi stored (JAX :127-131)."""
    laps: list  # nsi ints, clamped to [0, max_laps)
    valid: torch.Tensor  # (nsi,) bool: the lap id is >= 0
    lap: torch.Tensor  # (nsi,) i64: ``laps`` on the device


def lap_rows(lap_count: int, nsi: int, max_laps: int, dev) -> LapRows:
    ids = [lap_count - nsi + off for off in range(nsi)]
    laps = [min(max(i, 0), max_laps - 1) for i in ids]
    return LapRows(laps, torch.tensor([i >= 0 for i in ids], device=dev),
                   torch.tensor(laps, device=dev))


def knn_candidates(ss: DeviceSafeSet, rows: LapRows, guess, k: int):
    """The k nearest stored points of ``guess`` (B, 4) in each candidate
    lap: idx (B, nsi, k), states (B, nsi, k, 4), Qfun (B, nsi, k), +inf
    on the overflow rows (DeviceSafeSet.knn)."""
    knn = [ss.knn(lap, guess, k) for lap in rows.laps]
    return tuple(torch.stack([r[j] for r in knn], dim=1) for j in range(3))


def select_candidate(cost, q, idx, rows: LapRows):
    """The winner of (B, nsi, k) candidate costs by the reference's ragged
    list-min (JAX batched.py:150-159, batched_nlmpc.py:86-91): overflow
    candidates (k above the lap's valid rows, q poisoned +inf) are absent
    from its lists, so a strict prefix ranks below its extension; the
    first lap with the least list wins, then its first least cost.
    Returns (win (B,): the candidate's lane in the scenario-major launch,
    its cost, its safe-set row, its lap)."""
    b, nsi, k = cost.shape
    lanes = torch.arange(b, device=cost.device)
    cmp = torch.where(torch.isfinite(q), cost, -float("inf"))
    best_row = lexicographic_argmin(cmp, rows.valid)
    best_col = torch.argmin(cost[lanes, best_row], dim=1)
    return (lanes * (nsi * k) + best_row * k + best_col,
            cost[lanes, best_row, best_col], idx[lanes, best_row, best_col],
            rows.lap[best_row])


def _solve_step(params: IlqrParams, k3, ss: DeviceSafeSet, lap_count: int,
                x, obs_l, skip_l, max_laps: int):
    """One full-horizon i2LQR calc_input of every scenario (JAX
    ``solve_step`` :116-189): (u (B, 2), replay buffer (B, n, 2), shrink
    (B,) bool). Three K3 launches."""
    n, k, nsi = params.num_horizon, params.num_ss_points, params.num_ss_iter
    b, dev = x.shape[0], x.device
    rows = lap_rows(lap_count, nsi, max_laps, dev)
    x0_l = lanes_of(x, nsi * k)
    u0_l = torch.zeros((n, 2, b * nsi * k), dtype=x.dtype, device=dev)
    guess = x
    for outer in range(3):
        idx, xt, q = knn_candidates(ss, rows, guess, k)
        us, x_last, _, dist = k3(x0_l, xt.reshape(-1, 4).T.contiguous(),
                                 u0_l, obs_l, skip_l)
        cost = relaxed_cost(dist.reshape(b, nsi, k), q, float(n), outer,
                            params.max_relax_iter)
        win, _, chosen_idx, chosen_lap = select_candidate(cost, q, idx, rows)
        guess = x_last[:, win].T
        u_pred = us[:, :, win].permute(2, 0, 1)  # (B, n, 2)
    lanes = torch.arange(b, device=dev)
    shrink = (chosen_idx + 1) > (ss.lap_len[lanes, chosen_lap] - 1)
    u_old = torch.cat([u_pred[:, 1:], torch.zeros_like(u_pred[:, :1])], dim=1)
    return u_pred[:, 0], u_old, shrink


def simulate_learning_batch(params: IlqrParams, limits: SystemLimits,
                            scenarios: ScenarioSpec, seed_xs, seed_us,
                            seed_len, dt, *, num_laps: int,
                            max_steps: int = 128, max_laps: int = 16,
                            goal_append: bool = True,
                            sim_step_budget: int = 121,
                            candidate_solver=None,
                            noise: torch.Tensor | None = None
                            ) -> BatchedRunResult:
    """Seed the safe set, then run ``num_laps`` closed-loop learning laps of
    every scenario (JAX ``vmap(simulate_learning_run)``).

    seed_xs: (max_steps, 4) padded seed lap; seed_us: (max_steps, 2);
    seed_len: the seed's states. ``candidate_solver``: the K3 to launch
    (``build_fused_ilqr`` at ``max_iter=params.max_ilqr_iter``), else one
    is built. ``noise``: injected standard-normal draws (B, steps, 2),
    scenario b's n-th step taking row n of its own; else each scenario's
    ``lane_normals`` of its ``noise_key``. The tensors live where
    ``scenarios`` does."""
    n = params.num_horizon
    check_budget(max_steps, sim_step_budget, goal_append)
    if 1 + num_laps > max_laps:
        raise ValueError(f"max_laps={max_laps} cannot hold the seed and "
                         f"{num_laps} laps")
    k3 = candidate_solver
    if k3 is None:
        k3 = build_fused_ilqr(params, limits, dt, num_horizon=n,
                              max_iter=params.max_ilqr_iter)
    elif (k3.max_iter, k3.num_horizon) != (params.max_ilqr_iter, n):
        raise ValueError(
            f"candidate_solver was built for (max_iter, num_horizon)="
            f"({k3.max_iter}, {k3.num_horizon}); the tier solves at "
            f"({params.max_ilqr_iter}, {n})")
    x0, goal = scenarios.x0, scenarios.goal
    b, dtype, dev = x0.shape[0], x0.dtype, x0.device
    c = params.num_ss_iter * params.num_ss_points
    lanes = torch.arange(b, device=dev)
    ss = seed_safe_set(b, seed_xs, seed_us, seed_len, max_laps, max_steps,
                       dtype, dev)
    count = torch.zeros(b, dtype=torch.int64, device=dev)  # steps taken
    lap_steps = torch.zeros((b, num_laps), dtype=torch.int32, device=dev)
    lap_done = torch.zeros((b, num_laps), dtype=torch.bool, device=dev)
    zero_u = torch.zeros((b, 2), dtype=dtype, device=dev)
    final_x = x0
    for lap_i in range(num_laps):
        x, obstacle = x0, scenarios.obstacle
        t = torch.zeros(b, dtype=torch.int64, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        horizon_left = torch.full((b,), n, dtype=torch.int64, device=dev)
        replay_pos = torch.zeros(b, dtype=torch.int64, device=dev)
        u_old = torch.zeros((b, n, 2), dtype=dtype, device=dev)
        xs_rec = torch.zeros((b, max_steps, 4), dtype=dtype, device=dev)
        xs_rec[:, 0] = x0
        us_rec = torch.zeros((b, max_steps, 2), dtype=dtype, device=dev)
        while True:
            running = (t < sim_step_budget) & ~done
            in_replay = horizon_left < n
            solving = running & ~in_replay
            n_run, n_solve = torch.stack([running.sum(),
                                          solving.sum()]).tolist()
            if not n_run:
                break
            if n_solve:
                u_s, u_old_s, shrink = _solve_step(
                    params, k3, ss, 1 + lap_i, x,
                    lanes_of(obstacle_to_lanes(obstacle, b).T, c),
                    lanes_of((~solving).to(torch.float32)[:, None], c)[0],
                    max_laps)
            else:  # every scenario done or replaying: nothing is solved
                u_s, u_old_s = zero_u, u_old
                shrink = torch.zeros(b, dtype=torch.bool, device=dev)
            p = torch.clamp(replay_pos, 0, n - 1)
            u = torch.where(in_replay[:, None], u_old[lanes, p], u_s)
            u_old_n = torch.where(in_replay[:, None, None], u_old, u_old_s)
            hl_n = torch.where(in_replay | shrink, horizon_left - 1,
                               horizon_left)
            rp_n = torch.where(in_replay, replay_pos + 1, 0)
            z = draw_lane_noise(noise, scenarios.noise_key, count, dtype)
            # commit where the scenario runs (the vmapped while_loop)
            run2 = running[:, None]
            us_rec[lanes, t] = torch.where(run2, u, us_rec[lanes, t])
            x, obstacle, reach = plant(x, u, dt, z, scenarios, running,
                                       obstacle)
            t = torch.where(running, t + 1, t)
            xs_rec[lanes, t] = x  # a frozen scenario rewrites its row t
            horizon_left = torch.where(running, hl_n, horizon_left)
            replay_pos = torch.where(running, rp_n, replay_pos)
            u_old = torch.where(run2[..., None], u_old_n, u_old)
            done = torch.where(running, reach, done)
            count = count + running
        # the goal before learning (tests/ilqr_test.py:51): appended as one
        # more row, or snapped onto the last
        row = t + 1 if goal_append else t
        xs_rec[lanes, row] = goal
        ss.add_lap(xs_rec, us_rec, row + 1)
        lap_steps[:, lap_i] = t.to(torch.int32)
        lap_done[:, lap_i] = done
        final_x = xs_rec[lanes, t]
    return BatchedRunResult(lap_steps=lap_steps, lap_done=lap_done,
                            safe_set=ss, final_x=final_x)


def simulate_learning_run(params: IlqrParams, limits: SystemLimits,
                          scenario: ScenarioSpec, seed_xs, seed_us, seed_len,
                          dt, **kw) -> BatchedRunResult:
    """One scenario's run (its leaves without the batch axis): the batch
    of one, with the batch axis taken off every output."""
    res = simulate_learning_batch(
        params, limits, scenario.map(lambda t: t[None]), seed_xs, seed_us,
        seed_len, dt, **{key: (v[None] if key == "noise" and v is not None
                               else v) for key, v in kw.items()})
    first = lambda t: t[0]
    return BatchedRunResult(res.lap_steps[0], res.lap_done[0],
                            res.safe_set.map(first), res.final_x[0])
