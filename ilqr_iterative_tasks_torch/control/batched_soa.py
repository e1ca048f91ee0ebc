"""Batch-native (structure-of-arrays) i2LQR learning simulator in torch.

Port of the base path of ilqr_iterative_tasks_tpu/control/batched_soa.py
(``SoaScenarios.randomized`` :56, ``simulate_learning_runs_soa`` :237 with
its ``stall_reseed`` guard, ``resume_from``, ``pallas_solver``,
``dedup_passes``, ``retile_frac``, ``tail_shrink`` and
``precision_islands``, ``run_lap`` :717, ``lap_loop`` :924).
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

import time
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
    # a step solver built with_stats: (iters_useful, iters_executed,
    # queue_floor) (B,) i64, each lane's sums over the run's steps (this
    # run's only where it resumes one)
    iter_stats: tuple = ()


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


def check_budget(max_steps, sim_step_budget, goal_append):
    """Raise unless the records hold a lap: the record write reaches row
    sim_step_budget, goal_append one more."""
    if max_steps < sim_step_budget + (2 if goal_append else 1):
        raise ValueError(
            f"max_steps={max_steps} too small for sim_step_budget="
            f"{sim_step_budget} (+{2 if goal_append else 1} recorded rows)")


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
                        max_steps: int, max_laps: int, max_iter: int,
                        reseeded: bool = False) -> FusedI2lqrStep:
    """The K1 that ``simulate_learning_runs_soa`` launches on CUDA
    scenarios when no step_solver is passed: built once per constants and
    sizes, then reused (its ``launches`` keeps counting). At k = 8 and
    nsi = 1 it takes the options the JAX main path ships, ``dedup`` and
    ``qsort_skip`` (bench.py:79-82; bitwise-neutral), whose lane queue
    runs from ``LANE_QUEUE_FROM`` lanes on
    (``FusedI2lqrStep.lane_queue_runs``, a switch set by measurement,
    ops/i2lqr_step.py); smaller batches run the plain order. A
    ``reseeded`` run (``stall_reseed``), whose reseeded lanes visit every
    position in series, runs the plain order at every batch: there the
    lane queue measured slower at each batch (``LANE_QUEUE_FROM``)."""
    key = (tuple(_build.consts_array(solver_consts(params, limits, dt))),
           params.num_ss_points, params.num_ss_iter, params.num_horizon,
           max_steps, max_laps, max_iter, reseeded)
    if key not in _K1_CACHE:
        pair = (params.num_ss_points == 8 and params.num_ss_iter == 1
                and not reseeded)
        _K1_CACHE[key] = build_fused_i2lqr_step(
            params, limits, dt, num_horizon=params.num_horizon,
            max_steps=max_steps, max_laps=max_laps, max_iter=max_iter,
            dedup=pair, qsort_skip=pair)
    return _K1_CACHE[key]


class LaneOrder:
    """The lane permutation of ``retile_frac`` and ``tail_shrink`` (JAX
    batched_soa.py:714-781, batched_nlmpc_soa.py:604-658): when a step
    permutes every per-lane state, in which order, and which original lane
    each position holds (``orig_id``). Both counts come from the one small
    host read a step makes (``read``); ``log``, a list, receives a dict a
    lap: the permutations (``perms``), whether the lap compacted
    (``compacted``) and each permutation's ms (``perm_ms``: CUDA events on
    the card, the host clock on the CPU; read after the run).

    ``spread``: on a rank of a ``_sharded`` run, the whole run's lane
    order (parallel/sharded_soa.py ``SpreadLanes``): the counts a step
    reads are the whole run's (every rank steps until no lane of any rank
    runs), the compaction fires on the whole run's not-done count, gives
    each lane its position in the whole run's order, and the prefix this
    rank's kernel runs holds at most its own lanes."""

    def __init__(self, b, retile_frac, tail_shrink, device, log=None,
                 spread=None):
        whole = b if spread is None else spread.b
        if tail_shrink is not None and not 0 < tail_shrink < whole:
            raise ValueError(f"tail_shrink={tail_shrink} must be < batch "
                             f"{whole}")
        self.b, self.tail, self.log = b, tail_shrink, log
        self.spread = spread
        self.block = (None if retile_frac is None
                      else max(1, int(round(retile_frac * b))))
        self.orig_id = torch.arange(b, device=device)
        self.on_card = torch.device(device).type == "cuda"
        self._spans = []  # (lap entry, start, end) of each permutation

    def start_lap(self):
        """A lap begins: the skip count and the compaction restart."""
        self.skip_base, self.compacted = 0, False
        if self.log is not None:
            self.log.append(dict(perms=0, compacted=False, perm_ms=[]))

    def read(self, running, skipf, done):
        """(any lane running, solver-skip lanes, not-done lanes) in one
        host read; under ``spread`` the running and not-done lanes of the
        whole run."""
        counts = torch.stack([running.sum(), skipf.sum(), (~done).sum()])
        if self.spread is None:
            return counts.tolist()
        _, n_skip, _, running, _, n_notdone = self.spread.counts(counts)
        return running, n_skip, n_notdone

    def fires(self, n_skip, n_notdone) -> bool:
        """Whether this step permutes: the skip count grew by the retile
        block since the last permutation, or (once a lap) the not-done
        lanes first fit the tail_shrink prefix."""
        tail = (self.tail is not None and not self.compacted
                and n_notdone <= self.tail)
        fire = tail or (self.block is not None
                        and n_skip - self.skip_base >= self.block)
        if fire:
            self.skip_base = n_skip
        self.compacted = self.compacted or tail
        if self.log is not None:
            self.log[-1]["compacted"] = self.compacted
        return fire

    def lanes(self) -> int:
        """The lanes a step kernel runs and a step's records are written
        for: the tail_shrink prefix once the lap compacted (every lane
        past it is done), else all B."""
        return min(self.tail, self.b) if self.compacted else self.b

    def source(self, skipf, done):
        """The stable order of the permutation: solver-active lanes
        first, then the skipped; under tail_shrink active, then not done
        but skipped, then done, so the not-done lanes stay in the prefix
        after a later retile."""
        key = skipf.to(torch.int8)
        if self.tail is not None:
            key = key + done.to(torch.int8)
        if self.spread is not None:
            self.spread.reorder(key)
        return torch.argsort(key, stable=True)

    def permute(self, src, lanes, safe_set, stored):
        """Move every tensor of ``lanes`` (a list, lane-trailing) to the
        order ``src``, and the ``stored`` slots of each safe-set tensor in
        place (the slots above hold zeros in every lane); returns the
        permuted list."""
        if self.log is not None:
            if self.on_card:
                t0 = torch.cuda.Event(enable_timing=True)
                t0.record()
            else:
                t0 = time.perf_counter()
        take = lambda a: a.index_select(-1, src) if a.dim() else a
        out = [a.map(take) if isinstance(a, Obstacle) else take(a)
               for a in lanes]
        for a in safe_set:
            a[:stored] = a[:stored].index_select(-1, src)
        self.orig_id = self.orig_id[src]
        if self.spread is not None:
            self.spread.pos = self.spread.pos[src]
        if self.log is not None:
            entry = self.log[-1]
            entry["perms"] += 1
            if self.on_card:
                t1 = torch.cuda.Event(enable_timing=True)
                t1.record()
                self._spans.append((entry, t0, t1))
            else:
                entry["perm_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def route(self, z):
        """Noise drawn in the original lane order, each lane's own (the
        i2LQR simulator routes only under ``retile_frac``, the NLMPC one
        under either option, as JAX's do)."""
        return z[:, self.orig_id]

    def to_original(self, a):
        """A lane-trailing tensor in the original lane order."""
        out = torch.empty_like(a)
        out[..., self.orig_id] = a
        return out

    def finish(self, safe_set, stored):
        """The safe set's ``stored`` slots back in the original lane
        order, in place; the log's device times read."""
        inv = torch.empty_like(self.orig_id)
        inv[self.orig_id] = torch.arange(self.b, device=inv.device)
        for a in safe_set:
            a[:stored] = a[:stored].index_select(-1, inv)
        if self._spans:
            self._spans[-1][2].synchronize()
            for entry, t0, t1 in self._spans:
                entry["perm_ms"].append(t0.elapsed_time(t1))
        return inv


def refuse(unsupported: dict, left_out) -> None:
    """Raise TypeError on options the port does not take (``left_out``:
    the JAX simulator's options it leaves out)."""
    if unsupported:
        note = f" (left out: {', '.join(left_out)})" if left_out else ""
        raise TypeError(f"{sorted(unsupported)} not supported by the torch "
                        f"port{note}")


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
                               retile_frac: float | None = None,
                               tail_shrink: int | None = None,
                               perm_log: list | None = None,
                               dedup_passes: bool = False,
                               dedup_log: list | None = None,
                               precision_islands: tuple = (),
                               _spread=None,
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

    ``retile_frac=f`` and ``tail_shrink=P`` (default None: no permutation
    and the same ops) change the schedule, as in the JAX simulator
    (batched_soa.py:284-299): whenever the solver-skip lanes (done or
    replaying) have grown by round(f * B) since the last permutation, and
    once a lap when the not-done lanes first fit the first P lanes, every
    per-lane state (the solver carry, the records, the stored laps of the
    safe set, the scenario leaves, the ``iter_stats`` sums) is stably
    permuted, active lanes first (under ``tail_shrink`` active, then
    replaying, then done); from the compaction on a step kernel runs the
    first P lanes only (``lanes=P``; the per-candidate path's launches do
    not change) and the records are written there. Every output comes
    back in the original lane order. Noise is drawn in the original lane
    order; with ``retile_frac`` it is routed to each lane's position, so
    the run equals the run without the options bit for bit
    (``iter_stats``' executed and floor counts excepted: they count the
    warps the lanes share). With ``tail_shrink`` alone it is not routed,
    as JAX's i2LQR simulator does not route it (batched_soa.py:838-843):
    once a lap compacts, the lane at position p takes draw p, and from
    there the run is JAX's, not the run without the option (on draws equal
    across the lanes it is that run too). The port's
    kernels run any lane count, so P need be no tile multiple; it must be
    below B, and does not combine with ``stall_reseed``. ``perm_log``
    receives ``LaneOrder``'s record of the permutations a lap.
    ``_spread`` is internal: the ``_sharded`` wrapper's record of the whole
    run's lane order on one rank (``LaneOrder``), through which a rank's
    ``tail_shrink`` run is its columns of the unsharded run; its
    ``noise`` then holds the whole run's (2, B) rows.

    ``dedup_passes`` (with a ``candidate_solver`` only, as JAX's with a
    ``pallas_solver``): a relaxation pass-1 or pass-2 candidate that an
    earlier pass of the step solved is not solved again; it takes the
    cached result and enters K3 pre-done (``i2lqr_step_reference``).
    Bitwise-neutral. ``dedup_log``, a list, receives each such pass's
    count of live lanes' solves skipped (a 0-d tensor).

    ``precision_islands`` (JAX :646): the plain route's f64 islands inside
    an f32 solve (ops/ilqr_soa.py); where a kernel would solve (a step or
    candidate solver, or CUDA scenarios) a non-empty tuple raises: no
    kernel computes an island.
    """
    refuse(unsupported, ())
    if dedup_passes and candidate_solver is None:
        raise ValueError("dedup_passes requires a candidate_solver (built "
                         "with skip as an input)")
    if precision_islands and (
            step_solver is not None or candidate_solver is not None
            or scenarios.x0.device.type != "cpu"):
        raise ValueError("precision_islands run on the plain route only "
                         "(CPU scenarios, no step or candidate solver): no "
                         "kernel computes an island")
    if tail_shrink is not None and stall_reseed is not None:
        raise ValueError("tail_shrink with stall_reseed is not supported "
                         "(the stall count reads every lane's step)")
    n = params.num_horizon
    k = params.num_ss_points
    nsi = params.num_ss_iter
    cap = 150 if solver_max_iter is None else solver_max_iter
    step_solver, candidate_solver = solver_of(
        step_solver, candidate_solver, "max_iter", cap, (),
        scenarios.x0.device.type != "cpu",
        lambda: (default_step_solver(params, limits, dt, max_steps=max_steps,
                                     max_laps=max_laps, max_iter=cap,
                                     reseeded=stall_reseed is not None),
                 None))
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
                                        candidate_solver=candidate_solver,
                                        dedup_passes=dedup_passes,
                                        dedup_log=dedup_log,
                                        precision_islands=precision_islands)
    stats_on = bool(getattr(step_solver, "with_stats", False))
    check_budget(max_steps, sim_step_budget, goal_append)
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
    stat_acc = (tuple(torch.zeros((b,), dtype=torch.int64, device=dev)
                      for _ in range(3)) if stats_on else ())
    order = (None if retile_frac is None and tail_shrink is None
             else LaneOrder(b, retile_frac, tail_shrink, dev, perm_log,
                            _spread))
    scen_obs = scenarios.obstacle
    # sim_step: executed steps over the run (and the run it resumes), the
    # noise row

    for lap_i in range(num_laps):
        lap_count = lap0 + lap_i  # laps stored so far (seed + learned)
        x = x0
        t = torch.zeros((b,), dtype=torch.int32, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        obstacle = scen_obs
        horizon_left = torch.full((b,), n, dtype=torch.int32, device=dev)
        replay_pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        u_old = torch.zeros((n, 2, b), dtype=dtype, device=dev)
        xs_rec = torch.zeros((max_steps, 4, b), dtype=dtype, device=dev)
        xs_rec[0] = x0
        if stall_reseed is not None:  # steps without progress, last Qfun
            stall = torch.zeros((b,), dtype=torch.int32, device=dev)
            q_prev = torch.full((b,), float("inf"), dtype=dtype, device=dev)
        if order is not None:
            order.start_lap()
        while True:
            in_replay = horizon_left < n
            if order is None:
                if not bool(((t < sim_step_budget) & ~done).any()):
                    break
            else:
                skipf = done | in_replay
                running, n_skip, n_notdone = order.read(
                    (t < sim_step_budget) & ~done, skipf, done)
                if not running:
                    break
                if order.fires(n_skip, n_notdone):
                    moved = [x, t, done, obstacle, horizon_left, replay_pos,
                             u_old, xs_rec, x0, goal, noise_on, scen_obs,
                             *stat_acc]
                    if stall_reseed is not None:
                        moved += [stall, q_prev]
                    moved = order.permute(order.source(skipf, done), moved,
                                          ss, lap_count)
                    (x, t, done, obstacle, horizon_left, replay_pos, u_old,
                     xs_rec, x0, goal, noise_on, scen_obs) = moved[:12]
                    stat_acc = tuple(moved[12:12 + len(stat_acc)])
                    if stall_reseed is not None:
                        stall, q_prev = moved[-2:]
                    in_replay = horizon_left < n
            w = b if order is None else order.lanes()
            lap_ids, lap_ok, skip = _step_solver_inputs(
                lap_count, nsi, max_laps, done | in_replay, b, dev)
            g0 = x if stall_reseed is None else torch.where(
                (stall >= stall_reseed)[None], goal, x)
            if (bool((skip < 0.5).any()) if order is None
                    else n_skip < b):
                prefix = {} if w == b or step_solver is None else dict(
                    lanes=w)
                us_sel, shrink_f, idx_sel, row_sel, *stats = solver(
                    x, g0, states, qfun, lap_len, lap_ids, lap_ok,
                    obstacle_to_lanes(obstacle, b), skip, **prefix)
                stat_acc = tuple(a + v for a, v in zip(stat_acc, stats))
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
            if retile_frac is not None:
                # as JAX routes them (batched_soa.py:838-843): under
                # tail_shrink alone the lane at position p takes draw p
                z = order.route(z)
            elif _spread is not None and noise is not None:
                z = _spread.draw(z)  # of the whole run's row
            sim_step += 1
            x_next, obstacle, reach = plant_step(x, u, dt, z, noise_on, done,
                                                 obstacle, goal)
            # freeze finished lanes
            t = torch.where(done, t, t + 1)
            horizon_left = torch.where(done, horizon_left, horizon_next)
            replay_pos = torch.where(done, replay_pos, replay_next)
            u_old = torch.where(done[None, None], u_old, u_old_next)
            # record row t of each lane (a done lane rewrites its frozen
            # row, so the lanes past w need no write)
            xs_rec[t[:w].to(torch.int64), :, lanes[:w]] = x_next[:, :w].T
            done = done | reach
            x = x_next
        if goal_append:  # goal as an extra recorded row
            xs_rec[(t + 1).to(torch.int64), :, lanes] = goal.T
            n_valid = t + 2
        else:  # goal snapped onto the final row
            xs_rec[t.to(torch.int64), :, lanes] = goal.T
            n_valid = t + 1
        add_lap(ss, lap_count, xs_rec, n_valid)
        if order is not None:  # lap rows in the original lane order
            t, done = order.to_original(t), order.to_original(done)
        lap_steps[lap_i] = t
        lap_done[lap_i] = done
    if order is not None:
        inv = order.finish(ss, lap0 + num_laps)
        stat_acc = tuple(a[inv] for a in stat_acc)
    return SoaRunResult(lap_steps=lap_steps, lap_done=lap_done,
                        final_x=scenarios.goal, safe_set=ss,
                        lap_count=lap0 + num_laps,
                        final_key=noise_key(noise, generator, sim_step),
                        iter_stats=stat_acc)
