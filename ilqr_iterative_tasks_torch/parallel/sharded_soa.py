"""Scenario-sharded batch-native (SoA) learning runs over a rank mesh.

Port of ilqr_iterative_tasks_tpu/parallel/sharded_soa.py. The SoA
simulators (control/batched_soa.py, control/batched_nlmpc_soa.py) keep the
scenario batch trailing; sharding it gives each rank the columns
``[i * B/n, (i + 1) * B/n)`` of every batch-trailing field, and each rank
runs the port's whole simulator on its columns: on the card it launches K1
(i2LQR) or K2 / K4 (NLMPC) as the unsharded run does. No lane reads
another, so the ranks share nothing while they run. At the end every
per-lane field (lap steps and done flags, final states, the safe set,
``streaks``, ``iter_stats``) is gathered along the trailing axis into the
global result on every rank, and ``lap_count`` is checked equal across
ranks. ``iter_stats`` (a step solver built ``with_stats``) are the
unsharded run's where each rank's columns hold whole groups of the
counts' lanes (a warp's for ``iters_executed``, ``floor_width`` for K1's
``queue_floor``); under ``*_shardmap`` each shard counts its own run.

The two noise semantics differ, as in the JAX package:

- ``*_sharded`` equals the unsharded run bit for bit on the same noise
  source. Injected ``noise`` (rows, 2, B) is sliced by column. With a
  ``generator`` (seeded alike on every rank) each rank draws the global
  (2, B) row at every executed step and keeps its columns. The unsharded
  run draws one row a step until its last lane ends the lap, so the ranks
  run one lap at a time (exact resume, ``resume_from``) and agree on the
  lap's rows (the most any rank executed) before the next. ``final_key``
  is the global run's: the rows consumed, or the generator's state.
- ``*_shardmap`` gives each shard its own stream, deterministic in
  (seed, shard), the counterpart of JAX's ``fold_in(key, shard)``: with a
  ``generator``, shard i draws from a generator seeded with
  ``shard_seed(generator.initial_seed(), i)``; injected ``noise`` (rows, 2,
  B) holds shard i's stream in its columns, each shard reading rows at its
  own pace (so a test can feed JAX's per-shard draws). Each rank runs all
  its laps in one call. ``resume_from`` raises NotImplementedError and
  ``final_key`` is None: the per-shard streams are not continued through
  this wrapper.

The simulators' options pass through in ``kw``, ``retile_frac`` and
``tail_shrink`` included (as JAX's wrappers pass them,
ilqr_iterative_tasks_tpu/parallel/sharded_soa.py:39-54): each rank
permutes its own columns (its retile block ``retile_frac`` x its lanes;
``tail_shrink`` a prefix of its lanes, below their count) and, where the
simulator routes the draws (the NLMPC one under either option, the i2LQR
one under ``retile_frac``), routes its own columns' draws by its own lane
ids, so the ``_sharded`` result stays the unsharded run's bit for bit (of
``iter_stats`` the useful trips). The i2LQR simulator with ``tail_shrink``
alone gives the lane at position p of a compacted lap draw p, as JAX's
does, so there each rank's compaction of its own columns makes the
``_sharded`` run another than the unsharded one, as it is in JAX.

``stats`` (a dict, optional) receives ``run_s`` (the rank's seconds in its
simulator calls) and ``gather_ms`` (the gather of the result).
"""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from ilqr_iterative_tasks_torch.control import batched_nlmpc_soa, batched_soa
from ilqr_iterative_tasks_torch.control.batched_soa import SoaScenarios
from ilqr_iterative_tasks_torch.parallel.distributed import build_kernels
from ilqr_iterative_tasks_torch.parallel.mesh import Mesh


def shard_columns(b: int, mesh: Mesh, axis: str = "scenario") -> slice:
    """This rank's columns of a batch of ``b`` lanes; ValueError where b
    does not divide over the mesh."""
    n = mesh.axis_size(axis)
    if b % n:
        raise ValueError(f"a batch of {b} lanes does not divide over a "
                         f"mesh of {n} ranks")
    per = b // n
    return slice(mesh.axis_index(axis) * per,
                 (mesh.axis_index(axis) + 1) * per)


def shard_soa_scenarios(scenarios: SoaScenarios, mesh: Mesh,
                        axis: str = "scenario") -> SoaScenarios:
    """This rank's columns of every batch-trailing field of ``scenarios``."""
    cols = shard_columns(scenarios.x0.shape[-1], mesh, axis)
    take = lambda a: a[..., cols].contiguous()
    return replace(scenarios, x0=take(scenarios.x0),
                   goal=take(scenarios.goal),
                   obstacle=scenarios.obstacle.map(take),
                   noise_on=take(scenarios.noise_on))


def shard_seed(seed: int, shard: int) -> int:
    """The seed of shard ``shard``'s noise stream under ``*_shardmap``."""
    return int(np.random.SeedSequence([int(seed), int(shard)])
               .generate_state(1, np.uint64)[0])


class ColumnDraws:
    """The noise of a ``*_sharded`` rank drawn from ``generator``: row r is
    the r-th global (2, b) standard-normal draw, this rank's columns. Rows
    are taken in increasing order; a row asked for past the next one draws
    (and drops) the rows between, as the unsharded run draws them."""

    def __init__(self, generator, b, cols, dtype, device):
        self.generator, self.b, self.cols = generator, b, cols
        self.dtype, self.device = dtype, device
        self.next, self.last = 0, None
        self.shape = (np.iinfo(np.int64).max, 2, cols.stop - cols.start)

    def advance(self, row: int) -> None:
        """Draw every row before ``row``."""
        while self.next < row:
            self.last = torch.randn((2, self.b), generator=self.generator,
                                    dtype=self.dtype, device=self.device)
            self.next += 1

    def __getitem__(self, row: int) -> torch.Tensor:
        if row < self.next - 1:
            raise ValueError(f"row {row} was drawn before")
        self.advance(row + 1)
        return self.last[:, self.cols]


def gather_result(res, mesh: Mesh, axis: str = "scenario", stats=None):
    """The global result on every rank: every per-lane field of this
    rank's ``res`` gathered along the trailing axis in mesh order;
    RuntimeError where the ranks' lap counts differ."""
    t0 = time.perf_counter()
    g = lambda t: torch.cat(mesh.all_gather(t, axis), dim=-1)
    fields = dict(lap_steps=g(res.lap_steps), lap_done=g(res.lap_done),
                  final_x=g(res.final_x),
                  safe_set=tuple(g(t) for t in res.safe_set))
    if getattr(res, "streaks", ()):
        fields["streaks"] = tuple(g(t) for t in res.streaks)
    if getattr(res, "iter_stats", ()):
        fields["iter_stats"] = tuple(g(t) for t in res.iter_stats)
    counts = mesh.all_gather(torch.tensor([res.lap_count],
                                          device=res.lap_steps.device), axis)
    if any(int(c) != res.lap_count for c in counts):
        raise RuntimeError(f"the ranks stored different lap counts "
                           f"{[int(c) for c in counts]}")
    if stats is not None:
        if res.lap_steps.is_cuda:
            torch.cuda.synchronize(res.lap_steps.device)
        stats["gather_ms"] = (time.perf_counter() - t0) * 1e3
    return res._replace(**fields)


def _max_rows(rows, mesh, axis, device):
    return max(int(r) for r in mesh.all_gather(
        torch.tensor([rows], dtype=torch.int64, device=device), axis))


def _sharded(sim, params, limits, scenarios, seed_xs, seed_us, seed_len, dt,
             mesh, axis, stats, kw):
    local = shard_soa_scenarios(scenarios, mesh, axis)
    dev, dtype = local.x0.device, local.x0.dtype
    if dev.type == "cuda":
        build_kernels(mesh)
    b = scenarios.x0.shape[-1]
    cols = shard_columns(b, mesh, axis)
    noise, generator = kw.pop("noise", None), kw.pop("generator", None)
    resume, num_laps = kw.pop("resume_from", None), kw.pop("num_laps")
    if noise is not None:
        source = noise[..., cols].contiguous()
    elif generator is not None:
        source = ColumnDraws(generator, b, cols, dtype, dev)
    else:
        source = None
    state = None
    if resume is not None:
        ss, lap0, key = resume
        row = batched_soa.resume_noise(key, noise, generator)
        state = (tuple(torch.as_tensor(t)[..., cols] for t in ss), lap0,
                 row if source is not None else None)
    t0 = time.perf_counter()
    laps = []
    for _ in range(max(num_laps, 1)):
        res = sim(params, limits, local, seed_xs, seed_us, seed_len, dt,
                  num_laps=min(num_laps, 1), noise=source,
                  resume_from=state, **kw)
        rows = res.final_key
        if rows is not None:
            rows = _max_rows(rows, mesh, axis, dev)
        state = (res.safe_set, res.lap_count, rows)
        laps.append(res)
    if stats is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats["run_s"] = time.perf_counter() - t0
    res = res._replace(lap_steps=torch.cat([r.lap_steps for r in laps]),
                       lap_done=torch.cat([r.lap_done for r in laps]))
    if getattr(res, "streaks", ()):
        res = res._replace(streaks=tuple(
            torch.cat(ts) for ts in zip(*(r.streaks for r in laps))))
    if getattr(res, "iter_stats", ()):  # each lap's run counts afresh
        res = res._replace(iter_stats=tuple(
            sum(ts) for ts in zip(*(r.iter_stats for r in laps))))
    key = None
    if isinstance(source, ColumnDraws):
        source.advance(rows)
        key = generator.get_state()
    elif source is not None:
        key = rows
    return gather_result(res, mesh, axis, stats)._replace(final_key=key)


def _shardmap(sim, params, limits, scenarios, seed_xs, seed_us, seed_len, dt,
              mesh, axis, stats, kw):
    if kw.get("resume_from") is not None:
        raise NotImplementedError(
            "resume_from under the shardmap wrapper: resume the per-shard "
            "runs one by one (each shard has its own noise stream)")
    local = shard_soa_scenarios(scenarios, mesh, axis)
    if local.x0.device.type == "cuda":
        build_kernels(mesh)
    cols = shard_columns(scenarios.x0.shape[-1], mesh, axis)
    if kw.get("noise") is not None:
        kw["noise"] = kw["noise"][..., cols].contiguous()
    elif kw.get("generator") is not None:
        g = kw["generator"]
        kw["generator"] = torch.Generator(device=g.device).manual_seed(
            shard_seed(g.initial_seed(), mesh.axis_index(axis)))
    t0 = time.perf_counter()
    res = sim(params, limits, local, seed_xs, seed_us, seed_len, dt, **kw)
    if stats is not None:
        if local.x0.is_cuda:
            torch.cuda.synchronize(local.x0.device)
        stats["run_s"] = time.perf_counter() - t0
    return gather_result(res, mesh, axis, stats)._replace(final_key=None)


def simulate_learning_runs_soa_sharded(params, limits, scenarios, seed_xs,
                                       seed_us, seed_len, dt, mesh: Mesh, *,
                                       axis: str = "scenario", stats=None,
                                       **kw):
    """Scenario-sharded i2LQR learning runs, bit for bit the unsharded run
    (``batched_soa.simulate_learning_runs_soa``; its options in ``kw``)
    but where ``tail_shrink`` alone compacts a lap (module docstring)."""
    return _sharded(lambda *a, **k: batched_soa.simulate_learning_runs_soa(
        *a, **k), params, limits, scenarios, seed_xs, seed_us, seed_len, dt,
        mesh, axis, stats, kw)


def simulate_nlmpc_runs_soa_sharded(params, limits, scenarios, seed_xs,
                                    seed_us, seed_len, dt, mesh: Mesh, *,
                                    axis: str = "scenario", stats=None, **kw):
    """Scenario-sharded NLMPC learning runs, bit for bit the unsharded run
    (``batched_nlmpc_soa.simulate_nlmpc_runs_soa``; its options in
    ``kw``)."""
    return _sharded(lambda *a, **k: batched_nlmpc_soa.simulate_nlmpc_runs_soa(
        *a, **k), params, limits, scenarios, seed_xs, seed_us, seed_len, dt,
        mesh, axis, stats, kw)


def simulate_learning_runs_soa_shardmap(params, limits, scenarios, seed_xs,
                                        seed_us, seed_len, dt, mesh: Mesh, *,
                                        axis: str = "scenario", stats=None,
                                        **kw):
    """i2LQR learning runs, each shard with its own noise stream (JAX's
    shard_map wrapper): equal to running each shard alone on its stream."""
    return _shardmap(lambda *a, **k: batched_soa.simulate_learning_runs_soa(
        *a, **k), params, limits, scenarios, seed_xs, seed_us, seed_len, dt,
        mesh, axis, stats, kw)


def simulate_nlmpc_runs_soa_shardmap(params, limits, scenarios, seed_xs,
                                     seed_us, seed_len, dt, mesh: Mesh, *,
                                     axis: str = "scenario", stats=None,
                                     **kw):
    """NLMPC learning runs, each shard with its own noise stream (see
    ``simulate_learning_runs_soa_shardmap``)."""
    return _shardmap(lambda *a, **k: batched_nlmpc_soa.simulate_nlmpc_runs_soa(
        *a, **k), params, limits, scenarios, seed_xs, seed_us, seed_len, dt,
        mesh, axis, stats, kw)
