"""The two parallel axes of the vmap tier over a rank mesh, and the
multi-rank dry run.

Port of ilqr_iterative_tasks_tpu/parallel/sharded.py:

1. **Scenario data parallelism** (``simulate_learning_batch_sharded``,
   :38-55): each rank runs its rows of the scenario batch through
   control/batched.py's ``simulate_learning_batch`` (K3 on the card), and
   every per-scenario output is gathered along the batch axis. A
   scenario's run reads no other and its noise is a function of its own
   seed and step count, so the result equals the unsharded run bit for
   bit.
2. **Candidate parallelism** (``sharded_candidate_sweep``, :57-121): ONE
   control step's candidate sweep split over the ranks of the
   "candidate" axis. Each rank solves its C / n candidates in one K3
   launch, costs them at relaxation pass 0 and takes its local first-min
   argmin; an ``all_gather`` over the axis shares (cost, local index) and
   the local winners' inputs; the winner is the first global minimum (the
   lowest rank among equal costs) and its trajectory its owner's. K3
   returns x_N, not the states: ``xs`` is the rollout of the winner's
   clipped inputs with K3's x_N as its last row.

``dryrun(n)`` (:124-213) runs JAX's four parts on tiny shapes on the
ranks of this process group: the scenario-sharded vmap run (against the
unsharded one), the candidate-sharded sweep (against the sweep on one
rank), the SoA ``_sharded`` simulators (K1, K2), and the ``_shardmap``
i2LQR simulator with K1. On the card they launch the kernels (NCCL, one
card a rank; ranks that share a card use gloo); on the CPU they run the
kernels' plain versions over gloo. ``python -m
ilqr_iterative_tasks_torch.parallel.sharded N`` starts N ranks
(parallel/launch.py) and runs it.
"""

from __future__ import annotations

import sys
import time
from dataclasses import replace

import numpy as np
import torch

from ilqr_iterative_tasks_torch.control.batched import (
    BatchedRunResult, ScenarioSpec, make_batch_scenarios, relaxed_cost,
    simulate_learning_batch)
from ilqr_iterative_tasks_torch.models import kinetic_bicycle as dyn
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
    build_fused_ilqr, obstacle_to_lanes)
from ilqr_iterative_tasks_torch.ops.ilqr import rollout
from ilqr_iterative_tasks_torch.parallel.distributed import (
    build_kernels, rank_device)
from ilqr_iterative_tasks_torch.parallel.mesh import Mesh, make_mesh
from ilqr_iterative_tasks_torch.parallel.sharded_soa import shard_columns
from ilqr_iterative_tasks_torch.utils.device import resolve
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits


def shard_scenarios(scenarios: ScenarioSpec, mesh: Mesh,
                    axis: str = "scenario") -> ScenarioSpec:
    """This rank's rows of a scenario batch."""
    rows = shard_columns(scenarios.batch, mesh, axis)
    return scenarios.map(lambda t: t[rows].contiguous())


def _gather_rows(t, mesh, axis):
    return torch.cat(mesh.all_gather(t, axis), dim=0)


def simulate_learning_batch_sharded(params, limits, scenarios, seed_xs,
                                    seed_us, seed_len, dt, mesh: Mesh, *,
                                    axis: str = "scenario",
                                    **kw) -> BatchedRunResult:
    """Scenario-sharded vmap i2LQR runs: each rank runs its rows
    (``simulate_learning_batch``, its options in ``kw``; an injected
    ``noise`` (B, steps, 2) is sliced by row), then every output is
    gathered on every rank. Bit for bit the unsharded run."""
    local = shard_scenarios(scenarios, mesh, axis)
    if kw.get("noise") is not None:
        kw["noise"] = kw["noise"][shard_columns(scenarios.batch, mesh, axis)]
    if local.x0.device.type == "cuda":
        build_kernels(mesh)
    res = simulate_learning_batch(params, limits, local, seed_xs, seed_us,
                                  seed_len, dt, **kw)
    g = lambda t: _gather_rows(t, mesh, axis)
    return BatchedRunResult(g(res.lap_steps), g(res.lap_done),
                            res.safe_set.map(g), g(res.final_x))


def local_mesh(axis: str, device=None) -> Mesh:
    """A mesh of this process alone (its collectives return the input):
    the sweep on one rank, whatever the world."""
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_initialized() else 0
    return Mesh(ranks=(rank,), shape=(1,), axis_names=(axis,), rank=rank,
                device=rank_device() if device is None else device)


def sharded_candidate_sweep(params: IlqrParams, limits: SystemLimits,
                            obstacle: Obstacle, x0, x_terminals, q_terms,
                            u_init, lamb0, dt, *, num_horizon: int,
                            mesh: Mesh, axis_name: str = "candidate",
                            candidate_solver=None):
    """One i2LQR control step's candidate sweep sharded over ``mesh``'s
    ``axis_name`` (module docstring).

    x0 (4,); x_terminals (C, 4), C divisible by the axis size; q_terms
    (C,); u_init (N, 2). ``candidate_solver``: the K3 to launch (built
    with ``lamb0`` as its params' lamb and ``max_iter=params.max_ilqr_iter``),
    else one is built. Returns (us (N, 2), xs (N+1, 4), cost, the global
    candidate index), the same on every rank."""
    n = num_horizon
    c = x_terminals.shape[0]
    rows = shard_columns(c, mesh, axis_name)
    per = rows.stop - rows.start
    dtype, dev = x_terminals.dtype, x_terminals.device
    k3 = candidate_solver
    if k3 is None:
        k3 = build_fused_ilqr(
            replace(params, lamb=torch.as_tensor(
                lamb0, dtype=params.lamb.dtype, device=params.lamb.device)),
            limits, dt, num_horizon=n, max_iter=params.max_ilqr_iter)
    x0 = torch.as_tensor(x0, dtype=dtype, device=dev)
    us, x_last, _, dist = k3(
        x0[:, None].expand(4, per).contiguous(),
        x_terminals[rows].T.contiguous(),
        torch.as_tensor(u_init, dtype=dtype, device=dev)[..., None].expand(
            n, 2, per).contiguous(),
        obstacle_to_lanes(obstacle, per).contiguous())
    # relaxation pass 0's cost: Qfun + horizon + the distance penalty
    cost = relaxed_cost(dist, q_terms[rows], float(n), 0,
                        params.max_relax_iter)
    best = torch.argmin(cost)
    mine = torch.cat([cost[best, None], best[None].to(dtype),
                      us[:, :, best].reshape(-1), x_last[:, best]])
    every = torch.stack(mesh.all_gather(mine, axis_name))  # (ranks, ...)
    owner = torch.argmin(every[:, 0])
    win = every[owner]
    local_idx = win[1].to(torch.int64)
    us_win = win[2:2 + 2 * n].reshape(n, 2)
    xs = rollout(x0, us_win, dt)
    xs[-1] = win[2 + 2 * n:]
    return us_win, xs, win[0], owner * per + local_idx


# ---- the dry run ----
DRY_MAX_STEPS, DRY_MAX_LAPS, DRY_BUDGET, DRY_SOA_CAP = 16, 4, 4, 8
DRY_K = 8  # the whole-step kernels are instantiated at k = 8 and 32


def dry_seed(dtype):
    """JAX's dry-run seed lap: 9 states from rest, u = (1, 0) for two
    steps then zero, padded to DRY_MAX_STEPS rows; (seed_xs, seed_us,
    goal) as numpy."""
    xs = [torch.zeros(4, dtype=dtype)]
    for i in range(8):
        u = torch.tensor([1.0 if i < 2 else 0.0, 0.0], dtype=dtype)
        xs.append(dyn.step(xs[-1], u, 1.0))
    seed = torch.stack(xs).numpy()
    seed_xs = np.zeros((DRY_MAX_STEPS, 4), seed.dtype)
    seed_xs[:9] = seed
    return seed_xs, np.zeros((DRY_MAX_STEPS, 2), seed.dtype), seed[-1]


def _same(a, b) -> bool:
    """Bitwise equality of two runs' outputs (tensors, tuples, a safe set)."""
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and bool(torch.equal(a, b))
    return all(_same(x, y) for x, y in zip(a, b))


def dryrun(n_devices: int, *, device=None, dtype=torch.float32,
           candidates: int | None = None) -> dict:
    """The multi-rank dry run on this process group's first ``n_devices``
    ranks (module docstring), at JAX's tiny shapes with k = 8; each part
    checked here. Returns, for the caller's checks, the vmap run's lap
    steps, the sweep's result (CPU tensors) and its inputs, each part's
    seconds and the kernels' launches (K3 in the sharded vmap run and
    sweep, K1 in the shard-map run; 0 on the CPU). ``candidates``: the
    sweep's C (16 per rank by default)."""
    import torch.distributed as dist
    from ilqr_iterative_tasks_torch.control.batched_soa import SoaScenarios
    from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
        build_fused_i2lqr_step)
    from ilqr_iterative_tasks_torch.parallel.sharded_soa import (
        simulate_learning_runs_soa_shardmap,
        simulate_learning_runs_soa_sharded, simulate_nlmpc_runs_soa_sharded)
    from ilqr_iterative_tasks_torch.utils.params import LmpcParams

    dev = resolve(device)
    mesh = make_mesh(n_devices)
    mesh_c = make_mesh(n_devices, axis_name="candidate")
    if mesh is None:  # a rank outside the dry run's mesh
        return {}
    if dev.type == "cuda":
        build_kernels(mesh)
    params = IlqrParams.make(num_ss_points=DRY_K, dtype=dtype, device=dev)
    limits = SystemLimits.make(dtype=dtype, device=dev)
    obstacle = Obstacle.make(5.0, -2.0, 1.0, 1.0, dtype=dtype, device=dev)
    seed_xs, seed_us, goal = dry_seed(dtype)
    sizes = dict(max_steps=DRY_MAX_STEPS, max_laps=DRY_MAX_LAPS,
                 sim_step_budget=DRY_BUDGET, num_laps=1)
    out, secs = {}, {}

    def timed(part, fn):
        t0 = time.perf_counter()
        r = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs[part] = time.perf_counter() - t0
        return r

    # the K3 of parts 1-2 (the sweep's lamb0 is params.lamb), counted
    k3 = build_fused_ilqr(params, limits, 1.0, num_horizon=params.num_horizon,
                          max_iter=params.max_ilqr_iter)
    launches = {}

    # 1) the scenario-sharded vmap learning run (one lap, a tiny budget)
    b = 4 * n_devices  # whole vector widths of lanes a rank on the CPU
    scen = make_batch_scenarios(np.zeros(4), goal, obstacle, b, key=0,
                                dtype=dtype, device=dev)
    res = timed("vmap_sharded", lambda: simulate_learning_batch_sharded(
        params, limits, scen, seed_xs, seed_us, 9, 1.0, mesh,
        candidate_solver=k3, **sizes))
    launches["vmap_sharded"] = k3.launches
    ref = timed("vmap_unsharded", lambda: simulate_learning_batch(
        params, limits, scen, seed_xs, seed_us, 9, 1.0, candidate_solver=k3,
        **sizes))
    if res.lap_steps.shape != (b, 1) or not _same(res, ref):
        raise AssertionError("dryrun: the sharded vmap run is not the "
                             "unsharded run bit for bit")
    out["vmap_lap_steps"] = res.lap_steps.cpu()

    # 2) the candidate-sharded sweep with its cross-rank argmin
    nc = 16 * n_devices if candidates is None else int(candidates)
    cands = torch.as_tensor(np.linspace([2.0, 0.0, 1.0, 0.0],
                                        [6.0, 0.5, 2.0, 0.1], nc),
                            dtype=dtype, device=dev)
    # Qfun falling along the candidates: the winner is the last rank's
    qs = torch.arange(nc - 1, -1, -1, dtype=dtype, device=dev)
    u0 = torch.zeros((params.num_horizon, 2), dtype=dtype, device=dev)
    x0 = torch.zeros(4, dtype=dtype, device=dev)
    sweep = lambda m: sharded_candidate_sweep(
        params, limits, obstacle, x0, cands, qs, u0, 1.0, 1.0,
        num_horizon=params.num_horizon, mesh=m, candidate_solver=k3)
    k3.launches = 0
    got = timed("sweep_sharded", lambda: sweep(mesh_c))
    launches["sweep_sharded"] = k3.launches
    want = timed("sweep_local", lambda: sweep(local_mesh("candidate", dev)))
    if got[0].shape != (params.num_horizon, 2) or not _same(got, want):
        raise AssertionError("dryrun: the sharded sweep is not the sweep "
                             "on one rank bit for bit")
    out["sweep"] = tuple(t.cpu() for t in got)
    out["sweep_inputs"] = (cands.cpu(), qs.cpu())

    # 3) the batch-trailing SoA simulators, trailing axis sharded
    bs = 2 * n_devices
    soa = SoaScenarios.broadcast(np.zeros(4), goal, obstacle, bs,
                                 dtype=dtype, device=dev)
    res_i = timed("soa_i2lqr_sharded", lambda: (
        simulate_learning_runs_soa_sharded(
            params, limits, soa, seed_xs, seed_us, 9, 1.0, mesh,
            solver_max_iter=DRY_SOA_CAP, **sizes)))
    lp = LmpcParams.make(num_ss_points=DRY_K, dtype=dtype, device=dev)
    nl_limits = SystemLimits.make(dtype=torch.float64, device=dev)
    res_n = timed("soa_nlmpc_sharded", lambda: (
        simulate_nlmpc_runs_soa_sharded(
            lp, nl_limits, soa, seed_xs, seed_us, 9, 1.0, mesh,
            max_lm_iters=DRY_SOA_CAP, **sizes)))
    if res_i.lap_steps.shape != (1, bs) or res_n.lap_steps.shape != (1, bs):
        raise AssertionError("dryrun: the SoA sharded runs' shapes")

    # 4) the shard-map wrapper around the whole-step kernel K1
    bm = 8 * n_devices
    sm = SoaScenarios.broadcast(np.zeros(4), goal, obstacle, bm,
                                dtype=dtype, device=dev)
    k1 = build_fused_i2lqr_step(
        params, limits, 1.0, num_horizon=params.num_horizon,
        max_steps=DRY_MAX_STEPS, max_laps=DRY_MAX_LAPS, max_iter=DRY_SOA_CAP)
    res_sm = timed("soa_shardmap_k1", lambda: (
        simulate_learning_runs_soa_shardmap(
            params, limits, sm, seed_xs, seed_us, 9, 1.0, mesh,
            solver_max_iter=DRY_SOA_CAP, step_solver=k1, **sizes)))
    if res_sm.lap_steps.shape != (1, bm):
        raise AssertionError("dryrun: the shard-map run's shape")
    launches["k1_shardmap"] = k1.launches
    out.update(rank=mesh.rank, ranks=n_devices, seconds=secs,
               backend=dist.get_backend() if dist.is_initialized() else None,
               launches=launches)
    return out


def dryrun_rank(n_devices: int, **kw) -> dict:
    """``dryrun`` on one rank started by parallel/launch.py (the rank's
    device: its card, or the CPU)."""
    return dryrun(n_devices, device=rank_device(), **kw)


def main(argv=None) -> None:
    """python -m ilqr_iterative_tasks_torch.parallel.sharded N: the dry run
    on N ranks of this host, NCCL where there is a card a rank, else gloo;
    prints each rank's summary."""
    from ilqr_iterative_tasks_torch.parallel.launch import spawn
    n = int((argv or sys.argv[1:] or ["2"])[0])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if 0 < n <= cards else "gloo"
    for r in spawn("ilqr_iterative_tasks_torch.parallel.sharded:dryrun_rank",
                   n, n, backend=backend,
                   timeout=900):
        print(f"rank {r['rank']}/{n} {r['backend']}: vmap lap steps "
              f"{r['vmap_lap_steps'].flatten().tolist()}, sweep index "
              f"{int(r['sweep'][3])}, seconds "
              f"{ {k: round(v, 3) for k, v in r['seconds'].items()} }",
              flush=True)


if __name__ == "__main__":
    main()
