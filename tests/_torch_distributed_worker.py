"""Rank functions of the port's multi-process CPU tests, run by
``ilqr_iterative_tasks_torch.parallel.launch.spawn`` (gloo on loopback):

    spawn(f"{WORKER}:sharded_runs", 4, backend="gloo")

Each runs on every rank of the group and returns CPU tensors and numbers.
Imports only the port (tests/test_torch_no_jax.py scans this file).
"""

from dataclasses import replace

import numpy as np
import torch

from ilqr_iterative_tasks_torch.control.batched_soa import SoaScenarios
from ilqr_iterative_tasks_torch.control.nlmpc import NlmpcController
from ilqr_iterative_tasks_torch.experiments.runner import (
    default_obstacle, run_closed_loop)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.parallel.distributed import (
    global_scenario_mesh, host_local_batch_slice)
from ilqr_iterative_tasks_torch.parallel.mesh import (
    Mesh, make_mesh, make_mesh_2d)
from ilqr_iterative_tasks_torch.parallel.sharded_safe_set import sharded_knn
from ilqr_iterative_tasks_torch.parallel.sharded_soa import (
    simulate_learning_runs_soa_shardmap, simulate_learning_runs_soa_sharded,
    simulate_nlmpc_runs_soa_shardmap, simulate_nlmpc_runs_soa_sharded)
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, LmpcParams, SystemLimits)

F64, CPU = torch.float64, "cpu"
SHARDED_B, SHARDMAP_B, CAP, NOISE_ROWS = 16, 8, 8, 300
I2LQR_KW = dict(num_laps=1, max_steps=128, max_laps=4, solver_max_iter=CAP)
NLMPC_KW = dict(num_laps=1, max_steps=128, max_laps=4, max_lm_iters=CAP)
# the counting run: 2 laps of at most 20 steps through a K1 with_stats
# (and dedup), its queue_floor over groups of 8 lanes, a rank's share of
# SHARDED_B
STATS_KW = dict(I2LQR_KW, num_laps=2, sim_step_budget=20)
STATS_WIDTH = 8
# the lane permutations of the options runs (each rank its own 8 lanes)
OPTIONS = dict(retile_frac=0.25, tail_shrink=4)
# ``tail_shrink`` alone over two laps of at most 25 steps on the
# staggered scenarios (``tail_setup``): a prefix below a rank's share of
# SHARDED_B and one at or above it
TAIL_KW = dict(num_laps=2, max_steps=128, max_laps=4, sim_step_budget=25)
TAILS = (4, 12)


def stats_solver(ip, lim):
    """The counting K1 of the ``_sharded`` i2LQR stats run."""
    from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
        build_fused_i2lqr_step)
    return build_fused_i2lqr_step(
        ip, lim, 1.0, num_horizon=ip.num_horizon,
        max_steps=I2LQR_KW["max_steps"], max_laps=I2LQR_KW["max_laps"],
        max_iter=CAP, dedup=True, with_stats=True, floor_width=STATS_WIDTH)


def setup(b):
    """(i2LQR params, NLMPC params, limits, seed_xs, seed_us, scenarios) of
    the JAX package's loopback tests (tests/test_distributed.py): f64, the
    seed lap, the (31, -2) 8 x 6 obstacle, b lanes with plant noise on."""
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((128, 4)), np.zeros((128, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=F64,
                                            device=CPU),
        b, noise_on=True, dtype=F64, device=CPU)
    return (IlqrParams.make(dtype=F64, device=CPU),
            LmpcParams.make(ss_option="spaceVarying", device=CPU),
            SystemLimits.make(dtype=F64, device=CPU), seed_xs, seed_us, scen)


def tail_setup(b, nlmpc=False):
    """(params, limits, seed_xs, seed_us, scenarios, the LM cap keyword):
    ``setup(b)``, i2LQR's or (``nlmpc``) NLMPC's, with each lane starting
    at another state of the seed lap (rows 80-118, in an order drawn from
    numpy's seed 0), so that the lanes end each lap at different steps and
    a ``tail_shrink`` lap compacts in the first learning lap already."""
    ip, lp, lim, seed_xs, seed_us, scen = setup(b)
    rows = np.random.default_rng(0).permutation(
        np.linspace(80, 118, b).round().astype(int))
    x0 = torch.tensor(seed_xs[rows].T.copy())
    return (lp if nlmpc else ip, lim, seed_xs, seed_us,
            replace(scen, x0=x0),
            dict(max_lm_iters=CAP) if nlmpc else dict(solver_max_iter=CAP))


def tail_run(params, lim, sx, su, scen, cap_kw, tail, sim, *args, **kw):
    """The run ``sim`` (unsharded, or a ``_sharded`` wrapper with its mesh
    in ``args``) with ``tail_shrink=tail`` alone over TAIL_KW's laps on
    the injected ``global_noise``, beside its permutation log; a run that
    raises gives the error's text instead."""
    log = []
    try:
        res = sim(params, lim, scen, sx, su, 121, 1.0, *args,
                  noise=global_noise(SHARDED_B), tail_shrink=tail,
                  perm_log=log, **cap_kw, **kw, **TAIL_KW)
    except ValueError as err:
        return f"{type(err).__name__}: {err}"
    return res, log


def global_noise(b, seed=5):
    """Injected standard-normal draws (NOISE_ROWS, 2, b) from numpy."""
    return torch.tensor(np.random.default_rng(seed).normal(
        size=(NOISE_ROWS, 2, b)))


def pair_mesh():
    """This rank's 1-D mesh in a world of 4: ranks (0, 1) or (2, 3) (every
    rank forms both pairs' groups)."""
    import torch.distributed as dist
    groups = {f: dist.new_group([f, f + 1]) for f in (0, 2)}
    first = dist.get_rank() // 2 * 2
    return Mesh(ranks=(first, first + 1), shape=(2,),
                axis_names=("scenario",), rank=dist.get_rank(),
                device=torch.device(CPU), groups={"scenario": groups[first]})


def sharded_runs():
    """The ``_sharded`` runs of tests/test_torch_sharded_soa.py on a world
    of 4, each pair of ranks a 2-rank mesh: ranks 0-1 i2LQR (B = 16, 1 lap,
    injected global noise) and then i2LQR over 2 laps through a K1 that
    counts (``stats_solver``), ranks 2-3 NLMPC on that noise (with its
    streak statistics) and then NLMPC over 3 laps on a generator of seed
    7; the first i2LQR run and the last NLMPC run again with OPTIONS,
    each beside its permutation log; ranks 0-1 then i2LQR with
    ``tail_shrink`` alone at each of TAILS (``tail_run``), ranks 2-3 NLMPC
    at the last, a prefix above a rank's lanes."""
    mesh = pair_mesh()
    ip, lp, lim, sx, su, scen = setup(SHARDED_B)
    noise = global_noise(SHARDED_B)
    out = dict(index=mesh.axis_index(), size=mesh.size)
    if mesh.ranks[0] == 0:
        out["i2lqr"] = simulate_learning_runs_soa_sharded(
            ip, lim, scen, sx, su, 121, 1.0, mesh, noise=noise, **I2LQR_KW)
        out["i2lqr_stats"] = simulate_learning_runs_soa_sharded(
            ip, lim, scen, sx, su, 121, 1.0, mesh, noise=noise,
            step_solver=stats_solver(ip, lim),
            **STATS_KW)
        log = []
        out["i2lqr_options"] = (simulate_learning_runs_soa_sharded(
            ip, lim, scen, sx, su, 121, 1.0, mesh, noise=noise,
            perm_log=log, **OPTIONS, **I2LQR_KW), log)
        for tail in TAILS:
            out[f"i2lqr_tail{tail}"] = tail_run(
                *tail_setup(SHARDED_B), tail,
                simulate_learning_runs_soa_sharded, mesh)
    else:
        out["nlmpc"] = simulate_nlmpc_runs_soa_sharded(
            lp, lim, scen, sx, su, 121, 1.0, mesh, noise=noise,
            with_streak_stats=True, **NLMPC_KW)
        out["nlmpc_generator"] = simulate_nlmpc_runs_soa_sharded(
            lp, lim, scen, sx, su, 121, 1.0, mesh,
            generator=torch.Generator().manual_seed(7),
            **dict(NLMPC_KW, num_laps=3))
        log = []
        out["nlmpc_generator_options"] = (simulate_nlmpc_runs_soa_sharded(
            lp, lim, scen, sx, su, 121, 1.0, mesh,
            generator=torch.Generator().manual_seed(7), perm_log=log,
            **OPTIONS, **dict(NLMPC_KW, num_laps=3)), log)
        out[f"nlmpc_tail{TAILS[-1]}"] = tail_run(
            *tail_setup(SHARDED_B, nlmpc=True), TAILS[-1],
            simulate_nlmpc_runs_soa_sharded, mesh)
    return out


def shardmap_runs(i2lqr_noise, nlmpc_noise):
    """On a world of 4, each pair of ranks a 2-rank mesh: ``_shardmap``
    i2LQR on ranks 0-1 and NLMPC spaceVarying on ranks 2-3 (B = 8, 1 lap),
    each shard's stream the columns of its injected noise."""
    mesh = pair_mesh()
    ip, lp, lim, sx, su, scen = setup(SHARDMAP_B)
    if mesh.ranks[0] == 0:
        return dict(i2lqr=simulate_learning_runs_soa_shardmap(
            ip, lim, scen, sx, su, 121, 1.0, mesh,
            noise=torch.as_tensor(i2lqr_noise), **I2LQR_KW))
    return dict(nlmpc=simulate_nlmpc_runs_soa_shardmap(
        lp, lim, scen, sx, su, 121, 1.0, mesh,
        noise=torch.as_tensor(nlmpc_noise), **NLMPC_KW))


def knn_and_meshes(cases, k, batch):
    """On a world of 4: ``sharded_knn`` of every (states, valid, qfun,
    x_guess) case over meshes of the first 1, 2 and 4 ranks (rank 0
    returns them), this rank's ``host_local_batch_slice(batch)``, and the
    ranks that a 2 x 2 mesh gathers along each axis."""
    out = dict(slice=host_local_batch_slice(batch), knn={})
    for n in (1, 2, 4):
        mesh = make_mesh(n, axis_name="history")
        if mesh is None:
            continue
        for name, (states, valid, qfun, x) in cases.items():
            got = sharded_knn(torch.as_tensor(states), torch.as_tensor(valid),
                              torch.as_tensor(qfun), torch.as_tensor(x), k,
                              mesh)
            out["knn"][(n, name)] = got
    mesh = make_mesh_2d(2, 2)
    me = torch.tensor([mesh.rank])
    out["mesh_2d"] = {axis: [int(r) for r in mesh.all_gather(me, axis)]
                      for axis in mesh.axis_names}
    out["mesh_2d_index"] = (mesh.axis_index("scenario"),
                            mesh.axis_index("candidate"))
    return out


def distributed_checks(i2lqr_noise, nlmpc_noise, cases, k, batch):
    """``shardmap_runs`` then ``knn_and_meshes`` on a world of 4."""
    return dict(shardmap=shardmap_runs(i2lqr_noise, nlmpc_noise),
                **knn_and_meshes(cases, k, batch))


def meshed_controller(mode, laps=2):
    """The meshed NlmpcController over every rank (f64, zero noise, the
    default obstacle): its lap times and the lanes of its K4 calls."""
    params = (LmpcParams.make(all_ss_point=True, all_ss_iter=True,
                              device=CPU) if mode == "all"
              else LmpcParams.make(ss_option="spaceVarying", device=CPU))
    ctrl = NlmpcController(params, obstacle=default_obstacle(1.0), dtype=F64,
                           device=CPU, mesh=make_mesh(axis_name="history"))
    res = run_closed_loop(ctrl, lap_number=laps, dt=1.0, goal_fixup=None)
    return dict(laps=res.all_lap_times, finished=res.lap_finished,
                launch_lanes=ctrl.launch_lanes)


def all_mode_shardmap(noise, kw):
    """The NLMPC ``all`` mode through ``_shardmap`` over every rank (B = 8,
    1 lap, LM cap 8, the options ``kw``) on injected per-shard noise."""
    _, _, lim, sx, su, scen = setup(SHARDMAP_B)
    return simulate_nlmpc_runs_soa_shardmap(
        LmpcParams.make(all_ss_point=True, device=CPU), lim, scen, sx, su,
        121, 1.0, global_scenario_mesh(), noise=torch.as_tensor(noise),
        **dict(NLMPC_KW, **kw))


def fail_on_rank_1():
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()


def sharded_i2lqr(args, kw):
    """The i2LQR ``_sharded`` run of ``args`` (params, limits, scenarios,
    seed_xs, seed_us, seed_len, dt: the port's objects) and keywords
    ``kw`` over every rank (tests/test_torch_retile_jax.py: JAX's run on
    JAX's draws); rank 0's gathered result and its permutation log."""
    log = []
    res = simulate_learning_runs_soa_sharded(*args, global_scenario_mesh(),
                                             perm_log=log, **kw)
    return (res, log) if torch.distributed.get_rank() == 0 else None
