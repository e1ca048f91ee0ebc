"""The scale-out runs of ``chip_smoke.py``'s phase 32: the i2LQR and NLMPC
headlines (experiments/headlines.py's configurations: B lanes, seed lap +
3 learning laps, f32, plant noise on; i2LQR through K1 at LM cap 16, NLMPC
spaceVarying through K2 with qsort_skip at cap 12 and infeasible_retire 8)
on injected noise, unsharded or through the ``_sharded`` wrappers
(parallel/sharded_soa.py) over a mesh of ranks, the i2LQR headline at
TAIL_BATCH lanes over TAIL_LAPS laps with ``tail_shrink`` alone (each
rank's lanes in the whole run's order), and the meshed NLMPC host
controller through K4 (f64, zero noise, 2 learning laps).

``scale_out_rank`` is what each rank of a group started by
parallel/launch.py runs; it returns, for each run, the gathered result's
lap-records hash (which must be the unsharded run's), the rank's kernel
launches (counts zeroed just before the run), its seconds and the
gather's ms. Every run is inside ``headlines.no_plain_solve_on_card``.
Nothing touches the card at import.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ilqr_iterative_tasks_torch.control import batched_nlmpc_soa, batched_soa
from ilqr_iterative_tasks_torch.control.batched_soa import SoaScenarios
from ilqr_iterative_tasks_torch.experiments.headlines import (
    CAP, LAPS, MAX_LAPS, MAX_STEPS, NL_CAP, NL_RETIRE, lap_records_hash,
    no_plain_solve_on_card)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.parallel.sharded_soa import (
    simulate_learning_runs_soa_sharded, simulate_nlmpc_runs_soa_sharded)
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, LmpcParams, SystemLimits)

NOISE_SEED = 32  # the injected noise's generator seed
SMALL_BATCH = 2048  # the one-rank NCCL check's batch
# the JAX package's pinned meshed laps, seed lap first
# (tests/test_nlmpc.py:153-173)
MESHED_LAPS = {"space": [120.0, 32.0, 23.0], "all": [120.0, 26.0, 22.0]}
# the i2LQR ``tail_shrink`` runs: B, learning laps, and the prefixes (one
# below and one above the 2 048 lanes a rank of 2 holds)
TAIL_BATCH, TAIL_LAPS, TAILS = 4096, 2, (1024, 3072)


def headline_noise(batch: int, dev) -> torch.Tensor:
    """The injected standard-normal draws of a headline at ``batch`` lanes:
    (LAPS * 121, 2, batch) f32 from a generator of NOISE_SEED on ``dev``
    (as many rows as the runs can execute)."""
    g = torch.Generator(device=dev).manual_seed(NOISE_SEED)
    return torch.randn((LAPS * 121, 2, batch), generator=g, device=dev)


def headline_args(which: str, batch: int, dev):
    """(the simulator, its sharded wrapper, positional args, keywords, the
    kernel the simulator launches) of the headline ``which`` ("i2lqr" or
    "nlmpc") at ``batch`` lanes on ``dev`` with its injected noise."""
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((MAX_STEPS, 4)), np.zeros((MAX_STEPS, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0, device=dev),
        batch, noise_on=True, device=dev)
    kw = dict(num_laps=LAPS, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
              noise=headline_noise(batch, dev))
    if which == "i2lqr":
        params, limits = IlqrParams.make(device=dev), SystemLimits.make(
            device=dev)
        kernel = batched_soa.default_step_solver(
            params, limits, 1.0, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
            max_iter=CAP)
        return (batched_soa.simulate_learning_runs_soa,
                simulate_learning_runs_soa_sharded,
                (params, limits, scen, seed_xs, None, 121, 1.0),
                dict(kw, solver_max_iter=CAP), kernel)
    # the NLMPC solve clips at the raw delta_max: its limits in f64
    params = LmpcParams.make(device=dev)
    limits = SystemLimits.make(dtype=torch.float64, device=dev)
    kernel = batched_nlmpc_soa.default_step_solver(
        params, limits, 1.0, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
        max_iters=NL_CAP)
    return (batched_nlmpc_soa.simulate_nlmpc_runs_soa,
            simulate_nlmpc_runs_soa_sharded,
            (params, limits, scen, seed_xs, seed_us, 121, 1.0),
            dict(kw, max_lm_iters=NL_CAP, infeasible_retire=NL_RETIRE),
            kernel)


def headline(which: str, batch: int, dev, mesh=None, **opts) -> dict:
    """The headline ``which`` at ``batch`` lanes, unsharded or (``mesh``)
    through its ``_sharded`` wrapper: the lap-records hash, the completion,
    this process's launches of the kernel (K1 or K2), the wall seconds
    (between barriers of the mesh, the card synchronized) and, sharded,
    the rank's simulator seconds and the gather's ms. ``opts``: the
    simulator's (``num_laps``, ``tail_shrink``); with ``tail_shrink``,
    whether each lap compacted (``compacted``, this rank's)."""
    sim, sharded, args, kw, kernel = headline_args(which, batch, dev)
    log = []
    kw.update(opts)
    if "tail_shrink" in opts:
        kw["perm_log"] = log
    stats = {}
    kernel.launches = 0
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda d: None
    if mesh is not None:
        mesh.barrier()
    sync(dev)
    t0 = time.perf_counter()
    with no_plain_solve_on_card():
        res = (sim(*args, **kw) if mesh is None
               else sharded(*args, mesh, stats=stats, **kw))
    sync(dev)
    if mesh is not None:
        mesh.barrier()
    out = dict(wall_s=time.perf_counter() - t0, launches=kernel.launches,
               hash=lap_records_hash(res),
               completion=float(res.lap_done.float().mean()), **stats)
    if log:
        out["compacted"] = [e["compacted"] for e in log]
    del res
    return out


def meshed_controller(mode: str, mesh, dev) -> dict:
    """NlmpcController(mesh=) in ``mode`` ("space" or "all": all_ss_point
    and all_ss_iter), f64, zero noise, the default obstacle, 2 learning
    laps on this rank: its laps, K4's launches and lanes a launch, the wall
    seconds and the median ms of a solving step."""
    from ilqr_iterative_tasks_torch.control.nlmpc import NlmpcController
    from ilqr_iterative_tasks_torch.experiments.runner import (
        default_obstacle, run_closed_loop)

    params = (LmpcParams.make(all_ss_point=True, all_ss_iter=True,
                              device=dev) if mode == "all"
              else LmpcParams.make(ss_option="spaceVarying", device=dev))
    ctrl = NlmpcController(params, obstacle=default_obstacle(1.0),
                           dtype=torch.float64, device=dev, mesh=mesh)
    t0 = time.perf_counter()
    with no_plain_solve_on_card():
        res = run_closed_loop(ctrl, lap_number=2, dt=1.0, goal_fixup=None)
    return dict(laps=res.all_lap_times, finished=list(res.lap_finished),
                wall_s=time.perf_counter() - t0,
                k4_launches=sum(k.launches for k in ctrl._k4.values()),
                solving_steps=len(ctrl.solve_seconds),
                lanes=[min(ctrl.launch_lanes), max(ctrl.launch_lanes)],
                lanes_total=sum(ctrl.launch_lanes),
                step_ms_median=float(np.median(ctrl.solve_seconds)) * 1e3)


def gather_probe(mesh, reps: int = 50) -> dict:
    """Milliseconds an ``all_gather`` of a small (8, 6) f64 tensor takes
    over ``mesh`` (the meshed controller's gathers are this small), on the
    rank's device and, where the backend takes them, on the host: the
    mean of ``reps`` after a warm one, between barriers."""
    out = {}
    places = [mesh.device]
    if torch.distributed.get_backend() == "gloo" and mesh.device.type != "cpu":
        places.append(torch.device("cpu"))
    for where in places:
        t = torch.zeros((8, 6), dtype=torch.float64, device=where)
        mesh.all_gather(t)
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            mesh.all_gather(t)
        if where.type == "cuda":
            torch.cuda.synchronize(where)
        out[where.type] = (time.perf_counter() - t0) / reps * 1e3
    return out


def scale_out_rank(batch: int, modes=(), tails=()) -> dict:
    """One rank of phase 32: the i2LQR and NLMPC headlines at ``batch``
    lanes through the ``_sharded`` wrappers over the global scenario mesh,
    the i2LQR headline at TAIL_BATCH lanes over TAIL_LAPS laps with
    ``tail_shrink`` alone at each of ``tails`` (``i2lqr_tail{P}``), then
    the meshed controller in each of ``modes`` over a mesh of every rank
    (axis "history") and ``gather_probe``; every rank returns its
    figures."""
    from ilqr_iterative_tasks_torch.parallel.distributed import (
        global_scenario_mesh)
    from ilqr_iterative_tasks_torch.parallel.mesh import make_mesh

    mesh = global_scenario_mesh()
    dev = mesh.device
    out = dict(rank=mesh.rank, device=str(dev),
               backend=torch.distributed.get_backend())
    for which in ("i2lqr", "nlmpc"):
        out[which] = headline(which, batch, dev, mesh)
    for tail in tails:
        out[f"i2lqr_tail{tail}"] = headline(
            "i2lqr", TAIL_BATCH, dev, mesh, num_laps=TAIL_LAPS,
            tail_shrink=tail)
    history = make_mesh(axis_name="history")
    for mode in modes:
        out[f"controller_{mode}"] = meshed_controller(mode, history, dev)
    out["gather_probe_ms"] = gather_probe(history)
    return out
