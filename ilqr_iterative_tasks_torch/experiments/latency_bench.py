"""Latency and scaling benchmark CLI of the host tier and the kernels.

Port of ilqr_iterative_tasks_tpu/experiments/latency_bench.py. Reports
(one JSON object):
- ``per_step_latency`` / ``per_step_latency_nlmpc``: the host
  controllers' per-step ``calc_input`` latency percentiles (the plant's
  wall time of every step, replay steps included; utils/metrics.py) over
  3 laps in f32 with the default obstacle; on the card their candidate
  solves are K3 (i2LQR) and K4 (NLMPC) launches;
- ``device_fused_step_latency`` (on the card only): one whole i2LQR step
  through K1 (k = 8, LM cap 16) at a batch of 1024 lanes against the seed
  lap's safe set, blocking round trip and per step of a chain of
  ``pipeline_depth`` launches;
- ``soa_solves_per_s``: K3 candidate solves a second across batch sizes
  (its plain version on the CPU);
- ``lap_sims_per_s_by_devices``: the batched i2LQR learning run a device
  count n, sharded over n ranks (parallel/sharded_soa.py, through K1 on
  the card; NCCL, one card a rank, so counts above the visible cards are
  skipped; gloo on the CPU).

Each bench function, and ``main``, takes an optional ``launches`` dict
into which it writes, under the report key it measures, the kernel
launches of its run (and the solving steps of the per-step runs): what a
caller needs to hold the run to its kernels.

Run:  python -m ilqr_iterative_tasks_torch.experiments.latency_bench \\
          [--device cpu] [--batches 2048,32768] [--devices 1]
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from ilqr_iterative_tasks_torch.parallel.launch import spawn
from ilqr_iterative_tasks_torch.utils.device import resolve

MAX_STEPS, MAX_LAPS = 128, 8
K1_MAX_ITER = 16  # the JAX bench's K1 LM cap
K1_NOTE = ("K1 at k = 8 in the plain candidate order: the JAX bench's "
           "dedup=True is bitwise-neutral, and the port's K1 runs its "
           "options only on a batch that fills the card at one thread a "
           "lane, which these do not")


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_step_latency(device=None, launches=None):
    """The i2LQR host controller (f32, CI obstacle, goal appended), 3
    laps: ``summary_dict`` of the run."""
    from ilqr_iterative_tasks_torch.control.i2lqr import I2LqrController
    from ilqr_iterative_tasks_torch.experiments.runner import (
        default_obstacle, run_closed_loop)
    from ilqr_iterative_tasks_torch.utils import metrics
    from ilqr_iterative_tasks_torch.utils.params import IlqrParams

    ctrl = I2LqrController(IlqrParams.make(device=device),
                           obstacle=default_obstacle(1.0), device=device)
    res = run_closed_loop(ctrl, lap_number=3, dt=1.0, goal_fixup="append")
    if launches is not None:
        launches["per_step_latency"] = dict(
            k3=sum(k.launches for k in ctrl._k3.values()),
            solving_steps=len(ctrl.solve_seconds))
    return metrics.summary_dict(res)


def bench_step_latency_nlmpc(device=None, launches=None):
    """The NLMPC host controller (f32, spaceVarying, CI obstacle), 3 laps:
    ``summary_dict`` of the run."""
    from ilqr_iterative_tasks_torch.control.nlmpc import NlmpcController
    from ilqr_iterative_tasks_torch.experiments.runner import (
        default_obstacle, run_closed_loop)
    from ilqr_iterative_tasks_torch.utils import metrics
    from ilqr_iterative_tasks_torch.utils.params import LmpcParams

    ctrl = NlmpcController(
        LmpcParams.make(ss_option="spaceVarying", device=device),
        obstacle=default_obstacle(1.0), device=device)
    res = run_closed_loop(ctrl, lap_number=3, dt=1.0)
    if launches is not None:
        launches["per_step_latency_nlmpc"] = dict(
            k4=sum(k.launches for k in ctrl._k4.values()),
            solving_steps=len(ctrl.solve_seconds))
    return metrics.summary_dict(res)


def solver_throughput_inputs(bsz: int, rng, device=None):
    """K3's lanes of one ``bench_solver_throughput`` batch: from the
    origin to terminal states uniform in [0, 30)^4, zero initial inputs,
    the CI obstacle (f32)."""
    from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
    from ilqr_iterative_tasks_torch.ops.fused_ilqr import obstacle_to_lanes

    f32 = torch.float32
    device = resolve(device)
    obstacle = Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=f32, device=device)
    xts = torch.tensor(rng.uniform(0, 30, (4, bsz)), dtype=f32, device=device)
    return (torch.zeros((4, bsz), dtype=f32, device=device), xts,
            torch.zeros((6, 2, bsz), dtype=f32, device=device),
            obstacle_to_lanes(obstacle, bsz).contiguous())


def build_throughput_solver(device=None):
    """The K3 that ``bench_solver_throughput`` launches: N = 6 at the
    params' LM cap (the JAX call's ``ilqr_solve_soa`` default)."""
    from ilqr_iterative_tasks_torch.ops.fused_ilqr import build_fused_ilqr
    from ilqr_iterative_tasks_torch.utils.params import (IlqrParams,
                                                         SystemLimits)

    params = IlqrParams.make(device=device)
    limits = SystemLimits.make(device=device)
    return build_fused_ilqr(params, limits, 1.0, num_horizon=6,
                            max_iter=params.max_ilqr_iter)


def bench_solver_throughput(batches, device=None, launches=None):
    """Candidate solves a second through K3 (its plain version on the
    CPU), best of 3 calls after a warm one, per batch size."""
    dev = resolve(device)
    k3 = build_throughput_solver(dev)
    rng = np.random.default_rng(0)
    out, counts = {}, {}
    for bsz in batches:
        args = solver_throughput_inputs(bsz, rng, dev)
        before = k3.launches

        def run():
            k3(*args)
            _sync(dev)

        run()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        out[str(bsz)] = round(bsz / min(times), 1)
        counts[str(bsz)] = k3.launches - before
    if launches is not None:
        launches["soa_solves_per_s"] = counts
    return out


def device_step_inputs(batch: int, device=None):
    """(K1, its inputs) of ``bench_device_step_latency``: k = 8, one stored
    lap (the seed lap, 121 states, Qfun 120 down to 0), every lane at the
    origin with pass-0 guess the origin, the CI obstacle, f32."""
    from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
    from ilqr_iterative_tasks_torch.ops.fused_ilqr import obstacle_to_lanes
    from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
        build_fused_i2lqr_step)
    from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
    from ilqr_iterative_tasks_torch.utils.params import (IlqrParams,
                                                         SystemLimits)

    dev = resolve(device)
    f32 = torch.float32
    params = IlqrParams.make(device=dev)
    limits = SystemLimits.make(device=dev)
    xcl, _ = seed_trajectory(1.0)
    states = torch.zeros((MAX_LAPS, MAX_STEPS, 4, batch), dtype=f32,
                         device=dev)
    states[0, :len(xcl)] = torch.tensor(xcl, dtype=f32, device=dev)[:, :, None]
    qfun = torch.zeros((MAX_LAPS, MAX_STEPS, batch), dtype=f32, device=dev)
    qfun[0] = torch.clamp(120.0 - torch.arange(MAX_STEPS, dtype=f32,
                                               device=dev), min=0.0)[:, None]
    lap_len = torch.zeros((MAX_LAPS, batch), dtype=torch.int32, device=dev)
    lap_len[0] = len(xcl)
    obs = obstacle_to_lanes(Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=f32,
                                          device=dev), batch).contiguous()
    x = torch.zeros((4, batch), dtype=f32, device=dev)
    skip = torch.zeros((batch,), dtype=torch.float32, device=dev)
    lap_ids = torch.zeros((1,), dtype=torch.int32, device=dev)
    lap_ok = torch.ones((1,), dtype=torch.int32, device=dev)
    solver = build_fused_i2lqr_step(
        params, limits, 1.0, num_horizon=params.num_horizon,
        max_steps=MAX_STEPS, max_laps=MAX_LAPS, max_iter=K1_MAX_ITER)
    return solver, (x, x, states, qfun, lap_len, lap_ids, lap_ok, obs, skip)


def _pctile(sorted_ms, q):
    """Nearest-rank percentile of sorted samples."""
    return sorted_ms[min(len(sorted_ms) - 1,
                         max(0, math.ceil(q * len(sorted_ms)) - 1))]


def bench_device_step_latency(batch: int = 1024, reps: int = 30,
                              pipeline_depth: int = 10, device=None,
                              launches=None):
    """Latency of one whole-step K1 launch on the card: the blocking round
    trip (launch, synchronise) and the per-step time of a chain of
    ``pipeline_depth`` launches with one synchronise at its end. None on
    the CPU."""
    dev = resolve(device)
    if dev.type != "cuda":
        return None
    solver, args = device_step_inputs(batch, dev)

    def run():
        solver(*args)
        torch.cuda.synchronize(dev)

    run()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    amort = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(pipeline_depth):
            solver(*args)
        torch.cuda.synchronize(dev)
        amort.append((time.perf_counter() - t0) * 1e3 / pipeline_depth)
    amort.sort()
    if launches is not None:
        launches["device_fused_step_latency"] = solver.launches
    return {"batch": batch,
            "note": K1_NOTE,
            "p50_ms": round(_pctile(times, 0.5), 3),
            "p99_ms": round(_pctile(times, 0.99), 3),
            "p50_ms_per_step_pipelined": round(_pctile(amort, 0.5), 3),
            "p99_ms_per_step_pipelined": round(_pctile(amort, 0.99), 3),
            "budget_ms": 1000.0}


def scaling_rank(per_device: int, num_laps: int, sim_step_budget: int,
                 device_type: str) -> dict:
    """One rank of ``bench_device_scaling``: the batched i2LQR learning run
    (LM cap 40, plant noise on, f32) over the global scenario mesh, each
    rank ``per_device`` lanes of it (``_shardmap``: each shard its own
    noise stream, the result gathered at the end). A warm run, then a timed
    one between barriers (the card synchronized): its seconds and the K1
    launches of this rank (0 on the CPU). A plain candidate solve on the
    card raises (``headlines.no_plain_solve_on_card``)."""
    from ilqr_iterative_tasks_torch.control.batched_soa import (
        SoaScenarios, default_step_solver)
    from ilqr_iterative_tasks_torch.experiments.headlines import (
        no_plain_solve_on_card)
    from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
    from ilqr_iterative_tasks_torch.parallel.distributed import (
        global_scenario_mesh)
    from ilqr_iterative_tasks_torch.parallel.sharded_soa import (
        simulate_learning_runs_soa_shardmap)
    from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
    from ilqr_iterative_tasks_torch.utils.params import (IlqrParams,
                                                         SystemLimits)

    mesh = global_scenario_mesh()
    dev = mesh.device if device_type == "cuda" else torch.device("cpu")
    on_card = dev.type == "cuda"
    f32 = torch.float32
    params = IlqrParams.make(device=dev)
    limits = SystemLimits.make(device=dev)
    xcl, ucl = seed_trajectory(1.0)
    seed_xs = torch.zeros((MAX_STEPS, 4), dtype=f32, device=dev)
    seed_xs[:len(xcl)] = torch.tensor(xcl, dtype=f32, device=dev)
    seed_us = torch.zeros((MAX_STEPS, 2), dtype=f32, device=dev)
    seed_us[:len(ucl)] = torch.tensor(ucl, dtype=f32, device=dev)
    obstacle = Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=f32, device=dev)
    scs = SoaScenarios.broadcast(np.zeros(4), xcl[-1], obstacle,
                                 per_device * mesh.size, noise_on=True,
                                 dtype=f32, device=dev)

    def run(seed):
        with no_plain_solve_on_card():
            simulate_learning_runs_soa_shardmap(
                params, limits, scs, seed_xs, seed_us, len(xcl), 1.0, mesh,
                num_laps=num_laps, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                solver_max_iter=40, sim_step_budget=sim_step_budget,
                generator=torch.Generator(dev).manual_seed(seed))
        _sync(dev)

    # on the card the run launches the simulator's cached K1
    k1 = (default_step_solver(params, limits, 1.0, max_steps=MAX_STEPS,
                              max_laps=MAX_LAPS, max_iter=40)
          if on_card else None)
    before = k1.launches if on_card else 0
    run(0)
    mesh.barrier()
    t0 = time.perf_counter()
    run(1)
    mesh.barrier()
    return dict(seconds=time.perf_counter() - t0,
                k1_launches=k1.launches - before if on_card else 0)


def bench_device_scaling(device_counts, device=None, launches=None, *,
                         per_device=None, num_laps=2, sim_step_budget=121):
    """Lap-sims a second of the batched i2LQR learning run (``num_laps``
    laps, LM cap 40, plant noise on, f32) a device count n: n ranks, each
    with ``per_device`` lanes (256 a card, 8 on the CPU), started by
    parallel/launch.py (NCCL, one card a rank; gloo on the CPU, one thread
    a rank) and run through the scenario-sharded simulator. The rate is
    the global B x laps over rank 0's seconds of the timed run. Counts
    above the visible cards are skipped (on the CPU every count is there,
    as JAX makes that many CPU devices). ``launches`` gets the K1 launches
    of each count's runs, summed over its ranks."""
    from ilqr_iterative_tasks_torch.ops import _build

    dev = resolve(device)
    on_card = dev.type == "cuda"
    n_avail = torch.cuda.device_count() if on_card else max(device_counts)
    per_dev = per_device or (256 if on_card else 8)
    if on_card:
        _build.build()  # once, before the ranks load it
    out, counts = {}, {}
    for nd in device_counts:
        if nd > n_avail:
            continue
        got = spawn(f"{__name__}:scaling_rank", nd, per_dev, num_laps,
                    sim_step_budget, dev.type,
                    backend="nccl" if on_card else "gloo",
                    threads=None if on_card else 1, timeout=3600)
        out[str(nd)] = round(per_dev * nd * num_laps / got[0]["seconds"], 1)
        counts[str(nd)] = sum(g["k1_launches"] for g in got)
    if launches is not None:
        launches["lap_sims_per_s_by_devices"] = counts
    return out


def main(argv=None, launches=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="where the solves run (default: the current "
                             "CUDA device)")
    parser.add_argument("--batches", type=str, default="2048,32768")
    parser.add_argument("--devices", type=str, default="1")
    parser.add_argument("--skip-latency", action="store_true")
    args = parser.parse_args(argv)
    dev = resolve(args.device)
    report = {"backend": dev.type}
    if not args.skip_latency:
        report["per_step_latency"] = bench_step_latency(dev, launches)
        report["per_step_latency_nlmpc"] = bench_step_latency_nlmpc(
            dev, launches)
    step = bench_device_step_latency(device=dev,  # None on the CPU
                                     launches=launches)
    if step is not None:
        report["device_fused_step_latency"] = step
    report["soa_solves_per_s"] = bench_solver_throughput(
        [int(b) for b in args.batches.split(",")], dev, launches)
    report["lap_sims_per_s_by_devices"] = bench_device_scaling(
        [int(d) for d in args.devices.split(",")], dev, launches)
    print(json.dumps(report, indent=2, default=float))
    return report


if __name__ == "__main__":
    main()
