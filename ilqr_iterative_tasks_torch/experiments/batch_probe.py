"""Learning-run throughput against the scenario batch, for both SoA
simulators, on the port's own kernels.

    python -m ilqr_iterative_tasks_torch.experiments.batch_probe 16384 49152
    python -m ilqr_iterative_tasks_torch.experiments.batch_probe --nlmpc \\
        --ss-option time 8192
    python -m ilqr_iterative_tasks_torch.experiments.batch_probe --dedup 4096

Port of ilqr_iterative_tasks_tpu/experiments/batch_probe.py. Each batch
size runs the i2LQR (or, with ``--nlmpc``, NLMPC) headline scenario (seed
lap, obstacle (31, -2, 8, 6), plant noise on unless ``--nonoise``, f32)
twice, seeds 0 and 1: a warm run, then a timed one. It prints one JSON
line a batch: lap-sims/s = batch * laps / the timed run's seconds (host
clock, the run ended by ``torch.cuda.synchronize()`` on the card, as
experiments/headlines.py times), completion, each lap's mean steps, the
backend and the kernel's launches in the timed run. Backends: the
simulator's own whole-step kernel (K1 / K2, the default on the card);
``--candidate``, the per-candidate kernel (K3 / K4) under the plain step's
glue; ``--dedup``, K3 with ``dedup_passes`` (i2LQR), whose skipped solves
are counted; ``--stats``, the whole-step kernel built ``with_stats``,
whose trip counts are summarised. ``--device cpu`` runs the kernels' plain
versions. None of the JAX probe's TPU timing rules applies here.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import (
    default_options, simulate_nlmpc_runs_soa)
from ilqr_iterative_tasks_torch.control.batched_soa import (
    SoaScenarios, simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.fused_ilqr import build_fused_ilqr
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    build_fused_lm_shooting)
from ilqr_iterative_tasks_torch.ops.i2lqr_step import build_fused_i2lqr_step
from ilqr_iterative_tasks_torch.ops.nlmpc_step import build_fused_nlmpc_step
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.device import resolve
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, LmpcParams, SystemLimits)

MAX_STEPS, MAX_LAPS = 128, 8
SS_OPTIONS = {"space": "spaceVarying", "time": "timeVarying", "all": "all"}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(batch: int, *, nlmpc: bool = False, num_laps: int = 3,
        cap: int | None = None, noise_on: bool = True,
        candidate: bool = False, dedup: bool = False, stats: bool = False,
        ss_option: str = "spaceVarying", retire: int | None = None,
        device=None) -> dict:
    """One batch size: the warm and the timed run; returns the record."""
    dev = resolve(device)
    if dedup and nlmpc:
        raise ValueError("dedup_passes is the i2LQR simulator's option")
    cap = (60 if nlmpc else 40) if cap is None else cap
    xcl, ucl = seed_trajectory(1.0)
    seed_xs = np.zeros((MAX_STEPS, 4))
    seed_xs[:121] = xcl
    seed_us = np.zeros((MAX_STEPS, 2))
    seed_us[:120] = ucl
    scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0,
                                            device=dev),
        batch, noise_on=noise_on, device=dev)
    kw = dict(num_laps=num_laps, max_steps=MAX_STEPS, max_laps=MAX_LAPS)
    dedup_log = None
    if nlmpc:
        params = LmpcParams.make(ss_option=ss_option, device=dev)
        # the NLMPC solve clips at the raw delta_max: its limits in f64
        limits = SystemLimits.make(dtype=torch.float64, device=dev)
        kw.update(max_lm_iters=cap)
        if retire is not None:
            kw["infeasible_retire"] = retire
        if candidate:
            kernel = build_fused_lm_shooting(limits, 1.0, num_horizon=6,
                                             max_iters=cap)
            kw["candidate_solver"] = kernel
        else:
            kernel = build_fused_nlmpc_step(
                params, limits, 1.0, num_horizon=6, max_steps=MAX_STEPS,
                max_laps=MAX_LAPS, max_iters=cap, with_stats=stats,
                **default_options(params))
            kw["step_solver"] = kernel
        sim = lambda g: simulate_nlmpc_runs_soa(
            params, limits, scen, seed_xs, seed_us, 121, 1.0, generator=g,
            **kw)
    else:
        params, limits = IlqrParams.make(device=dev), SystemLimits.make(
            device=dev)
        kw.update(solver_max_iter=cap)
        if candidate or dedup:
            kernel = build_fused_ilqr(params, limits, 1.0, num_horizon=6,
                                      max_iter=cap)
            kw.update(candidate_solver=kernel, dedup_passes=dedup)
            dedup_log = [] if dedup else None
            kw["dedup_log"] = dedup_log
        else:
            # the pair the simulator's own K1 takes (batched_soa.py
            # default_step_solver)
            kernel = build_fused_i2lqr_step(
                params, limits, 1.0, num_horizon=6, max_steps=MAX_STEPS,
                max_laps=MAX_LAPS, max_iter=cap, dedup=True,
                qsort_skip=True, with_stats=stats)
            kw["step_solver"] = kernel
        sim = lambda g: simulate_learning_runs_soa(
            params, limits, scen, seed_xs, None, 121, 1.0, generator=g,
            **kw)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    sim(gen(0))
    _sync(dev)
    warm_s = time.perf_counter() - t0
    if dedup_log is not None:
        dedup_log.clear()
    kernel.launches = 0
    t0 = time.perf_counter()
    out = sim(gen(1))
    _sync(dev)
    secs = time.perf_counter() - t0
    rec = dict(
        controller="nlmpc" if nlmpc else "i2lqr", batch=batch, cap=cap,
        backend=("candidate" if candidate or dedup else "step"),
        kernel=type(kernel).__name__, dedup=dedup,
        ss_option=ss_option if nlmpc else None, retire=retire,
        device=str(dev), lap_sims_per_s=batch * num_laps / secs,
        seconds=secs, warm_s=warm_s, launches=kernel.launches,
        completion=float(out.lap_done.float().mean()),
        mean_lap_steps=[float(v) for v in out.lap_steps.float().mean(dim=1)])
    if dedup_log is not None:
        rec["dedup_skipped_solves"] = int(sum(int(c) for c in dedup_log))
    if stats and out.iter_stats:
        useful, executed = (float(t.double().sum())
                            for t in out.iter_stats[:2])
        rec.update(useful_per_lane=useful / batch,
                   executed_per_lane=executed / batch,
                   straggler_waste=1.0 - useful / max(executed, 1.0))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="*", type=int)
    ap.add_argument("--nlmpc", action="store_true")
    ap.add_argument("--candidate", action="store_true",
                    help="the per-candidate kernel, K3 / K4")
    ap.add_argument("--dedup", action="store_true",
                    help="K3 with dedup_passes (i2LQR)")
    ap.add_argument("--stats", action="store_true")
    ap.add_argument("--nonoise", action="store_true")
    ap.add_argument("--ss-option", default="space", choices=SS_OPTIONS)
    ap.add_argument("--retire", type=int, default=None)
    ap.add_argument("--laps", type=int, default=3)
    ap.add_argument("--cap", type=int, default=None)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    for b in a.batch or ([8192] if a.nlmpc else [65536]):
        print(json.dumps(run(
            b, nlmpc=a.nlmpc, num_laps=a.laps, cap=a.cap,
            noise_on=not a.nonoise, candidate=a.candidate, dedup=a.dedup,
            stats=a.stats, ss_option=SS_OPTIONS[a.ss_option],
            retire=a.retire, device=a.device)), flush=True)


if __name__ == "__main__":
    main()
