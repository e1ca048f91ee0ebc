"""Where the time of an NLMPC headline run goes on the card: one warm run,
five timed runs back to back, then one run under ``torch.profiler``,
printed as one JSON line with the card's name and power limit.

The run is ``chip_smoke.py``'s headline of the safe-set mode ``--mode``
(bench.py:109-132, 207-221): seed lap + 3 learning laps, f32, plant noise
on, LM cap 12, ``infeasible_retire`` 8, B = 49 152 (8 192 for all), the
simulator's own K2 (``default_step_solver``). Reported: the timed runs'
host seconds, lap-sims/s and K2 device seconds (CUDA events around each
launch, in the same runs); of the profiled run, its host seconds, the
device time summed over kernels, K2's share and launches, the other
kernels' time by name (the five largest), the device's idle share of
that run's host time, and the peak device memory.

    python -m ilqr_iterative_tasks_torch.experiments.nlmpc_profile \\
        --mode timeVarying
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ilqr_iterative_tasks_torch.control import batched_nlmpc_soa
from ilqr_iterative_tasks_torch.control.batched_soa import SoaScenarios
from ilqr_iterative_tasks_torch.experiments.generic_bench import card_line
from ilqr_iterative_tasks_torch.experiments.headlines import K2_ATTRS
from ilqr_iterative_tasks_torch.experiments.nlmpc_lane_laps import (
    CAP, LAPS, MAX_LAPS, MAX_STEPS, MODES, RETIRE)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import LmpcParams, SystemLimits


RUNS = 5  # timed runs before the profiled one


class EventTimed:
    """A step solver that records a pair of CUDA events around each call
    of ``k2``; ``seconds()`` sums their spans (the simulator reads only
    the attributes ``attrs``: K2_ATTRS of a step solver, or a candidate
    solver's, e.g. K3's ``max_iter`` and ``with_skip``)."""

    def __init__(self, k2, attrs=K2_ATTRS):
        self.k2 = k2
        for a in attrs:
            setattr(self, a, getattr(k2, a))
        self.events = []

    def __call__(self, *args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self.k2(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out

    def seconds(self):
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events) / 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=sorted(MODES), default="spaceVarying")
    args = ap.parse_args()
    dev = torch.device("cuda", torch.cuda.current_device())
    b = 8192 if args.mode == "all" else 49152
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((MAX_STEPS, 4)), np.zeros((MAX_STEPS, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    scen = SoaScenarios.broadcast(np.zeros(4), xcl[-1],
                                  Obstacle.make(31.0, -2.0, 8.0, 6.0,
                                                device=dev),
                                  b, noise_on=True, device=dev)
    params = LmpcParams.make(device=dev, **MODES[args.mode])
    limits = SystemLimits.make(dtype=torch.float64, device=dev)
    k2 = batched_nlmpc_soa.default_step_solver(
        params, limits, 1.0, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
        max_iters=CAP)

    def run(seed, solver=None):
        g = torch.Generator(device=dev).manual_seed(seed)
        batched_nlmpc_soa.simulate_nlmpc_runs_soa(
            params, limits, scen, seed_xs, seed_us, 121, 1.0,
            num_laps=LAPS, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
            max_lm_iters=CAP, infeasible_retire=RETIRE, generator=g,
            step_solver=solver)
        torch.cuda.synchronize(dev)

    run(0)  # warm
    runs_s, runs_k2_s = [], []
    for seed in range(1, RUNS + 1):
        timed = EventTimed(k2)
        t0 = time.perf_counter()
        run(seed, timed)
        runs_s.append(time.perf_counter() - t0)
        runs_k2_s.append(timed.seconds())
    torch.cuda.reset_peak_memory_stats(dev)
    before = k2.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(RUNS + 1)
        host_s = time.perf_counter() - t0
    by_name = {}  # device-side events only: kernels, copies, fills
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        by_name[e.key] = (us / 1e6, e.count)
    k2_s = sum(v[0] for k, v in by_name.items() if "nlmpc_step" in k)
    device_s = sum(v[0] for v in by_name.values())
    others = sorted(((v[0], k, v[1]) for k, v in by_name.items()
                     if "nlmpc_step" not in k), reverse=True)[:5]
    print(json.dumps(dict(
        mode=args.mode, batch=b, card=card_line(dev), runs_s=runs_s,
        runs_lap_sims_per_s=[b * LAPS / t for t in runs_s],
        runs_k2_s=runs_k2_s, host_s=host_s,
        device_s=device_s, k2_s=k2_s, k2_launches=k2.launches - before,
        k2_share=k2_s / device_s if device_s else None,
        idle_share=1.0 - device_s / host_s,
        others=[dict(name=k[:60], s=s, calls=c) for s, k, c in others],
        peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)))


if __name__ == "__main__":
    main()
