"""Lane-lap records of an NLMPC headline configuration on one device, from
noise draws that numpy makes from seed 0, so that two devices (the card
and the CPU port) can be compared lane-lap by lane-lap on identical draws.

The configuration is the JAX bench's NLMPC tier (bench.py:109-132, 207-221):
seed lap + 3 learning laps, f32, plant noise on, max_steps 128, max_laps 8,
k 8, nsi 1, horizon 6, obstacle (31, -2, 8, 6), LM cap 12,
``infeasible_retire`` 8, in the safe-set mode ``--mode``. On the card the
simulator launches its own K2 (``default_step_solver``); on the CPU it runs
the plain step.

    python -m ilqr_iterative_tasks_torch.experiments.nlmpc_lane_laps \\
        --mode timeVarying --batch 1024 --device cpu --out cpu.npz
    python -m ilqr_iterative_tasks_torch.experiments.nlmpc_lane_laps \\
        --compare card.npz cpu.npz
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import (
    simulate_nlmpc_runs_soa)
from ilqr_iterative_tasks_torch.control.batched_soa import SoaScenarios
from ilqr_iterative_tasks_torch.experiments.generic_bench import card_line
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.device import resolve
from ilqr_iterative_tasks_torch.utils.params import LmpcParams, SystemLimits

LAPS, MAX_STEPS, MAX_LAPS, CAP, RETIRE, BUDGET = 3, 128, 8, 12, 8, 121
MODES = {"spaceVarying": {}, "timeVarying": dict(ss_option="timeVarying"),
         "all": dict(all_ss_point=True)}


def run(mode: str, batch: int, device=None) -> dict:
    """One run; returns its lap records, completion and device."""
    dev = resolve(device)
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((MAX_STEPS, 4)), np.zeros((MAX_STEPS, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    scen = SoaScenarios.broadcast(np.zeros(4), xcl[-1],
                                  Obstacle.make(31.0, -2.0, 8.0, 6.0,
                                                device=dev),
                                  batch, noise_on=True, device=dev)
    noise = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (LAPS * BUDGET, 2, batch)).astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    res = simulate_nlmpc_runs_soa(
        LmpcParams.make(device=dev, **MODES[mode]),
        SystemLimits.make(dtype=torch.float64, device=dev), scen, seed_xs,
        seed_us, 121, 1.0, num_laps=LAPS, max_steps=MAX_STEPS,
        max_laps=MAX_LAPS, max_lm_iters=CAP, infeasible_retire=RETIRE,
        noise=noise)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    done = res.lap_done.cpu().numpy()
    return dict(mode=mode, batch=batch, device=card_line(dev),
                seconds=time.perf_counter() - t0,
                lap_steps=res.lap_steps.cpu().numpy(), lap_done=done,
                completion=float(done.mean()))


def compare(a: dict, b: dict) -> dict:
    """Completions of two runs on the same draws, their standard errors,
    and the lane-laps on which they differ, each way."""
    da, db = a["lap_done"].astype(bool), b["lap_done"].astype(bool)
    n = da.size
    se = lambda p: (p * (1 - p) / n) ** 0.5
    return dict(devices=[str(a["device"]), str(b["device"])],
                lane_laps=n, completion=[float(da.mean()), float(db.mean())],
                standard_error=[se(da.mean()), se(db.mean())],
                only_first_done=int((da & ~db).sum()),
                only_second_done=int((db & ~da).sum()),
                equal_lap_steps=int((a["lap_steps"] == b["lap_steps"]).sum()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=sorted(MODES), default="timeVarying")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", help="write the run's records to this .npz")
    ap.add_argument("--compare", nargs=2, metavar="NPZ",
                    help="compare two runs' records instead of running")
    args = ap.parse_args()
    if args.compare:
        a, b = (dict(np.load(p)) for p in args.compare)
        print(json.dumps(compare(a, b)))
        return
    r = run(args.mode, args.batch, args.device)
    if args.out:
        np.savez(args.out, **r)
    print(json.dumps({k: v for k, v in r.items()
                      if k not in ("lap_steps", "lap_done")}))


if __name__ == "__main__":
    main()
