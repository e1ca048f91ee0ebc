"""Round-4 measurement probes on the port's kernels (one card). Each
subcommand prints JSON lines, the last its whole record:

  python -m ilqr_iterative_tasks_torch.experiments.round4_probe stats
      K1 built with_stats (and dedup, qsort_skip) at B = 32 768: useful /
      executed / queue-floor trips a lane, the waste share, completion.
  python -m ilqr_iterative_tasks_torch.experiments.round4_probe reuse
      the i2LQR headline through K1 with and without reuse_extract.
  python -m ilqr_iterative_tasks_torch.experiments.round4_probe cap
      the i2LQR headline at LM caps 16, 15 and 14.
  python -m ilqr_iterative_tasks_torch.experiments.round4_probe stall
      the i2LQR headline with stall_reseed None and 3.
  python -m ilqr_iterative_tasks_torch.experiments.round4_probe canary
      the robustness sweep (B = 4 096, 4 laps, moving obstacle, k 8 /
      nsi 1) at stall_reseed None, 3 and 5.
  python -m ilqr_iterative_tasks_torch.experiments.round4_probe \\
      nlmpc_modes [timeVarying] [all] [all_ss_iter]
      the NLMPC learning runs through K2 in its other modes (B = 8 192).

Port of ilqr_iterative_tasks_tpu/experiments/round4_probe.py: the same
subcommands, positional arguments and JSON keys, the runs of
``headlines.Headlines`` (seed lap, obstacle (31, -2, 8, 6), plant noise
on, f32, max_steps 128, max_laps 8, 3 learning laps), each inside
``headlines.no_plain_solve_on_card``. Beside JAX's keys a record names the
device and the card (``card``: nvidia-smi's name and power limit), each
K1's schedule (``schedule``: the lane queue or the plain order, by
``FusedI2lqrStep.lane_queue_runs``; "plain step" on the CPU) and the
kernel's launches in the record's last run. Timing: a warm run (seed 0;
its seconds are ``compile_s``, the kernels' build included where it runs
first), then ``--reps`` timed runs (seeds 1, 2, ...) on the host clock,
each ended by ``torch.cuda.synchronize()``; the best is the rate's
(``--reps 0`` times the warm run). ``tile_rows`` (the TPU kernel's tile)
and the K2 options ``store_solutions`` / ``stream_safe_set`` (VMEM trades
of the TPU kernel) have no counterpart: the records that JAX builds with
them say so (``not_ported``).

Options beside JAX's arguments, for runs at a small size: ``--device
cpu`` (the kernels' plain versions; without it the card, and an error
where there is none), ``--batch B`` (every run's lanes), ``--laps L``
(learning laps), ``--cap C`` (the LM cap; the cap ladder C, C-1, C-2),
``--budget S`` (a lap's step budget; 121) and ``--reps R`` (timed runs;
2).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass, field

import torch

from ilqr_iterative_tasks_torch.control import batched_soa
from ilqr_iterative_tasks_torch.experiments.headlines import (
    CAP, LAPS, MAX_LAPS, MAX_STEPS, NL_CAP, Headlines, no_plain_solve_on_card,
    stats_summary)
from ilqr_iterative_tasks_torch.ops.i2lqr_step import build_fused_i2lqr_step
from ilqr_iterative_tasks_torch.ops.nlmpc_step import build_fused_nlmpc_step
from ilqr_iterative_tasks_torch.utils.device import resolve
from ilqr_iterative_tasks_torch.utils.params import LmpcParams

HEADLINE_BATCH, STATS_BATCH, NLMPC_MODES_BATCH = 49152, 32768, 8192
CANARY_BATCH, CANARY_LAPS = 4096, 4
# the K2 options of JAX's probes that are VMEM trades of the TPU kernel
NOT_PORTED = ["store_solutions", "stream_safe_set"]


@dataclass
class Probe:
    """A probe's device, its size options and positional arguments, and
    the JSON records it printed (``lines``)."""

    device: torch.device
    args: list
    batch: int | None = None
    laps: int | None = None
    cap: int | None = None
    budget: int | None = None
    reps: int = 2
    lines: list = field(default_factory=list)

    def b(self, default: int) -> int:
        return self.batch or default

    def n_laps(self, default: int = LAPS) -> int:
        return self.laps or default

    def lm_cap(self, default: int) -> int:
        return self.cap or default

    def sim_kw(self) -> dict:
        """The simulators' step budget, where one was given."""
        return {} if self.budget is None else dict(
            sim_step_budget=self.budget)

    def emit(self, rec: dict) -> dict:
        print(json.dumps(rec), flush=True)
        self.lines.append(rec)
        return rec

    def card(self) -> dict:
        from ilqr_iterative_tasks_torch.experiments.generic_bench import (
            card_line)
        return dict(device=str(self.device), card=card_line(self.device))


def parse(argv) -> tuple[str, Probe]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cmd")
    ap.add_argument("args", nargs="*")
    ap.add_argument("--device", default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--laps", type=int, default=None)
    ap.add_argument("--cap", type=int, default=None)
    ap.add_argument("--budget", type=int, default=None)
    ap.add_argument("--reps", type=int, default=2)
    a = ap.parse_args(argv)
    return a.cmd, Probe(resolve(a.device), a.args, a.batch, a.laps, a.cap,
                        a.budget, a.reps)


def best_of(go, reps: int):
    """(the warm run's result, the best seconds of ``reps`` timed runs, or
    the warm run's where reps is 0, the warm run's seconds); ``go(seed)``
    ends in a synchronize."""
    t0 = time.perf_counter()
    res = go(0)
    first = time.perf_counter() - t0
    times = []
    for rep in range(1, reps + 1):
        t0 = time.perf_counter()
        go(rep)
        times.append(time.perf_counter() - t0)
    return res, min(times, default=first), first


def summary(res, batch: int, laps: int, best: float) -> dict:
    """JAX's ``_summ``: lap-sims/s, completion and each lap's mean steps."""
    return {"lap_sims_per_s": round(batch * laps / best, 1),
            "completion": round(float(res.lap_done.float().mean()), 4),
            "mean_lap_steps": [round(float(v), 2) for v in
                               res.lap_steps.double().mean(-1)]}


def schedule(kernel, lanes: int, dev) -> str:
    """What a K1 launch of ``lanes`` lanes runs."""
    if dev.type != "cuda":
        return "plain step"
    return ("lane queue" if kernel.lane_queue_runs(lanes)
            else "plain order")


def k1(hl: Headlines, cap: int, **opts):
    """The headline's K1 at LM cap ``cap`` with ``opts``."""
    return build_fused_i2lqr_step(
        hl.params, hl.limits, 1.0, num_horizon=hl.params.num_horizon,
        max_steps=MAX_STEPS, max_laps=MAX_LAPS, max_iter=cap, **opts)


def k2(lp: LmpcParams, limits, cap: int, **opts):
    """The NLMPC K2 of ``lp`` at LM cap ``cap`` with ``opts``."""
    return build_fused_nlmpc_step(
        lp, limits, 1.0, num_horizon=lp.num_horizon, max_steps=MAX_STEPS,
        max_laps=MAX_LAPS, max_iters=cap, **opts)


def i2lqr_arm(p: Probe, hl: Headlines, solver, cap: int, **opts):
    """The i2LQR headline through ``solver`` at cap ``cap``: (the warm
    run's result, best seconds, warm seconds, launches in the last run)."""
    laps = p.n_laps()

    def go(seed):
        solver.launches = 0
        return hl.i2lqr(seed, solver, num_laps=laps, cap=cap,
                        **p.sim_kw(), **opts)
    res, best, first = best_of(go, p.reps)
    return res, best, first, solver.launches


def cmd_stats(p: Probe) -> dict:
    batch, cap = p.b(STATS_BATCH), p.lm_cap(CAP)
    hl = Headlines(p.device, batch=batch, all_batch=1)
    solver = k1(hl, cap, dedup=True, qsort_skip=True, with_stats=True)
    res, best, first, launches = i2lqr_arm(p, hl, solver, cap)
    s = stats_summary(res.iter_stats)
    useful, execd, floor = (t.double() for t in res.iter_stats)
    return p.emit({
        "probe": "with_stats_at_qsort_point", "batch": batch,
        "lap_sims_per_s": round(batch * p.n_laps() / best, 1),
        "useful_per_lane": round(float(useful.mean()), 1),
        "executed_per_lane": round(float(execd.mean()), 1),
        "straggler_waste": round(s["waste"], 4),
        "queue_floor_per_lane": round(float(floor.mean()), 1),
        "completion": round(float(res.lap_done.float().mean()), 4),
        "compile_s": round(first, 1),
        "floor_width": solver.floor_width,
        "schedule": schedule(solver, batch, p.device),
        "launches": launches, "not_ported": ["tile_rows"], **p.card()})


def cmd_reuse(p: Probe) -> dict:
    batch, cap = p.b(HEADLINE_BATCH), p.lm_cap(CAP)
    hl = Headlines(p.device, batch=batch, all_batch=1)
    out = {}
    for tag, kw in (("base", dict(dedup=True, qsort_skip=True)),
                    ("reuse", dict(dedup=True, qsort_skip=True,
                                   reuse_extract=True))):
        solver = k1(hl, cap, **kw)
        res, best, first, launches = i2lqr_arm(p, hl, solver, cap)
        out[tag] = {**summary(res, batch, p.n_laps(), best),
                    "compile_s": round(first, 1),
                    "schedule": schedule(solver, batch, p.device),
                    "launches": launches}
    out["probe"] = "reuse_extract_ab"
    out["batch"] = batch
    out["speedup"] = round(out["reuse"]["lap_sims_per_s"]
                           / out["base"]["lap_sims_per_s"], 3)
    return p.emit({**out, **p.card()})


def cmd_cap(p: Probe) -> dict:
    batch, top = p.b(HEADLINE_BATCH), p.lm_cap(CAP)
    hl = Headlines(p.device, batch=batch, all_batch=1)
    out = {"probe": "i2lqr_cap_ladder", "batch": batch}
    for cap in (top, top - 1, top - 2):
        solver = k1(hl, cap, dedup=True, qsort_skip=True)
        res, best, _, launches = i2lqr_arm(p, hl, solver, cap)
        out[f"cap{cap}"] = {**summary(res, batch, p.n_laps(), best),
                            "schedule": schedule(solver, batch, p.device),
                            "launches": launches}
    return p.emit({**out, **p.card()})


def cmd_stall(p: Probe) -> dict:
    """JAX builds both arms' K1 with dedup and qsort_skip; the port's
    reseeded run takes the simulator's own K1 for ``stall_reseed``, the
    plain order at every batch (``batched_soa.default_step_solver``)."""
    batch, cap = p.b(HEADLINE_BATCH), p.lm_cap(CAP)
    hl = Headlines(p.device, batch=batch, all_batch=1)
    out = {"probe": "i2lqr_stall_reseed_headline", "batch": batch}
    for tag, sr in (("base", None), ("sr3", 3)):
        solver = batched_soa.default_step_solver(
            hl.params, hl.limits, 1.0, max_steps=MAX_STEPS,
            max_laps=MAX_LAPS, max_iter=cap, reseeded=sr is not None)
        res, best, _, launches = i2lqr_arm(p, hl, solver, cap,
                                           stall_reseed=sr)
        out[tag] = {**summary(res, batch, p.n_laps(), best),
                    "schedule": schedule(solver, batch, p.device),
                    "launches": launches}
    return p.emit({**out, **p.card()})


def cmd_canary(p: Probe) -> dict:
    from ilqr_iterative_tasks_torch.experiments.scenario_sweep import (
        MAX_LAPS as S_LAPS, MAX_STEPS as S_STEPS, run_sweep)
    from ilqr_iterative_tasks_torch.utils.params import (
        IlqrParams, SystemLimits)
    batch, cap = p.b(CANARY_BATCH), p.lm_cap(CAP)
    rows = {}
    for sr in (None, 3, 5):
        # the K1 the sweep's simulator takes (its cache's), to count
        solver = batched_soa.default_step_solver(
            IlqrParams.make(num_ss_points=8, num_ss_iter=1,
                            device=p.device),
            SystemLimits.make(device=p.device), 1.0, max_steps=S_STEPS,
            max_laps=S_LAPS, max_iter=cap, reseeded=sr is not None)
        solver.launches = 0
        with no_plain_solve_on_card():
            r = run_sweep(batch, p.n_laps(CANARY_LAPS), moving=True,
                          num_ss_points=8, num_ss_iter=1, stall_reseed=sr,
                          solver_max_iter=cap, quiet=True, device=p.device,
                          **p.sim_kw())
        rows[str(sr)] = {"completion": r["completion_rate"],
                         "final_lap_mean": r["final_lap_mean"],
                         "schedule": schedule(solver, batch, p.device),
                         "launches": solver.launches}
    return p.emit({"probe": "stall_reseed_canary", **rows, "batch": batch,
                   **p.card()})


NLMPC_MODES = {"timeVarying": dict(ss_option="timeVarying"),
               "all": dict(all_ss_point=True),
               "all_ss_iter": dict(all_ss_point=True, all_ss_iter=True)}


def cmd_nlmpc_modes(p: Probe) -> dict:
    """JAX's runs: no ``infeasible_retire``, LM cap 12, K2 in each mode
    (the port's K2 takes the mode from the params)."""
    batch, cap = p.b(NLMPC_MODES_BATCH), p.lm_cap(NL_CAP)
    hl = Headlines(p.device, batch=batch, all_batch=1)
    sel = p.args  # an optional tag filter, e.g. "all all_ss_iter"
    out = {"probe": "nlmpc_step_kernel_modes", "batch": batch}
    for tag, pkw in NLMPC_MODES.items():
        if sel and tag not in sel:
            continue
        lp = LmpcParams.make(device=p.device, **pkw)
        solver = k2(lp, hl.nl_limits, cap)

        def go(seed):
            solver.launches = 0
            return hl.nlmpc(seed, lp, hl.scen, solver, num_laps=p.n_laps(),
                            cap=cap, retire=None, **p.sim_kw())
        res, best, first = best_of(go, p.reps)
        out[tag] = {**summary(res, batch, p.n_laps(), best),
                    "compile_s": round(first, 1),
                    "launches": solver.launches}
        p.emit({tag: out[tag]})
    return p.emit({**out, "not_ported": NOT_PORTED, **p.card()})


COMMANDS = {"stats": cmd_stats, "reuse": cmd_reuse, "canary": cmd_canary,
            "nlmpc_modes": cmd_nlmpc_modes, "cap": cmd_cap,
            "stall": cmd_stall}


def main(argv=None, commands=COMMANDS) -> Probe:
    cmd, p = parse(sys.argv[1:] if argv is None else argv)
    commands[cmd](p)
    return p


if __name__ == "__main__":
    main()
