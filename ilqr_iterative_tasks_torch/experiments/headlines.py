"""The headline runs of ``chip_smoke.py`` and what its card checks share
with ``experiments/kernel_ab.py``: the headlines' sizes, the runs
themselves (through the whole-step kernels K1 / K2 or, with a
``candidate_solver``, through the per-candidate path of K3 / K4), the step
solver that captures a kernel's inputs and its rule, the tap that captures
the plain step's inputs on the per-candidate path, the guard that no plain
candidate solve sees a CUDA tensor, CUDA-event timing and a hash of a run's
lap records.

The i2LQR headline is bench.py:44-62 (B = 49 152, seed lap + 3 learning
laps, f32, plant noise on, LM cap 16); the NLMPC headlines are
bench.py:109-148 and 207-221 (LM cap 12, ``infeasible_retire`` 8; the
`all` tier at B = 8 192); the robustness sweep is bench.py:250-270 (its
canary's three configurations at B = 4 096, 4 laps, moving obstacle).
Nothing touches the card at import.
"""

from __future__ import annotations

import contextlib
import hashlib

import numpy as np
import torch

from ilqr_iterative_tasks_torch.control import batched_soa
from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import (
    simulate_nlmpc_runs_soa)
from ilqr_iterative_tasks_torch.control.batched_soa import (
    SoaScenarios, simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits

BATCH, LAPS, MAX_STEPS, MAX_LAPS, CAP, N = 49152, 3, 128, 8, 16, 6
# (learning lap, control step within it) where K1's inputs are captured
CAPTURES = {1: 5, 2: 14, 3: 18}
NL_CAP = 12  # the NLMPC headline's LM cap (bench.py:131)
NL_RETIRE = 8  # infeasible_retire of the NLMPC headline (bench.py:132)
# (learning lap, control step) where K2's inputs are captured; lap 3 is
# taken at its first step with shrunk horizons on >= 1 % of active lanes
# and at least one active lane at horizon 1 (the reach check)
NL_CAPTURES = {1: 5, 2: 14, 3: None}
ALL_BATCH = 8192  # the all tier's batch (bench.py:218-221)
# the robustness canary (bench.py:250-270): batch, laps, LM cap and its
# (tag, k, nsi, stall_reseed) configurations
SWEEP_BATCH, SWEEP_LAPS, SWEEP_CAP = 4096, 4, 16
SWEEP_CONFIGS = (("k8_nsi1", 8, 1, None), ("k8_nsi1_sr3", 8, 1, 3),
                 ("k32_nsi4", 32, 4, None))
# (learning lap, control step) where the k32_nsi4 sweep's K1 inputs are
# captured: by lap 4 most lanes' stored laps are shorter than 32 rows
SWEEP_CAPTURES = {1: 5, 2: 14, 4: 10}
K1_ATTRS = ("k", "nsi", "num_horizon", "max_steps", "max_laps", "max_iter")
K2_ATTRS = ("k", "nsi", "num_horizon", "max_steps", "max_laps", "max_iters",
            "mode", "all_iter")


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps):
    """Mean milliseconds per call on the card's clock, after one warm call."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lap_records_hash(res) -> str:
    """16 hex digits of a sha256 over a run's lap records: lap steps, done
    flags, final states and the safe set, each float tensor by its bit
    patterns (summed over the stored rows, per lap and lane)."""
    h = hashlib.sha256()
    for t in (res.lap_steps, res.lap_done, res.final_x, *res.safe_set):
        t = t.contiguous()
        if t.is_floating_point():
            t = t.view(torch.int32 if t.element_size() == 4 else torch.int64)
        t = t.to(torch.int64)
        if t.dim() >= 3:
            t = t.sum(dim=1)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


class Capture:
    """Step solver that delegates to a whole-step kernel and keeps a copy of
    its inputs where ``want(lap, step, args)`` says so (the simulators only
    see the kernel's attributes). ``lap_arg`` is the position of lap_ids;
    ``all_iter``: lap_ids names every slot, and lap_ok the stored ones."""

    def __init__(self, kernel, attrs, lap_arg, want, all_iter=False):
        self.kernel = kernel
        for a in attrs:
            setattr(self, a, getattr(kernel, a))
        self.lap_arg, self.want, self.iter_rows = lap_arg, want, all_iter
        self.calls = {}
        self.captured = {}

    def __call__(self, *args):
        if self.iter_rows:  # laps stored - 1
            lap = int(args[self.lap_arg + 1].sum())
        else:
            lap = int(args[self.lap_arg][-1]) + 1  # lap_ids[-1] = laps stored - 1
        i = self.calls.get(lap, 0)
        self.calls[lap] = i + 1
        if lap not in self.captured and self.want(lap, i, args):
            self.captured[lap] = (i, [a.clone() for a in args])
        return self.kernel(*args)


@contextlib.contextmanager
def tap_step(module, name, lap_arg, want, all_iter=False):
    """Inside the block, the plain step ``module.name`` that a simulator
    calls (the per-candidate path: ``batched_soa.i2lqr_step_reference``,
    lap_ids at ``lap_arg`` 5, or ``batched_nlmpc_soa.nlmpc_step_reference``,
    6) runs through a Capture by the rule ``want``: it counts the steps a
    lap and keeps a copy of the inputs (without params, limits and dt)
    where ``want`` says so. Yields the Capture."""
    step = getattr(module, name)
    cap = Capture(None, (), lap_arg, want, all_iter=all_iter)

    def tapped(params, limits, dt, *args, **kw):
        cap.kernel = lambda *a: step(params, limits, dt, *a, **kw)
        return cap(*args)

    setattr(module, name, tapped)
    try:
        yield cap
    finally:
        setattr(module, name, step)


@contextlib.contextmanager
def no_plain_solve_on_card():
    """Inside the block, the plain candidate solves (``ilqr_solve_soa``,
    ``lm_feasibility_solve_soa``), as the plain steps and the kernels' CPU
    routes call them, raise on a CUDA tensor: on the card a simulator's
    candidate solves are K3's or K4's, never the plain version's."""
    from ilqr_iterative_tasks_torch.ops import (
        fused_ilqr, fused_lm_shooting, i2lqr_step, nlmpc_step)
    sites = [(m, "ilqr_solve_soa") for m in (i2lqr_step, fused_ilqr)] + [
        (m, "lm_feasibility_solve_soa") for m in (nlmpc_step,
                                                  fused_lm_shooting)]
    saved = [getattr(m, name) for m, name in sites]

    def guard(fn, name):
        def guarded(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda
                   for a in (*args, *kw.values())):
                raise AssertionError(f"the plain {name} ran on the card")
            return fn(*args, **kw)
        return guarded

    for (m, name), fn in zip(sites, saved):
        setattr(m, name, guard(fn, name))
    try:
        yield
    finally:
        for (m, name), fn in zip(sites, saved):
            setattr(m, name, fn)


def k1_capture(k1) -> Capture:
    """K1 capturing its inputs at the steps of CAPTURES."""
    return Capture(k1, K1_ATTRS, 5,
                   lambda lap, i, args: CAPTURES.get(lap) == i)


def want_capture(sched):
    """The capture rule of K2's checks: at control step ``sched[lap]`` of a
    lap, or, where that is None, at the lap's first step with shrunk
    horizons on >= 1 % of active lanes and at least one active lane at
    horizon 1 (the reach check)."""
    def want(lap, i, args):
        if sched[lap] is not None:
            return sched[lap] == i
        act = args[9] < 0.5
        shrunk = int((act & (args[10] < N)).sum())
        return (shrunk >= 0.01 * int(act.sum())
                and bool((act & (args[10] <= 1)).any()))
    return want


def k2_capture(k2, all_iter=False) -> Capture:
    """K2 capturing its inputs by the rule of NL_CAPTURES."""
    return Capture(k2, K2_ATTRS, 6, want_capture(NL_CAPTURES),
                   all_iter=all_iter)


def sweep_capture(k1) -> Capture:
    """K1 capturing its inputs at the steps of SWEEP_CAPTURES."""
    return Capture(k1, K1_ATTRS, 5,
                   lambda lap, i, args: SWEEP_CAPTURES.get(lap) == i)


@contextlib.contextmanager
def sweep_step_solver(k, nsi, wrap, device=None):
    """Inside the block, the K1 that ``run_sweep``'s simulator takes for
    (k, nsi) (``default_step_solver``'s) is ``wrap(k1)``, a step solver
    that delegates to it (a Capture); yields (k1, the wrapper)."""
    from ilqr_iterative_tasks_torch.experiments.scenario_sweep import (
        MAX_LAPS as S_LAPS, MAX_STEPS as S_STEPS)
    params = IlqrParams.make(num_ss_points=k, num_ss_iter=nsi, device=device)
    k1 = batched_soa.default_step_solver(
        params, SystemLimits.make(device=device), 1.0, max_steps=S_STEPS,
        max_laps=S_LAPS, max_iter=SWEEP_CAP)
    key = next(kk for kk, v in batched_soa._K1_CACHE.items() if v is k1)
    wrapper = wrap(k1)
    batched_soa._K1_CACHE[key] = wrapper
    try:
        yield k1, wrapper
    finally:
        batched_soa._K1_CACHE[key] = k1


class Headlines:
    """The headline runs on ``dev``: the seed lap, one static obstacle at
    (31, -2, 8, 6), plant noise on; ``scen`` holds BATCH lanes and
    ``scen_all`` ALL_BATCH. Each run ends in a synchronize."""

    def __init__(self, dev):
        self.dev = dev
        self.xcl, ucl = seed_trajectory(1.0)
        self.seed_xs = np.zeros((MAX_STEPS, 4))
        self.seed_xs[:121] = self.xcl
        self.seed_us = np.zeros((MAX_STEPS, 2))
        self.seed_us[:120] = ucl
        self.params, self.limits = (IlqrParams.make(device=dev),
                                    SystemLimits.make(device=dev))
        # the NLMPC solve clips at the raw delta_max: keep it exact in f64
        self.nl_limits = SystemLimits.make(dtype=torch.float64, device=dev)
        self.scen, self.scen_all = (
            SoaScenarios.broadcast(np.zeros(4), self.xcl[-1],
                                   Obstacle.make(31.0, -2.0, 8.0, 6.0,
                                                 device=dev),
                                   b, noise_on=True, device=dev)
            for b in (BATCH, ALL_BATCH))

    def i2lqr(self, seed, solver, candidate_solver=None):
        """The i2LQR headline through ``solver`` (K1 or one wrapping it) or,
        with ``candidate_solver`` (K3 built with max_iter CAP) and no
        solver, through the per-candidate path."""
        g = torch.Generator(device=self.dev).manual_seed(seed)
        with no_plain_solve_on_card():
            res = simulate_learning_runs_soa(
                self.params, self.limits, self.scen, self.seed_xs, None, 121,
                1.0, step_solver=solver, candidate_solver=candidate_solver,
                generator=g, num_laps=LAPS, max_steps=MAX_STEPS,
                max_laps=MAX_LAPS, solver_max_iter=CAP)
        torch.cuda.synchronize(self.dev)
        return res

    def nlmpc(self, seed, lp, sc, solver, candidate_solver=None):
        """An NLMPC headline of the parameters ``lp`` on the scenarios
        ``sc`` through ``solver`` (K2 or one wrapping it) or, with
        ``candidate_solver`` (K4 built with max_iters NL_CAP) and no solver,
        through the per-candidate path; with neither, through the
        simulator's default backend."""
        g = torch.Generator(device=self.dev).manual_seed(seed)
        with no_plain_solve_on_card():
            res = simulate_nlmpc_runs_soa(
                lp, self.nl_limits, sc, self.seed_xs, self.seed_us, 121, 1.0,
                step_solver=solver, candidate_solver=candidate_solver,
                generator=g, num_laps=LAPS, max_steps=MAX_STEPS,
                max_laps=MAX_LAPS, max_lm_iters=NL_CAP,
                infeasible_retire=NL_RETIRE)
        torch.cuda.synchronize(self.dev)
        return res
