"""``dedup_passes`` in the port's i2LQR simulator
(control/batched_soa.py, ops/i2lqr_step.py::i2lqr_step_reference), JAX's
test_dedup_passes_bitwise_neutral (tests/test_batched.py:251-285) through
the K3 candidate solver's CPU route: B 16, 3 laps, LM cap 12, plant noise
on, the run with the option bit for bit the run without it, in f64 and
f32, with the solves it skipped counted (more than 0). The tier-1 runs
start each lap near the seed lap's end (row 108, a 14-step budget) so that
three laps take seconds; the ``slow`` ones are JAX's test's laps from
rest. Also the option's guards, as JAX's: no candidate solver (a step solver in its
place too), the NLMPC simulator (no such option)."""

import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import (
    simulate_nlmpc_runs_soa)
from ilqr_iterative_tasks_torch.control.batched_soa import (
    SoaScenarios, simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.fused_ilqr import build_fused_ilqr
from ilqr_iterative_tasks_torch.ops.i2lqr_step import build_fused_i2lqr_step
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, LmpcParams, SystemLimits)

torch.set_num_threads(1)
B, CAP = 16, 12


def _setup(dtype, start):
    xcl, _ = seed_trajectory(1.0)
    seed_xs = np.zeros((128, 4))
    seed_xs[:121] = xcl
    p = IlqrParams.make(dtype=dtype, device="cpu")
    lim = SystemLimits.make(dtype=dtype, device="cpu")
    scen = SoaScenarios.broadcast(
        xcl[start], xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=dtype,
                                           device="cpu"),
        B, noise_on=True, dtype=dtype, device="cpu")
    return p, lim, scen, seed_xs


def _neutral(dtype, start, budget):
    p, lim, scen, seed_xs = _setup(dtype, start)
    kw = dict(num_laps=3, max_steps=128, max_laps=8, solver_max_iter=CAP,
              sim_step_budget=budget)
    k3 = build_fused_ilqr(p, lim, 1.0, num_horizon=6, max_iter=CAP)
    runs, logs = [], []
    for dedup in (False, True):
        logs.append([])
        runs.append(simulate_learning_runs_soa(
            p, lim, scen, seed_xs, None, 121, 1.0, candidate_solver=k3,
            dedup_passes=dedup, dedup_log=logs[-1],
            generator=torch.Generator().manual_seed(3), **kw))
    base, dedup = runs
    for a, b in ((base.lap_steps, dedup.lap_steps),
                 (base.lap_done, dedup.lap_done),
                 (base.final_x, dedup.final_x),
                 *zip(base.safe_set, dedup.safe_set)):
        assert torch.equal(a, b)
    assert torch.equal(base.final_key, dedup.final_key)
    assert not logs[0]  # without the option nothing is skipped or logged
    skipped = int(sum(int(c) for c in logs[1]))
    assert skipped > 0, skipped
    return base, skipped


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dedup_passes_bitwise_neutral(dtype):
    base, _ = _neutral(dtype, 108, 14)
    assert base.lap_done.any()  # laps end within the budget


@pytest.mark.slow
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dedup_passes_bitwise_neutral_from_rest(dtype):
    """JAX's test's laps: from rest, the whole track, 3 laps."""
    base, skipped = _neutral(dtype, 0, 121)
    assert bool(base.lap_done.all()) and skipped > 1000


def test_dedup_passes_guards():
    p, lim, scen, seed_xs = _setup(torch.float64, 100)
    kw = dict(num_laps=1, max_steps=128, max_laps=4, solver_max_iter=CAP,
              sim_step_budget=2, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="dedup_passes requires"):
        simulate_learning_runs_soa(p, lim, scen, seed_xs, None, 121, 1.0,
                                   dedup_passes=True, **kw)
    k1 = build_fused_i2lqr_step(p, lim, 1.0, num_horizon=6, max_steps=128,
                                max_laps=4, max_iter=CAP)
    with pytest.raises(ValueError, match="dedup_passes requires"):
        simulate_learning_runs_soa(p, lim, scen, seed_xs, None, 121, 1.0,
                                   step_solver=k1, dedup_passes=True, **kw)
    # the NLMPC simulator takes no such option, as JAX's takes none
    with pytest.raises(TypeError, match="dedup_passes"):
        simulate_nlmpc_runs_soa(
            LmpcParams.make(device="cpu"), lim, scen, seed_xs,
            np.zeros((128, 2)), 121, 1.0, num_laps=1, max_laps=4,
            dedup_passes=True)
