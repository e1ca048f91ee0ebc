"""The helpers that chip_smoke.py and experiments/kernel_ab.py share
(experiments/headlines.py), on the CPU: the lap-records hash tells runs
apart by their bits, and the capturing step solver keeps the inputs of the
steps its rule names while the run goes on through the kernel's CPU
route."""

import types

import numpy as np
import torch

from ilqr_iterative_tasks_torch.control.batched_soa import (
    SoaScenarios, simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.experiments import headlines
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.i2lqr_step import build_fused_i2lqr_step
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits


def _records(seed):
    g = torch.Generator().manual_seed(seed)
    return types.SimpleNamespace(
        lap_steps=torch.randint(10, 120, (3, 4), generator=g),
        lap_done=torch.ones((3, 4), dtype=torch.bool),
        final_x=torch.randn((4, 4), generator=g),
        safe_set=(torch.randn((8, 128, 4, 4), generator=g),
                  torch.randn((8, 128, 4), generator=g)))


def test_lap_records_hash_follows_the_bits():
    a, b = _records(0), _records(0)
    assert headlines.lap_records_hash(a) == headlines.lap_records_hash(b)
    assert len(headlines.lap_records_hash(a)) == 16
    b.final_x[2, 1] = torch.nextafter(b.final_x[2, 1], torch.tensor(np.inf))
    assert headlines.lap_records_hash(a) != headlines.lap_records_hash(b)
    c = _records(0)
    c.safe_set[1][3, 5, 0] += 1.0  # one stored row of one lap and lane
    assert headlines.lap_records_hash(a) != headlines.lap_records_hash(c)
    d = _records(0)
    d.lap_steps[0, 0] += 1
    assert headlines.lap_records_hash(a) != headlines.lap_records_hash(d)


def test_k1_capture_keeps_the_named_steps():
    cpu = "cpu"
    params, limits = IlqrParams.make(device=cpu), SystemLimits.make(device=cpu)
    xcl, _ = seed_trajectory(1.0)
    seed = np.zeros((128, 4))
    seed[:121] = xcl
    sc = SoaScenarios.broadcast(np.zeros(4), xcl[-1],
                                Obstacle.make(31.0, -2.0, 8.0, 6.0,
                                              device=cpu),
                                2, noise_on=True, device=cpu)
    k1 = build_fused_i2lqr_step(params, limits, 1.0, num_horizon=6,
                                max_steps=128, max_laps=4, max_iter=16)

    def run(solver):
        return simulate_learning_runs_soa(
            params, limits, sc, seed, None, 121, 1.0, num_laps=1,
            max_laps=4, sim_step_budget=20, solver_max_iter=16,
            step_solver=solver, generator=torch.Generator().manual_seed(0))

    cap = headlines.k1_capture(k1)
    res = run(cap)
    assert sorted(cap.captured) == [1]
    step, args = cap.captured[1]
    assert step == headlines.CAPTURES[1] and cap.calls[1] == 20
    assert args[0].shape == (4, 2)  # the lanes' states at that step
    # the capture changes nothing of the run
    assert (headlines.lap_records_hash(res)
            == headlines.lap_records_hash(run(k1)))


def test_tap_step_keeps_the_plain_steps_inputs_on_the_candidate_path():
    """On the per-candidate path the tap sees the plain step's calls (one a
    step with active lanes) and keeps the named ones, and puts the step
    back; the guard lets CPU tensors through and puts the solves back."""
    from ilqr_iterative_tasks_torch.control import batched_soa
    from ilqr_iterative_tasks_torch.ops import fused_ilqr, i2lqr_step
    from ilqr_iterative_tasks_torch.ops.fused_ilqr import build_fused_ilqr
    cpu = "cpu"
    params, limits = IlqrParams.make(device=cpu), SystemLimits.make(device=cpu)
    xcl, _ = seed_trajectory(1.0)
    seed = np.zeros((128, 4))
    seed[:121] = xcl
    sc = SoaScenarios.broadcast(np.zeros(4), xcl[-1],
                                Obstacle.make(31.0, -2.0, 8.0, 6.0,
                                              device=cpu),
                                2, noise_on=True, device=cpu)
    k3 = build_fused_ilqr(params, limits, 1.0, num_horizon=6, max_iter=16)
    step = batched_soa.i2lqr_step_reference
    solves = (i2lqr_step.ilqr_solve_soa, fused_ilqr.ilqr_solve_soa)

    def run():
        return simulate_learning_runs_soa(
            params, limits, sc, seed, None, 121, 1.0, num_laps=1,
            max_laps=4, sim_step_budget=12, solver_max_iter=16,
            candidate_solver=k3, generator=torch.Generator().manual_seed(0))

    with headlines.no_plain_solve_on_card(), headlines.tap_step(
            batched_soa, "i2lqr_step_reference", 5,
            lambda lap, i, a: i == 5) as tap:
        assert i2lqr_step.ilqr_solve_soa is not solves[0]
        res = run()
    assert batched_soa.i2lqr_step_reference is step
    assert (i2lqr_step.ilqr_solve_soa, fused_ilqr.ilqr_solve_soa) == solves
    assert tap.calls == {1: 12} and sorted(tap.captured) == [1]
    step_i, args = tap.captured[1]
    assert step_i == 5 and len(args) == 9 and args[0].shape == (4, 2)
    assert headlines.lap_records_hash(res) == headlines.lap_records_hash(
        run())
