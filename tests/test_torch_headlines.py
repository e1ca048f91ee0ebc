"""The helpers that chip_smoke.py and experiments/kernel_ab.py share
(experiments/headlines.py), on the CPU: the lap-records hash tells runs
apart by their bits, the capturing step solver keeps the inputs of the
steps its rule names while the run goes on through the kernel's CPU
route, K4's edge-case and random lanes are what they say, and the
candidates a step at k = 32 needs are each distinct (lap, row) once."""

import types

import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_torch.control.batched_soa import (
    SoaScenarios, simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.experiments import headlines
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    obstacle_to_lanes_nlmpc)
from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
    build_fused_i2lqr_step, i2lqr_step_reference)
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


@pytest.mark.parametrize("case", sorted(headlines.K4_EDGE_CASES))
def test_k4_edge_lanes_hold_their_case(case):
    b, share, (lo, hi), every = headlines.K4_EDGE_CASES[case]
    a = headlines.k4_edge_lanes(case, "cpu")
    assert [tuple(t.shape) for t in a] == [(4, b), (4, b), (6, 2, b), (7, b),
                                           (b,), (b,)]
    assert [t.dtype for t in a] == [torch.float64] * 4 + [torch.float32,
                                                          torch.int32]
    assert set(a[4].tolist()) <= {0.0, 1.0}
    if every:  # every n-th chunk of 32 lanes live, the rest as the share
        chunks = a[4][:b // 32 * 32].view(-1, 32)
        assert int(chunks[every - 1::every].sum()) == 0
        assert 0.6 < float(chunks.sum(dim=1).gt(0).double().mean()) < 0.7
    else:  # skipped, scattered
        assert int(a[4].sum()) == round(share * b)
    assert int(a[5].min()) >= lo and int(a[5].max()) < hi
    if case == "hzn_1_to_7":  # below and above the solve's [2, 6]
        assert int(a[5].min()) == 1 and int(a[5].max()) == 7
    for t in a:
        assert t.is_contiguous() and bool(torch.isfinite(t.double()).all())


def test_random_k4_lanes_are_phase_7s_draws():
    # chip_smoke.py's phase 7 draws its K4 lanes from numpy's generator of
    # seed 0 after phase 3's K3 lanes
    b = headlines.RANDOM_LANES
    rng = np.random.default_rng(0)
    xcl = seed_trajectory(1.0)[0]
    headlines.seed_lanes(rng, xcl, b, 1, 9)
    headlines.lane_obstacle(rng, b, "cpu")
    hzn = rng.integers(1, 7, b)
    x0, xt = headlines.seed_lanes(rng, xcl, b, 0, 3, extra=hzn)
    obs = obstacle_to_lanes_nlmpc(headlines.lane_obstacle(rng, b, "cpu"), b)
    warm = rng.normal(size=(6, 2, b)) * np.array([1.5, 1.0])[None, :, None]
    want = (x0, xt, warm, obs, np.arange(b) % 16 == 5, hzn)
    got = headlines.random_k4_lanes("cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w, dtype=g.numpy().dtype))


@pytest.mark.parametrize("nsi,lap_count", [(4, 2), (4, 4)])
def test_k32_distinct_gives_each_needed_candidate_once(nsi, lap_count):
    # the candidates a step needs are the distinct (lap, row) of the valid
    # slots of stored laps over the three passes, each once, at the first
    # lap row of its lap id
    a = headlines.k1_block_lanes(nsi, lap_count, "cpu", b=10)
    p = IlqrParams.make(num_ss_points=32, num_ss_iter=nsi, device="cpu")
    cands = []
    i2lqr_step_reference(p, SystemLimits.make(device="cpu"), 1.0, *a,
                         max_iter=16, cands=cands)
    solved = headlines.k32_distinct(a[5], a[6], cands)
    laps, oks = a[5].tolist(), a[6].tolist()
    for lane in range(10):
        got = [(laps[c // 32], int(idx[c, lane]))
               for m, (idx, _, _) in zip(solved, cands)
               for c in range(nsi * 32) if m[c, lane]]
        want = {(laps[c // 32], int(idx[c, lane]))
                for idx, fin, _ in cands for c in range(nsi * 32)
                if oks[c // 32] and fin[c, lane]}
        assert len(got) == len(set(got)) and set(got) == want
        assert all(laps.index(laps[c // 32]) == c // 32
                   for m in solved for c in range(nsi * 32) if m[c, lane])
