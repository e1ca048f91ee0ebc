"""The CUDA kernels K1, K3 (i2LQR), K2, K4 (NLMPC) and K5 (generic LM-iLQR)
against their plain torch versions on the card, the simulators' own K1 /
K2 / K4 when they are given no solver, the per-candidate path of both
simulators through K3 / K4 (no plain solve on the card) and exact resume
from a checkpoint on the card.

Marked ``cuda``: each test skips without a CUDA device. On a machine with
one, run ``python -m pytest tests/test_torch_cuda.py -q --noconftest``
(tests/conftest.py sets up JAX, which these tests do not use).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_torch.control import batched_nlmpc_soa, batched_soa
from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import (
    default_options, lap_window, simulate_nlmpc_runs_soa)
from ilqr_iterative_tasks_torch.control.batched_soa import (
    SoaScenarios, _step_solver_inputs, simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.experiments.generic_bench import (
    candidates, generic_kwargs, k5_task, throughput_inputs)
from ilqr_iterative_tasks_torch.experiments.headlines import (
    K4_EDGE_CASES, k1_block_lanes, k4_edge_lanes)
from ilqr_iterative_tasks_torch.models import double_integrator
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops import _build
from ilqr_iterative_tasks_torch.ops.fused_generic_ilqr import (
    build_fused_generic_ilqr, fused_generic_ilqr_reference, k5_library)
from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
    build_fused_ilqr, fused_ilqr_reference, obstacle_to_lanes)
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    build_fused_lm_shooting, fused_lm_shooting_reference,
    obstacle_to_lanes_nlmpc)
from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
    build_fused_i2lqr_step, i2lqr_step_reference)
from ilqr_iterative_tasks_torch.ops.ilqr_soa import ilqr_solve_soa
from ilqr_iterative_tasks_torch.ops.nlmpc_step import (
    build_fused_nlmpc_step, nlmpc_step_reference)
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, LmpcParams, SystemLimits)

pytestmark = pytest.mark.cuda
N, CAP, T_ROWS, MAX_LAPS = 6, 16, 128, 8


class PlainStep:
    """A step solver that runs a kernel's plain version on the card: the
    simulators launch the kernel itself when passed no step_solver."""

    def __init__(self, kernel, attrs, plain):
        for a in attrs:
            setattr(self, a, getattr(kernel, a))
        self.plain = plain

    def __call__(self, *args):
        return self.plain(*args)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _lanes(b, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    xcl, _ = seed_trajectory(1.0)
    rows = rng.integers(0, 100, b)
    x0 = (xcl[rows] + rng.normal(size=(b, 4)) * [0.5, 0.5, 0.2, 0.05]).T
    xt = (xcl[rows + rng.integers(1, 9, b)] + rng.normal(size=(b, 4)) * 0.3).T
    obs = obstacle_to_lanes(
        Obstacle.make(31.0, -2.0, 8.0, 6.0, spd=0.5, moving_option=1,
                      dtype=dtype, device=dev).map(lambda v: v.expand(b)), b)
    f = lambda a: torch.tensor(a, dtype=dtype, device=dev).contiguous()
    return f(x0), f(xt), torch.zeros((N, 2, b), dtype=dtype, device=dev), \
        obs.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_matches_plain(dev, dtype):
    p, l = IlqrParams.make(), SystemLimits.make()
    k3 = build_fused_ilqr(p, l, 1.0, num_horizon=N, max_iter=CAP)
    a = _lanes(1000, dtype, dev)  # not a multiple of the 128-thread block
    skip = (torch.arange(1000, device=dev) % 5 == 0).float()
    got = k3(*a, skip)
    want = fused_ilqr_reference(p, l, 1.0, *a, skip, num_horizon=N,
                                max_iter=CAP)
    torch.cuda.synchronize()
    assert k3.launches == 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    with pytest.raises(TypeError):
        k3(*(t.to(torch.float16) for t in a))
    with pytest.raises(ValueError):
        k3(a[0][:, :10], *a[1:])


@pytest.mark.parametrize("nsi", [1, 2])
def test_k1_matches_plain(dev, nsi):
    p, l = IlqrParams.make(num_ss_iter=nsi), SystemLimits.make()
    xcl, _ = seed_trajectory(1.0)
    b = 700
    states = torch.zeros((MAX_LAPS, T_ROWS, 4, b), device=dev)
    seed = torch.tensor(xcl, dtype=torch.float32, device=dev)
    states[0, :121] = seed[:, :, None]
    states[1, :61] = seed[::2, :, None]
    lap_len = torch.zeros((MAX_LAPS, b), dtype=torch.int32, device=dev)
    lap_len[0], lap_len[1] = 121, 61
    lap_len[1, :5] = 4  # fewer stored rows than k
    t = torch.arange(T_ROWS, device=dev)[:, None]
    qfun = torch.clamp_min(lap_len[:, None, :] - 1.0 - t[None], 0.0)
    x = (seed[torch.arange(b, device=dev) % 100].T
         + 0.1 * torch.randn((4, b), device=dev)).contiguous()
    lap_ids, lap_ok, _ = _step_solver_inputs(2, nsi, MAX_LAPS, None, b, dev)
    skip = (torch.arange(b, device=dev) % 7 == 0).float()
    obs = _lanes(b, torch.float32, dev)[3]
    k1 = build_fused_i2lqr_step(p, l, 1.0, num_horizon=N, max_steps=T_ROWS,
                                max_laps=MAX_LAPS, max_iter=CAP)
    for dtype in (torch.float32, torch.float64):
        a = (x.to(dtype), x.to(dtype), states.to(dtype), qfun.to(dtype),
             lap_len, lap_ids, lap_ok, obs.to(dtype), skip)
        got = k1(*a)
        want = i2lqr_step_reference(p, l, 1.0, *a, max_iter=CAP)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    assert k1.launches == 2


def _k1_tile_inputs(nsi, lap_count, dev, b=1003):
    """Safe sets that hit K1's kNN merge: lap 0 the seed lap and lap 1 its
    first 60 rows each stored twice (equal distances at different rows),
    all on a 0.5 grid with x on it too (more ties), some lanes with fewer
    stored rows than k; with lap_count < nsi a lap not yet stored. b is not
    a multiple of the lanes a block holds."""
    rng = np.random.default_rng(5 + nsi)
    xcl, _ = seed_trajectory(1.0)
    states = np.zeros((MAX_LAPS, T_ROWS, 4, b))
    states[0, :121] = xcl[:, :, None]
    states[1, :120] = np.repeat(xcl[:60], 2, axis=0)[:, :, None]
    states = np.round(states * 2) / 2
    lap_len = np.zeros((MAX_LAPS, b), np.int32)
    lap_len[0], lap_len[1] = 121, 120
    lap_len[1, ::11] = rng.integers(1, 8, lap_len[1, ::11].shape)
    t = np.arange(T_ROWS)[None, :, None]
    qfun = np.maximum(lap_len[:, None, :] - 1.0 - t, 0.0)
    x = np.round((xcl[rng.integers(0, 100, b)]
                  + rng.normal(size=(b, 4)) * [1.0, 1.0, 0.3, 0.05]) * 2) / 2
    f = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
    lap_ids, lap_ok, _ = _step_solver_inputs(lap_count, nsi, MAX_LAPS, None,
                                             b, dev)
    skip = (torch.arange(b, device=dev) % 7 == 0).float()
    obs = _lanes(b, torch.float64, dev)[3]
    return (f(x.T).contiguous(), f(x.T).contiguous(), f(states), f(qfun),
            torch.tensor(lap_len, device=dev), lap_ids, lap_ok, obs, skip)


@pytest.mark.parametrize("nsi,lap_count", [(1, 2), (2, 2), (2, 1)])
def test_k1_thread_tiles_match_plain_bitwise(dev, nsi, lap_count):
    p, l = IlqrParams.make(num_ss_iter=nsi), SystemLimits.make()
    args = _k1_tile_inputs(nsi, lap_count, dev)
    k1 = build_fused_i2lqr_step(p, l, 1.0, num_horizon=N, max_steps=T_ROWS,
                                max_laps=MAX_LAPS, max_iter=CAP)
    for dtype in (torch.float32, torch.float64):
        a = [t.to(dtype) if t.is_floating_point() and i != 8 else t
             for i, t in enumerate(args)]
        got = k1(*a)
        want = i2lqr_step_reference(p, l, 1.0, *a, max_iter=CAP)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert k1.launches == 2


def test_closed_loop_through_k1_matches_plain(dev):
    p, l = IlqrParams.make(dtype=torch.float64), SystemLimits.make()
    xcl, _ = seed_trajectory(1.0)
    seed_xs = np.zeros((T_ROWS, 4))
    seed_xs[:121] = xcl
    scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0), 8,
        noise_on=True, dtype=torch.float64, device=dev)
    noise = torch.randn((60, 2, 8), dtype=torch.float64, device=dev)
    kw = dict(num_laps=1, max_steps=T_ROWS, max_laps=MAX_LAPS,
              sim_step_budget=30, solver_max_iter=CAP, noise=noise)
    k1 = build_fused_i2lqr_step(p, l, 1.0, num_horizon=N, max_steps=T_ROWS,
                                max_laps=MAX_LAPS, max_iter=CAP)
    got = simulate_learning_runs_soa(p, l, scen, seed_xs, None, 121, 1.0,
                                     step_solver=k1, **kw)
    plain = PlainStep(k1, ("k", "nsi", "num_horizon", "max_steps",
                           "max_laps", "max_iter"),
                      lambda *a: i2lqr_step_reference(p, l, 1.0, *a,
                                                      max_iter=CAP))
    want = simulate_learning_runs_soa(p, l, scen, seed_xs, None, 121, 1.0,
                                      step_solver=plain, **kw)
    assert k1.launches > 0
    assert torch.equal(got.lap_steps, want.lap_steps)
    torch.testing.assert_close(got.safe_set[0], want.safe_set[0], rtol=0,
                               atol=1e-9)


# ---- K1 at k = 32: one lane a warp ----
@pytest.mark.parametrize("nsi,lap_count", [(2, 4), (4, 4), (4, 2)])
def test_k1_blocks_of_32_candidates_match_plain_bitwise(dev, nsi, lap_count):
    p, l = IlqrParams.make(num_ss_points=32, num_ss_iter=nsi), \
        SystemLimits.make()
    args = k1_block_lanes(nsi, lap_count, dev)
    k1 = build_fused_i2lqr_step(p, l, 1.0, num_horizon=N, max_steps=T_ROWS,
                                max_laps=MAX_LAPS, max_iter=CAP)
    for dtype in (torch.float32, torch.float64):
        a = [t.to(dtype) if t.is_floating_point() and i != 8 else t
             for i, t in enumerate(args)]
        got = k1(*a)
        want = i2lqr_step_reference(p, l, 1.0, *a, max_iter=CAP)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert float(got[0][:, :, ::7].abs().max()) == 0.0  # skipped lanes
        assert int(got[3].max()) <= nsi - 1
    assert k1.launches == 2


def test_closed_loop_through_k1_at_32_candidates_matches_plain(dev):
    """Two laps of a 30-step budget, so lap 2 selects among 32 candidates
    of a stored lap of 31 rows (ragged rows, slots of laps not yet
    stored)."""
    p = IlqrParams.make(dtype=torch.float64, num_ss_points=32, num_ss_iter=4)
    l = SystemLimits.make()
    xcl, _ = seed_trajectory(1.0)
    seed_xs = np.zeros((T_ROWS, 4))
    seed_xs[:121] = xcl
    scen = SoaScenarios.randomized(
        np.zeros(4), xcl[-1], Obstacle.make(35.0, -16.0, 20.0, 20.0, spd=1.0,
                                            moving_option=1), 8,
        torch.Generator(dev).manual_seed(0), x0_jitter=(0.5, 0.5, 0.0, 0.5),
        obs_spd_jitter=0.3, dtype=torch.float64, device=dev)
    noise = torch.randn((60, 2, 8), dtype=torch.float64, device=dev)
    kw = dict(num_laps=2, max_steps=T_ROWS, max_laps=MAX_LAPS,
              sim_step_budget=30, solver_max_iter=CAP, noise=noise,
              stall_reseed=3)
    k1 = build_fused_i2lqr_step(p, l, 1.0, num_horizon=N, max_steps=T_ROWS,
                                max_laps=MAX_LAPS, max_iter=CAP)
    got = simulate_learning_runs_soa(p, l, scen, seed_xs, None, 121, 1.0,
                                     step_solver=k1, **kw)
    plain = PlainStep(k1, ("k", "nsi", "num_horizon", "max_steps",
                           "max_laps", "max_iter"),
                      lambda *a: i2lqr_step_reference(p, l, 1.0, *a,
                                                      max_iter=CAP))
    want = simulate_learning_runs_soa(p, l, scen, seed_xs, None, 121, 1.0,
                                      step_solver=plain, **kw)
    assert k1.launches > 0
    assert torch.equal(got.lap_steps, want.lap_steps)
    for g, w in zip(got.safe_set, want.safe_set):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k,nsi", [(8, 1), (32, 4)])
def test_sweep_on_the_card_launches_k1(dev, k, nsi):
    from ilqr_iterative_tasks_torch.experiments.scenario_sweep import (
        MAX_LAPS as SW_LAPS, MAX_STEPS as SW_STEPS, run_sweep)
    p = IlqrParams.make(num_ss_points=k, num_ss_iter=nsi)
    k1 = batched_soa.default_step_solver(p, SystemLimits.make(), 1.0,
                                         max_steps=SW_STEPS,
                                         max_laps=SW_LAPS, max_iter=16)
    before = k1.launches
    rep = run_sweep(256, 1, moving=True, num_ss_points=k, num_ss_iter=nsi,
                    stall_reseed=3, quiet=True)
    assert rep["backend"] == "cuda"
    assert k1.launches - before >= rep["lap_steps_p95"][0]
    assert 0.0 <= rep["completion_rate"] <= 1.0


@pytest.mark.parametrize("k,nsi,max_steps", [(32, 1, T_ROWS), (16, 2, T_ROWS),
                                             (32, 4, 160)])
def test_k1_raises_where_nothing_is_instantiated(dev, k, nsi, max_steps):
    p, l = IlqrParams.make(num_ss_points=k, num_ss_iter=nsi), \
        SystemLimits.make()
    a = list(k1_block_lanes(4, 4, dev, b=64))
    a[2] = torch.zeros((MAX_LAPS, max_steps, 4, 64), dtype=torch.float64,
                       device=dev)
    a[3] = torch.zeros((MAX_LAPS, max_steps, 64), dtype=torch.float64,
                       device=dev)
    a[5], a[6], _ = _step_solver_inputs(4, nsi, MAX_LAPS, None, 64, dev)
    k1 = build_fused_i2lqr_step(p, l, 1.0, num_horizon=N,
                                max_steps=max_steps, max_laps=MAX_LAPS,
                                max_iter=CAP)
    with pytest.raises(ValueError, match="no kernel instantiated"):
        k1(*a)
    assert k1.launches == 0
    if max_steps == T_ROWS:  # no kernel of these (k, nsi) at all
        with pytest.raises(ValueError, match="no kernel instantiated"):
            _build.attributes(_build.library(), "i2lqr_step_attributes", 0,
                              N, k, nsi)


# ---- NLMPC: K4 and K2 (mirroring chip_smoke.py phases 7 and 8) ----
NL_CAP, NL_B = 12, 4096


def _nl_obs(rng, b, dtype, dev):
    opt = np.arange(b) % 3
    return obstacle_to_lanes_nlmpc(Obstacle(
        x=31.0 + rng.normal(size=b) * 4, y=-2.0 + rng.normal(size=b) * 4,
        width=np.full(b, 8.0), height=np.full(b, 6.0),
        spd=np.where(opt == 0, 0.0, 0.5 + rng.random(b)),
        moving_option=opt.astype(float),
        present=(np.arange(b) % 8 != 7).astype(float)).map(
            lambda a: torch.tensor(a, dtype=dtype, device=dev)), b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_matches_plain(dev, dtype):
    rng = np.random.default_rng(1)
    xcl, _ = seed_trajectory(1.0)
    b = NL_B + 77  # not a multiple of the 128-thread block
    hzn = rng.integers(1, N + 1, b)
    rows = rng.integers(0, 100, b)
    x0 = xcl[rows] + rng.normal(size=(b, 4)) * [0.5, 0.5, 0.2, 0.05]
    xt = (xcl[rows + hzn + rng.integers(0, 3, b)]
          + rng.normal(size=(b, 4)) * [0.3, 0.3, 0.1, 0.02])
    warm = rng.normal(size=(N, 2, b)) * np.array([1.5, 1.0])[None, :, None]
    f = lambda a: torch.tensor(a, dtype=dtype, device=dev).contiguous()
    lim = SystemLimits.make(dtype=torch.float64)
    a = (f(x0.T), f(xt.T), f(warm), _nl_obs(rng, b, dtype, dev).contiguous(),
         (torch.arange(b, device=dev) % 16 == 5).float(),
         torch.tensor(hzn, dtype=torch.int32, device=dev))
    k4 = build_fused_lm_shooting(lim, 1.0, num_horizon=N, max_iters=NL_CAP)
    got = k4(*a)
    want = fused_lm_shooting_reference(lim, 1.0, *a, num_horizon=N,
                                       max_iters=NL_CAP)
    torch.cuda.synchronize()
    assert k4.launches == 1
    live = a[4] < 0.5
    same = (got[3] == want[3])[live]
    dus = (got[0] - want[0]).abs().amax(dim=(0, 1))[live]
    if dtype == torch.float64:
        assert float((same & (dus <= 1e-6)).double().mean()) >= 0.999
    else:
        assert float(same.double().mean()) >= 0.99
        assert float(dus[same].max()) <= 1e-5
    with pytest.raises(TypeError):
        k4(*(t.to(torch.float16) for t in a[:4]), *a[4:])
    with pytest.raises(ValueError):
        k4(a[0][:, :10], *a[1:])


def _nl_step_inputs(dtype, dev, b=NL_B, t_rows=64, max_laps=4, seed=2):
    """Two stored laps per lane (the newest a slice of the seed lap from the
    lane's start, some shorter than k), x near that start, per-lane
    obstacles, every horizon 1..N, 1/9 of lanes skipped."""
    rng = np.random.default_rng(seed)
    xcl, ucl = seed_trajectory(1.0)
    start = rng.integers(0, 80, b)
    length = np.minimum(rng.integers(4, t_rows + 1, b), 121 - start)
    rows = np.minimum(start[:, None] + np.arange(t_rows)[None], 120)
    on = np.arange(t_rows)[None] < length[:, None]  # (b, T)
    states = np.zeros((max_laps, t_rows, 4, b))
    inputs = np.zeros((max_laps, t_rows, 2, b))
    states[0] = xcl[:t_rows, :, None]
    inputs[0] = ucl[:t_rows, :, None]
    states[1] = np.where(on[..., None], xcl[rows], 0.0).transpose(1, 2, 0)
    inputs[1] = np.where(on[..., None], ucl[np.minimum(rows, 119)],
                         0.0).transpose(1, 2, 0)
    lap_len = np.zeros((max_laps, b), np.int32)
    lap_len[0], lap_len[1] = t_rows, length
    t = np.arange(t_rows)[None, :, None]
    qfun = np.maximum(lap_len[:, None, :] - 1.0 - t, 0.0)
    x = xcl[start] + rng.normal(size=(b, 4)) * [0.2, 0.2, 0.05, 0.02]
    f = lambda a: torch.tensor(a, dtype=dtype, device=dev).contiguous()
    lap_ids, lap_ok, _ = _step_solver_inputs(2, 1, max_laps, None, b, dev)
    hzn = torch.tensor(1 + np.arange(b) % N, dtype=torch.int32, device=dev)
    skip = (torch.arange(b, device=dev) % 9 == 4).float()
    st = f(states)
    return (f(x.T), st[1, N].contiguous(), f(inputs)[1, :N].contiguous(), st,
            f(qfun), torch.tensor(lap_len, device=dev), lap_ids, lap_ok,
            _nl_obs(rng, b, dtype, dev).contiguous(), skip, hzn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_matches_plain(dev, dtype):
    p, lim = LmpcParams.make(), SystemLimits.make(dtype=torch.float64)
    a = _nl_step_inputs(dtype, dev)
    k2 = build_fused_nlmpc_step(p, lim, 1.0, num_horizon=N,
                                max_steps=a[3].shape[1],
                                max_laps=a[3].shape[0], max_iters=NL_CAP)
    got = k2(*a)
    want = nlmpc_step_reference(p, lim, 1.0, *a, max_iters=NL_CAP)
    torch.cuda.synchronize()
    assert k2.launches == 1
    live = a[9] < 0.5
    for g in got:
        assert not bool(g[..., ~live].any())  # skip lanes are zeros
    agree = ((got[1] == want[1]) & (got[3] == want[3]) & (got[4] == want[4])
             & (got[5] == want[5]))[live]
    share = float(agree.double().mean())
    assert share >= (0.999 if dtype == torch.float64 else 0.99), share
    assert 0.2 < float(want[1][live].mean()) < 1.0  # both verdicts occur
    # the winner's solution and guess on the lanes whose decisions agree
    tol = 1e-6 if dtype == torch.float64 else 1e-5
    dus = (got[0] - want[0]).abs().amax(dim=(0, 1))[live][agree]
    dng = (got[2] - want[2]).abs().amax(dim=0)[live][agree]
    assert float(dus.max()) <= tol and float(dng.max()) <= tol


def test_closed_loop_through_k2_matches_plain(dev):
    p, lim = LmpcParams.make(), SystemLimits.make(dtype=torch.float64)
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((T_ROWS, 4)), np.zeros((T_ROWS, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0), 8,
        noise_on=True, dtype=torch.float64, device=dev)
    noise = torch.randn((40, 2, 8), dtype=torch.float64, device=dev)
    kw = dict(num_laps=1, max_steps=T_ROWS, max_laps=MAX_LAPS,
              sim_step_budget=40, max_lm_iters=NL_CAP, noise=noise,
              infeasible_retire=8)
    k2 = build_fused_nlmpc_step(p, lim, 1.0, num_horizon=N, max_steps=T_ROWS,
                                max_laps=MAX_LAPS, max_iters=NL_CAP)
    got = simulate_nlmpc_runs_soa(p, lim, scen, seed_xs, seed_us, 121, 1.0,
                                  step_solver=k2, **kw)
    plain = PlainStep(k2, ("k", "nsi", "num_horizon", "max_steps",
                           "max_laps", "max_iters"),
                      lambda *a: nlmpc_step_reference(p, lim, 1.0, *a,
                                                      max_iters=NL_CAP))
    want = simulate_nlmpc_runs_soa(p, lim, scen, seed_xs, seed_us, 121, 1.0,
                                   step_solver=plain, **kw)
    assert k2.launches > 0
    assert torch.equal(got.lap_steps, want.lap_steps)
    for i in (0, 1):
        torch.testing.assert_close(got.safe_set[i], want.safe_set[i], rtol=0,
                                   atol=1e-9)


NL_MODES = {"spaceVarying": {}, "timeVarying": dict(ss_option="timeVarying"),
            "all": dict(all_ss_point=True),
            "all_iter": dict(all_ss_point=True, all_ss_iter=True)}
# (mode, option): the option is bitwise-neutral against K2 without it
K2_OPTIONS = [("spaceVarying", "qsort_skip"), ("timeVarying", None),
              ("timeVarying", "qsort_skip"), ("all", None),
              ("all", "all_rev_skip"), ("all_iter", None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode,option", K2_OPTIONS)
def test_k2_modes_match_plain(dev, dtype, mode, option):
    p, lim = LmpcParams.make(**NL_MODES[mode]), SystemLimits.make(
        dtype=torch.float64)
    b = NL_B if mode in ("spaceVarying", "timeVarying") else 1024
    a = list(_nl_step_inputs(dtype, dev, b=b))
    a[6], a[7] = lap_window(2, 1, a[3].shape[0], p.all_ss_iter, b, dev)
    extra = ((torch.arange(b, device=dev) % 9).to(torch.int32),
             (a[5][:2] - 1).amin(dim=0)) if mode == "timeVarying" else ()
    sizes = dict(num_horizon=N, max_steps=a[3].shape[1],
                 max_laps=a[3].shape[0], max_iters=NL_CAP)
    k2 = build_fused_nlmpc_step(p, lim, 1.0, **sizes,
                                **({option: True} if option else {}))
    got = k2(*a, *extra)
    want = nlmpc_step_reference(p, lim, 1.0, *a, *extra, max_iters=NL_CAP)
    torch.cuda.synchronize()
    assert k2.launches == 1
    live = a[9] < 0.5
    for g in got:
        assert not bool(g[..., ~live].any())  # skip lanes are zeros
    agree = ((got[1] == want[1]) & (got[3] == want[3]) & (got[4] == want[4])
             & (got[5] == want[5]))[live]
    share = float(agree.double().mean())
    assert share >= (0.999 if dtype == torch.float64 else 0.99), share
    assert 0.05 < float(want[1][live].mean()) < 1.0  # both verdicts occur
    tol = 1e-6 if dtype == torch.float64 else 1e-5
    dus = (got[0] - want[0]).abs().amax(dim=(0, 1))[live][agree]
    dng = (got[2] - want[2]).abs().amax(dim=0)[live][agree]
    assert float(dus.max()) <= tol and float(dng.max()) <= tol
    if option:  # the same kernel without the option, bit for bit
        base = build_fused_nlmpc_step(p, lim, 1.0, **sizes)(*a, *extra)
        for g, w in zip(got, base):
            assert torch.equal(g, w)


def _all_tile_inputs(dtype, dev, b=1007):
    """``_nl_step_inputs`` edited to hit K2 all's thread tiles: lanes 1
    mod 5 end their newest lap with 24 rows at x's position and 12 m/s
    faster (in reach, infeasible: the descending scan crosses several
    chunks before a feasible row), lanes 2 mod 5 store only such rows (in
    reach, nothing feasible), lanes 3 mod 5 start 60 m off the lap (nothing
    in reach); every horizon 1..n. b is not a multiple of the lanes a
    block holds."""
    a = list(_nl_step_inputs(dtype, dev, b=b))
    x, st, ln = a[0].clone(), a[3].clone(), a[5][1].long()
    lane = torch.arange(b, device=dev)
    t = torch.arange(st.shape[1], device=dev)[:, None]
    stall = x.clone()
    stall[2] += 12.0
    rows = (((lane % 5 == 1) & (ln >= 30) & (t >= ln - 24))
            | ((lane % 5 == 2) & (t < ln))) & (t < ln)
    st[1] = torch.where(rows[:, None, :], stall[None], st[1])
    x[1] = torch.where(lane % 5 == 3, x[1] + 60.0, x[1])
    a[0], a[3] = x.contiguous(), st.contiguous()
    return a


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode,option", [("all", "all_rev_skip"),
                                         ("all", None), ("all_iter", None)])
def test_k2_all_thread_tiles_match_plain_bitwise(dev, dtype, mode, option):
    p, lim = LmpcParams.make(**NL_MODES[mode]), SystemLimits.make(
        dtype=torch.float64)
    a = _all_tile_inputs(dtype, dev)
    b = a[0].shape[-1]
    a[6], a[7] = lap_window(2, 1, a[3].shape[0], p.all_ss_iter, b, dev)
    sizes = dict(num_horizon=N, max_steps=a[3].shape[1],
                 max_laps=a[3].shape[0], max_iters=NL_CAP)
    k2 = build_fused_nlmpc_step(p, lim, 1.0, **sizes,
                                **({option: True} if option else {}))
    got = k2(*a)
    want = nlmpc_step_reference(p, lim, 1.0, *a, max_iters=NL_CAP)
    torch.cuda.synchronize()
    assert k2.launches == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    live = a[9] < 0.5
    lane = torch.arange(b, device=dev)
    # the edited lanes: none feasible where nothing is (all_iter also
    # reads the seed lap), some elsewhere
    none = (lane % 5 == 3) | ((lane % 5 == 2) & (mode == "all"))
    assert not bool(want[1][live & none].any())
    assert bool(want[1][live & (lane % 5 == 1)].any())
    assert bool((live & (a[10] <= 1)).any())  # horizon-1 lanes
    if option:  # the forward scan, bit for bit
        base = build_fused_nlmpc_step(p, lim, 1.0, **sizes)(*a)
        for g, w in zip(got, base):
            assert torch.equal(g, w)


def _k2_tile_inputs(dtype, dev, mode, nsi, lap_count, b=1003):
    """``_nl_step_inputs`` edited to hit K2's thread tiles in spaceVarying
    and timeVarying: Qfun tied in threes along each lap (equal keys in
    qsort_skip's rank order), lanes 1 mod 7 storing 1-3 rows of the newest
    lap (fewer than k) and lanes 2 mod 7 none (every slot invalid, so rank 0
    is), lanes 3 mod 7 60 m off the laps (nothing feasible: the slot-0
    fallback); every horizon 1..n, 1/9 of lanes skipped; the last nsi of
    ``lap_count`` stored laps, so a lap not yet stored where lap_count <
    nsi. In timeVarying the simulator's (t, min_cost) are appended. b is
    not a multiple of the lanes a block holds."""
    a = list(_nl_step_inputs(dtype, dev, b=b))
    lane = torch.arange(b, device=dev)
    ln = a[5].clone()
    ln[1] = torch.where(lane % 7 == 1, 1 + lane % 3, ln[1])
    ln[1] = torch.where(lane % 7 == 2, 0, ln[1])
    x = a[0].clone()
    x[1] = torch.where(lane % 7 == 3, x[1] + 60.0, x[1])
    t = torch.arange(a[3].shape[1], device=dev)[None, :, None]
    a[4] = torch.floor(torch.clamp_min(ln[:, None, :] - 1.0 - t, 0.0)
                       / 3).to(dtype).contiguous()
    a[0], a[5] = x.contiguous(), ln.contiguous()
    a[6], a[7] = lap_window(lap_count, nsi, a[3].shape[0], False, b, dev)
    if mode == "timeVarying":
        a += [(lane % 9).to(torch.int32), (ln[:lap_count] - 1).amin(dim=0)]
    return a


# (mode, qsort_skip, nsi, laps stored)
K2_TILE_CASES = [(mode, qsort, nsi, laps)
                 for mode in ("spaceVarying", "timeVarying")
                 for qsort, nsi, laps in ((False, 1, 2), (True, 1, 2),
                                          (False, 2, 2), (False, 2, 1))]


@pytest.mark.parametrize("mode,qsort,nsi,laps", K2_TILE_CASES)
def test_k2_thread_tiles_match_plain_bitwise(dev, mode, qsort, nsi, laps):
    """K2 spaceVarying / timeVarying on ``_k2_tile_inputs`` equals the plain
    step bit for bit, and with qsort_skip K2 without it; at nsi = 1 also
    with the lap flagged not stored (every slot invalid)."""
    p = LmpcParams.make(num_ss_iter=nsi, **NL_MODES[mode])
    lim = SystemLimits.make(dtype=torch.float64)
    for dtype in (torch.float32, torch.float64):
        a = _k2_tile_inputs(dtype, dev, mode, nsi, laps)
        b = a[0].shape[-1]
        sizes = dict(num_horizon=N, max_steps=a[3].shape[1],
                     max_laps=a[3].shape[0], max_iters=NL_CAP)
        k2 = build_fused_nlmpc_step(p, lim, 1.0, qsort_skip=qsort, **sizes)
        base = build_fused_nlmpc_step(p, lim, 1.0, **sizes)
        for lap_ok in [a[7]] + [torch.zeros_like(a[7])] * (nsi == 1):
            a[7] = lap_ok
            got = k2(*a)
            want = nlmpc_step_reference(p, lim, 1.0, *a, max_iters=NL_CAP)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            if qsort:
                for g, w in zip(got, base(*a)):
                    assert torch.equal(g, w)
            live = a[9] < 0.5
            lane = torch.arange(b, device=dev)
            assert not bool(want[1][live & (lane % 7 == 3)].any())
            assert bool(want[1][live].any()) == bool(lap_ok.any())
            assert bool((live & (a[10] <= 1)).any())  # horizon-1 lanes
        assert k2.launches == 1 + (nsi == 1)


@pytest.mark.parametrize("mode", ["spaceVarying", "timeVarying"])
def test_closed_loop_at_nsi_2_through_k2_matches_plain(dev, mode):
    p = LmpcParams.make(num_ss_iter=2, **NL_MODES[mode])
    lim = SystemLimits.make(dtype=torch.float64)
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((T_ROWS, 4)), np.zeros((T_ROWS, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0), 8,
        noise_on=True, dtype=torch.float64, device=dev)
    noise = torch.randn((80, 2, 8), dtype=torch.float64, device=dev)
    kw = dict(num_laps=2, max_steps=T_ROWS, max_laps=MAX_LAPS,
              sim_step_budget=40, max_lm_iters=NL_CAP, noise=noise,
              infeasible_retire=8)
    k2 = batched_nlmpc_soa.default_step_solver(
        p, lim, 1.0, max_steps=T_ROWS, max_laps=MAX_LAPS, max_iters=NL_CAP)
    assert (k2.nsi, k2.qsort_skip) == (2, False)
    before = k2.launches
    got = simulate_nlmpc_runs_soa(p, lim, scen, seed_xs, seed_us, 121, 1.0,
                                  **kw)
    assert k2.launches > before
    plain = PlainStep(k2, ("k", "nsi", "num_horizon", "max_steps",
                           "max_laps", "max_iters", "mode", "all_iter"),
                      lambda *a: nlmpc_step_reference(p, lim, 1.0, *a,
                                                      max_iters=NL_CAP))
    want = simulate_nlmpc_runs_soa(p, lim, scen, seed_xs, seed_us, 121, 1.0,
                                   step_solver=plain, **kw)
    assert torch.equal(got.lap_steps, want.lap_steps)
    for i in (0, 1):
        assert torch.equal(got.safe_set[i], want.safe_set[i])


@pytest.mark.parametrize("mode", ["timeVarying", "all", "all_iter"])
def test_closed_loop_through_default_k2_matches_plain(dev, mode):
    p, lim = LmpcParams.make(**NL_MODES[mode]), SystemLimits.make(
        dtype=torch.float64)
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((T_ROWS, 4)), np.zeros((T_ROWS, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0), 8,
        noise_on=True, dtype=torch.float64, device=dev)
    noise = torch.randn((80, 2, 8), dtype=torch.float64, device=dev)
    kw = dict(num_laps=2, max_steps=T_ROWS, max_laps=MAX_LAPS,
              sim_step_budget=40, max_lm_iters=NL_CAP, noise=noise,
              infeasible_retire=8)
    k2 = batched_nlmpc_soa.default_step_solver(
        p, lim, 1.0, max_steps=T_ROWS, max_laps=MAX_LAPS, max_iters=NL_CAP)
    assert (k2.mode, k2.qsort_skip, k2.all_rev_skip) == (
        p.ss_mode, *(default_options(p).get(o, False)
                     for o in ("qsort_skip", "all_rev_skip")))
    before = k2.launches
    got = simulate_nlmpc_runs_soa(p, lim, scen, seed_xs, seed_us, 121, 1.0,
                                  **kw)
    assert k2.launches > before
    plain = PlainStep(k2, ("k", "nsi", "num_horizon", "max_steps",
                           "max_laps", "max_iters", "mode", "all_iter"),
                      lambda *a: nlmpc_step_reference(p, lim, 1.0, *a,
                                                      max_iters=NL_CAP))
    want = simulate_nlmpc_runs_soa(p, lim, scen, seed_xs, seed_us, 121, 1.0,
                                   step_solver=plain, **kw)
    assert torch.equal(got.lap_steps, want.lap_steps)
    for i in (0, 1):
        torch.testing.assert_close(got.safe_set[i], want.safe_set[i], rtol=0,
                                   atol=1e-9)


def test_simulators_launch_their_own_kernels_without_a_step_solver(dev):
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((T_ROWS, 4)), np.zeros((T_ROWS, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0), 8,
        noise_on=True)
    kw = dict(num_laps=1, max_steps=T_ROWS, max_laps=MAX_LAPS,
              sim_step_budget=10)
    p, l = IlqrParams.make(), SystemLimits.make()
    k1 = batched_soa.default_step_solver(p, l, 1.0, max_steps=T_ROWS,
                                         max_laps=MAX_LAPS, max_iter=CAP)
    before = k1.launches
    simulate_learning_runs_soa(p, l, scen, seed_xs, None, 121, 1.0,
                               solver_max_iter=CAP, **kw,
                               generator=torch.Generator(dev).manual_seed(0))
    assert k1.launches > before
    lp, lim = LmpcParams.make(), SystemLimits.make(dtype=torch.float64)
    k2 = batched_nlmpc_soa.default_step_solver(
        lp, lim, 1.0, max_steps=T_ROWS, max_laps=MAX_LAPS, max_iters=NL_CAP)
    before = k2.launches
    simulate_nlmpc_runs_soa(lp, lim, scen, seed_xs, seed_us, 121, 1.0,
                            max_lm_iters=NL_CAP, **kw,
                            generator=torch.Generator(dev).manual_seed(0))
    assert k2.launches > before


# ---- the generic tier: K5 (mirroring chip_smoke.py phases 11, 11b) ----
# (model, horizon) of generic_bench.k5_task's tasks run here: the five an
# earlier fixed table held, a horizon it lacked, the caller's 3-input models
INSTANTIATIONS = [("bicycle", 6), ("double_integrator", 6),
                  ("double_integrator", 10), ("unicycle", 6), ("unicycle", 8),
                  ("double_integrator", 5), ("holonomic", 3),
                  ("holonomic", 6), ("point_mass", 6)]


def _k5_problem(name, nh, b, dev):
    """(model, K5 settings, f64 (x0, x_term, u_init)): the
    tests/test_generic_ilqr.py tasks with jittered targets, and the bicycle
    with IlqrParams costs (generic_bench.k5_task, which kernel_ab.py runs
    too)."""
    return k5_task(name, nh, b, dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,nh", INSTANTIATIONS)
def test_k5_matches_plain(dev, name, nh, dtype):
    b = 1000  # not a multiple of the 128-thread block
    model, kw, inputs = _k5_problem(name, nh, b, dev)
    a = tuple(t.to(dtype) for t in inputs)
    k5 = build_fused_generic_ilqr(model, **kw)
    got = k5(*a)
    want = fused_generic_ilqr_reference(model, *a, **kw)
    torch.cuda.synchronize()
    assert k5.launches == 1
    for g in got:
        assert bool(torch.isfinite(g.double()).all())
    assert got[3].dtype == torch.int32 and int(got[3].min()) >= 1
    same = got[3] == want[3]
    dus = (got[0] - want[0]).abs().amax(dim=(0, 1))
    tol, need = (1e-8, 0.999) if dtype == torch.float64 else (1e-4, 0.99)
    share = float((same & (dus <= tol)).double().mean())
    assert share >= need, share
    # one (n,) start state for every lane is the same as x0 spread out
    for g, h in zip(k5(a[0][:, 0].clone(), a[1], a[2]), got):
        assert torch.equal(g, h)
    with pytest.raises(TypeError):
        k5(*(t.to(torch.float16) for t in a))
    with pytest.raises(ValueError):
        k5(a[0][:, :10], *a[1:])


def test_k5_raises_where_nothing_is_instantiated(dev):
    """A model without CUDA_STEP has no kernel: a CUDA tensor raises (no
    plain fallback); any horizon of a model with one builds and runs."""
    model, kw, a = _k5_problem("bicycle", 6, 256, dev)
    plain_only = SimpleNamespace(__name__="plain_only", X_DIM=4, U_DIM=2,
                                 step_comps=model.step_comps)
    k5 = build_fused_generic_ilqr(plain_only, **kw)
    with pytest.raises(ValueError, match="no CUDA_STEP"):
        k5(*a)
    assert k5.launches == 0
    k5 = build_fused_generic_ilqr(model, **{**kw, "num_horizon": 7})
    u7 = torch.zeros((7, 2, 256), dtype=torch.float64, device=dev)
    _equal(k5(a[0], a[1], u7), k5.plain(a[0], a[1], u7))
    assert k5.launches == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,nh", [("holonomic", 3), ("holonomic", 6),
                                     ("point_mass", 6)])
def test_k5_three_inputs_match_plain_bitwise(dev, name, nh, dtype):
    """The damped-Cholesky branch (m = 3) on 4 096 lanes, every output bit
    for bit the plain version's, and the kernel's resources."""
    model, kw, inputs = k5_task(name, nh, 4096, dev)
    a = tuple(t.to(dtype) for t in inputs)
    k5 = build_fused_generic_ilqr(model, **kw)
    _equal(k5(*a), k5.plain(*a))
    assert k5.launches == 1
    att = _build.attributes(k5_library(model, nh), "k5_attributes",
                            0 if dtype == torch.float32 else 1)
    assert att["warps_per_sm"] >= 4, att


# ---- K3 and K5 bitwise against their plain versions at the edges of the
# lane queue: lanes refilled as they finish (tile.cuh launch_lanes), a grid
# of what the card holds, warps whose lanes take 1 trip or the cap ----
def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _resident_threads(entry, *sizes, lib=None):
    """Threads of a kernel the card holds at once: its resident warps an SM
    (from the CUDA runtime) x 32 x the SMs; no grid holds more
    lanes. ``lib``: the library with ``entry``, the package's by
    default."""
    att = _build.attributes(lib or _build.library(), entry, *sizes)
    return (att["warps_per_sm"] * 32
            * torch.cuda.get_device_properties(0).multi_processor_count)


def _k3_kernel_lanes(b, dtype, dev):
    """generic_bench --kernel's first b lanes (absent obstacle)."""
    x0 = torch.tensor([0.0, 0.0, 1.0, 0.0], device=dev)[:, None].expand(
        4, b).contiguous()
    xts = candidates(b, np.random.default_rng(0), dev)
    obs = obstacle_to_lanes(Obstacle.absent(device=dev), b).contiguous()
    return tuple(t.to(dtype) for t in (x0, xts, torch.zeros((N, 2, b),
                                                            device=dev), obs))


def _cap_among_one_trip(trips, b):
    """Indices of b lanes: the first lane that takes the cap, 150 trips, at
    b // 2 among lanes that take 1 trip (repeated as needed)."""
    slow = torch.nonzero(trips == 150).flatten()[:1]
    fast = torch.nonzero(trips == 1).flatten()
    assert len(slow) == 1 and len(fast) > 0
    idx = fast[torch.arange(b - 1, device=fast.device) % len(fast)]
    return torch.cat([idx[:b // 2], slow, idx[b // 2:]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_lane_at_the_cap_among_one_trip_lanes_is_bitwise(dev, dtype):
    p, l = IlqrParams.make(), SystemLimits.make()
    a = _k3_kernel_lanes(4096, dtype, dev)
    trips = ilqr_solve_soa(p, l, a[3], a[0], a[1], a[2], float(p.lamb), 1.0,
                           num_horizon=N, max_iter=150).lane_iters
    idx = _cap_among_one_trip(trips, 1000)
    a = tuple(t[..., idx].contiguous() for t in a)
    want_trips = ilqr_solve_soa(p, l, a[3], a[0], a[1], a[2],
                                float(p.lamb), 1.0, num_horizon=N,
                                max_iter=150).lane_iters
    assert sorted(want_trips.tolist()) == [1] * 999 + [150]
    k3 = build_fused_ilqr(p, l, 1.0, num_horizon=N, max_iter=150)
    got = k3(*a)
    _equal(got, fused_ilqr_reference(p, l, 1.0, *a, num_horizon=N,
                                     max_iter=150))
    assert k3.launches == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_lane_at_the_cap_among_one_trip_lanes_is_bitwise(dev, dtype):
    p, l = IlqrParams.make(), SystemLimits.make()
    k5 = build_fused_generic_ilqr(double_integrator, **generic_kwargs(
        p, l, max_iter=150, matrix_Q=np.zeros((4, 4))))
    a = tuple(t.to(dtype) for t in throughput_inputs(4096, dev))
    idx = _cap_among_one_trip(k5.plain(*a)[3], 1000)
    a = tuple(t[..., idx].contiguous() for t in a)
    got, want = k5(*a), k5.plain(*a)
    assert sorted(want[3].tolist()) == [1] * 999 + [150]
    _equal(got, want)
    assert k5.launches == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_every_lane_skipped_is_the_rollout(dev, dtype):
    p, l = IlqrParams.make(), SystemLimits.make()
    k3 = build_fused_ilqr(p, l, 1.0, num_horizon=N, max_iter=CAP)
    a = _lanes(257, dtype, dev)
    a = (a[0], a[1], torch.full_like(a[2], 0.3), a[3])
    skip = torch.ones(257, device=dev)
    got = k3(*a, skip)
    want = fused_ilqr_reference(p, l, 1.0, *a, skip, num_horizon=N,
                                max_iter=CAP)
    _equal(got, want)
    # no LM trip: the initial inputs (inside the bounds) come back
    assert torch.equal(got[0], a[2])


# B = 1, 33 (not a multiple of a warp), 1000 (all below the resident grid)
# and twice the threads the card holds (every thread refilled)
LANE_COUNTS = ["1", "33", "1000", "beyond_the_grid"]


def _lane_count(b, entry, *sizes, lib=None):
    return (2 * _resident_threads(entry, *sizes, lib=lib)
            if b == "beyond_the_grid" else int(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", LANE_COUNTS)
def test_k3_lane_counts_are_bitwise(dev, b, dtype):
    code = 0 if dtype == torch.float32 else 1
    b = _lane_count(b, "fused_ilqr_attributes", code, N)
    p, l = IlqrParams.make(), SystemLimits.make()
    k3 = build_fused_ilqr(p, l, 1.0, num_horizon=N, max_iter=CAP)
    a = _lanes(b, dtype, dev, seed=b)
    skip = (torch.arange(b, device=dev) % 7 == 3).float()
    _equal(k3(*a, skip), fused_ilqr_reference(p, l, 1.0, *a, skip,
                                              num_horizon=N, max_iter=CAP))
    _equal(k3(*a), fused_ilqr_reference(p, l, 1.0, *a, num_horizon=N,
                                        max_iter=CAP))
    assert k3.launches == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", LANE_COUNTS)
def test_k5_lane_counts_are_bitwise(dev, b, dtype):
    code = 0 if dtype == torch.float32 else 1
    b = _lane_count(b, "k5_attributes", code,
                    lib=k5_library(double_integrator, N))
    p, l = IlqrParams.make(), SystemLimits.make()
    k5 = build_fused_generic_ilqr(double_integrator, **generic_kwargs(
        p, l, max_iter=150, matrix_Q=np.zeros((4, 4))))
    a = tuple(t.to(dtype) for t in throughput_inputs(b, dev))
    _equal(k5(*a), k5.plain(*a))
    assert k5.launches == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", [*K4_EDGE_CASES, "straddle"])
def test_k4_edge_cases_are_bitwise(dev, case, dtype):
    """K4's lane queue on its edge cases (experiments/headlines.py) and,
    ``straddle``, twice the threads the card holds and 19 lanes more, those
    19 live: the last chunk of 32 lanes crosses the end of the lanes with
    live lanes in it; every output bit for bit the plain solve's."""
    if case == "straddle":
        code = 0 if dtype == torch.float32 else 1
        tail = 2 * _resident_threads("fused_lm_shooting_attributes", code, N)
        a = k4_edge_lanes("skip_74", dev, b=tail + 19)
        a[4][tail:] = 0.0
    else:
        a = k4_edge_lanes(case, dev)
    a = tuple(t.to(dtype) if t.is_floating_point() and i != 4 else t
              for i, t in enumerate(a))
    lim = SystemLimits.make(dtype=torch.float64)
    k4 = build_fused_lm_shooting(lim, 1.0, num_horizon=N, max_iters=NL_CAP)
    _equal(k4(*a), fused_lm_shooting_reference(lim, 1.0, *a, num_horizon=N,
                                               max_iters=NL_CAP))
    assert k4.launches == 1


# ---- the per-candidate path: K3 under the i2LQR simulator, K4 under the
# NLMPC one (chip_smoke.py phases 22-24) ----
CANDIDATE_PATHS = {
    "i2lqr": None, "spaceVarying": {}, "timeVarying": dict(
        ss_option="timeVarying"),
    "spaceVarying_every_lap": dict(all_ss_iter=True),
    "timeVarying_every_lap": dict(ss_option="timeVarying", all_ss_iter=True)}


def _candidate_run(dev, path, dtype, b=64, **kw):
    """Two learning laps of ``path`` on the card with plant noise from a
    generator, through the simulator's per-candidate path and K3 / K4
    (built here), or as ``kw`` says."""
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((T_ROWS, 4)), np.zeros((T_ROWS, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0), b,
        noise_on=True, dtype=dtype, device=dev)
    run_kw = dict(num_laps=2, max_steps=T_ROWS, max_laps=MAX_LAPS,
                  generator=torch.Generator(dev).manual_seed(3))
    run_kw.update(kw)
    if path == "i2lqr":
        p, l = IlqrParams.make(), SystemLimits.make()
        run_kw.setdefault("candidate_solver", build_fused_ilqr(
            p, l, 1.0, num_horizon=N, max_iter=CAP))
        return simulate_learning_runs_soa(p, l, scen, seed_xs, None, 121,
                                          1.0, solver_max_iter=CAP, **run_kw)
    p, lim = LmpcParams.make(**CANDIDATE_PATHS[path]), SystemLimits.make(
        dtype=torch.float64)
    run_kw.setdefault("candidate_solver", build_fused_lm_shooting(
        lim, 1.0, num_horizon=N, max_iters=NL_CAP))
    return simulate_nlmpc_runs_soa(p, lim, scen, seed_xs, seed_us, 121, 1.0,
                                   max_lm_iters=NL_CAP, infeasible_retire=8,
                                   **run_kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("path", sorted(CANDIDATE_PATHS))
def test_candidate_steps_match_the_plain_steps_on_captured_inputs(
        dev, path, dtype):
    """On the inputs of a run through K3 / K4 (the plain step's, captured at
    step 7 of each lap), the per-candidate step equals the plain step with
    the plain solve on the card, bit for bit."""
    from ilqr_iterative_tasks_torch.experiments.headlines import tap_step
    nlmpc = path != "i2lqr"
    module, name, at = ((batched_nlmpc_soa, "nlmpc_step_reference", 6)
                        if nlmpc else (batched_soa, "i2lqr_step_reference",
                                       5))
    every = "every_lap" in path
    with tap_step(module, name, at, lambda lap, i, a: i == 7,
                  all_iter=every) as tap:
        res = _candidate_run(dev, path, dtype)
    assert sum(tap.calls.values()) > 0 and bool(res.lap_done.any())
    p = (LmpcParams.make(**CANDIDATE_PATHS[path]) if nlmpc
         else IlqrParams.make())
    lim = SystemLimits.make(dtype=torch.float64) if nlmpc else \
        SystemLimits.make()
    kernel = (build_fused_lm_shooting(lim, 1.0, num_horizon=N,
                                      max_iters=NL_CAP) if nlmpc
              else build_fused_ilqr(p, lim, 1.0, num_horizon=N, max_iter=CAP))
    step = (lambda *a, **kw: nlmpc_step_reference(
        p, lim, 1.0, *a, max_iters=NL_CAP, **kw)) if nlmpc else (
        lambda *a, **kw: i2lqr_step_reference(p, lim, 1.0, *a, max_iter=CAP,
                                              **kw))
    checked = 0
    for args in tap.captured.values():  # the first capture a lap
        got = step(*args[1], candidate_solver=kernel)
        want = step(*args[1])
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        checked += 1
    assert checked == 2 and kernel.launches > 0
    if every:  # lap 2's step reads both stored laps, through one launch
        assert int(tap.captured[2][1][7].sum()) == 2


@pytest.mark.parametrize("path", sorted(CANDIDATE_PATHS))
def test_candidate_path_runs_as_the_plain_path(dev, path):
    """A run through K3 / K4 equals the same run with the plain step and
    its plain solve on the card (the yardstick, outside the guard), bit for
    bit; inside the guard no plain solve sees a card tensor."""
    from ilqr_iterative_tasks_torch.experiments.headlines import (
        no_plain_solve_on_card)
    with no_plain_solve_on_card():
        got = _candidate_run(dev, path, torch.float32)
    if path == "i2lqr":
        p, l = IlqrParams.make(), SystemLimits.make()
        k1 = build_fused_i2lqr_step(p, l, 1.0, num_horizon=N,
                                    max_steps=T_ROWS, max_laps=MAX_LAPS,
                                    max_iter=CAP)
        plain = PlainStep(k1, ("k", "nsi", "num_horizon", "max_steps",
                               "max_laps", "max_iter"),
                          lambda *a: i2lqr_step_reference(p, l, 1.0, *a,
                                                          max_iter=CAP))
    else:
        p = LmpcParams.make(**CANDIDATE_PATHS[path])
        lim = SystemLimits.make(dtype=torch.float64)
        plain = PlainStep(SimpleNamespace(
            k=p.num_ss_points, nsi=p.num_ss_iter, num_horizon=N,
            max_steps=T_ROWS, max_laps=MAX_LAPS, max_iters=NL_CAP,
            mode=p.ss_mode, all_iter=p.all_ss_iter), (
                "k", "nsi", "num_horizon", "max_steps", "max_laps",
                "max_iters", "mode", "all_iter"),
            lambda *a: nlmpc_step_reference(p, lim, 1.0, *a,
                                            max_iters=NL_CAP))
    want = _candidate_run(dev, path, torch.float32, candidate_solver=None,
                          step_solver=plain)
    for name in ("lap_steps", "lap_done", "final_x"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for a, b in zip(got.safe_set, want.safe_set):
        assert torch.equal(a, b)
    # the guard catches a plain solve on the card: the plain step as a
    # simulator's step solver raises inside it
    from ilqr_iterative_tasks_torch.experiments.headlines import (
        no_plain_solve_on_card as guard)
    with guard(), pytest.raises(AssertionError, match="on the card"):
        _candidate_run(dev, path, torch.float32, candidate_solver=None,
                       step_solver=plain, num_laps=1)


def test_every_stored_lap_launches_the_default_k4(dev):
    """With no solver, the NLMPC simulator on the card serves the kNN over
    every stored lap with its own K4 (no K2 serves it), and never the plain
    solve."""
    from ilqr_iterative_tasks_torch.experiments.headlines import (
        no_plain_solve_on_card)
    lim = SystemLimits.make(dtype=torch.float64)
    k4 = batched_nlmpc_soa.default_candidate_solver(
        lim, 1.0, num_horizon=N, max_iters=NL_CAP)
    before = k4.launches
    with no_plain_solve_on_card():
        _candidate_run(dev, "spaceVarying_every_lap", torch.float32,
                       candidate_solver=None, num_laps=1)
    assert k4.launches > before
    assert batched_nlmpc_soa.default_candidate_solver(
        lim, 1.0, num_horizon=N, max_iters=NL_CAP) is k4


@pytest.mark.parametrize("kind", ["generator", "noise"])
@pytest.mark.parametrize("path", ["i2lqr", "spaceVarying"])
def test_resume_is_exact_on_the_card(dev, path, kind, tmp_path):
    """2 laps, a checkpoint and 2 more equal 4 laps in one run, bit for
    bit, through the simulators' own K1 / K2."""
    from ilqr_iterative_tasks_torch.utils.checkpoint import (
        load_soa_run, save_soa_run)

    def noise_kw():
        if kind == "generator":
            return dict(generator=torch.Generator(dev).manual_seed(5))
        return dict(generator=None, noise=torch.randn(
            (4 * 121, 2, 256), dtype=torch.float32, device=dev,
            generator=torch.Generator(dev).manual_seed(5)))

    run = lambda laps, **kw: _candidate_run(
        dev, path, torch.float32, b=256, candidate_solver=None,
        num_laps=laps, **kw)
    whole = run(4, **noise_kw())
    part = run(2, **noise_kw())
    save_soa_run(str(tmp_path / "run.npz"), part)
    ck, steps, done = load_soa_run(str(tmp_path / "run.npz"), device=dev)
    rest_kw = noise_kw()
    if kind == "generator":
        rest_kw["generator"].manual_seed(11)  # the checkpoint sets it
    rest = run(2, resume_from=ck, **rest_kw)
    assert torch.equal(torch.cat([torch.as_tensor(steps, device=dev),
                                  rest.lap_steps]), whole.lap_steps)
    assert torch.equal(torch.cat([torch.as_tensor(done, device=dev),
                                  rest.lap_done]), whole.lap_done)
    assert torch.equal(rest.final_x, whole.final_x)
    for a, b in zip(rest.safe_set, whole.safe_set):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["i2lqr", "nlmpc", "nlmpc_hzn3"])
def test_host_controller_step_on_the_card_matches_the_cpu(dev, kind):
    """One calc_input of a host controller (control/i2lqr.py through K3,
    control/nlmpc.py through K4) on the card and on the CPU (the kernels'
    plain versions), f64, from a state of the seed lap: the same inputs
    and predicted states (1e-8) and the same shrink, with three K3
    launches (one a relaxation pass) or one K4 launch on the card.
    ``nlmpc_hzn3`` shrinks the NLMPC horizon to 3 with a matching warm
    start, so the N = 6 K4 solves with hzn = 3 lanes and a zero-padded
    warm start."""
    from ilqr_iterative_tasks_torch.control.i2lqr import I2LqrController
    from ilqr_iterative_tasks_torch.control.nlmpc import NlmpcController
    from ilqr_iterative_tasks_torch.experiments.runner import (
        default_obstacle)
    f64 = torch.float64
    xcl, ucl = seed_trajectory(1.0)
    ctrls = {}
    for d in (dev, torch.device("cpu")):
        if kind == "i2lqr":
            c = I2LqrController(IlqrParams.make(dtype=f64, device=d),
                                obstacle=default_obstacle(1.0), dtype=f64,
                                device=d)
        else:
            c = NlmpcController(LmpcParams.make(device=d),
                                obstacle=default_obstacle(1.0), dtype=f64,
                                device=d)
        c.add_trajectory(xcl, ucl)
        c.set_timestep(1.0)
        if kind == "nlmpc_hzn3":
            c.num_horizon = 3
            c.x_guess = np.concatenate([xcl[10:14].flatten(),
                                        ucl[10:13].flatten()])
            c.x_terminal_guess = xcl[13].copy()
        c.set_state(xcl[10])
        c.calc_input()
        ctrls[d.type] = c
    card, cpu = ctrls["cuda"], ctrls["cpu"]
    for name in ("u", "x_pred", "u_pred", "x_terminal_guess"):
        np.testing.assert_allclose(getattr(card, name), getattr(cpu, name),
                                   rtol=0, atol=1e-8)
    assert card.num_horizon == cpu.num_horizon
    if kind == "nlmpc_hzn3":
        assert card.x_pred.shape == (4, 4) and card.u_pred.shape == (2, 3)
    kernels = card._k3 if kind == "i2lqr" else card._k4
    assert sum(k.launches for k in kernels.values()) == (
        3 if kind == "i2lqr" else 1)
    assert card.launch_lanes == cpu.launch_lanes


def test_sharded_knn_on_the_card_is_the_cpu_s(dev):
    """``sharded_knn`` over a one-rank mesh (no process group) on CUDA
    tensors gives the CPU's rows, points and distances, ties ordered by row
    (a stable sort on the card), f32 and f64."""
    from ilqr_iterative_tasks_torch.parallel.mesh import make_mesh
    from ilqr_iterative_tasks_torch.parallel.sharded_safe_set import (
        sharded_knn)
    rng = np.random.default_rng(4)
    grid = rng.integers(-3, 4, (32, 4)).astype(float)
    states = grid[np.arange(256) % 32]
    valid = rng.random(256) > 0.2
    for dtype in (torch.float32, torch.float64):
        args = [torch.tensor(states, dtype=dtype),
                torch.tensor(valid), torch.arange(256.0, dtype=dtype),
                torch.tensor(grid[5] + 0.5, dtype=dtype)]
        cpu = sharded_knn(*args, 8, make_mesh())
        card = sharded_knn(*(a.to(dev) for a in args), 8, make_mesh())
        for c, g in zip(cpu, card):
            assert torch.equal(c, g.cpu())
        assert len(set(cpu[3].tolist())) < 8  # ties among the 8


def test_one_rank_sharded_run_on_the_card_is_the_unsharded_run(dev):
    """The ``_sharded`` NLMPC wrapper over a one-rank mesh on the card, 2
    laps on a generator, through the simulator's own K2: the unsharded
    run's lap records and generator state, bit for bit."""
    from ilqr_iterative_tasks_torch.parallel.mesh import make_mesh
    from ilqr_iterative_tasks_torch.parallel.sharded_soa import (
        simulate_nlmpc_runs_soa_sharded)
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((T_ROWS, 4)), np.zeros((T_ROWS, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    scen = SoaScenarios.broadcast(np.zeros(4), xcl[-1], Obstacle.make(
        31.0, -2.0, 8.0, 6.0, device=dev), 256, noise_on=True, device=dev)
    args = (LmpcParams.make(device=dev),
            SystemLimits.make(dtype=torch.float64, device=dev), scen,
            seed_xs, seed_us, 121, 1.0)
    kw = dict(num_laps=2, max_steps=T_ROWS, max_laps=MAX_LAPS,
              max_lm_iters=12, infeasible_retire=8)
    want = simulate_nlmpc_runs_soa(
        *args, generator=torch.Generator(dev).manual_seed(5), **kw)
    got = simulate_nlmpc_runs_soa_sharded(
        *args, make_mesh(), generator=torch.Generator(dev).manual_seed(5),
        **kw)
    for g, w in zip((got.lap_steps, got.lap_done, got.final_x,
                     *got.safe_set), (want.lap_steps, want.lap_done,
                                      want.final_x, *want.safe_set)):
        assert torch.equal(g, w)
    assert torch.equal(got.final_key, want.final_key)


# K1 at k = 8 with its options (dedup, qsort_skip, with_stats) and K2's
# with_stats on the card, as tests/test_torch_k1_options.py,
# tests/test_torch_k2_stats.py and tests/test_torch_kernels_host.py hold
# their plain versions on the CPU
K1_OPTION_CASES = [(1, 3, dict(with_stats=True)), (1, 3, dict(dedup=True)),
                   (1, 3, dict(qsort_skip=True, with_stats=True)),
                   (1, 3, dict(dedup=True, qsort_skip=True,
                               with_stats=True)),
                   (1, 1, dict(dedup=True, qsort_skip=True,
                               with_stats=True)),
                   (2, 3, dict(dedup=True, with_stats=True)),
                   (2, 1, dict(dedup=True, with_stats=True))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nsi,lap_count,options", K1_OPTION_CASES)
def test_k1_options_match_plain_bitwise(dev, nsi, lap_count, options,
                                        dtype):
    """Outputs bit for bit the plain order's, counts integer for integer
    the plain version's on the card (queue_floor at the factory's 32 lanes
    and at JAX's tile of 128; qsort_skip's lane queue's iters_executed by
    its invariants)."""
    from ilqr_iterative_tasks_torch.experiments.headlines import (
        k1_option_lanes)
    p = IlqrParams.make(num_ss_iter=nsi, dtype=dtype, device=dev)
    lim = SystemLimits.make(dtype=dtype, device=dev)
    a = k1_option_lanes(nsi, lap_count, dev, b=517, dtype=dtype)
    for width in (32, 128):
        k1 = build_fused_i2lqr_step(p, lim, 1.0, num_horizon=N,
                                    max_steps=T_ROWS, max_laps=MAX_LAPS,
                                    max_iter=CAP, floor_width=width,
                                    **options)
        got = k1(*a)
        assert k1.launches == 1
        want = i2lqr_step_reference(p, lim, 1.0, *a, max_iter=CAP,
                                    floor_width=width, **options)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype
            if i == 5 and options.get("qsort_skip"):
                live = a[8] < 0.5
                assert bool((g >= got[4]).all())
                assert int(g[~live].abs().sum()) == 0
            else:
                assert torch.equal(g, w), i


@pytest.mark.parametrize("mode,nsi,lap_count,qsort", [
    ("spaceVarying", 1, 2, False), ("spaceVarying", 1, 2, True),
    ("timeVarying", 1, 2, False), ("timeVarying", 1, 2, True),
    ("spaceVarying", 2, 2, False), ("timeVarying", 2, 1, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_counts_match_plain(dev, mode, nsi, lap_count, qsort, dtype):
    """K2 with_stats: outputs bit for bit K2's without counts and the plain
    step's on the card, useful and executed integer for integer."""
    from ilqr_iterative_tasks_torch.experiments.headlines import (
        k2_option_lanes)
    p = LmpcParams.make(num_ss_iter=nsi, ss_option=mode, dtype=dtype,
                        device=dev)
    lim = SystemLimits.make(dtype=torch.float64, device=dev)
    a = k2_option_lanes(nsi, lap_count, dev, b=517, dtype=dtype)
    args = a if mode == "timeVarying" else a[:11]
    sizes = dict(num_horizon=N, max_steps=a[3].shape[1],
                 max_laps=a[3].shape[0], max_iters=12, qsort_skip=qsort)
    got = build_fused_nlmpc_step(p, lim, 1.0, with_stats=True, **sizes)(*args)
    plain = build_fused_nlmpc_step(p, lim, 1.0, **sizes)(*args)
    for g, w in zip(got[:6], plain):
        assert torch.equal(g, w)
    want = nlmpc_step_reference(p, lim, 1.0, *args, max_iters=12,
                                qsort_skip=qsort, with_stats=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_closed_loop_through_a_counting_k1_keeps_the_records(dev):
    """The simulator through K1 with dedup, qsort_skip and with_stats
    hashes as through K1 without options (2 laps, B = 256, f32, injected
    noise), and its iter_stats are populated."""
    from ilqr_iterative_tasks_torch.experiments.headlines import (
        lap_records_hash)
    p = IlqrParams.make(device=dev)
    lim = SystemLimits.make(device=dev)
    xcl, _ = seed_trajectory(1.0)
    seed = np.zeros((T_ROWS, 4))
    seed[:121] = xcl
    b = 256
    scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0, device=dev),
        b, noise_on=True, device=dev)
    noise = torch.tensor(np.random.default_rng(2).normal(size=(400, 2, b)),
                         dtype=torch.float32, device=dev)
    kw = dict(num_laps=2, max_steps=T_ROWS, max_laps=MAX_LAPS,
              solver_max_iter=CAP, noise=noise)
    sizes = dict(num_horizon=N, max_steps=T_ROWS, max_laps=MAX_LAPS,
                 max_iter=CAP)
    runs = [simulate_learning_runs_soa(
        p, lim, scen, seed, np.zeros((T_ROWS, 2)), 121, 1.0,
        step_solver=build_fused_i2lqr_step(p, lim, 1.0, **sizes, **o), **kw)
        for o in ({}, dict(dedup=True, qsort_skip=True, with_stats=True))]
    assert lap_records_hash(runs[0]) == lap_records_hash(runs[1])
    useful, executed, floor = runs[1].iter_stats
    assert bool((useful <= executed).all()) and int(useful.min()) > 0


def test_k1_runs_the_lane_queue_where_the_batch_fills_the_card(dev):
    """qsort_skip without counts runs the lane queue only on a batch of at
    least the lanes the card holds at one thread a lane (the headline's
    49 152 lanes; phase 6b of chip_smoke.py runs it there); below it the
    plain order, the same bits."""
    from ilqr_iterative_tasks_torch.experiments.headlines import (
        k1_option_lanes)
    p = IlqrParams.make(device=dev)
    lim = SystemLimits.make(device=dev)
    k1 = build_fused_i2lqr_step(p, lim, 1.0, num_horizon=N,
                                max_steps=T_ROWS, max_laps=MAX_LAPS,
                                max_iter=CAP, dedup=True, qsort_skip=True)
    assert not k1.lane_queue_runs(517, dev, torch.float32)
    assert k1.lane_queue_runs(49152, dev, torch.float32)
    a = k1_option_lanes(1, 3, dev, b=517, dtype=torch.float32)
    got = k1(*a)
    want = i2lqr_step_reference(p, lim, 1.0, *a, max_iter=CAP)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
