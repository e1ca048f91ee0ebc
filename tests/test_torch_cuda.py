"""The CUDA kernels K1 and K3 against their plain torch versions on the card.

Marked ``cuda``: each test skips without a CUDA device. On a machine with
one, run ``python -m pytest tests/test_torch_cuda.py -q --noconftest``
(tests/conftest.py sets up JAX, which these tests do not use).
"""

import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_torch.control.batched_soa import (
    SoaScenarios, _step_solver_inputs, simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
    build_fused_ilqr, fused_ilqr_reference, obstacle_to_lanes)
from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
    build_fused_i2lqr_step, i2lqr_step_reference)
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits

pytestmark = pytest.mark.cuda
N, CAP, T_ROWS, MAX_LAPS = 6, 16, 128, 8


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
    want = simulate_learning_runs_soa(p, l, scen, seed_xs, None, 121, 1.0,
                                      **kw)
    assert k1.launches > 0
    assert torch.equal(got.lap_steps, want.lap_steps)
    torch.testing.assert_close(got.safe_set[0], want.safe_set[0], rtol=0,
                               atol=1e-9)
