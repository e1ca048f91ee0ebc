"""The port's native_bindings.py (the C++ host runner, native/*.cpp)
against the port's host solvers, the five checks of tests/test_native.py:
the bicycle step (models/kinetic_bicycle.py), the iLQR solve (ops/ilqr.py)
with a static, a moving and no obstacle, the LM-shooting feasibility
verdicts (ops/lm_shooting.py), and the whole native i2LQR and NLMPC
closed-loop runs against the pinned host laps. The library builds into
build/native/, never over the committed native/libilqr_native.so. Skips
without a C++ toolchain, as tests/test_native.py does."""

import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_torch.models import kinetic_bicycle as dyn
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.ilqr import ilqr_solve, rollout
from ilqr_iterative_tasks_torch.ops.lm_shooting import lm_feasibility_solve
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, LmpcParams, SystemLimits)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

F64 = torch.float64
# us and xs of the iLQR solve: the C++ solve and the port's round in
# different orders, and the LM iterations carry the difference to up to
# 2.2e-11 in us and 1.1e-10 in xs (|xs| up to ~25) on these cases; a build
# without FMA contraction (-ffp-contract=off) gives 1.9e-11 / 1.8e-10, so
# the gap is the solve's and not the compiler's. tests/test_native.py
# holds JAX's at 1e-9 / 1e-8
US_TOL, XS_TOL = 5e-11, 3e-10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "native", "libilqr_native.so")
# the host i2LQR controller's f64 laps in the CI configuration (the JAX
# package's parallel sweep; chip_smoke.py's HOST_I2LQR_F64_LAPS)
HOST_I2LQR_LAPS = [55, 28, 23, 23, 23]


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def nb():
    from ilqr_iterative_tasks_torch import native_bindings
    before = _digest(COMMITTED)
    lib = native_bindings.build()
    assert lib == os.path.join(REPO, "build", "native", "libilqr_native.so")
    assert os.path.exists(lib)
    assert _digest(COMMITTED) == before
    return native_bindings


def _params():
    return (IlqrParams.make(dtype=F64, device="cpu"),
            SystemLimits.make(dtype=F64, device="cpu"))


def test_native_step_matches_the_port(nb):
    rng = np.random.default_rng(0)
    for _ in range(10):
        x, u = rng.normal(size=4), rng.normal(size=2)
        got = nb.bicycle_step_native(x, u, 0.7)
        want = dyn.step(torch.tensor(x), torch.tensor(u), 0.7).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)


@pytest.mark.parametrize("obstacle_kind", ["static", "moving_up", "absent"])
def test_native_ilqr_matches_the_port(nb, obstacle_kind):
    params, limits = _params()
    if obstacle_kind == "static":
        obs = Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=F64, device="cpu")
    elif obstacle_kind == "moving_up":
        obs = Obstacle.make(31.0, -2.0, 8.0, 6.0, spd=1.0, moving_option=1,
                            dtype=F64, device="cpu")
    else:
        obs = Obstacle.absent(dtype=F64, device="cpu")
    x0 = torch.zeros(4, dtype=F64)
    rng = np.random.default_rng(1)
    for _ in range(5):
        xt = torch.tensor(rng.uniform(0, 25, 4), dtype=F64)
        u0 = torch.zeros((6, 2), dtype=F64)
        sol = ilqr_solve(params, limits, obs, x0, xt, u0, 1.0, 1.0,
                         num_horizon=6)
        us_n, xs_n, lamb_n, it_n = nb.ilqr_solve_native(
            params, limits, obs, x0, xt, u0, 1.0, 1.0)
        assert it_n == int(sol.n_iters)
        assert lamb_n == pytest.approx(float(sol.lamb), rel=1e-12)
        np.testing.assert_allclose(us_n, sol.us.numpy(), rtol=0,
                                   atol=US_TOL)
        np.testing.assert_allclose(xs_n, sol.xs.numpy(), rtol=0,
                                   atol=XS_TOL)


def test_native_lm_feasibility_agrees(nb):
    _, limits = _params()
    obs = Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=F64, device="cpu")
    x0 = torch.zeros(4, dtype=F64)
    us_true = torch.tensor([[2, 0.35], [2, 0.1], [2, -0.15], [2, -0.2],
                            [2, -0.1], [2, 0.0]], dtype=F64)
    x_term = rollout(x0, us_true, 1.0)[-1]
    sol = lm_feasibility_solve(limits, obs, x0, x_term, us_true + 0.1, 1.0,
                               num_horizon=6)
    _, _, err_n, viol_n, feas_n = nb.lm_feasibility_solve_native(
        limits, obs, x0, x_term, us_true + 0.1, 1.0)
    assert bool(sol.feasible) and feas_n
    assert err_n <= 1e-4 and viol_n <= 1e-4
    # an unreachable target: both infeasible
    far = torch.tensor([200.0, 0.0, 0.0, 0.0], dtype=F64)
    sol2 = lm_feasibility_solve(limits, obs, x0, far,
                                torch.zeros((6, 2), dtype=F64), 1.0,
                                num_horizon=6)
    _, _, _, _, feas2 = nb.lm_feasibility_solve_native(
        limits, obs, x0, far, np.zeros((6, 2)), 1.0)
    assert not bool(sol2.feasible) and not feas2


def test_native_full_closed_loop_matches_the_host_laps(nb):
    """The whole C++ i2LQR learning run (f64, CI obstacle, goal appended)
    within one step of the host controller's laps."""
    params, limits = _params()
    obs = Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=F64, device="cpu")
    steps, completed = nb.run_i2lqr_closed_loop_native(params, limits, obs,
                                                       5)
    assert completed == 5
    for got, want in zip(steps, HOST_I2LQR_LAPS):
        assert abs(got - want) <= 1, steps


def test_native_nlmpc_closed_loop(nb):
    """The whole C++ NLMPC run converges monotonically to the host
    controller's 22-23-step laps (its LM uses a finite-difference
    Jacobian, so it may differ from the host by a step)."""
    _, limits = _params()
    obs = Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=F64, device="cpu")
    steps, completed = nb.run_nlmpc_closed_loop_native(
        LmpcParams.make(ss_option="spaceVarying", device="cpu"), limits,
        obs, 5)
    assert completed == 5
    assert all(a >= b for a, b in zip(steps, steps[1:])), steps
    assert steps[0] <= 40 and steps[-1] <= 24, steps
