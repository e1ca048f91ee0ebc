"""The i2LQR host tier of the port against the JAX package's, in f64 on the
CPU: the cost stack (and its derivatives against torch.autograd), the AoS
LM-iLQR solve and its candidate sweeps, the relaxed reach cost, one
``calc_input`` of the host controller from several states (the K3 sweep's
CPU route and the sequential-lambda sweep, the horizon-1 branch, replay and
its exhaustion), one zero-noise learning lap, and the demo CLI. The
five-lap runs mirror the JAX package's own ``slow`` tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_torch.control.i2lqr import (
    I2LqrController, relaxed_reach_cost)
from ilqr_iterative_tasks_torch.experiments import ilqr_test
from ilqr_iterative_tasks_torch.experiments.runner import (
    default_obstacle, run_closed_loop)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops import costs, ilqr
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits
from ilqr_iterative_tasks_tpu.control import i2lqr as jax_i2lqr
from ilqr_iterative_tasks_tpu.experiments import runner as jax_runner
from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JaxObstacle
from ilqr_iterative_tasks_tpu.ops import costs as jax_costs
from ilqr_iterative_tasks_tpu.ops import ilqr as jax_ilqr
from ilqr_iterative_tasks_tpu.utils.params import IlqrParams as JaxParams
from ilqr_iterative_tasks_tpu.utils.params import SystemLimits as JaxLimits

F64 = torch.float64
TOL = 1e-8
XCL, UCL = seed_trajectory(1.0)
# (x, y, width, height, spd, moving_option): static, moving up, moving
# left, absent (present=False)
OBSTACLES = {"static": (31.0, -2.0, 8.0, 6.0, 0.0, 0),
             "up": (28.0, -9.0, 8.0, 6.0, 1.0, 1),
             "left": (40.0, -1.0, 8.0, 6.0, 0.8, 2),
             "absent": None}


def _obstacles(kind):
    spec = OBSTACLES[kind]
    if spec is None:
        return (Obstacle.absent(dtype=F64, device="cpu"),
                JaxObstacle.absent(dtype=jnp.float64))
    x, y, w, h, spd, opt = spec
    return (Obstacle.make(x, y, w, h, spd=spd, moving_option=opt, dtype=F64,
                          device="cpu"),
            JaxObstacle.make(x, y, w, h, spd=spd, moving_option=opt,
                             dtype=jnp.float64))


def _params(**static):
    return (IlqrParams.make(dtype=F64, device="cpu", **static),
            JaxParams.make(dtype=jnp.float64, **static))


def _limits():
    return (SystemLimits.make(dtype=F64, device="cpu"),
            JaxLimits.make(dtype=jnp.float64))


def _close(ours, theirs, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(ours).numpy(),
                               np.asarray(theirs), rtol=0, atol=tol)


T = lambda a: torch.tensor(np.asarray(a), dtype=F64)
J = lambda a: jnp.asarray(np.asarray(a), dtype=jnp.float64)


@pytest.mark.parametrize("kind", ["static", "up", "left", "absent"])
def test_costs_match_jax_and_autograd(kind):
    rng = np.random.default_rng(0)
    (p, jp), (lim, jlim), (obs, jobs) = _params(), _limits(), _obstacles(kind)
    xs = XCL[20:27] + rng.normal(size=(7, 4))
    us = rng.uniform(-2.5, 2.5, size=(6, 2))
    xt = XCL[30] + rng.normal(size=4)
    xtarget = rng.normal(size=4) * 0.1
    for got, want in zip(
            costs.control_barrier_derivs(T(us), p, lim),
            jax_costs.control_barrier_derivs(J(us), jp, jlim)):
        _close(got, want, 1e-10)
    off = np.arange(6.0)
    for got, want in zip(
            costs.obstacle_barrier_derivs(T(xs[:6, 0]), T(xs[:6, 1]), T(off),
                                          obs, p),
            jax_costs.obstacle_barrier_derivs(J(xs[:6, 0]), J(xs[:6, 1]),
                                              J(off), jobs, jp)):
        _close(got, want, 1e-10)
    for got, want in zip(
            costs.stage_cost_derivs(T(xs[:6]), T(us), T(xtarget), obs, p,
                                    lim),
            jax_costs.stage_cost_derivs(J(xs[:6]), J(us), J(xtarget), jobs,
                                        jp, jlim)):
        _close(got, want, 1e-10)
    for got, want in zip(
            costs.terminal_cost_derivs(T(xs[-1]), T(xt), obs, p),
            jax_costs.terminal_cost_derivs(J(xs[-1]), J(xt), jobs, jp)):
        _close(got, want, 1e-10)
    _close(costs.trajectory_cost(T(xs), T(us), T(xt), T(xtarget), p),
           jax_costs.trajectory_cost(J(xs), J(us), J(xt), J(xtarget), jp),
           1e-9)

    # derivatives against torch.autograd, as tests/test_costs.py does for
    # JAX: the input barriers exactly, the obstacle barrier's gradient
    def ctrl_barrier(u):
        q1, q2 = p.tuning_ctrl_q1, p.tuning_ctrl_q2
        c = torch.stack([u[0] - lim.a_max, -lim.a_max - u[0],
                         u[1] - lim.delta_max_r, -lim.delta_max_r - u[1]])
        return torch.sum(q1 * torch.exp(q2 * c))

    for u in T(us):
        b_dot, b_ddot = costs.control_barrier_derivs(u, p, lim)
        _close(b_dot, torch.func.grad(ctrl_barrier)(u), 1e-9)
        _close(b_ddot, torch.autograd.functional.hessian(ctrl_barrier, u),
               1e-9)

    def obs_barrier(pos, i):
        cx, cy = obs.center_at(i)
        h = (1.0 + p.safety_margin - ((pos[0] - cx) ** 2 / obs.width ** 2
                                      + (pos[1] - cy) ** 2 / obs.height ** 2))
        return obs.present * p.tuning_obs_q1 * torch.exp(p.tuning_obs_q2 * h)

    for i in (0.0, 3.0):
        pos = T(xs[2, :2])
        b_dot, b_ddot = costs.obstacle_barrier_derivs(pos[0], pos[1], T(i),
                                                      obs, p)
        g = torch.func.grad(obs_barrier)(pos, T(i))
        _close(b_dot[:2], g, 1e-9)
        _close(b_dot[2:], np.zeros(2), 0.0)
        # Gauss-Newton Hessian q1 q2^2 e^{q2 h} h' h'^T = q2 g g^T / b
        b = obs_barrier(pos, T(i))
        if float(b) > 0:
            _close(b_ddot[:2, :2], p.tuning_obs_q2 * torch.outer(g, g) / b,
                   1e-9)
        else:
            _close(b_ddot, np.zeros((4, 4)), 0.0)


def test_reg_inv_2x2_matches_jax_and_eig_oracle():
    rng = np.random.default_rng(1)
    mats = [m @ m.T - s * np.eye(2) for m, s in
            zip(rng.normal(size=(20, 2, 2)), rng.uniform(-1, 3, size=20))]
    # degenerate eigenvalues: multiples of I, and zero
    mats += [3.0 * np.eye(2), -2.0 * np.eye(2), np.zeros((2, 2))]
    for lamb in (1.0, 1e-3):
        for m in mats:
            got = ilqr._reg_inv_2x2(T(m), lamb)
            _close(got, jax_ilqr._reg_inv_2x2(J(m), lamb), 1e-12)
            e, v = np.linalg.eigh(m)
            want = v @ np.diag(1.0 / (np.maximum(e, 0.0) + lamb)) @ v.T
            _close(got, want, 1e-9)


@pytest.mark.parametrize("kind", ["static", "absent"])
def test_backward_pass_matches_jax(kind):
    rng = np.random.default_rng(2)
    (p, jp), (lim, jlim), (obs, jobs) = _params(), _limits(), _obstacles(kind)
    us = rng.uniform(-1, 1, size=(6, 2))
    xs = ilqr.rollout(T(XCL[22]), T(us), 1.0)
    xt = XCL[30]
    for lamb in (1.0, 1e-2):
        got = ilqr.backward_pass(xs, T(us), T(xt), torch.zeros(4, dtype=F64),
                                 lamb, obs, p, lim, 1.0)
        want = jax_ilqr.backward_pass(J(xs), J(us), J(xt), jnp.zeros(4),
                                      lamb, jobs, jp, jlim, 1.0)
        for g, w in zip(got, want):
            _close(g, w, 1e-9)
        _close(xs, jax_ilqr.rollout(J(XCL[22]), J(us), 1.0), 1e-12)


def _candidates(seed):
    rng = np.random.default_rng(seed)
    x0 = XCL[20] + rng.normal(size=4) * [0.5, 0.5, 0.2, 0.05]
    xts = XCL[24:32] + rng.normal(size=(8, 4)) * 0.5
    return x0, xts


@pytest.mark.parametrize("kind", ["static", "up", "left", "absent"])
def test_ilqr_solve_matches_jax(kind):
    (p, jp), (lim, jlim), (obs, jobs) = _params(), _limits(), _obstacles(kind)
    x0, xts = _candidates(3)
    u0 = np.zeros((6, 2))
    for xt in xts[:3]:
        got = ilqr.ilqr_solve(p, lim, obs, T(x0), T(xt), T(u0), 1.0, 1.0,
                              num_horizon=6)
        want = jax_ilqr.ilqr_solve(jp, jlim, jobs, J(x0), J(xt), J(u0), 1.0,
                                   1.0, num_horizon=6)
        _close(got.us, want.us)
        _close(got.xs, want.xs)
        assert int(got.n_iters) == int(want.n_iters)
        assert float(got.lamb) == pytest.approx(float(want.lamb), rel=1e-12)
        _close(got.cost, want.cost, 1e-8 * max(1.0, abs(float(want.cost))))


@pytest.mark.parametrize("sweep", ["parallel", "sequential"])
def test_candidate_sweeps_match_jax(sweep):
    (p, jp), (lim, jlim), (obs, jobs) = (_params(), _limits(),
                                         _obstacles("static"))
    x0, xts = _candidates(4)
    fn, jfn = {"parallel": (ilqr.ilqr_solve_candidates,
                            jax_ilqr.ilqr_solve_candidates),
               "sequential": (ilqr.ilqr_solve_candidates_seq,
                              jax_ilqr.ilqr_solve_candidates_seq)}[sweep]
    got = fn(p, lim, obs, T(x0), T(xts), torch.zeros((6, 2), dtype=F64),
             1.0, 1.0, num_horizon=6)
    want = jfn(jp, jlim, jobs, J(x0), J(xts), jnp.zeros((6, 2)), 1.0, 1.0,
               num_horizon=6)
    _close(got.us, want.us)
    _close(got.xs, want.xs)
    np.testing.assert_array_equal(got.n_iters.numpy(), np.asarray(want.n_iters))
    np.testing.assert_allclose(got.lamb.numpy(), np.asarray(want.lamb),
                               rtol=1e-12)


def test_relaxed_reach_cost_semantics():
    # the JAX package's own asserts (tests/test_closed_loop_i2lqr.py:28-35)
    assert relaxed_reach_cost(0.0, 10.0, 6, 0, 55) == 10 + 6 + 100
    assert relaxed_reach_cost(80.0, 10.0, 6, 0, 55) == 10 + 6 + 100
    assert relaxed_reach_cost(80.0001, 10.0, 6, 0, 55) == 10 + 6 + 200
    assert relaxed_reach_cost(0.9, 0.0, 6, 2, 55) == 6 + 200
    assert np.isinf(relaxed_reach_cost(80.0 * 56, 0.0, 6, 0, 55))
    assert np.isinf(relaxed_reach_cost(0.8 * 55 + 0.01, 0.0, 6, 2, 55))
    rng = np.random.default_rng(5)
    for d, q, outer in zip(rng.uniform(0, 100, 50), rng.integers(0, 120, 50),
                           rng.integers(0, 3, 50)):
        assert relaxed_reach_cost(d, q, 6, outer, 55) == \
            jax_i2lqr.relaxed_reach_cost(d, q, 6, outer, 55)


@pytest.fixture(scope="module")
def jax_lap():
    """One zero-noise f64 learning lap of the JAX host controller (CI
    configuration): its result and its stored (states, inputs)."""
    ctrl = jax_i2lqr.I2LqrController(
        JaxParams.make(dtype=jnp.float64),
        obstacle=jax_runner.default_obstacle(1.0), dtype=jnp.float64)
    res = jax_runner.run_closed_loop(ctrl, 1, goal_fixup="append")
    return res, ctrl.safe_set.ss[-1].T.copy(), ctrl.safe_set.u_ss[-1].T.copy()


def _controllers(jax_lap, sequential=False, **static):
    """The port's controller on the CPU and the JAX package's, each with
    the seed lap and the JAX run's learning lap stored."""
    (p, jp), (lim, jlim) = _params(**static), _limits()
    ours = I2LqrController(p, obstacle=default_obstacle(1.0), limits=lim,
                           dtype=F64, sequential_lambda=sequential,
                           device="cpu")
    theirs = jax_i2lqr.I2LqrController(
        jp, obstacle=jax_runner.default_obstacle(1.0), limits=jlim,
        dtype=jnp.float64, sequential_lambda=sequential)
    _, lap_x, lap_u = jax_lap
    for c in (ours, theirs):
        c.add_trajectory(XCL, UCL)
        c.add_trajectory(lap_x, lap_u)
        c.set_timestep(1.0)
    return ours, theirs


def _same_step(ours, theirs):
    for name in ("u", "x_pred", "u_pred", "x_terminal_guess", "u_old"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.shape(a) == np.shape(b), name
            _close(a, b)
    assert ours.num_horizon == theirs.num_horizon  # equal shrink


@pytest.mark.parametrize("case", [
    ("parallel", 1, (0, 17, 34, 52)),
    ("parallel, two stored laps", 2, (8, 44)),
    ("sequential", 1, (0, 30)),
])
def test_controller_step_matches_jax(jax_lap, case):
    """One calc_input from several states of the JAX learning lap: the
    winner's inputs and predicted states to 1e-8 and the same shrink.
    (Distinct candidates end at distinct states, so equal x_pred at 1e-8
    is an equal winner.)"""
    name, nsi, rows = case
    _, lap_x, _ = jax_lap
    for row in rows:
        ours, theirs = _controllers(jax_lap, sequential="sequential" in name,
                                    num_ss_iter=nsi)
        for c in (ours, theirs):
            c.set_state(lap_x[row])
            c.calc_input()
        _same_step(ours, theirs)
        assert len(ours.solve_seconds) == 1
        if "sequential" not in name:
            assert ours.launch_lanes == [8 * nsi] * 3


def test_horizon_one_replay_and_exhausted_replay_match_jax(jax_lap):
    _, lap_x, lap_u = jax_lap
    # horizon 1 (params N = 1): the reach check of the next stored input
    ours, theirs = _controllers(jax_lap, num_horizon=1, num_ss_iter=2)
    for c in (ours, theirs):
        c.set_state(lap_x[50])
        c.u_old = lap_u[50:53].T.copy()
        c.calc_input()
    _same_step(ours, theirs)
    assert ours.solve_seconds == [] and ours.launch_lanes == []
    # replay of the stored inputs, then an exhausted buffer
    ours, theirs = _controllers(jax_lap)
    for c in (ours, theirs):
        c.set_state(lap_x[53])
        c.num_horizon = 4
        c.u = np.array([0.5, -0.1])
        c.u_old = lap_u[50:52].T.copy()
    for _ in range(3):
        for c in (ours, theirs):
            c.calc_input()
        _same_step(ours, theirs)
    np.testing.assert_array_equal(ours.get_input(), lap_u[51])
    assert ours.u_pred.shape == (2, 1) and ours.solve_seconds == []


def test_one_learning_lap_matches_jax(jax_lap):
    """The zero-noise f64 learning lap through the K3 sweep's CPU route:
    the JAX host's lap length and states (1e-8)."""
    jres, _, _ = jax_lap
    ctrl = I2LqrController(IlqrParams.make(dtype=F64, device="cpu"),
                           obstacle=default_obstacle(1.0), dtype=F64,
                           device="cpu")
    res = run_closed_loop(ctrl, 1, goal_fixup="append")
    assert res.all_lap_times == jres.all_lap_times
    assert res.lap_finished == jres.lap_finished == [True]
    _close(res.plant.data["state"][0], jres.plant.data["state"][0])
    _close(res.plant.data["input"][0], jres.plant.data["input"][0])
    # three K3 calls of 8 lanes a solving step
    assert ctrl.launch_lanes == [8] * (3 * len(ctrl.solve_seconds))


def test_sequential_lambda_refuses_a_cuda_device():
    with pytest.raises(ValueError, match="CPU"):
        I2LqrController(IlqrParams.make(device="cpu"), device="cuda",
                        sequential_lambda=True)


class _Replay:
    """Stands in for the controller in the demo CLI: replays the seed
    lap's inputs (a lap of the CPU route takes ~25-45 s)."""

    def __init__(self, params, obstacle=None, device=None):
        self.obstacle, self.k, self.u = obstacle, 0, None

    def set_timestep(self, dt):
        pass

    def set_state(self, x):
        pass

    def calc_input(self):
        self.u = UCL[min(self.k, len(UCL) - 1)]
        self.k += 1

    def get_input(self):
        return self.u

    def add_trajectory(self, x, u):
        pass


def test_demo_cli_on_the_cpu(capsys, monkeypatch):
    res = ilqr_test.main(["--lap-number", "0", "--device", "cpu"])
    assert res.all_lap_times == [120.0]
    assert "time at iteration 0 is 120 s" in capsys.readouterr().out
    # --plotting renders the inputs and the last lap against its obstacle
    # under Agg (the JAX CLI's utils/viz.py calls)
    import matplotlib
    backend = matplotlib.get_backend()
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    try:
        monkeypatch.setattr(ilqr_test, "I2LqrController", _Replay)
        before = set(plt.get_fignums())
        res = ilqr_test.main(["--lap-number", "1", "--device", "cpu",
                              "--plotting"])
        figs = [plt.figure(n) for n in sorted(set(plt.get_fignums())
                                              - before)]
        assert len(figs) == 2
        inputs, traj = figs
        np.testing.assert_array_equal(
            inputs.axes[0].get_lines()[0].get_ydata(),
            res.plant.data["input"][-1][:, 0])
        np.testing.assert_array_equal(
            traj.axes[0].get_lines()[-1].get_xydata(),
            res.plant.data["state"][-1][:, :2])
        # the obstacle's ellipse every 5 of its centres, then the trajectory
        centres = res.plant.ctrl_policy.obstacle.lap_states[-1]
        assert len(traj.axes[0].get_lines()) == 1 + len(
            range(0, len(centres), 5))
    finally:
        plt.close("all")
        matplotlib.use(backend)


@pytest.mark.slow
def test_five_lap_parallel_matches_jax():
    """The CI configuration over 5 laps, f64, the parallel sweep: the JAX
    host controller's lap sequence exactly."""
    params = IlqrParams.make(dtype=F64, device="cpu")
    ctrl = I2LqrController(params, obstacle=default_obstacle(1.0), dtype=F64,
                           device="cpu")
    res = run_closed_loop(ctrl, 5, goal_fixup="append")
    jres = jax_runner.run_closed_loop(
        jax_i2lqr.I2LqrController(JaxParams.make(dtype=jnp.float64),
                                  obstacle=jax_runner.default_obstacle(1.0),
                                  dtype=jnp.float64), 5, goal_fixup="append")
    assert all(res.lap_finished)
    assert res.all_lap_times == jres.all_lap_times


@pytest.mark.slow
def test_five_lap_sequential_lambda_exact():
    """The reference's sequential lambda at f64 reproduces its recorded
    [54, 27, 24, 24, 24] exactly (tests/test_closed_loop_i2lqr.py:55)."""
    params = IlqrParams.make(dtype=F64, device="cpu")
    ctrl = I2LqrController(params, obstacle=default_obstacle(1.0), dtype=F64,
                           sequential_lambda=True, device="cpu")
    res = run_closed_loop(ctrl, 5, goal_fixup="append")
    assert all(res.lap_finished)
    assert res.seed_time == 120.0
    assert res.lap_times == [54.0, 27.0, 24.0, 24.0, 24.0]
