"""The NLMPC host tier of the port against the JAX package's, in f64 on
the CPU: the AoS projected-LM shooting solve (every input on a bound, the
reachable / unreachable / bounds / moving-obstacle cases of
tests/test_nlmpc.py), the AL-iLQR solve and its 2x2 box QP, one
``calc_input`` of the host controller in each safe-set mode (through K4's
CPU route; the horizon-1 reach check and an all-infeasible step among the
cases), K4 at N = 6 with hzn lanes against the JAX host's decisions, one
zero-noise learning lap, and the demo CLI. The three-lap closed loops
mirror the JAX package's own ``slow`` tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_torch.control.nlmpc import (
    HOST_LM_ITERS, NlmpcController)
from ilqr_iterative_tasks_torch.experiments import nlmpc_test
from ilqr_iterative_tasks_torch.experiments.runner import (
    default_obstacle, run_closed_loop)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops import al_ilqr, lm_shooting
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    build_fused_lm_shooting, obstacle_to_lanes_nlmpc)
from ilqr_iterative_tasks_torch.sim.plant import InfeasibleStep
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import LmpcParams, SystemLimits
from ilqr_iterative_tasks_tpu.control import nlmpc as jax_nlmpc
from ilqr_iterative_tasks_tpu.experiments import runner as jax_runner
from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JaxObstacle
from ilqr_iterative_tasks_tpu.ops import al_ilqr as jax_al
from ilqr_iterative_tasks_tpu.ops import lm_shooting as jax_lm
from ilqr_iterative_tasks_tpu.ops.ilqr import rollout as jax_rollout
from ilqr_iterative_tasks_tpu.utils.params import LmpcParams as JaxParams
from ilqr_iterative_tasks_tpu.utils.params import SystemLimits as JaxLimits

F64 = torch.float64
TOL = 1e-8
XCL, UCL = seed_trajectory(1.0)
T = lambda a: torch.tensor(np.asarray(a), dtype=F64)
J = lambda a: jnp.asarray(np.asarray(a), dtype=jnp.float64)
MODES = {"spaceVarying": dict(ss_option="spaceVarying"),
         "timeVarying": dict(ss_option="timeVarying"),
         "all": dict(all_ss_point=True, all_ss_iter=True)}
US_TRUE = np.array([[2, 0.35], [2, 0.1], [2, -0.15], [2, -0.2], [2, -0.1],
                    [2, 0.0]])


def _limits():
    return (SystemLimits.make(dtype=F64, device="cpu"),
            JaxLimits.make(dtype=jnp.float64))


def _obstacle(*args, **kw):
    if not args:
        return (Obstacle.absent(dtype=F64, device="cpu"),
                JaxObstacle.absent(dtype=jnp.float64))
    return (Obstacle.make(*args, dtype=F64, device="cpu", **kw),
            JaxObstacle.make(*args, dtype=jnp.float64, **kw))


def _close(ours, theirs, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(ours).numpy(),
                               np.asarray(theirs), rtol=0, atol=tol)


def _same_solution(got, want):
    """Equal decisions; the solutions of feasible lanes to 1e-8."""
    feas = np.asarray(want.feasible)
    np.testing.assert_array_equal(got.feasible.numpy(), feas)
    _close(got.us[feas], np.asarray(want.us)[feas])
    _close(got.xs[feas], np.asarray(want.xs)[feas])


def test_clip_derivative_at_a_bound_is_jax_s():
    """jnp.clip splits its derivative at a tie (min / max), as
    torch.minimum / torch.maximum do and torch.clamp does not."""
    z = np.array([2.0, -2.0, 1.0, 3.0])
    m = torch.tensor(2.0, dtype=F64)
    want = jax.jacfwd(lambda u: jnp.clip(u, -2.0, 2.0))(J(z)).diagonal()
    got = torch.func.jacfwd(lambda u: lm_shooting._clip(u, m))(T(z))
    _close(got.diagonal(), want, 0.0)
    assert np.asarray(want).tolist() == [0.5, 0.5, 1.0, 0.0]


def test_lm_solve_with_every_input_on_a_bound_matches_jax():
    (lim, jlim), (obs, jobs) = _limits(), _obstacle(31.0, -2.0, 8.0, 6.0)
    x0 = np.zeros(4)
    x_term = np.asarray(jax_rollout(J(x0), J(US_TRUE), 1.0)[-1])
    d_max = float(np.pi / 2)
    # every warm input beyond or on a bound: clipped onto it
    warm = np.array([[5.0, 9.0], [2.0, -d_max], [-7.0, d_max], [2.0, 4.0],
                     [-2.0, -4.0], [3.0, -d_max]])
    got = lm_shooting.lm_feasibility_solve(lim, obs, T(x0), T(x_term),
                                           T(warm), 1.0, num_horizon=6)
    want = jax_lm.lm_feasibility_solve(jlim, jobs, J(x0), J(x_term), J(warm),
                                       1.0, num_horizon=6)
    assert bool(got.feasible) == bool(want.feasible)
    assert int(got.n_iters) == int(want.n_iters)
    _close(got.us, want.us)
    _close(got.xs, want.xs)


@pytest.mark.parametrize("solver", ["lm", "al"])
def test_reachable_target_is_feasible_as_in_jax(solver):
    (lim, jlim), (obs, jobs) = _limits(), _obstacle(31.0, -2.0, 8.0, 6.0)
    x0 = np.zeros(4)
    x_term = np.asarray(jax_rollout(J(x0), J(US_TRUE), 1.0)[-1])
    warm = US_TRUE + 0.1
    fn, jfn = {"lm": (lm_shooting.lm_feasibility_solve,
                      jax_lm.lm_feasibility_solve),
               "al": (al_ilqr.al_ilqr_solve, jax_al.al_ilqr_solve)}[solver]
    got = fn(lim, obs, T(x0), T(x_term), T(warm), 1.0, num_horizon=6)
    want = jfn(jlim, jobs, J(x0), J(x_term), J(warm), 1.0, num_horizon=6)
    assert bool(got.feasible) and bool(want.feasible)
    assert float(got.term_err) <= 1e-4 and float(got.max_violation) <= 1e-4
    _close(got.us, want.us)
    _close(got.xs, want.xs)


@pytest.mark.parametrize("solver", ["lm", "al"])
def test_unreachable_target_is_infeasible_as_in_jax(solver):
    """Through the candidate sweeps (one candidate)."""
    (lim, jlim), (obs, jobs) = _limits(), _obstacle()
    x0, x_term, u0 = np.zeros(4), np.array([[200.0, 0, 0, 0]]), np.zeros((1, 6, 2))
    fn, jfn = {"lm": (lm_shooting.lm_feasibility_solve_candidates,
                      jax_lm.lm_feasibility_solve_candidates),
               "al": (al_ilqr.al_ilqr_solve_candidates,
                      jax_al.al_ilqr_solve_candidates)}[solver]
    got = fn(lim, obs, T(x0), T(x_term), T(u0), 1.0, num_horizon=6)
    want = jfn(jlim, jobs, J(x0), J(x_term), J(u0), 1.0, num_horizon=6)
    assert got.feasible.tolist() == np.asarray(want.feasible).tolist() == [
        False]


def test_lm_solver_respects_bounds_and_obstacle_as_in_jax():
    (lim, jlim), (obs, jobs) = _limits(), _obstacle(31.0, -2.0, 8.0, 6.0)
    x0 = np.zeros(4)
    x_term = np.asarray(jax_rollout(J(x0), J(US_TRUE), 1.0)[-1])
    got = lm_shooting.lm_feasibility_solve(lim, obs, T(x0), T(x_term),
                                           torch.zeros((6, 2), dtype=F64),
                                           1.0, num_horizon=6)
    want = jax_lm.lm_feasibility_solve(jlim, jobs, J(x0), J(x_term),
                                       jnp.zeros((6, 2)), 1.0, num_horizon=6)
    assert bool(got.feasible) and bool(want.feasible)
    assert float(got.us[:, 0].abs().max()) <= 2.0 + 1e-9
    assert float(got.us[:, 1].abs().max()) <= np.pi / 2 + 1e-9
    mid = got.xs[1:-1].numpy()
    assert np.all((mid[:, 0] - 31.0) ** 2 / 64.0
                  + (mid[:, 1] + 2.0) ** 2 / 36.0 >= 1.0 - 1e-3)
    _close(got.us, want.us)


def test_moving_obstacle_constraint_matches_jax():
    (lim, jlim), (obs, jobs) = _limits(), _obstacle(10.0, -6.0, 3.0, 3.0,
                                                    spd=2.0, moving_option=1)
    x0 = np.zeros(4)
    us_true = np.array([[2, -0.2], [2, -0.1], [2, 0.1], [2, 0.1], [1, 0.05],
                        [0, 0.05]])
    x_term = np.asarray(jax_rollout(J(x0), J(us_true), 1.0)[-1])
    got = lm_shooting.lm_feasibility_solve(lim, obs, T(x0), T(x_term),
                                           T(us_true + 0.05), 1.0,
                                           num_horizon=6)
    want = jax_lm.lm_feasibility_solve(jlim, jobs, J(x0), J(x_term),
                                       J(us_true + 0.05), 1.0, num_horizon=6)
    assert bool(got.feasible) == bool(want.feasible)
    for i, row in enumerate(got.xs[1:-1].numpy(), start=1):
        val = (row[0] - 10.0) ** 2 / 9.0 + (row[1] - (-6.0 + 2.0 * i)) ** 2 / 9.0
        assert val >= 1.0 - 1e-3 or not bool(got.feasible)
    if bool(want.feasible):
        _close(got.us, want.us)


@pytest.mark.parametrize("n", [6, 3])
def test_lm_candidates_match_jax(n):
    (lim, jlim), (obs, jobs) = _limits(), _obstacle(31.0, -2.0, 8.0, 6.0)
    rng = np.random.default_rng(1)
    x0 = XCL[10] + rng.normal(size=4) * 0.1
    xts = XCL[14:20]
    warm = np.broadcast_to(UCL[10:10 + n], (6, n, 2)).copy()
    got = lm_shooting.lm_feasibility_solve_candidates(
        lim, obs, T(x0), T(xts), T(warm), 1.0, num_horizon=n)
    want = jax_lm.lm_feasibility_solve_candidates(
        jlim, jobs, J(x0), J(xts), J(warm), 1.0, num_horizon=n)
    _same_solution(got, want)


def test_boxqp_2x2_against_bruteforce_and_jax():
    rng = np.random.default_rng(7)
    for _ in range(30):
        m = rng.normal(size=(2, 2))
        quu = m @ m.T + 0.1 * np.eye(2)
        qu = rng.normal(size=2)
        lo = -np.abs(rng.normal(size=2)) - 0.1
        hi = np.abs(rng.normal(size=2)) + 0.1
        du, free = al_ilqr._boxqp_2x2(T(quu), T(qu), T(lo), T(hi))
        jdu, jfree = jax_al._boxqp_2x2(J(quu), J(qu), J(lo), J(hi))
        _close(du, jdu, 1e-12)
        assert free.tolist() == np.asarray(jfree).tolist()
        g = np.stack(np.meshgrid(np.linspace(lo[0], hi[0], 201),
                                 np.linspace(lo[1], hi[1], 201)), -1)
        pts = g.reshape(-1, 2)
        objs = 0.5 * np.einsum("ki,ij,kj->k", pts, quu, pts) + pts @ qu
        d = du.numpy()
        assert 0.5 * d @ quu @ d + d @ qu <= objs.min() + 1e-6
        assert np.all(d >= lo - 1e-9) and np.all(d <= hi + 1e-9)
        gains = al_ilqr._free_gains(T(quu), T(np.ones((2, 4))), free)
        _close(gains, jax_al._free_gains(J(quu), J(np.ones((2, 4))), jfree),
               1e-12)
    for lamb in (1.0, 1e-3):
        _close(al_ilqr._reg_pd_2x2(T(quu - 2 * np.eye(2)), lamb),
               jax_al._reg_pd_2x2(J(quu - 2 * np.eye(2)), lamb), 1e-12)


@pytest.fixture(scope="module")
def jax_lap():
    """One zero-noise f64 spaceVarying learning lap of the JAX host
    controller: its result and its stored (states, inputs)."""
    ctrl = jax_nlmpc.NlmpcController(
        JaxParams.make(ss_option="spaceVarying"),
        obstacle=jax_runner.default_obstacle(1.0), dtype=jnp.float64)
    res = jax_runner.run_closed_loop(ctrl, 1, goal_fixup=None)
    return res, ctrl.safe_set.ss[-1].T.copy(), ctrl.safe_set.u_ss[-1].T.copy()


def _controllers(jax_lap, mode, **static):
    (lim, jlim) = _limits()
    ours = NlmpcController(LmpcParams.make(device="cpu", **MODES[mode],
                                           **static),
                           obstacle=default_obstacle(1.0), limits=lim,
                           dtype=F64, device="cpu")
    theirs = jax_nlmpc.NlmpcController(
        JaxParams.make(**MODES[mode], **static),
        obstacle=jax_runner.default_obstacle(1.0), limits=jlim,
        dtype=jnp.float64)
    _, lap_x, lap_u = jax_lap
    for c in (ours, theirs):
        c.add_trajectory(XCL, UCL)
        c.add_trajectory(lap_x, lap_u)
        c.set_timestep(1.0)
    return ours, theirs


def _same_step(ours, theirs):
    for name in ("u", "x_pred", "u_pred", "x_terminal_guess", "x_guess"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert np.shape(a) == np.shape(b), name
        _close(a, b)
    assert ours.num_horizon == theirs.num_horizon  # equal shrink
    assert ours.cost == theirs.cost and ours.cost_improve == theirs.cost_improve
    for a, b in zip(ours.ss_windows, theirs.ss_windows):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["spaceVarying", "timeVarying", "all"])
def test_controller_steps_match_jax(jax_lap, mode):
    """Four consecutive calc_inputs from the learning lap's start (the
    warm-start shift between them), each from the JAX lap's next state:
    the same winner (its cost, inputs and predicted states to 1e-8) and
    the same shrink."""
    _, lap_x, _ = jax_lap
    ours, theirs = _controllers(jax_lap, mode, num_ss_iter=2)
    for row in range(4):
        for c in (ours, theirs):
            c.set_state(lap_x[row])
            c.calc_input()
        _same_step(ours, theirs)
    assert len(ours.solve_seconds) == len(ours.launch_lanes) == 4


def test_horizon_one_reach_check_and_all_infeasible_step(jax_lap):
    """At horizon 1 the warm start's first input is checked on the host;
    where it reaches no candidate both controllers refuse the step (the
    port with InfeasibleStep, which the plant records as infeasible)."""
    _, lap_x, lap_u = jax_lap
    k = len(lap_u) - 3
    ours, theirs = _controllers(jax_lap, "spaceVarying")
    for c in (ours, theirs):
        c.num_horizon = 1
        c.x_guess = np.concatenate([lap_x[k], lap_x[k + 1], lap_u[k]])
        c.x_terminal_guess = lap_x[k + 1].copy()
        c.set_state(lap_x[k])
        c.calc_input()
    _same_step(ours, theirs)
    assert ours.solve_seconds == [] and ours.launch_lanes == []
    for c in (ours, theirs):
        c.set_state(lap_x[k] + np.array([3.0, 3.0, 0.0, 0.0]))
    with pytest.raises(InfeasibleStep):
        ours.calc_input()
    with pytest.raises(RuntimeError):
        theirs.calc_input()


def test_k4_designs_give_the_jax_host_decisions(jax_lap):
    """Two ways to solve a step's candidates at a shrunk horizon n through
    K4: the N = 6 K4 with every lane's hzn = n (the controller's: the
    kernel is instantiated at N = 6 only) and a K4 built at num_horizon =
    n. Through K4's CPU route both give the JAX host's decisions at n = 3
    on candidates near the lap's end, the shipped one its solutions too."""
    _, lap_x, lap_u = jax_lap
    (lim, jlim), (obs, jobs) = _limits(), _obstacle(31.0, -2.0, 8.0, 6.0)
    n, b = 3, 8
    x0 = lap_x[-9]
    xts = lap_x[-8:]
    warm = lap_u[-9:-9 + n]
    want = jax_lm.lm_feasibility_solve_candidates(
        jlim, jobs, J(x0), J(xts), J(np.broadcast_to(warm, (b, n, 2))), 1.0,
        num_horizon=n)
    lanes = obstacle_to_lanes_nlmpc(obs, b).contiguous()
    skip = torch.zeros(b, dtype=torch.float32)
    hzn = torch.full((b,), n, dtype=torch.int32)
    x0_l = T(x0)[:, None].expand(4, b).contiguous()
    per_n = build_fused_lm_shooting(lim, 1.0, num_horizon=n,
                                    max_iters=HOST_LM_ITERS)(
        x0_l, T(xts.T), T(warm)[:, :, None].expand(n, 2, b).contiguous(),
        lanes, skip, hzn)
    warm6 = np.concatenate([warm, np.zeros((6 - n, 2))])
    at_n6 = build_fused_lm_shooting(lim, 1.0, num_horizon=6,
                                    max_iters=HOST_LM_ITERS)(
        x0_l, T(xts.T), T(warm6)[:, :, None].expand(6, 2, b).contiguous(),
        lanes, skip, hzn)
    feas = np.asarray(want.feasible)
    assert feas.any() and not feas.all()
    np.testing.assert_array_equal(at_n6[3].numpy() > 0.5, feas)
    np.testing.assert_array_equal(per_n[3].numpy() > 0.5, feas)
    _close(at_n6[0][:n].permute(2, 0, 1)[feas], np.asarray(want.us)[feas])


def test_one_learning_lap_matches_jax(jax_lap):
    """The zero-noise f64 spaceVarying learning lap through K4's CPU
    route: the JAX host's lap length and states (1e-8)."""
    jres, _, _ = jax_lap
    ctrl = NlmpcController(LmpcParams.make(device="cpu"),
                           obstacle=default_obstacle(1.0), dtype=F64,
                           device="cpu")
    res = run_closed_loop(ctrl, 1, goal_fixup=None)
    assert res.all_lap_times == jres.all_lap_times == [120.0, 32.0]
    _close(res.plant.data["state"][0], jres.plant.data["state"][0])
    _close(res.plant.data["input"][0], jres.plant.data["input"][0])
    assert list(res.plant.diagnostics["feasibility"][0]) == list(
        jres.plant.diagnostics["feasibility"][0])


def test_demo_cli_on_the_cpu(capsys):
    res = nlmpc_test.main(["--lap-number", "0", "--device", "cpu",
                           "--ss-option", "time"])
    assert res.all_lap_times == [120.0]
    assert "time at iteration 0 is 120 s" in capsys.readouterr().out
    # --plotting renders one learning lap's inputs and trajectory under
    # Agg (the JAX CLI's utils/viz.py calls)
    import matplotlib
    backend = matplotlib.get_backend()
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    try:
        before = set(plt.get_fignums())
        res = nlmpc_test.main(["--lap-number", "1", "--device", "cpu",
                               "--plotting"])
        assert res.lap_finished == [True]
        figs = [plt.figure(n) for n in sorted(set(plt.get_fignums())
                                              - before)]
        assert len(figs) == 2
        inputs, traj = figs
        np.testing.assert_array_equal(
            inputs.axes[1].get_lines()[0].get_ydata(),
            res.plant.data["input"][-1][:, 1])
        np.testing.assert_array_equal(
            traj.axes[0].get_lines()[-1].get_xydata(),
            res.plant.data["state"][-1][:, :2])
    finally:
        plt.close("all")
        matplotlib.use(backend)


@pytest.mark.slow
@pytest.mark.parametrize("mode,want", [("spaceVarying", [32, 23, 23]),
                                       ("timeVarying", [111, 104, 97]),
                                       ("all", [26, 22, 22])])
def test_three_lap_closed_loop_matches_the_jax_host(mode, want):
    """f64 zero noise, 3 laps: the JAX host controller's pinned sequences
    (tests/test_batched_nlmpc_soa.py:141-175)."""
    ctrl = NlmpcController(LmpcParams.make(device="cpu", **MODES[mode]),
                           obstacle=default_obstacle(1.0), dtype=F64,
                           device="cpu")
    res = run_closed_loop(ctrl, 3, goal_fixup=None)
    assert all(res.lap_finished)
    assert [int(t) for t in res.lap_times] == want
