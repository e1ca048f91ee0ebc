"""The port's NLMPC learning run (f64), in its safe-set modes.

- Zero noise, B = 2, seed lap + 3 learning laps, LM cap 60: the lap steps
  are the host controller's pinned sequences, without JAX: spaceVarying
  [32, 23, 23], timeVarying [111, 104, 97] and all with all_ss_iter
  [26, 22, 22] (tests/test_batched_nlmpc_soa.py:141-173,
  docs/PARITY.md:80).
- Against the JAX simulator: B = 4, 1 learning lap, cap 12; lanes 0-1 run
  without noise, lanes 2-3 with the JAX run's own draws
  (``jax.random.split(key, 3)`` per executed step, batched_nlmpc_soa.py:715);
  spaceVarying and timeVarying.
- ``infeasible_retire`` and the all-infeasible input hold; a step solver
  built for another mode is refused.
- The kNN or window over every stored lap (``all_ss_iter`` without
  ``all_ss_point``): zero-noise laps spaceVarying [32, 23, 23] and
  timeVarying [111, 102, 93] (the JAX simulator's and host controller's,
  pinned here), and lap 1 against JAX on its draws through K4's CPU route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_tpu.control import batched_nlmpc_soa as jns
from ilqr_iterative_tasks_tpu.control.batched_soa import (
    SoaScenarios as JScenarios)
from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObstacle
from ilqr_iterative_tasks_tpu.utils.params import (
    LmpcParams as JParams, SystemLimits as JLimits)
from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import (
    simulate_nlmpc_runs_soa)
from ilqr_iterative_tasks_torch.control.batched_soa import SoaScenarios
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    build_fused_lm_shooting)
from ilqr_iterative_tasks_torch.ops.nlmpc_step import (
    build_fused_nlmpc_step, nlmpc_step_reference)
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils import convert
from ilqr_iterative_tasks_torch.utils.params import LmpcParams, SystemLimits

torch.set_num_threads(1)
F64 = torch.float64
T_ROWS, MAX_LAPS = 128, 8
HOST_LAPS = [32, 23, 23]  # host controller, f64 zero noise, cap 60


def _seed():
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((T_ROWS, 4)), np.zeros((T_ROWS, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    return xcl, seed_xs, seed_us


def _scenarios(b, **kw):
    xcl, _, _ = _seed()
    return SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=F64, device="cpu"),
        b, dtype=F64, **kw, device="cpu")


def _zero_noise_laps(host_laps, **mode):
    _, seed_xs, seed_us = _seed()
    res = simulate_nlmpc_runs_soa(
        LmpcParams.make(dtype=F64, device="cpu", **mode),
        SystemLimits.make(dtype=F64, device="cpu"),
        _scenarios(2), seed_xs, seed_us, 121, 1.0, num_laps=3,
        max_steps=T_ROWS, max_laps=MAX_LAPS)
    assert res.lap_steps.T.tolist() == [host_laps, host_laps]
    assert bool(res.lap_done.all())
    assert res.lap_count == 4
    assert torch.equal(res.safe_set[4][1:4, 0],
                       torch.tensor(host_laps, dtype=torch.int32) + 1)


def test_zero_noise_laps_equal_the_host_sequence():
    _zero_noise_laps(HOST_LAPS)


def test_time_varying_zero_noise_laps_equal_the_host_sequence():
    _zero_noise_laps([111, 104, 97], ss_option="timeVarying")


def test_all_points_all_laps_zero_noise_laps_equal_the_host_sequence():
    # every stored point of every stored lap: ~40 s on one CPU thread
    _zero_noise_laps([26, 22, 22], all_ss_point=True, all_ss_iter=True)


def _jax_draws(key, steps, b):
    """The (v, theta) standard-normal draws the JAX NLMPC simulator takes at
    each executed step, in order: (steps, 2, b)."""
    def body(k, _):
        k, k1, k2 = jax.random.split(k, 3)
        return k, jnp.stack([jax.random.normal(k1, (b,), jnp.float64),
                             jax.random.normal(k2, (b,), jnp.float64)])
    return np.array(jax.jit(lambda k: jax.lax.scan(
        body, k, None, length=steps)[1])(key))


def _lap1_against_jax(candidate_solver=False, **mode):
    b, cap, budget = 4, 12, 121
    xcl, seed_xs, seed_us = _seed()
    jp = JParams.make(dtype=jnp.float64, **mode)
    jl = JLimits.make(dtype=jnp.float64)
    scen = JScenarios.broadcast(
        np.zeros(4), xcl[-1],
        JObstacle.make(31.0, -2.0, 8.0, 6.0, dtype=jnp.float64), b,
        noise_on=True, dtype=jnp.float64)
    scen = scen.replace(noise_on=jnp.asarray([0.0, 0.0, 1.0, 1.0]))
    key = jax.random.PRNGKey(5)
    kw = dict(num_laps=1, max_steps=T_ROWS, max_laps=MAX_LAPS,
              sim_step_budget=budget, max_lm_iters=cap)
    jr = jns.simulate_nlmpc_runs_soa(
        jp, jl, scen, jnp.asarray(seed_xs), jnp.asarray(seed_us), 121, 1.0,
        key, **kw)
    tl = convert.system_limits(jl, device="cpu")
    k4 = (build_fused_lm_shooting(tl, 1.0, num_horizon=6, max_iters=cap)
          if candidate_solver else None)
    tr = simulate_nlmpc_runs_soa(
        convert.lmpc_params(jp, device="cpu"), tl,
        convert.scenarios(scen, device="cpu"), seed_xs, seed_us, 121, 1.0,
        noise=torch.from_numpy(_jax_draws(key, budget, b)),
        candidate_solver=k4, **kw)
    np.testing.assert_array_equal(tr.lap_steps.numpy(),
                                  np.asarray(jr.lap_steps))
    np.testing.assert_array_equal(tr.lap_done.numpy(),
                                  np.asarray(jr.lap_done))
    assert tr.lap_steps[0, 0] == tr.lap_steps[0, 1]  # zero-noise lanes
    for i in (0, 1):  # lap-1 states and inputs
        np.testing.assert_allclose(tr.safe_set[i][1].numpy(),
                                   np.asarray(jr.safe_set[i][1]), rtol=0,
                                   atol=1e-9)
    np.testing.assert_array_equal(tr.safe_set[4].numpy(),
                                  np.asarray(jr.safe_set[4]))
    np.testing.assert_allclose(tr.final_x.numpy(), np.asarray(jr.final_x),
                               rtol=0, atol=1e-9)
    return tr


def test_closed_loop_lap1_matches_jax_f64():
    _lap1_against_jax()


def test_time_varying_closed_loop_lap1_matches_jax_f64():
    tr = _lap1_against_jax(ss_option="timeVarying")
    assert bool(tr.lap_done.all())


class _InfeasibleFrom:
    """Plain step solver that reports lane ``lane`` all-infeasible from
    control step ``start`` on, and records each call's skip mask."""

    def __init__(self, params, limits, lane, start, cap):
        self.params, self.limits, self.lane, self.start = (params, limits,
                                                           lane, start)
        self.k, self.nsi = params.num_ss_points, params.num_ss_iter
        self.num_horizon, self.max_steps, self.max_laps = 6, T_ROWS, MAX_LAPS
        self.max_iters = cap
        self.skips = []

    def __call__(self, *args):
        out = list(nlmpc_step_reference(self.params, self.limits, 1.0, *args,
                                        max_iters=self.max_iters))
        if len(self.skips) >= self.start:
            out[1] = out[1].clone()
            out[1][self.lane] = 0.0
        self.skips.append(args[9].clone())
        return tuple(out)


def test_infeasible_retire_holds_the_input_and_skips_the_lane():
    retire, start, budget = 3, 2, 9
    _, seed_xs, seed_us = _seed()
    params, limits = LmpcParams.make(dtype=F64, device="cpu"), SystemLimits.make(dtype=F64, device="cpu")
    solver = _InfeasibleFrom(params, limits, 1, start, 12)
    res = simulate_nlmpc_runs_soa(
        params, limits, _scenarios(2), seed_xs, seed_us, 121, 1.0,
        num_laps=1, max_steps=T_ROWS, max_laps=MAX_LAPS,
        sim_step_budget=budget, max_lm_iters=12, infeasible_retire=retire,
        step_solver=solver)
    u1 = res.safe_set[1][1, :budget, :, 1]  # lane 1's applied inputs
    assert bool((u1[start - 1] != 0).all())
    assert torch.equal(u1[start:], u1[start - 1].expand(budget - start, 2))
    # solved while the streak is short, skipped from the retiring step on
    skips = torch.stack(solver.skips)[:, 1]
    assert skips.tolist() == [0.0] * (start + retire) + [1.0] * (
        budget - start - retire)
    assert res.lap_steps.tolist() == [[budget, budget]]
    # lane 0 is unaffected: its inputs equal a run without the fault (run
    # with the goal appended as an extra row: one more stored state)
    ref = simulate_nlmpc_runs_soa(
        params, limits, _scenarios(2), seed_xs, seed_us, 121, 1.0,
        num_laps=1, max_steps=T_ROWS, max_laps=MAX_LAPS,
        sim_step_budget=budget, max_lm_iters=12, infeasible_retire=retire,
        goal_append=True)
    assert torch.equal(res.safe_set[1][1, :, :, 0], ref.safe_set[1][1, :, :, 0])
    assert res.safe_set[4][1].tolist() == [budget + 1] * 2
    assert ref.safe_set[4][1].tolist() == [budget + 2] * 2
    goal = _scenarios(2).goal
    assert torch.equal(res.safe_set[0][1, budget], goal)
    assert torch.equal(ref.safe_set[0][1, budget + 1], goal)
    assert torch.equal(ref.safe_set[0][1, budget], ref.final_x)


def test_unported_options_raise():
    """An option the simulator does not know raises; retile_frac and
    tail_shrink are taken (tests/test_torch_retile_nlmpc.py holds them bit
    for bit)."""
    _, seed_xs, seed_us = _seed()
    limits = SystemLimits.make(dtype=F64, device="cpu")
    kw = dict(num_laps=1, max_steps=T_ROWS, max_laps=MAX_LAPS,
              sim_step_budget=3, max_lm_iters=4)
    with pytest.raises(TypeError, match="precision_islands"):
        simulate_nlmpc_runs_soa(LmpcParams.make(dtype=F64, device="cpu"),
                                limits, _scenarios(2), seed_xs, seed_us,
                                121, 1.0, precision_islands=(), **kw)
    for taken in (dict(retile_frac=0.25), dict(tail_shrink=1)):
        res = simulate_nlmpc_runs_soa(
            LmpcParams.make(dtype=F64, device="cpu"), limits, _scenarios(2),
            seed_xs, seed_us, 121, 1.0, **taken, **kw)
        assert res.lap_steps.tolist() == [[3, 3]]
    # the kNN or window over every stored lap runs: see the
    # every_stored_lap tests here and in tests/test_torch_nlmpc_step.py


@pytest.mark.parametrize("mode, host_laps", [
    ("spaceVarying", HOST_LAPS),
    # the JAX simulator's and host controller's f64 zero-noise laps with
    # all_ss_iter (tests/test_batched_nlmpc_soa.py helpers), pinned here
    ("timeVarying", [111, 102, 93])], ids=["spaceVarying", "timeVarying"])
def test_every_stored_lap_zero_noise_laps_equal_the_host_sequence(
        mode, host_laps):
    """The kNN or window over every stored lap (all_ss_iter without
    all_ss_point): spaceVarying gives the laps of the last lap alone
    (tests/test_batched_nlmpc_soa.py:176-185), timeVarying its own."""
    _zero_noise_laps(host_laps, ss_option=mode, all_ss_iter=True)


@pytest.mark.parametrize("mode", ["spaceVarying", "timeVarying"])
def test_every_stored_lap_lap1_matches_jax_f64_through_k4(mode):
    """Lap 1 of the every-stored-lap option on JAX's noisy draws, the port
    through K4's CPU route (the default backend on the card)."""
    tr = _lap1_against_jax(ss_option=mode, all_ss_iter=True,
                           candidate_solver=True)
    assert bool(tr.lap_done[:, :2].all())


def test_step_solver_of_another_mode_is_refused():
    _, seed_xs, seed_us = _seed()
    limits = SystemLimits.make(dtype=F64, device="cpu")
    kw = dict(num_laps=1, max_steps=T_ROWS, max_laps=MAX_LAPS,
              max_lm_iters=12)
    sizes = dict(num_horizon=6, max_steps=T_ROWS, max_laps=MAX_LAPS,
                 max_iters=12)
    space = LmpcParams.make(dtype=F64, device="cpu")
    every = LmpcParams.make(dtype=F64, all_ss_point=True, all_ss_iter=True,
                            device="cpu")
    last = LmpcParams.make(dtype=F64, all_ss_point=True, device="cpu")
    for built, run in ((space, LmpcParams.make(
            dtype=F64, ss_option="timeVarying", device="cpu")),
                       (every, last), (last, every), (last, space)):
        k2 = build_fused_nlmpc_step(built, limits, 1.0, **sizes)
        with pytest.raises(ValueError, match="mode"):
            simulate_nlmpc_runs_soa(run, limits, _scenarios(2), seed_xs,
                                    seed_us, 121, 1.0, step_solver=k2, **kw)
        assert k2.launches == 0
