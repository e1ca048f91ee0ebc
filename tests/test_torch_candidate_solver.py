"""The per-candidate path of both simulators (f64, CPU): the plain step's
glue around a candidate solver, K3 under the i2LQR simulator and K4 under
the NLMPC one (``candidate_solver``, the JAX ``pallas_solver``), here
through the kernels' CPU routes.

- Against the JAX simulators, B = 16, plant noise on with the JAX run's
  own draws, LM cap 12: i2LQR one learning lap, NLMPC spaceVarying two
  (with ``with_streak_stats``) and timeVarying one. Lap steps and done
  flags equal, final states and the safe set within 1e-9. JAX's Pallas K3
  and K4 compute in f32 only (their outputs are f32,
  pallas_ilqr.py:154-157, pallas_lm_shooting.py:178-181), so the f64 side
  is JAX's XLA path (``pallas_solver=None``), the oracle the JAX tests hold
  those kernels to.
- The candidate path equals the port's own plain path
  (``step_solver=None``, the plain solve) bit for bit.
- The backend checks raise where the JAX simulators' raise (:317-331 of
  batched_soa.py, :165-179 of batched_nlmpc_soa.py), and the K2 factory
  refuses the kNN or window over every stored lap as the TPU factory does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_tpu.control import batched_nlmpc_soa as jns
from ilqr_iterative_tasks_tpu.control import batched_soa as jbs
from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObstacle
from ilqr_iterative_tasks_tpu.ops.pallas_nlmpc_step import (
    build_fused_nlmpc_step as j_build_fused_nlmpc_step)
from ilqr_iterative_tasks_tpu.sim.seed import seed_trajectory as j_seed
from ilqr_iterative_tasks_tpu.utils.params import (
    IlqrParams as JIlqrParams, LmpcParams as JLmpcParams,
    SystemLimits as JLimits)
from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import (
    k2_serves, simulate_nlmpc_runs_soa)
from ilqr_iterative_tasks_torch.control.batched_soa import (
    simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.ops.fused_ilqr import build_fused_ilqr
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    build_fused_lm_shooting)
from ilqr_iterative_tasks_torch.ops.nlmpc_step import build_fused_nlmpc_step
from ilqr_iterative_tasks_torch.utils import convert

torch.set_num_threads(1)
B, T_ROWS, MAX_LAPS, CAP, BUDGET = 16, 128, 8, 12, 121
NL_MODES = {"spaceVarying": ({}, 2, 6), "timeVarying":
            (dict(ss_option="timeVarying"), 1, 5)}  # options, laps, key


def _jax_draws(key, steps, b):
    """The (v, theta) standard-normal draws the JAX simulators take at each
    executed step, in order: (steps, 2, b)."""
    def body(k, _):
        k, k1, k2 = jax.random.split(k, 3)
        return k, jnp.stack([jax.random.normal(k1, (b,), jnp.float64),
                             jax.random.normal(k2, (b,), jnp.float64)])
    return np.array(jax.jit(lambda k: jax.lax.scan(
        body, k, None, length=steps)[1])(key))


def _seed():
    xcl, ucl = j_seed(1.0)
    seed_xs, seed_us = np.zeros((T_ROWS, 4)), np.zeros((T_ROWS, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    return xcl, seed_xs, seed_us


def _jax_scenarios():
    xcl, _, _ = _seed()
    return jbs.SoaScenarios.broadcast(
        np.zeros(4), xcl[-1],
        JObstacle.make(31.0, -2.0, 8.0, 6.0, dtype=jnp.float64), B,
        noise_on=True, dtype=jnp.float64)


@pytest.fixture(scope="module")
def i2lqr_runs():
    """The JAX run and the port's runs through K3 and the plain step."""
    _, seed_xs, _ = _seed()
    jp = JIlqrParams.make(dtype=jnp.float64)
    jl = JLimits.make(dtype=jnp.float64)
    scen = _jax_scenarios()
    key = jax.random.PRNGKey(7)
    kw = dict(num_laps=1, max_steps=T_ROWS, max_laps=MAX_LAPS,
              sim_step_budget=BUDGET, solver_max_iter=CAP)
    jr = jbs.simulate_learning_runs_soa(
        jp, jl, scen, jnp.asarray(seed_xs), jnp.zeros((T_ROWS, 2)), 121,
        1.0, key, **kw)
    tp = convert.ilqr_params(jp, device="cpu")
    tl = convert.system_limits(jl, device="cpu")
    ts = convert.scenarios(scen, device="cpu")
    noise = torch.from_numpy(_jax_draws(key, BUDGET, B))
    k3 = build_fused_ilqr(tp, tl, 1.0, num_horizon=6, max_iter=CAP)
    runs = {name: simulate_learning_runs_soa(
        tp, tl, ts, seed_xs, None, 121, 1.0, noise=noise, **kw, **extra)
        for name, extra in (("candidate", dict(candidate_solver=k3)),
                            ("plain", {}))}
    return jr, runs


@pytest.fixture(scope="module", params=sorted(NL_MODES))
def nlmpc_runs(request):
    """The JAX run and the port's runs through K4 and the plain step, with
    streak statistics, in one safe-set mode."""
    mode, laps, seed = NL_MODES[request.param]
    _, seed_xs, seed_us = _seed()
    jp = JLmpcParams.make(dtype=jnp.float64, **mode)
    jl = JLimits.make(dtype=jnp.float64)
    scen = _jax_scenarios()
    key = jax.random.PRNGKey(seed)
    kw = dict(num_laps=laps, max_steps=T_ROWS, max_laps=MAX_LAPS,
              sim_step_budget=BUDGET, max_lm_iters=CAP,
              with_streak_stats=True)
    jr = jns.simulate_nlmpc_runs_soa(
        jp, jl, scen, jnp.asarray(seed_xs), jnp.asarray(seed_us), 121, 1.0,
        key, **kw)
    tp = convert.lmpc_params(jp, device="cpu")
    tl = convert.system_limits(jl, device="cpu")
    ts = convert.scenarios(scen, device="cpu")
    noise = torch.from_numpy(_jax_draws(key, laps * BUDGET, B))
    k4 = build_fused_lm_shooting(tl, 1.0, num_horizon=6, max_iters=CAP)
    runs = {name: simulate_nlmpc_runs_soa(
        tp, tl, ts, seed_xs, seed_us, 121, 1.0, noise=noise, **kw, **extra)
        for name, extra in (("candidate", dict(candidate_solver=k4)),
                            ("plain", {}))}
    return jr, runs


def _against_jax(tr, jr):
    np.testing.assert_array_equal(tr.lap_steps.numpy(),
                                  np.asarray(jr.lap_steps))
    np.testing.assert_array_equal(tr.lap_done.numpy(),
                                  np.asarray(jr.lap_done))
    np.testing.assert_allclose(tr.final_x.numpy(), np.asarray(jr.final_x),
                               rtol=0, atol=1e-9)
    assert len(tr.safe_set) == len(jr.safe_set)
    for t, j in zip(tr.safe_set, jr.safe_set):
        np.testing.assert_allclose(t.numpy().astype(np.float64),
                                   np.asarray(j).astype(np.float64), rtol=0,
                                   atol=1e-9)
    assert tr.lap_count == int(jr.lap_count)


def _bitwise(a, b):
    for name in ("lap_steps", "lap_done", "final_x"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for x, y in zip(a.safe_set, b.safe_set):
        assert torch.equal(x, y)
    assert a.final_key == b.final_key


def test_i2lqr_candidate_path_matches_jax_f64(i2lqr_runs):
    jr, runs = i2lqr_runs
    _against_jax(runs["candidate"], jr)
    assert bool(runs["candidate"].lap_done.all())


def test_i2lqr_candidate_path_equals_the_plain_path(i2lqr_runs):
    _, runs = i2lqr_runs
    _bitwise(runs["candidate"], runs["plain"])


def test_nlmpc_candidate_path_matches_jax_f64(nlmpc_runs):
    jr, runs = nlmpc_runs
    _against_jax(runs["candidate"], jr)


def test_nlmpc_candidate_path_equals_the_plain_path(nlmpc_runs):
    _, runs = nlmpc_runs
    _bitwise(runs["candidate"], runs["plain"])
    for x, y in zip(runs["candidate"].streaks, runs["plain"].streaks):
        assert torch.equal(x, y)


def test_streaks_match_jax(nlmpc_runs):
    """(recovered, terminal) all-infeasible streak maxima per lane-lap
    (batched_nlmpc_soa.py:704-711, :812-815); spaceVarying's key 6 has
    lanes that recover from a streak and lanes that end in one."""
    jr, runs = nlmpc_runs
    for t, j in zip(runs["candidate"].streaks, jr.streaks):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if runs["candidate"].lap_steps.shape[0] == 2:
        assert int(runs["candidate"].streaks[0].max()) > 0
        assert int(runs["candidate"].streaks[1].max()) > 0


class _Solver:
    """A backend that is only its attributes: the checks run before any
    step."""

    def __init__(self, **attrs):
        self.__dict__.update(attrs)


def _i2lqr_call(port, solver_kw, cap):
    _, seed_xs, _ = _seed()
    jp, jl, scen = (JIlqrParams.make(dtype=jnp.float64),
                    JLimits.make(dtype=jnp.float64), _jax_scenarios())
    kw = dict(num_laps=1, max_steps=T_ROWS, max_laps=MAX_LAPS,
              solver_max_iter=cap)
    if port:
        return simulate_learning_runs_soa(
            convert.ilqr_params(jp, device="cpu"),
            convert.system_limits(jl, device="cpu"),
            convert.scenarios(scen, device="cpu"), seed_xs, None, 121, 1.0,
            **{{"pallas_solver": "candidate_solver",
                "pallas_step_solver": "step_solver"}[k]: v
               for k, v in solver_kw.items()}, **kw)
    return jbs.simulate_learning_runs_soa(
        jp, jl, scen, jnp.asarray(seed_xs), jnp.zeros((T_ROWS, 2)), 121,
        1.0, jax.random.PRNGKey(0), **solver_kw, **kw)


def _nlmpc_call(port, solver_kw, cap):
    _, seed_xs, seed_us = _seed()
    jp, jl, scen = (JLmpcParams.make(dtype=jnp.float64),
                    JLimits.make(dtype=jnp.float64), _jax_scenarios())
    kw = dict(num_laps=1, max_steps=T_ROWS, max_laps=MAX_LAPS,
              max_lm_iters=cap)
    if port:
        return simulate_nlmpc_runs_soa(
            convert.lmpc_params(jp, device="cpu"),
            convert.system_limits(jl, device="cpu"),
            convert.scenarios(scen, device="cpu"), seed_xs, seed_us, 121,
            1.0, **{{"pallas_solver": "candidate_solver",
                     "pallas_step_solver": "step_solver"}[k]: v
                    for k, v in solver_kw.items()}, **kw)
    return jns.simulate_nlmpc_runs_soa(
        jp, jl, scen, jnp.asarray(seed_xs), jnp.asarray(seed_us), 121, 1.0,
        jax.random.PRNGKey(0), **solver_kw, **kw)


K1_LIKE = dict(k=8, nsi=1, num_horizon=6, max_steps=T_ROWS,
               max_laps=MAX_LAPS, max_iter=CAP)
K2_LIKE = dict(k=8, nsi=1, num_horizon=6, max_steps=T_ROWS,
               max_laps=MAX_LAPS, max_iters=CAP, mode="spaceVarying",
               all_iter=False)
BAD_BACKENDS = {
    "i2lqr cap": (_i2lqr_call, dict(pallas_solver=_Solver(
        max_iter=CAP + 1, with_skip=True)), "max_iter"),
    "i2lqr both": (_i2lqr_call, dict(
        pallas_solver=_Solver(max_iter=CAP, with_skip=True),
        pallas_step_solver=_Solver(**K1_LIKE)), "one backend"),
    "nlmpc cap": (_nlmpc_call, dict(pallas_solver=_Solver(
        max_iters=CAP + 1, with_skip=True, with_hzn=True)), "max_iters"),
    "nlmpc no hzn": (_nlmpc_call, dict(pallas_solver=_Solver(
        max_iters=CAP, with_skip=True, with_hzn=False)), "with_hzn"),
    "nlmpc both": (_nlmpc_call, dict(
        pallas_solver=_Solver(max_iters=CAP, with_skip=True, with_hzn=True),
        pallas_step_solver=_Solver(**K2_LIKE)), "one backend"),
}


@pytest.mark.parametrize("case", sorted(BAD_BACKENDS))
def test_backend_checks_raise_as_jax(case):
    call, solver_kw, match = BAD_BACKENDS[case]
    with pytest.raises(ValueError):
        call(False, solver_kw, CAP)
    with pytest.raises(ValueError, match=match):
        call(True, solver_kw, CAP)


@pytest.mark.parametrize("mode", ["spaceVarying", "timeVarying"])
def test_k2_factory_refuses_every_stored_lap_outside_all(mode):
    """The kNN or window over every stored lap runs through the plain
    step's glue and a candidate solver: no K2 serves it, as no TPU step
    kernel does (pallas_nlmpc_step.py:214-215)."""
    opts = dict(ss_option=mode, all_ss_iter=True)
    sizes = dict(num_horizon=6, max_steps=T_ROWS, max_laps=MAX_LAPS,
                 max_iters=CAP)
    with pytest.raises(ValueError, match="all_iter"):
        j_build_fused_nlmpc_step(JLmpcParams.make(**opts),
                                 JLimits.make(), 1.0, mode=mode,
                                 all_iter=True, **sizes)
    tp = convert.lmpc_params(JLmpcParams.make(**opts), device="cpu")
    with pytest.raises(ValueError, match="all_iter"):
        build_fused_nlmpc_step(tp, convert.system_limits(
            JLimits.make(), device="cpu"), 1.0, **sizes)
    assert not k2_serves(tp)
    for served in (dict(ss_option=mode),
                   dict(all_ss_point=True, all_ss_iter=True)):
        assert k2_serves(convert.lmpc_params(JLmpcParams.make(**served),
                                             device="cpu"))
