"""One NLMPC control step (spaceVarying, f64, B = 64): the port's plain K2
(``nlmpc_step_reference``) plus ``advance_tail`` against the JAX simulator.

``solve_step_general`` is a closure of the JAX simulator, so the JAX side
is one simulator step: ``resume_from`` a safe set built with numpy, one
learning lap with ``sim_step_budget=1``, noise off. The newest stored lap
sets each lane's terminal guess (its row n) and warm start (its first n
inputs), batched_nlmpc_soa.py:833-836. Each lane stores a slice of the seed
lap that starts near its own x0, some shorter than k, with its own
obstacle; a few lanes start far off and have no feasible candidate. The
recorded next state and input agree to 1e-9. The step runs at hzn = n;
shrunk horizons are held by tests/test_torch_lm_shooting_soa.py
(``m_lanes``) and the closed loops of tests/test_torch_batched_nlmpc_soa.py.
Also: the K2 wrapper's CPU route is the plain step, at every horizon.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ilqr_iterative_tasks_tpu.control import batched_nlmpc_soa as jns
from ilqr_iterative_tasks_tpu.control.batched_soa import (
    SoaScenarios as JScenarios)
from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObstacle
from ilqr_iterative_tasks_tpu.sim.seed import seed_trajectory as j_seed
from ilqr_iterative_tasks_tpu.utils.params import (
    LmpcParams as JParams, SystemLimits as JLimits)
from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import advance_tail
from ilqr_iterative_tasks_torch.control.batched_soa import _step_solver_inputs
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    obstacle_to_lanes_nlmpc)
from ilqr_iterative_tasks_torch.ops.ilqr_soa import step_soa
from ilqr_iterative_tasks_torch.ops.nlmpc_step import (
    build_fused_nlmpc_step, nlmpc_step_reference)
from ilqr_iterative_tasks_torch.utils import convert

torch.set_num_threads(1)
B, N, T_ROWS, MAX_LAPS, LAPS, CAP = 64, 6, 40, 4, 2, 12


def _problem(seed=0):
    """Numpy safe set with LAPS stored laps, scenarios and obstacles."""
    rng = np.random.default_rng(seed)
    xcl, ucl = j_seed(1.0)
    start = rng.integers(0, 80, B)
    length = rng.integers(4, T_ROWS + 1, B)  # some shorter than k = 8
    states = np.zeros((MAX_LAPS, T_ROWS, 4, B))
    inputs = np.zeros((MAX_LAPS, T_ROWS, 2, B))
    lap_len = np.zeros((MAX_LAPS, B), np.int32)
    for lap in range(LAPS):
        for b in range(B):
            r = start[b] if lap == LAPS - 1 else 0
            rows = min(length[b], 120 - r)
            states[lap, :rows, :, b] = xcl[r:r + rows]
            inputs[lap, :rows, :, b] = ucl[r:r + rows]
            lap_len[lap, b] = rows
    t = np.arange(T_ROWS)[None, :, None]
    qfun = np.maximum(lap_len[:, None, :] - 1.0 - t, 0.0)
    valid = t < lap_len[:, None, :]
    x0 = (xcl[start] + rng.normal(size=(B, 4)) * [0.2, 0.2, 0.05, 0.02]).T
    x0[1, -8:] += 60.0  # far off the stored lap: all candidates infeasible
    opt = np.arange(B) % 3
    centre = xcl[start + 3]
    obs = dict(x=centre[:, 0] + rng.normal(size=B) * 4,
               y=centre[:, 1] + rng.normal(size=B) * 4,
               width=1.0 + 3 * rng.random(B), height=1.0 + 3 * rng.random(B),
               spd=np.where(opt == 0, 0.0, 0.5 * rng.random(B)),
               moving_option=opt.astype(float),
               present=(np.arange(B) % 10 != 9).astype(float))
    return (states, inputs, qfun, valid, lap_len), x0, obs, xcl[-1]


def test_one_step_matches_jax_f64():
    ss, x0, obs, goal = _problem()
    jp, jl = JParams.make(dtype=jnp.float64), JLimits.make(dtype=jnp.float64)
    jo = JObstacle(**{k: jnp.asarray(v) for k, v in obs.items()})
    scen = JScenarios(x0=jnp.asarray(x0),
                      goal=jnp.broadcast_to(jnp.asarray(goal)[:, None],
                                            (4, B)),
                      obstacle=jo, noise_on=jnp.zeros(B))
    key = jax.random.PRNGKey(0)
    jss = tuple(jnp.asarray(a) for a in ss)
    jr = jns.simulate_nlmpc_runs_soa(
        jp, jl, scen, jss[0][0, :, :, 0], jss[1][0, :, :, 0], 121, 1.0, key,
        num_laps=1, max_steps=T_ROWS, max_laps=MAX_LAPS, goal_append=True,
        sim_step_budget=1, max_lm_iters=CAP, resume_from=(jss, LAPS, key))
    j_x1 = np.asarray(jr.safe_set[0])[LAPS, 1]  # recorded next state
    j_u = np.asarray(jr.safe_set[1])[LAPS, 0]  # recorded input

    tp, tl = convert.lmpc_params(jp, device="cpu"), convert.system_limits(jl, device="cpu")
    states, inputs, qfun, _valid, lap_len = convert.safe_set(ss, device="cpu")
    x = convert.tensor(x0, dtype=torch.float64, device="cpu")
    guess, u_warm = states[LAPS - 1, N], inputs[LAPS - 1, :N]
    lap_ids, lap_ok, skip = _step_solver_inputs(LAPS, tp.num_ss_iter,
                                                MAX_LAPS, None, B, "cpu")
    hzn = torch.full((B,), N, dtype=torch.int32)
    obs_l = obstacle_to_lanes_nlmpc(convert.obstacle(jo, device="cpu"), B)
    us_w, feas, new_guess, idx, row, succ = nlmpc_step_reference(
        tp, tl, 1.0, x, guess, u_warm, states, qfun, lap_len, lap_ids,
        lap_ok, obs_l, skip, hzn, max_iters=CAP)
    lanes = torch.arange(B)
    u_app = inputs[lap_ids.long()[row.long()], idx.long(), :, lanes].T
    u_sel, _, _, _ = advance_tail(us_w, u_app, new_guess, succ > 0.5,
                                  hzn <= 1, hzn, feas > 0.5, guess, u_warm)
    u = torch.where(feas[None] > 0.5, u_sel, 0.0)
    x1 = torch.stack(step_soa(tuple(x[i] for i in range(4)), (u[0], u[1]),
                              1.0))

    f = feas.numpy() > 0.5
    assert 0.5 < f.mean() < 1.0 and not f[-8:].any(), f
    assert 0.0 < (succ.numpy() > 0.5).mean() < 1.0  # both guess advances
    np.testing.assert_allclose(u.numpy(), j_u, rtol=0, atol=1e-9)
    np.testing.assert_allclose(x1.numpy(), j_x1, rtol=0, atol=1e-9)


def test_k2_cpu_route_is_the_plain_step():
    ss, x0, obs, _ = _problem(1)
    tp = convert.lmpc_params(JParams.make(dtype=jnp.float64), device="cpu")
    tl = convert.system_limits(JLimits.make(dtype=jnp.float64), device="cpu")
    states, inputs, qfun, _valid, lap_len = convert.safe_set(ss, device="cpu")
    lap_ids, lap_ok, _ = _step_solver_inputs(LAPS, 1, MAX_LAPS, None, B,
                                             "cpu")
    skip = (torch.arange(B) % 9 == 0).to(torch.float32)
    hzn = (1 + torch.arange(B) % N).to(torch.int32)  # every horizon 1..n
    a = (convert.tensor(x0, dtype=torch.float64, device="cpu"), states[LAPS - 1, N],
         inputs[LAPS - 1, :N], states, qfun, lap_len, lap_ids, lap_ok,
         obstacle_to_lanes_nlmpc(
             convert.obstacle(JObstacle(**{k: jnp.asarray(v)
                                           for k, v in obs.items()}), device="cpu"), B),
         skip, hzn)
    k2 = build_fused_nlmpc_step(tp, tl, 1.0, num_horizon=N,
                                max_steps=T_ROWS, max_laps=MAX_LAPS,
                                max_iters=CAP)
    got = k2(*a)
    want = nlmpc_step_reference(tp, tl, 1.0, *a, max_iters=CAP)
    assert k2.launches == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    s = skip > 0.5
    for g in got:
        assert not bool(g[..., s].any())  # skip lanes are zeros
    assert 0.0 < float((got[1][~s] > 0.5).double().mean()) < 1.0
    # trip counts of the candidate solves, summed over the two starts: 0 on
    # skipped and horizon-1 lanes
    trips = []
    for g, w in zip(nlmpc_step_reference(tp, tl, 1.0, *a, max_iters=CAP,
                                         trips=trips), got):
        assert torch.equal(g, w)
    (t,) = trips
    run = ~s & (hzn > 1)
    assert t.shape == (tp.num_ss_iter * tp.num_ss_points, B)
    assert int(t[:, ~run].abs().max()) == 0
    assert 1 <= int(t[:, run].min()) and int(t.max()) <= 2 * CAP
