"""Port ``lm_feasibility_solve_soa`` against the JAX solve on random
candidate lanes: every effective horizon m = 2..6 (``m_lanes``), per-lane
static and moving obstacles with one absent, random warm starts past the
input bounds, LM cap 12. Also the K4 wrapper's CPU route against the plain
solve.

In f64 the verdicts agree on every lane and the feasible lanes' solutions
to 1e-8 (they agree to ~1e-13). An infeasible lane runs both starts to the
cap along a shallow valley, where the last-bit differences between XLA:CPU
(FMA contraction, its own sin/cos) and torch grow into other iterates; for
those lanes only the verdict is held, as tests/test_lm_shooting_soa.py
holds the JAX package's own solves.
"""

import jax.numpy as jnp
import numpy as np
import torch

from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObstacle
from ilqr_iterative_tasks_tpu.ops.lm_shooting_soa import (
    lm_feasibility_solve_soa as j_solve)
from ilqr_iterative_tasks_tpu.sim.seed import seed_trajectory as j_seed
from ilqr_iterative_tasks_tpu.utils.params import SystemLimits as JLimits
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    build_fused_lm_shooting, fused_lm_shooting_reference,
    obstacle_to_lanes_nlmpc)
from ilqr_iterative_tasks_torch.ops.lm_shooting_soa import (
    lm_feasibility_solve_soa)
from ilqr_iterative_tasks_torch.utils import convert

torch.set_num_threads(1)
B, N, CAP = 64, 6, 12


def _problem(seed=0):
    """x0 near a seed-lap state, x_term m..m+2 seed rows ahead (reachable
    or just out of reach), an obstacle near the segment between them
    (static / moving +y / moving -x, lane 5 absent), m = 2..6 per lane."""
    rng = np.random.default_rng(seed)
    xcl, _ = j_seed(1.0)
    m = 2 + np.arange(B) % 5
    rows = rng.integers(0, 100, B)
    x0 = xcl[rows] + rng.normal(size=(B, 4)) * [0.3, 0.3, 0.1, 0.03]
    xt = (xcl[rows + m + rng.integers(0, 3, B)]
          + rng.normal(size=(B, 4)) * [0.3, 0.3, 0.1, 0.03])
    mid = 0.5 * (x0 + xt)
    opt = np.arange(B) % 3
    obs = dict(x=mid[:, 0] + rng.normal(size=B) * 3,
               y=mid[:, 1] + rng.normal(size=B) * 3,
               width=2.0 + 4 * rng.random(B), height=2.0 + 4 * rng.random(B),
               spd=np.where(opt == 0, 0.0, 0.5 * rng.random(B)),
               moving_option=opt.astype(float),
               present=(np.arange(B) != 5).astype(float))
    u0 = rng.normal(size=(N, 2, B)) * np.array([1.5, 1.0])[None, :, None]
    return x0.T.copy(), xt.T.copy(), u0, obs, m


def _both(dtype_j, dtype_t):
    x0, xt, u0, obs, m = _problem()
    jo = JObstacle(**{k: jnp.asarray(v, dtype_j) for k, v in obs.items()})
    jl = JLimits.make(dtype=dtype_j)
    js = j_solve(jl, jo, jnp.asarray(x0, dtype_j), jnp.asarray(xt, dtype_j),
                 jnp.asarray(u0, dtype_j), 1.0, num_horizon=N,
                 max_iters=CAP, m_lanes=jnp.asarray(m, jnp.int32))
    tl = convert.system_limits(jl, dtype=dtype_t, device="cpu")
    f = lambda a: convert.tensor(a, dtype=dtype_t, device="cpu")
    obs_l = obstacle_to_lanes_nlmpc(convert.obstacle(jo, dtype=dtype_t, device="cpu"), B)
    ts = lm_feasibility_solve_soa(tl, obs_l, f(x0), f(xt), f(u0), 1.0,
                                  num_horizon=N, max_iters=CAP,
                                  m_lanes=torch.from_numpy(m),
                                  done0=torch.zeros(B, dtype=torch.bool))
    return js, ts, (tl, obs_l, f(x0), f(xt), f(u0), m)


def test_solve_matches_jax_f64():
    js, ts, _ = _both(jnp.float64, torch.float64)
    feas = np.asarray(js.feasible)
    assert 0.2 < feas.mean() < 0.9, feas.mean()  # both verdicts exercised
    np.testing.assert_array_equal(ts.feasible.numpy(), feas)
    for got, want in ((ts.us, js.us), (ts.xs, js.xs),
                      (ts.term_err, js.term_err),
                      (ts.max_violation, js.max_violation)):
        np.testing.assert_allclose(got.numpy()[..., feas],
                                   np.asarray(want)[..., feas], rtol=0,
                                   atol=1e-8)
    np.testing.assert_array_equal(ts.n_iters.numpy()[feas],
                                  np.asarray(js.n_iters)[feas])


def test_solve_done0_lanes_freeze():
    """done0 lanes run no iteration in either start: they return the better
    of the clipped warm start and zeros; the other lanes solve as if no lane
    were frozen."""
    _, ts, (tl, obs_l, x0, xt, u0, m) = _both(jnp.float64, torch.float64)
    done0 = torch.arange(B) % 4 == 1
    mm = torch.from_numpy(m)
    got = lm_feasibility_solve_soa(tl, obs_l, x0, xt, u0, 1.0,
                                   num_horizon=N, max_iters=CAP, m_lanes=mm,
                                   done0=done0)
    frozen = lm_feasibility_solve_soa(tl, obs_l, x0, xt, u0, 1.0,
                                      num_horizon=N, max_iters=0, m_lanes=mm,
                                      done0=torch.zeros(B, dtype=torch.bool))
    assert bool((got.n_iters[done0] == 0).all())
    assert bool((got.n_iters[~done0] > 0).all())
    for g, f, t in zip(got, frozen, ts):
        assert torch.equal(g[..., done0], f[..., done0])
        assert torch.equal(g[..., ~done0], t[..., ~done0])


def test_solve_f32_decisions():
    js, ts, _ = _both(jnp.float32, torch.float32)
    agree = (ts.feasible.numpy() == np.asarray(js.feasible)).mean()
    assert agree >= 0.95, agree


def test_k4_cpu_route_is_the_plain_solve():
    _, ts, (tl, obs_l, x0, xt, u0, m) = _both(jnp.float64, torch.float64)
    k4 = build_fused_lm_shooting(tl, 1.0, num_horizon=N, max_iters=CAP)
    skip = torch.zeros(B, dtype=torch.float32)
    skip[::16] = 1.0
    hzn = torch.from_numpy(m).to(torch.int32)
    hzn[::7] = 1  # clipped to 2 inside
    got = k4(x0, xt, u0, obs_l, skip, hzn)
    want = fused_lm_shooting_reference(tl, 1.0, x0, xt, u0, obs_l, skip, hzn,
                                       num_horizon=N, max_iters=CAP)
    assert k4.launches == 0  # the plain route counts no launch
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # non-skip lanes at m >= 2 are the plain solve's lanes
    keep = (skip == 0) & (hzn >= 2)
    torch.testing.assert_close(got[0][..., keep], ts.us[..., keep], rtol=0,
                               atol=0)
    np.testing.assert_array_equal(got[3][keep].numpy(),
                                  ts.feasible[keep].double().numpy())
    # skip lanes ran no iteration: the better of the clipped warm start and
    # zeros, judged by the residual
    frozen = lm_feasibility_solve_soa(tl, obs_l, x0, xt, u0, 1.0,
                                      num_horizon=N, max_iters=0,
                                      m_lanes=torch.clamp(hzn, 2, N),
                                      done0=torch.zeros(B, dtype=torch.bool))
    s = skip > 0.5
    assert torch.equal(got[0][..., s], frozen.us[..., s])
