"""Port ``ilqr_solve_soa`` against the JAX solver on random candidate lanes
(per-lane static and moving obstacles, LM cap 16), and the K3 wrapper's CPU
route against the plain solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObstacle
from ilqr_iterative_tasks_tpu.ops.ilqr_soa import ilqr_solve_soa as j_solve
from ilqr_iterative_tasks_tpu.sim.seed import seed_trajectory as j_seed
from ilqr_iterative_tasks_tpu.utils.params import (
    IlqrParams as JParams, SystemLimits as JLimits)
from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
    build_fused_ilqr, fused_ilqr_reference, obstacle_to_lanes)
from ilqr_iterative_tasks_torch.ops.ilqr_soa import ilqr_solve_soa
from ilqr_iterative_tasks_torch.utils import convert

torch.set_num_threads(1)
B, N, CAP = 64, 6, 16


def _problem(seed=0):
    """Random lanes around the seed lap: x0 near a seed state, x_term 15-40
    seed rows ahead (mostly out of reach in 6 steps, so costs stay far from
    the f32 cancellation floor of a reached terminal), obstacle per lane
    (static / moving +y / moving -x)."""
    rng = np.random.default_rng(seed)
    xcl, _ = j_seed(1.0)
    rows = rng.integers(0, 80, B)
    x0 = xcl[rows] + rng.normal(size=(B, 4)) * [0.5, 0.5, 0.2, 0.05]
    xt = (xcl[rows + rng.integers(15, 40, B)]
          + rng.normal(size=(B, 4)) * [2.0, 2.0, 1.0, 0.3])
    opt = np.arange(B) % 3
    obs = dict(x=31.0 + rng.normal(size=B) * 4, y=-2.0 + rng.normal(size=B) * 4,
               width=np.full(B, 8.0), height=np.full(B, 6.0),
               spd=np.where(opt == 0, 0.0, 0.5 + rng.random(B)),
               moving_option=opt.astype(float), present=np.ones(B))
    return x0.T.copy(), xt.T.copy(), obs


def _both(dtype_j, dtype_t):
    x0, xt, obs = _problem()
    jo = JObstacle(**{k: jnp.asarray(v, dtype_j) for k, v in obs.items()})
    jp, jl = JParams.make(dtype=dtype_j), JLimits.make(dtype=dtype_j)
    js = j_solve(jp, jl, jo, jnp.asarray(x0, dtype_j), jnp.asarray(xt, dtype_j),
                 jnp.zeros((N, 2, B), dtype_j), 1.0, 1.0, num_horizon=N,
                 max_iter=CAP)
    tp, tl = (convert.ilqr_params(jp, dtype=dtype_t, device="cpu"),
              convert.system_limits(jl, dtype=dtype_t, device="cpu"))
    obs_l = obstacle_to_lanes(convert.obstacle(jo, dtype=dtype_t, device="cpu"), B)
    ts = ilqr_solve_soa(tp, tl, obs_l, convert.tensor(x0, dtype=dtype_t, device="cpu"),
                        convert.tensor(xt, dtype=dtype_t, device="cpu"),
                        torch.zeros((N, 2, B), dtype=dtype_t), 1.0, 1.0,
                        num_horizon=N, max_iter=CAP)
    return js, ts, (tp, tl, obs_l, x0, xt)


def test_solve_matches_jax_f64():
    js, ts, _ = _both(jnp.float64, torch.float64)
    np.testing.assert_allclose(ts.us.numpy(), np.asarray(js.us), atol=1e-8)
    np.testing.assert_allclose(ts.xs.numpy(), np.asarray(js.xs), atol=1e-8)
    np.testing.assert_allclose(ts.cost.numpy(), np.asarray(js.cost),
                               rtol=1e-8, atol=1e-8)
    assert ts.n_iters == int(js.n_iters)


def test_solve_matches_jax_f32():
    """f32 costs within 1e-3 relative on >= 95 % of lanes. The bound is
    1e-3, not 1e-4: XLA:CPU contracts f32 a*b+c into FMAs (23 % of random
    a*b+c differ from torch's op-by-op result) and its f32 sin/cos/exp
    differ from torch's on 5-9 % of inputs; 16 LM iterations amplify that
    to 92 % of these lanes within 1e-4 (JAX f32 against JAX f64 itself
    gives 95 %)."""
    js, ts, _ = _both(jnp.float32, torch.float32)
    jc, tc = np.asarray(js.cost), ts.cost.numpy()
    agree = np.abs(tc - jc) <= 1e-3 * np.abs(jc)
    assert agree.mean() >= 0.95, agree.mean()


@pytest.mark.parametrize("with_skip", [False, True])
def test_k3_wrapper_on_cpu_is_the_plain_solve(with_skip):
    _, _, (tp, tl, obs_l, x0, xt) = _both(jnp.float64, torch.float64)
    k3 = build_fused_ilqr(tp, tl, 1.0, num_horizon=N, max_iter=CAP)
    args = (torch.from_numpy(x0), torch.from_numpy(xt),
            torch.zeros((N, 2, B), dtype=torch.float64), obs_l)
    skip = (torch.arange(B) % 4 == 0).to(torch.float32) if with_skip else None
    got = k3(*args, skip)
    want = fused_ilqr_reference(tp, tl, 1.0, *args, skip, num_horizon=N,
                                max_iter=CAP)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert k3.launches == 0  # the CPU route launches no kernel
    if with_skip:  # skip lanes start done: the rollout of u_init = zeros
        assert float(got[0][:, :, ::4].abs().max()) == 0.0
