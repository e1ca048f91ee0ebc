"""Port leaves against the JAX package in f64: params (with the
delta_max_r rounding), the NLMPC params and constants (raw delta_max), the
bicycle step and Jacobians, the obstacle's extrapolation and motion, both
obstacle lane packings and the seed lap."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_tpu.models import kinetic_bicycle as jdyn
from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObstacle
from ilqr_iterative_tasks_tpu.ops._pallas_nlmpc_core import bake_nlmpc_consts
from ilqr_iterative_tasks_tpu.ops.pallas_ilqr import (
    obstacle_to_lanes as j_obstacle_to_lanes)
from ilqr_iterative_tasks_tpu.ops.pallas_lm_shooting import (
    obstacle_to_lanes_nlmpc as j_obstacle_to_lanes_nlmpc)
from ilqr_iterative_tasks_tpu.sim.seed import seed_trajectory as j_seed
from ilqr_iterative_tasks_tpu.utils.params import (
    IlqrParams as JParams, LmpcParams as JLmpcParams, SystemLimits as JLimits)
from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import k2_serves
from ilqr_iterative_tasks_torch.models import kinetic_bicycle as tdyn
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.fused_ilqr import obstacle_to_lanes
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    obstacle_to_lanes_nlmpc)
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils import convert
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, LmpcParams, SystemLimits, nlmpc_consts)

torch.set_num_threads(1)
TOL = dict(rtol=1e-12, atol=1e-12)
F64 = torch.float64


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def test_params_match_jax():
    jp, tp = JParams.make(dtype=jnp.float64), IlqrParams.make(dtype=F64, device="cpu")
    for name in tp.__dataclass_fields__:
        _close(getattr(tp, name), getattr(jp, name))
    jl, tl = JLimits.make(dtype=jnp.float64), SystemLimits.make(dtype=F64, device="cpu")
    for name in tl.__dataclass_fields__:
        _close(getattr(tl, name), getattr(jl, name))
    assert float(tl.delta_max_r) == 1.57  # round(pi/2, 2), not pi/2
    conv = convert.system_limits(jl, device="cpu")
    _close(conv.delta_max_r, jl.delta_max_r)
    cp = convert.ilqr_params(JParams.make(dtype=jnp.float64, num_ss_iter=2), device="cpu")
    assert cp.num_ss_iter == 2 and cp.num_horizon == 6


def test_lmpc_params_and_nlmpc_consts_match_jax():
    jp, tp = JLmpcParams.make(dtype=jnp.float64), LmpcParams.make(dtype=F64, device="cpu")
    for f in tp.__dataclass_fields__:
        a, b = getattr(tp, f), getattr(jp, f)
        if isinstance(a, torch.Tensor):
            _close(a, b)
        else:
            assert a == b, f
    assert (tp.num_ss_points, tp.num_ss_iter, tp.num_horizon) == (8, 1, 6)
    assert (tp.ss_option, tp.all_ss_point, tp.all_ss_iter) == (
        "spaceVarying", False, False)
    cp = convert.lmpc_params(JLmpcParams.make(dtype=jnp.float64,
                                              num_ss_points=4), device="cpu")
    assert cp.num_ss_points == 4 and cp.ss_option == "spaceVarying"
    # every safe-set option converts and resolves to the JAX simulator's
    # mode (batched_nlmpc_soa.py:157-164), the kNN or window over every
    # stored lap included; only that one runs without a K2
    for opts in (dict(), dict(ss_option="timeVarying"),
                 dict(all_ss_point=True),
                 dict(all_ss_point=True, all_ss_iter=True),
                 dict(all_ss_iter=True),
                 dict(ss_option="timeVarying", all_ss_iter=True)):
        jo = JLmpcParams.make(dtype=jnp.float64, **opts)
        co = convert.lmpc_params(jo, device="cpu")
        assert co.ss_mode == ("all" if jo.all_ss_point else jo.ss_option)
        assert co.all_ss_iter == jo.all_ss_iter
        assert k2_serves(co) == (co.ss_mode == "all" or not co.all_ss_iter)
    jc = bake_nlmpc_consts(JLimits.make(dtype=jnp.float64), 1.0)
    tc = nlmpc_consts(SystemLimits.make(dtype=F64, device="cpu"), 1.0)
    for t_name, j_name in (("dt", "dtf"), ("a_max", "a_max"),
                           ("d_max", "d_max"), ("sqrt_w", "sqrt_w"),
                           ("margin", "margin"), ("term_tol", "term_tol"),
                           ("viol_tol", "viol_tol")):
        _close(getattr(tc, t_name), getattr(jc, j_name))
    assert tc.d_max == np.pi / 2  # the raw bound, not round(pi/2, 2)


def test_bicycle_step_and_jacobians_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 4)) * [10, 10, 3, 2]
    u = rng.normal(size=(7, 2))
    for dt in (1.0, 0.7):
        _close(tdyn.step(torch.from_numpy(x), torch.from_numpy(u), dt),
               jdyn.step(jnp.asarray(x), jnp.asarray(u), dt))
        v, th, a = (torch.from_numpy(x[:, 2]), torch.from_numpy(x[:, 3]),
                    torch.from_numpy(u[:, 0]))
        _close(tdyn.jacobian_A(v, th, a, dt),
               jdyn.jacobian_A(jnp.asarray(x[:, 2]), jnp.asarray(x[:, 3]),
                               jnp.asarray(u[:, 0]), dt))
        _close(tdyn.jacobian_B(th, dt),
               jdyn.jacobian_B(jnp.asarray(x[:, 3]), dt))


@pytest.mark.parametrize("option,spd", [(0, 0.0), (1, 1.0), (2, 0.5)])
def test_obstacle_center_advance_and_lanes_match_jax(option, spd):
    jo = JObstacle.make(31.0, -2.0, 8.0, 6.0, spd=spd, moving_option=option,
                        dtype=jnp.float64)
    to = Obstacle.make(31.0, -2.0, 8.0, 6.0, spd=spd, moving_option=option,
                       dtype=F64, device="cpu")
    offs = np.arange(7.0)
    for a, b in zip(to.center_at(torch.from_numpy(offs)),
                    jo.center_at(jnp.asarray(offs))):
        _close(a, b)
    ta, ja = to.advance(1.0), jo.advance(1.0)
    _close(ta.x, ja.x)
    _close(ta.y, ja.y)
    _close(convert.obstacle(jo, device="cpu").y, jo.y)
    # lane packing: the JAX packer casts to f32; compare at f32 exactly
    jl = np.asarray(j_obstacle_to_lanes(jo, 5))
    tl = obstacle_to_lanes(to, 5).to(torch.float32).numpy()
    np.testing.assert_array_equal(tl, jl)
    absent = obstacle_to_lanes(Obstacle.absent(dtype=F64, device="cpu"), 3)
    assert float(absent[2].abs().max()) == 0.0  # present masks the barrier
    # the NLMPC packing: the JAX packer casts to f32 (equal there); in f64
    # each row equals the quantity the JAX plain solve computes
    jn = np.asarray(j_obstacle_to_lanes_nlmpc(jo, 5))
    tn = obstacle_to_lanes_nlmpc(to, 5)
    np.testing.assert_array_equal(tn.to(torch.float32).numpy(), jn)
    up = jo.spd * (jo.moving_option == 1)
    left = jo.spd * (jo.moving_option == 2)
    for row, want in zip(tn, (jo.x, jo.y, 1.0 / jo.width ** 2,
                              1.0 / jo.height ** 2, up, left, jo.present)):
        _close(row, np.broadcast_to(np.asarray(want), (5,)))
    cx, cy = jo.center_at(3.0)
    _close(tn[0] - tn[5] * 3.0, np.broadcast_to(np.asarray(cx), (5,)))
    _close(tn[1] + tn[4] * 3.0, np.broadcast_to(np.asarray(cy), (5,)))
    assert float(obstacle_to_lanes_nlmpc(Obstacle.absent(dtype=F64, device="cpu"),
                                         3)[6].max()) == 0.0


def test_seed_trajectory_matches_jax():
    for dt in (1.0, 0.5):
        jx, ju = j_seed(dt)
        tx, tu = seed_trajectory(dt)
        assert tx.shape == jx.shape == (int(120 / dt) + 1, 4)
        _close(tx, jx)
        _close(tu, ju)
