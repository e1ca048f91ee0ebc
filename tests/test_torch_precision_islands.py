"""``precision_islands`` in the port's plain SoA solve (ops/ilqr_soa.py)
against the JAX package's (ops/ilqr_soa.py:83-133), with x64 on: "trig",
"exp" and "cost" inside an f32 solve, alone and all three together, on
tests/test_torch_ilqr_soa.py's random lanes at horizon 3.

JAX's solve runs op by op (``jax.disable_jit``). Compiled, XLA:CPU
contracts f32 a*b+c into FMAs and the port does not, which moves both
solves by ulps on most lanes and hides an island's own ulp. Op by op, the
only f32 differences left are the sin / cos / exp implementations, which
are what the "trig" and "exp" islands replace by f64-then-round.

The standard, bit for bit on a lane's inputs and cost:
- every lane on which the plain solves agree bit for bit agrees with the
  island too (so the lanes the island changes among them are the same
  lanes in both);
- the island changes the port's solve on some lane;
- it makes more lanes agree than the plain solves do, or changes some of
  the lanes on which those agree ("cost" alone: the sums already agree op
  by op, and the island changes 11 of those lanes in both);
- with all three, 95 % of lanes agree and the rest within 1e-7 in the
  inputs (the plain solves: 35 of 64 lanes, up to 3e-6).
Ignoring an island, or wiring it to another island's terms, fails one of
these. In f64 an island is the solve itself, bit for bit. The i2LQR
simulator passes them to its plain route and refuses them where a kernel
solves."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObstacle
from ilqr_iterative_tasks_tpu.ops.ilqr_soa import ilqr_solve_soa as j_solve
from ilqr_iterative_tasks_tpu.utils.params import (
    IlqrParams as JParams, SystemLimits as JLimits)
from ilqr_iterative_tasks_torch.control.batched_soa import (
    SoaScenarios, simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
    build_fused_ilqr, obstacle_to_lanes)
from ilqr_iterative_tasks_torch.ops.ilqr_soa import ilqr_solve_soa
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils import convert
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits

from test_torch_ilqr_soa import B, CAP, _problem

torch.set_num_threads(1)
N = 3
ISLANDS = [("trig",), ("exp",), ("cost",), ("trig", "exp", "cost")]


def _port(dtype, islands):
    x0, xt, obs = _problem()
    o = Obstacle(**{k: torch.tensor(v, dtype=dtype) for k, v in obs.items()})
    return ilqr_solve_soa(
        IlqrParams.make(dtype=dtype, device="cpu"),
        SystemLimits.make(dtype=dtype, device="cpu"), obstacle_to_lanes(o, B),
        torch.tensor(x0, dtype=dtype), torch.tensor(xt, dtype=dtype),
        torch.zeros((N, 2, B), dtype=dtype), 1.0, 1.0, num_horizon=N,
        max_iter=CAP, precision_islands=islands)


@functools.lru_cache(maxsize=None)
def _jax(islands):
    """JAX's f32 solve op by op: (us, cost, lamb, n_iters) as numpy."""
    x0, xt, obs = _problem()
    f32 = jnp.float32
    with jax.disable_jit():
        js = j_solve(JParams.make(dtype=f32), JLimits.make(dtype=f32),
                     JObstacle(**{k: jnp.asarray(v, f32)
                                  for k, v in obs.items()}),
                     jnp.asarray(x0, f32), jnp.asarray(xt, f32),
                     jnp.zeros((N, 2, B), f32), 1.0, 1.0, num_horizon=N,
                     max_iter=CAP, precision_islands=islands)
    return (np.asarray(js.us), np.asarray(js.cost), np.asarray(js.lamb),
            int(js.n_iters))


def _same(a, b):
    """Lanes on which two solves' inputs and costs are equal bit for bit."""
    return (a[0] == b[0]).all(axis=(0, 1)) & (a[1] == b[1])


@pytest.mark.parametrize("islands", ISLANDS, ids="+".join)
def test_island_matches_jax(islands):
    ts = _port(torch.float32, islands)
    assert ts.cost.dtype == ts.us.dtype == torch.float32
    port = (ts.us.numpy(), ts.cost.numpy())
    port_plain = _port(torch.float32, ())
    port_plain = (port_plain.us.numpy(), port_plain.cost.numpy())
    jx, jx_plain = _jax(islands), _jax(())
    assert ts.n_iters == jx[3]
    np.testing.assert_array_equal(ts.lamb.numpy(), jx[2])
    agree, agree_plain = _same(port, jx), _same(port_plain, jx_plain)
    changed = ~_same(port, port_plain)
    assert agree[agree_plain].all(), np.where(agree_plain & ~agree)
    assert changed.any()
    assert agree.sum() > agree_plain.sum() or (changed & agree_plain).any()
    if len(islands) == 3:
        assert agree.mean() >= 0.95, agree.sum()
        np.testing.assert_allclose(port[0], jx[0], atol=1e-7, rtol=0)


def test_islands_in_f64_are_the_solve():
    plain = _port(torch.float64, ())
    for islands in ISLANDS + [("trig", "exp", "cost")]:
        got = _port(torch.float64, islands)
        assert torch.equal(got.us, plain.us) and torch.equal(
            got.cost, plain.cost)
    with pytest.raises(ValueError, match="precision_islands"):
        _port(torch.float32, ("sqrt",))


def test_simulator_takes_islands_on_the_plain_route_only():
    xcl, _ = seed_trajectory(1.0)
    seed_xs = np.zeros((128, 4))
    seed_xs[:121] = xcl
    p, lim = IlqrParams.make(device="cpu"), SystemLimits.make(device="cpu")
    scen = SoaScenarios.broadcast(np.zeros(4), xcl[-1],
                                  Obstacle.make(31.0, -2.0, 8.0, 6.0,
                                                device="cpu"),
                                  2, device="cpu")
    kw = dict(num_laps=1, max_steps=128, max_laps=4, solver_max_iter=8,
              sim_step_budget=3)
    runs = [simulate_learning_runs_soa(p, lim, scen, seed_xs, None, 121, 1.0,
                                       precision_islands=isl, **kw)
            for isl in ((), ("trig", "exp", "cost"))]
    assert all(r.lap_steps.tolist() == [[3, 3]] for r in runs)
    assert all(bool(torch.isfinite(r.safe_set[0][1]).all()) for r in runs)
    k3 = build_fused_ilqr(p, lim, 1.0, num_horizon=6, max_iter=8)
    with pytest.raises(ValueError, match="precision_islands"):
        simulate_learning_runs_soa(p, lim, scen, seed_xs, None, 121, 1.0,
                                   candidate_solver=k3,
                                   precision_islands=("trig",), **kw)
