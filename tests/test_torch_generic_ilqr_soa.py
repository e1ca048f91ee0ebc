"""The generic-system SoA solver and K5's CPU route against the JAX package:
the models' component steps and jvp Jacobians, the plain solve on the
double integrator, the unicycle, the bicycle through the generic path and a
3-input system (the damped-Cholesky branch) in f64, and the plain solve in
f32 against the JAX Pallas kernel in interpret mode, with two and three
inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_tpu.models import double_integrator as j_di
from ilqr_iterative_tasks_tpu.models import unicycle as j_uni
from ilqr_iterative_tasks_tpu.ops.generic_ilqr_soa import (
    build_generic_ilqr_soa as j_build)
from ilqr_iterative_tasks_tpu.ops.ilqr_soa import step_soa as j_bike_comps
from ilqr_iterative_tasks_tpu.ops.pallas_generic_ilqr import (
    build_generic_ilqr_pallas)
from ilqr_iterative_tasks_tpu.utils.params import (
    IlqrParams as JParams, SystemLimits as JLimits)
from ilqr_iterative_tasks_torch.experiments.generic_bench import k5_task
from ilqr_iterative_tasks_torch.models import (
    double_integrator, kinetic_bicycle, unicycle)
from ilqr_iterative_tasks_torch.ops.fused_generic_ilqr import (
    build_fused_generic_ilqr, fused_generic_ilqr_reference)
from ilqr_iterative_tasks_torch.ops.generic_ilqr_soa import (
    build_generic_ilqr_soa)

torch.set_num_threads(1)
F64 = torch.float64
MODELS = {"double_integrator": (double_integrator, j_di.step_comps),
          "unicycle": (unicycle, j_uni.step_comps),
          "bicycle": (kinetic_bicycle, j_bike_comps)}


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_step_comps_and_jvp_jacobians_match_jax(name):
    model, j_comps = MODELS[name]
    n, m = model.X_DIM, model.U_DIM
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, 7)) * 2.0
    u = rng.normal(size=(m, 7))
    dt = 0.7
    got = model.step_comps(tuple(_t(x)), tuple(_t(u)), dt)
    want = j_comps(tuple(jnp.asarray(x)), tuple(jnp.asarray(u)), dt)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)
    # one-hot jvp columns, as the solvers take them
    primals_t = tuple(_t(x)) + tuple(_t(u))
    primals_j = tuple(jnp.asarray(x)) + tuple(jnp.asarray(u))
    for j in range(n + m):
        tan_t = tuple(torch.ones(7, dtype=F64) if k == j
                      else torch.zeros(7, dtype=F64) for k in range(n + m))
        tan_j = tuple(jnp.ones(7) if k == j else jnp.zeros(7)
                      for k in range(n + m))
        _, col_t = torch.func.jvp(
            lambda *xu: model.step_comps(xu[:n], xu[n:], dt), primals_t,
            tan_t)
        _, col_j = jax.jvp(
            lambda xu: j_comps(tuple(xu[:n]), tuple(xu[n:]), dt),
            (primals_j,), (tan_j,))
        for g, w in zip(col_t, col_j, strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-12)
    # the state-last step equals the component step
    np.testing.assert_allclose(
        model.step(_t(x.T), _t(u.T), dt).numpy().T,
        np.stack([g.numpy() for g in got]), rtol=0, atol=1e-12)


def _config(name):
    """(n, m, N, kwargs, x0 (n,B), xt (n,B), u_init (N,m,B), lamb0): the
    tests/test_generic_ilqr.py configs, 16 lanes each."""
    rng = np.random.default_rng(7)
    b = 16
    if name == "double_integrator":  # tests/test_generic_ilqr.py:114-145
        n, m, nh = 4, 2, 10
        kw = dict(matrix_Q=np.zeros((n, n)), matrix_R=0.05 * np.eye(m),
                  matrix_Qterminal=20.0 * np.eye(n), u_lower=-2.0 * np.ones(m),
                  u_upper=2.0 * np.ones(m), dt=0.5)
        return (n, m, nh, kw, np.zeros((n, b)),
                rng.uniform(-4, 4, (n, b)), np.zeros((nh, m, b)), 1.0)
    if name == "unicycle":  # tests/test_generic_ilqr.py:148-167, lanes jittered
        n, m, nh = 3, 2, 8
        kw = dict(matrix_Q=np.zeros((n, n)), matrix_R=0.01 * np.eye(m),
                  matrix_Qterminal=30.0 * np.eye(n),
                  u_lower=-1.5 * np.ones(m), u_upper=1.5 * np.ones(m), dt=0.5)
        xt = np.asarray([2.0, 1.0, 0.5])[:, None] + 0.5 * rng.normal(
            size=(n, b))
        return n, m, nh, kw, np.zeros((n, b)), xt, 0.1 * np.ones((nh, m, b)), 1.0
    # bicycle through the generic path, IlqrParams costs
    # (tests/test_generic_ilqr.py:170-220). Q = R = 0 there, so a reachable
    # target drives the cost to ~0, where |dcost/cost| < eps runs on
    # rounding noise and the trip counts follow last-bit differences between
    # XLA and torch; targets out of reach in 6 steps keep the cost positive
    rng = np.random.default_rng(11)
    jp, jl = JParams.make(dtype=jnp.float64), JLimits.make(dtype=jnp.float64)
    n, m, nh = 4, 2, 6
    kw = dict(matrix_Q=np.asarray(jp.matrix_Q), matrix_R=np.asarray(jp.matrix_R),
              matrix_Qterminal=np.asarray(jp.matrix_Qterminal),
              u_lower=[-float(jl.a_max), -float(jl.delta_max_r)],
              u_upper=[float(jl.a_max), float(jl.delta_max_r)], dt=1.0)
    x0 = np.broadcast_to(np.asarray([0, 0, 1.0, 0])[:, None], (n, b)).copy()
    xt = (np.asarray([60.0, 0.0, 1.0, 0.0])[:, None]
          + np.asarray([5.0, 5.0, 0.5, 0.2])[:, None] * rng.normal(
              size=(n, b)))
    return n, m, nh, kw, x0, xt, np.zeros((nh, m, b)), float(jp.lamb)


def _compare(gen, jsol):
    np.testing.assert_allclose(gen.us.numpy(), np.asarray(jsol.us), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(gen.xs.numpy(), np.asarray(jsol.xs), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(gen.cost.numpy(), np.asarray(jsol.cost),
                               rtol=1e-9, atol=1e-12)
    assert gen.n_iters == int(jsol.n_iters)
    assert int(gen.lane_iters.max()) == gen.n_iters


@pytest.mark.parametrize("name", sorted(MODELS))
def test_plain_solve_matches_jax_f64(name):
    model, j_comps = MODELS[name]
    n, m, nh, kw, x0, xt, u0, lamb0 = _config(name)
    jsol = j_build(j_comps, n=n, m=m, num_horizon=nh, **kw)(
        jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(u0), lamb0)
    gen = build_generic_ilqr_soa(model.step_comps, n=n, m=m, num_horizon=nh,
                                 **kw)(_t(x0), _t(xt), _t(u0), lamb0)
    _compare(gen, jsol)
    # K5's CPU route is the plain solve, with per-lane trip counts
    k5 = build_fused_generic_ilqr(model, n=n, m=m, num_horizon=nh,
                                  lamb0=lamb0, **kw)
    us, x_last, cost, iters = k5(_t(x0), _t(xt), _t(u0))
    assert k5.launches == 0
    assert torch.equal(us, gen.us) and torch.equal(x_last, gen.xs[-1])
    assert torch.equal(cost, gen.cost) and torch.equal(iters, gen.lane_iters)
    assert iters.dtype == torch.int32
    ref = fused_generic_ilqr_reference(model, _t(x0), _t(xt), _t(u0), n=n,
                                       m=m, num_horizon=nh, lamb0=lamb0,
                                       **kw)
    assert all(torch.equal(a, b) for a, b in zip(ref, (us, x_last, cost,
                                                         iters)))


def _three_input(cos, sin):
    """A 3-state, 3-input system (the solvers' m > 2 branch)."""
    def step_comps(x, u, dt):
        px, py, th = x
        v, w, s = u
        return (px + v * cos(th) * dt - s * sin(th) * dt,
                py + v * sin(th) * dt + s * cos(th) * dt,
                th + w * dt)
    return step_comps


def test_three_input_cholesky_branch_matches_jax_f64():
    n, m, nh, b = 3, 3, 3, 12  # XLA:CPU compiles m = 3 slowly: keep N short
    rng = np.random.default_rng(9)
    kw = dict(matrix_Q=0.1 * np.eye(n), matrix_R=0.05 * np.eye(m)
              + 0.01 * np.ones((m, m)), matrix_Qterminal=25.0 * np.eye(n),
              u_lower=-1.5 * np.ones(m), u_upper=1.5 * np.ones(m), dt=0.5,
              max_iter=20)
    x0 = np.zeros((n, b))
    xt = rng.uniform(-2, 2, (n, b))
    u0 = 0.1 * np.ones((nh, m, b))
    jsol = j_build(_three_input(jnp.cos, jnp.sin), n=n, m=m, num_horizon=nh,
                   **kw)(jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(u0),
                         1.0)
    gen = build_generic_ilqr_soa(_three_input(torch.cos, torch.sin), n=n,
                                 m=m, num_horizon=nh, **kw)(
        _t(x0), _t(xt), _t(u0), 1.0)
    _compare(gen, jsol)
    assert 1 < gen.n_iters < 20


def test_plain_f32_matches_pallas_kernel_in_interpret_mode():
    """tests/test_generic_ilqr.py:242-274 at f32: the JAX Pallas kernel in
    interpret mode (tile_rows=1: 128-lane tiles) against the port's plain
    solve (K5's CPU route) on the same inputs; the JAX kernel reports each
    tile's lockstep trip count, the port each lane's."""
    n, m, nh, b = 4, 2, 6, 256
    kw = dict(n=n, m=m, matrix_Q=np.zeros((n, n)),
              matrix_R=0.05 * np.eye(m), matrix_Qterminal=20.0 * np.eye(n),
              u_lower=-2.0 * np.ones(m), u_upper=2.0 * np.ones(m), dt=0.5,
              num_horizon=nh, max_iter=60)
    rng = np.random.default_rng(3)
    xts = rng.uniform(-4, 4, (n, b)).astype(np.float32)
    pal = build_generic_ilqr_pallas(j_di.step_comps, tile_rows=1,
                                    interpret=True, **kw)(
        jnp.zeros((n, b), jnp.float32), jnp.asarray(xts),
        jnp.zeros((nh, m, b), jnp.float32))
    us_p, xl_p, cost_p, iters_p = (np.asarray(a) for a in pal)
    k5 = build_fused_generic_ilqr(double_integrator, **kw)
    f32 = torch.float32
    us, x_last, cost, iters = k5(torch.zeros((n, b), dtype=f32),
                                 _t(xts, f32), torch.zeros((nh, m, b),
                                                           dtype=f32))
    np.testing.assert_allclose(cost.numpy(), cost_p, rtol=2e-4)
    np.testing.assert_allclose(x_last.numpy(), xl_p, atol=2e-3)
    np.testing.assert_allclose(us.numpy(), us_p, atol=2e-3)
    tile_max = iters.reshape(-1, 128).amax(dim=1)
    np.testing.assert_array_equal(tile_max.numpy(),
                                  iters_p.reshape(-1, 128)[:, 0])


def test_three_input_k5_cpu_route_matches_pallas_kernel_in_interpret_mode():
    """K5's CPU route at m = 3 (the damped-Cholesky branch) against the JAX
    Pallas kernel in interpret mode on the same inputs, f32, at the
    tolerances of the 2-input test above: the holonomic vehicle of
    generic_bench.k5_task (this file's 3-input dynamics) at N = 3, two
    tiles of 128 lanes (tile_rows=1)."""
    model, kw, a = k5_task("holonomic", 3, 256, "cpu")
    n, m, nh = kw["n"], kw["m"], kw["num_horizon"]
    x0, xt, u0 = (t.numpy().astype(np.float32) for t in a)
    pal = build_generic_ilqr_pallas(
        _three_input(jnp.cos, jnp.sin), tile_rows=1, interpret=True,
        **kw)(jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(u0))
    us_p, xl_p, cost_p, iters_p = (np.asarray(v) for v in pal)
    k5 = build_fused_generic_ilqr(model, **kw)
    f32 = torch.float32
    us, x_last, cost, iters = k5(*(t.to(f32) for t in a))
    assert k5.launches == 0 and (n, m) == (3, 3)
    np.testing.assert_allclose(cost.numpy(), cost_p, rtol=2e-4)
    np.testing.assert_allclose(x_last.numpy(), xl_p, atol=2e-3)
    np.testing.assert_allclose(us.numpy(), us_p, atol=2e-3)
    tile_max = iters.reshape(-1, 128).amax(dim=1)
    np.testing.assert_array_equal(tile_max.numpy(),
                                  iters_p.reshape(-1, 128)[:, 0])
    assert int(iters.max()) > 1 and us.shape == (nh, m, 256)


def test_caller_model_state_squared_angle_row_input_matches_jax_f64():
    """The repair pass's caller model (tests/_k5_caller_model.py: the drag
    v * v, v * kappa in the angle's row) through the plain solve and K5's
    CPU route against the JAX package's plain solve of the same dynamics,
    f64, 16 lanes, N = 3 (XLA:CPU compiles the trig model's longer
    horizons slowly)."""
    from _k5_caller_model import DragCar, comps, task
    kw, x0, xt, u0 = task(16, 3)
    jsol = j_build(comps(jnp.cos, jnp.sin), **kw)(
        jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(u0), 1.0)
    gen = build_generic_ilqr_soa(DragCar.step_comps, **kw)(
        _t(x0), _t(xt), _t(u0), 1.0)
    _compare(gen, jsol)
    assert 1 < gen.n_iters < kw["max_iter"]
    k5 = build_fused_generic_ilqr(DragCar, **kw)
    us, x_last, cost, iters = k5(_t(x0), _t(xt), _t(u0))
    assert k5.launches == 0
    assert torch.equal(us, gen.us) and torch.equal(x_last, gen.xs[-1])
    assert torch.equal(cost, gen.cost) and torch.equal(iters, gen.lane_iters)


def test_caller_model_k5_cpu_route_matches_pallas_kernel_in_interpret_mode():
    """The same caller model in f32: K5's CPU route against the JAX Pallas
    kernel in interpret mode on the same inputs, one tile of 128 lanes
    (tile_rows=1) at N = 3 (interpreted at N = 6 a tile takes minutes),
    at the 2-input test's tolerances and with the tile's lockstep trips
    the most of its lanes'. In f32 a lane's LM path follows each
    framework's rounding (at longer horizons a few lanes take another
    path, where f64 agrees to 1e-9), so the costs are held on 97 % of the
    lanes."""
    from _k5_caller_model import DragCar, comps, task
    kw, x0, xt, u0 = (a.astype(np.float32) if isinstance(a, np.ndarray)
                      else a for a in task(128, 3))
    pal = build_generic_ilqr_pallas(comps(jnp.cos, jnp.sin), tile_rows=1,
                                    interpret=True, **kw)(
        jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(u0))
    us_p, xl_p, cost_p, iters_p = (np.asarray(v) for v in pal)
    k5 = build_fused_generic_ilqr(DragCar, **kw)
    f32 = torch.float32
    us, x_last, cost, iters = k5(_t(x0, f32), _t(xt, f32), _t(u0, f32))
    assert k5.launches == 0
    same = np.isclose(cost.numpy(), cost_p, rtol=2e-4, atol=0)
    assert same.mean() >= 0.97
    np.testing.assert_allclose(x_last.numpy()[:, same], xl_p[:, same],
                               atol=2e-3)
    np.testing.assert_allclose(us.numpy()[..., same], us_p[..., same],
                               atol=2e-3)
    tile_max = iters.reshape(-1, 128).amax(dim=1)
    np.testing.assert_array_equal(tile_max.numpy(),
                                  iters_p.reshape(-1, 128)[:, 0])
    assert int(iters.max()) > 1
