"""The port's closed-loop learning run against the JAX simulator, f64.

B = 4 lanes, seed lap + 2 learning laps, LM cap 16: lanes 0-1 run without
noise, lanes 2-3 with noise. The port's noise input is the JAX run's own
draws (``jax.random.split(key, 3)`` per executed step, batched_soa.py:833).
Lap 1 must match exactly; from lap 2 on the learned safe set holds near-tie
candidates, and one-ulp differences between the two frameworks' libm can
flip an LM decision (docs/PARITY.md:151-159), so lap 2 is held to +-2 steps
and whether it matched exactly is recorded.

The robustness sweep's pieces: ``SoaScenarios.randomized`` fed JAX's own
``split(key, 4)`` draws equals the JAX version leaf for leaf, and the
``stall_reseed`` guard's closed loop (B = 8 randomized moving-obstacle
lanes with heading jitter, noise on with JAX's draws, 2 learning laps, cap
16) matches the JAX simulator's lap 1 exactly, on scenarios where the guard
changes the JAX run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_tpu.control import batched_soa as jbs
from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObstacle
from ilqr_iterative_tasks_tpu.sim.seed import seed_trajectory as j_seed
from ilqr_iterative_tasks_tpu.utils.params import (
    IlqrParams as JParams, SystemLimits as JLimits)
from ilqr_iterative_tasks_torch.control.batched_soa import (
    SoaScenarios, simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.utils import convert

torch.set_num_threads(1)
B, LAPS, BUDGET, T_ROWS, MAX_LAPS, CAP = 4, 2, 121, 128, 8, 16


def _jax_draws(key, steps, b):
    """The standard-normal (v, theta) draws the JAX simulator takes at each
    executed step, in order: (steps, 2, b)."""
    def body(k, _):
        k, k1, k2 = jax.random.split(k, 3)
        return k, jnp.stack([jax.random.normal(k1, (b,), jnp.float64),
                             jax.random.normal(k2, (b,), jnp.float64)])
    return np.array(jax.jit(lambda k: jax.lax.scan(
        body, k, None, length=steps)[1])(key))


def test_closed_loop_matches_jax_f64(record_property):
    xcl, _ = j_seed(1.0)
    jp, jl = JParams.make(dtype=jnp.float64), JLimits.make(dtype=jnp.float64)
    scen = jbs.SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], JObstacle.make(31.0, -2.0, 8.0, 6.0,
                                             dtype=jnp.float64),
        B, noise_on=True, dtype=jnp.float64)
    scen = scen.replace(noise_on=jnp.asarray([0.0, 0.0, 1.0, 1.0]))
    seed_xs = np.zeros((T_ROWS, 4))
    seed_xs[:121] = xcl
    key = jax.random.PRNGKey(3)
    kw = dict(num_laps=LAPS, max_steps=T_ROWS, max_laps=MAX_LAPS,
              sim_step_budget=BUDGET, solver_max_iter=CAP)
    jr = jbs.simulate_learning_runs_soa(
        jp, jl, scen, jnp.asarray(seed_xs), jnp.zeros((T_ROWS, 2)), 121, 1.0,
        key, **kw)
    tr = simulate_learning_runs_soa(
        convert.ilqr_params(jp, device="cpu"), convert.system_limits(jl, device="cpu"),
        convert.scenarios(scen, device="cpu"), seed_xs, None, 121, 1.0,
        noise=torch.from_numpy(_jax_draws(key, LAPS * BUDGET, B)), **kw)

    j_steps, j_done = np.asarray(jr.lap_steps), np.asarray(jr.lap_done)
    t_steps, t_done = tr.lap_steps.numpy(), tr.lap_done.numpy()
    np.testing.assert_array_equal(t_steps[0], j_steps[0])
    np.testing.assert_array_equal(t_done[0], j_done[0])
    assert t_done[0].all()
    np.testing.assert_allclose(tr.safe_set[0][1].numpy(),
                               np.asarray(jr.safe_set[0][1]), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(tr.safe_set[3][1].numpy(),
                                  np.asarray(jr.safe_set[3][1]))
    assert np.abs(t_steps[1] - j_steps[1]).max() <= 2
    assert t_steps[0, 0] == t_steps[0, 1]  # the zero-noise lanes agree
    lap2_exact = bool((t_steps[1] == j_steps[1]).all()
                      and (t_done[1] == j_done[1]).all())
    record_property("lap2_exact", lap2_exact)
    print(f"lap steps port {t_steps.tolist()} jax {j_steps.tolist()}; "
          f"lap 2 exact: {lap2_exact}")


def _randomized_draws(key, b, dtype):
    """The standard-normal draws of JAX's ``SoaScenarios.randomized``
    (batched_soa.py:74-84), as numpy: z_x0 (4, b), z_ox, z_oy, z_spd."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return (np.array(jax.random.normal(k1, (4, b), dtype)),
            *(np.array(jax.random.normal(kk, (b,), dtype))
              for kk in (k2, k3, k4)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("x0_jitter", [0.7, (0.5, 0.5, 0.0, 0.5)],
                         ids=["scalar", "per_component"])
def test_randomized_scenarios_match_jax(dtype, x0_jitter):
    b, key = 64, jax.random.PRNGKey(11)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xcl, _ = j_seed(1.0)
    # a speed jitter of 2 around a speed of 1: some lanes clamp at 0
    kw = dict(x0_jitter=x0_jitter, obs_pos_jitter=4.0, obs_spd_jitter=2.0,
              noise_on=True)
    want = jbs.SoaScenarios.randomized(
        np.zeros(4), xcl[-1], JObstacle.make(35.0, -16.0, 20.0, 20.0,
                                             spd=1.0, moving_option=1,
                                             dtype=jdt),
        b, key, dtype=jdt, **kw)
    got = SoaScenarios.randomized(
        np.zeros(4), xcl[-1], Obstacle.make(35.0, -16.0, 20.0, 20.0, spd=1.0,
                                            moving_option=1, dtype=tdt,
                                            device="cpu"),
        b, dtype=tdt, device="cpu", draws=_randomized_draws(key, b, jdt),
        **kw)
    for name in ("x0", "goal", "noise_on"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == tdt and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    for f in JObstacle.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(got.obstacle, f).numpy(),
                                      np.asarray(getattr(want.obstacle, f)))
    spd = got.obstacle.spd.numpy()
    assert (spd == 0.0).any() and (spd > 0.0).any()  # the clamp at 0 ran
    # a generator gives the same scenarios as its own draws, in that order
    g = torch.Generator().manual_seed(3)
    draws = (torch.randn((4, b), generator=g, dtype=tdt),
             *(torch.randn((b,), generator=g, dtype=tdt) for _ in range(3)))
    base = (np.zeros(4), xcl[-1], Obstacle.make(
        35.0, -16.0, 20.0, 20.0, spd=1.0, moving_option=1, dtype=tdt,
        device="cpu"), b)
    a = SoaScenarios.randomized(*base, torch.Generator().manual_seed(3),
                                dtype=tdt, device="cpu", **kw)
    c = SoaScenarios.randomized(*base, dtype=tdt, device="cpu", draws=draws,
                                **kw)
    assert torch.equal(a.x0, c.x0) and torch.equal(a.obstacle.y,
                                                   c.obstacle.y)


# jitter seed 6 with heading jitter: lane 2 parks in lap 1 without the
# guard (83 steps against 57 with it) and times out in lap 2
SR_SEED, SR_B = 6, 8


def test_stall_reseed_closed_loop_matches_jax_f64(record_property):
    xcl, _ = j_seed(1.0)
    jp, jl = JParams.make(dtype=jnp.float64), JLimits.make(dtype=jnp.float64)
    scen = jbs.SoaScenarios.randomized(
        np.zeros(4), xcl[-1], JObstacle.make(35.0, -16.0, 20.0, 20.0,
                                             spd=1.0, moving_option=1,
                                             dtype=jnp.float64),
        SR_B, jax.random.PRNGKey(SR_SEED), x0_jitter=(0.5, 0.5, 0.0, 0.5),
        obs_pos_jitter=4.0, obs_spd_jitter=0.3, noise_on=True,
        dtype=jnp.float64)
    seed_xs = np.zeros((T_ROWS, 4))
    seed_xs[:121] = xcl
    key = jax.random.PRNGKey(100 + SR_SEED)
    kw = dict(num_laps=LAPS, max_steps=T_ROWS, max_laps=MAX_LAPS,
              sim_step_budget=BUDGET, solver_max_iter=CAP)
    jr, j_off = (jbs.simulate_learning_runs_soa(
        jp, jl, scen, jnp.asarray(seed_xs), jnp.zeros((T_ROWS, 2)), 121,
        1.0, key, stall_reseed=sr, **kw) for sr in (3, None))
    j_steps, j_done = np.asarray(jr.lap_steps), np.asarray(jr.lap_done)
    # the guard changes the JAX run's lap 1 on these scenarios
    assert (np.asarray(j_off.lap_steps)[0] != j_steps[0]).any()
    tr = simulate_learning_runs_soa(
        convert.ilqr_params(jp, device="cpu"),
        convert.system_limits(jl, device="cpu"),
        convert.scenarios(scen, device="cpu"), seed_xs, None, 121, 1.0,
        noise=torch.from_numpy(_jax_draws(key, LAPS * BUDGET, SR_B)),
        stall_reseed=3, **kw)
    t_steps, t_done = tr.lap_steps.numpy(), tr.lap_done.numpy()
    np.testing.assert_array_equal(t_steps[0], j_steps[0])
    np.testing.assert_array_equal(t_done[0], j_done[0])
    np.testing.assert_allclose(tr.safe_set[0][1].numpy(),
                               np.asarray(jr.safe_set[0][1]), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(tr.safe_set[3][1].numpy(),
                                  np.asarray(jr.safe_set[3][1]))
    assert np.abs(t_steps[1] - j_steps[1]).max() <= 2
    lap2_exact = bool((t_steps[1] == j_steps[1]).all()
                      and (t_done[1] == j_done[1]).all())
    record_property("lap2_exact", lap2_exact)
    print(f"lap steps port {t_steps.tolist()} jax {j_steps.tolist()} "
          f"(without the guard {np.asarray(j_off.lap_steps).tolist()}); "
          f"lap 2 exact: {lap2_exact}")
