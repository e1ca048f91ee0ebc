"""The port's closed-loop learning run against the JAX simulator, f64.

B = 4 lanes, seed lap + 2 learning laps, LM cap 16: lanes 0-1 run without
noise, lanes 2-3 with noise. The port's noise input is the JAX run's own
draws (``jax.random.split(key, 3)`` per executed step, batched_soa.py:833).
Lap 1 must match exactly; from lap 2 on the learned safe set holds near-tie
candidates, and one-ulp differences between the two frameworks' libm can
flip an LM decision (docs/PARITY.md:151-159), so lap 2 is held to +-2 steps
and whether it matched exactly is recorded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ilqr_iterative_tasks_tpu.control import batched_soa as jbs
from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObstacle
from ilqr_iterative_tasks_tpu.sim.seed import seed_trajectory as j_seed
from ilqr_iterative_tasks_tpu.utils.params import (
    IlqrParams as JParams, SystemLimits as JLimits)
from ilqr_iterative_tasks_torch.control.batched_soa import (
    simulate_learning_runs_soa)
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
