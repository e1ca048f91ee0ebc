"""``tail_shrink`` alone in the port's i2LQR simulator against the JAX
simulator (f64, the CPU).

JAX's i2LQR simulator routes each step's noise draws to the permuted lanes
only when ``retile_frac`` is set (ilqr_iterative_tasks_tpu/control/
batched_soa.py:838-843); with ``tail_shrink`` alone, once a lap compacts,
the lane at position p takes draw p. On tests/test_torch_retile.py's
setup (48 randomized lanes, noise on, 2 laps, budget 50, cap 12) at
``tail_shrink=24`` the compaction fires, and the JAX run with the option
differs from the run without it. The port, on JAX's own draws in JAX's
positional order, gives JAX's run with the option: lap steps, done flags
and lap lengths exactly, the stored states to 1e-9. One JAX compile.

``slow``: the same setup through JAX's ``_sharded`` wrapper on a 2-device
virtual mesh (conftest's 8 CPU devices), whose compaction is the whole
batch's, at ``tail_shrink`` 12 and 24, beside the port's ``_sharded``
wrapper on 2 gloo ranks on JAX's draws: lap steps, flags, Qfun and lap
lengths exactly, the stored states to 1e-9 at lap 1 and 1e-6 at lap 2.
"""

import os
import time

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
from ilqr_iterative_tasks_tpu.parallel.mesh import make_mesh as j_make_mesh
from ilqr_iterative_tasks_tpu.parallel.sharded_soa import (
    simulate_learning_runs_soa_sharded as j_sharded)
from ilqr_iterative_tasks_torch.control.batched_soa import (
    simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.parallel.launch import spawn
from ilqr_iterative_tasks_torch.utils import convert
from test_torch_batched_soa import _jax_draws

torch.set_num_threads(1)
B, T_ROWS, MAX_LAPS, CAP, LAPS, BUDGET, TAIL = 48, 128, 8, 12, 2, 50, 24


WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_distributed_worker.py")


def _setup():
    """(JAX params, limits, scenarios, seed_xs, key, the runs' keywords)."""
    xcl, _ = j_seed(1.0)
    jp, jl = JParams.make(dtype=jnp.float64), JLimits.make(dtype=jnp.float64)
    scen = jbs.SoaScenarios.randomized(
        np.zeros(4), xcl[-1], JObstacle.make(31.0, -2.0, 8.0, 6.0,
                                             dtype=jnp.float64),
        B, jax.random.PRNGKey(42), noise_on=True, dtype=jnp.float64)
    seed_xs = np.zeros((T_ROWS, 4))
    seed_xs[:121] = xcl
    kw = dict(num_laps=LAPS, max_steps=T_ROWS, max_laps=MAX_LAPS,
              sim_step_budget=BUDGET, solver_max_iter=CAP)
    return jp, jl, scen, seed_xs, jax.random.PRNGKey(7), kw


def _held_to_jax(tr, jr, lap2=True):
    """The port's run ``tr`` against JAX's ``jr``: lap steps, flags, Qfun,
    valid rows and lap lengths exactly; the stored states by slot (seed,
    lap 1, lap 2) to 0, 1e-9 and (``lap2``) 1e-6."""
    j_xs = np.asarray(jr.safe_set[0])
    np.testing.assert_array_equal(tr.lap_steps.numpy(),
                                  np.asarray(jr.lap_steps))
    np.testing.assert_array_equal(tr.lap_done.numpy(),
                                  np.asarray(jr.lap_done))
    for i in (1, 2, 3):  # Qfun, valid rows, lap lengths
        np.testing.assert_array_equal(tr.safe_set[i].numpy(),
                                      np.asarray(jr.safe_set[i]))
    gap = np.abs(tr.safe_set[0].numpy() - j_xs).max(axis=(1, 2, 3))
    print(f"max |stored state - JAX's| by slot (seed, lap 1, lap 2): "
          f"{gap[:3].tolist()}")
    assert gap[0] == 0.0 and gap[1] <= 1e-9
    # lap 2 runs from a safe set whose lap 1 differs from JAX's in the
    # last bits (XLA's and torch's sin / cos), and its closed loop grows
    # that (1.0e-7 here, printed above), against the 7.5 the option moves
    # JAX's run
    assert not lap2 or gap[2] <= 1e-6


def test_tail_shrink_alone_matches_the_jax_simulator_f64():
    jp, jl, scen, seed_xs, key, kw = _setup()
    t0 = time.perf_counter()
    jr = jbs.simulate_learning_runs_soa(
        jp, jl, scen, jnp.asarray(seed_xs), jnp.zeros((T_ROWS, 2)), 121,
        1.0, key, tail_shrink=TAIL, **kw)
    jax.block_until_ready(jr.lap_steps)
    print(f"JAX run {time.perf_counter() - t0:.1f} s")
    noise = torch.from_numpy(_jax_draws(key, LAPS * BUDGET, B))
    port = lambda **o: simulate_learning_runs_soa(
        convert.ilqr_params(jp, device="cpu"),
        convert.system_limits(jl, device="cpu"),
        convert.scenarios(scen, device="cpu"), seed_xs, None, 121, 1.0,
        noise=noise, **o, **kw)
    log = []
    tr, without = port(tail_shrink=TAIL, perm_log=log), port()
    assert any(e["compacted"] for e in log)
    j_steps, j_xs = np.asarray(jr.lap_steps), np.asarray(jr.safe_set[0])
    # the option changes JAX's run: the run without it (the port's, on the
    # same draws) stores other states
    moved = np.abs(without.safe_set[0].numpy() - j_xs).max()
    print(f"log {log}; lap steps {j_steps.tolist()}; max |stored state| "
          f"without the option - JAX's with it: {moved:.3e}; the port's "
          f"with it: {np.abs(tr.safe_set[0].numpy() - j_xs).max():.3e}")
    assert moved > 1e-6
    _held_to_jax(tr, jr)


@pytest.mark.slow
@pytest.mark.parametrize("tail,compacts", [(12, False), (24, True)])
def test_sharded_tail_shrink_alone_matches_jax_s_sharded_run(tail, compacts):
    """JAX's ``_sharded`` wrapper on 2 virtual CPU devices (its compaction
    over the whole batch: B / 2 = 24 lanes a device, so 24 is a prefix
    that holds a device's lanes) against the port's on 2 gloo ranks, on
    JAX's draws. At 24 lap 2 compacts. At 12 no lap compacts (more than
    12 lanes run to the 50-step budget in each lap), so each side's run is
    its run without the option (JAX's bit for bit on XLA:CPU; the port's
    held here), and lap 2's stored states differ from JAX's by that run's
    own gap, 1.68e-6 (1.0e-7 at 24): lap 1's last bits (2.7e-11) grown by
    the closed loop, which the 1e-6 of lap 2 does not bound."""
    jp, jl, scen, seed_xs, key, kw = _setup()
    t0 = time.perf_counter()
    jr = j_sharded(jp, jl, scen, jnp.asarray(seed_xs),
                   jnp.zeros((T_ROWS, 2)), 121, 1.0, key, j_make_mesh(2),
                   tail_shrink=tail, **kw)
    jax.block_until_ready(jr.lap_steps)
    print(f"JAX _sharded run {time.perf_counter() - t0:.1f} s")
    args = (convert.ilqr_params(jp, device="cpu"),
            convert.system_limits(jl, device="cpu"),
            convert.scenarios(scen, device="cpu"), seed_xs, None, 121, 1.0)
    noise = torch.from_numpy(_jax_draws(key, LAPS * BUDGET, B))
    port, log = spawn(f"{WORKER}:sharded_i2lqr", 2, args,
                      dict(kw, noise=noise, tail_shrink=tail),
                      backend="gloo", timeout=600, threads=1)[0]
    print(f"rank 0's permutation log {log}")
    assert any(e["compacted"] for e in log) == compacts
    if not compacts:  # the run without the option, bit for bit
        without = simulate_learning_runs_soa(*args, noise=noise, **kw)
        for a, b in zip((port.lap_steps, port.lap_done, *port.safe_set),
                        (without.lap_steps, without.lap_done,
                         *without.safe_set)):
            assert torch.equal(a, b)
    _held_to_jax(port, jr, lap2=compacts)
