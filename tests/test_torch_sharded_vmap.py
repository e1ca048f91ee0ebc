"""The port's parallel/sharded.py on 2 gloo ranks on the CPU, in f64: one
spawn runs ``dryrun(2)``, whose parts check themselves (the scenario-
sharded vmap run equals the unsharded run bit for bit, the candidate-
sharded sweep the sweep on one rank bit for bit, the SoA ``_sharded``
simulators and the ``_shardmap`` one with K1's CPU route run); here both
ranks must return the same sweep, and its index, inputs and states equal
the JAX package's ``ilqr_solve_candidates`` reference
(tests/test_batched.py:95-123), inputs and states within 1e-8."""

import jax.numpy as jnp
import numpy as np
import torch

from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObstacle
from ilqr_iterative_tasks_tpu.ops.ilqr import ilqr_solve_candidates
from ilqr_iterative_tasks_tpu.utils.params import (
    IlqrParams as JParams, SystemLimits as JLimits)
from ilqr_iterative_tasks_torch.parallel.launch import spawn
from ilqr_iterative_tasks_torch.parallel.sharded import DRY_K


def test_dryrun_on_two_gloo_ranks_and_the_sweep_against_jax():
    ranks = spawn("ilqr_iterative_tasks_torch.parallel.sharded:dryrun_rank",
                  2, 2, dtype=torch.float64, backend="gloo", threads=1,
                  timeout=600)
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["backend"] == "gloo" and r["ranks"] == 2
        assert r["vmap_lap_steps"].shape == (8, 1)
        for got, want in zip(r["sweep"], ranks[0]["sweep"]):
            assert torch.equal(got, want)
    us, xs, cost, idx = ranks[0]["sweep"]
    cands, qs = (t.numpy() for t in ranks[0]["sweep_inputs"])
    assert cands.shape == (32, 4) and int(idx) >= 16  # the second rank's
    params = JParams.make(num_ss_points=DRY_K, dtype=jnp.float64)
    sols = ilqr_solve_candidates(
        params, JLimits.make(dtype=jnp.float64),
        JObstacle.make(5.0, -2.0, 1.0, 1.0, dtype=jnp.float64),
        jnp.zeros(4), jnp.asarray(cands), jnp.zeros((6, 2)), 1.0, 1.0,
        num_horizon=6)
    d = np.linalg.norm(np.asarray(sols.xs)[:, -1] - cands, axis=-1)
    i_relax = np.maximum(np.ceil(d / 80.0 - 1e-12), 1.0)
    local = np.where(d <= 80.0 * params.max_relax_iter,
                     qs + 6.0 + 100.0 * i_relax, np.inf)
    want = int(np.argmin(local))
    assert int(idx) == want
    assert float(cost) == local[want]
    np.testing.assert_allclose(us.numpy(), np.asarray(sols.us)[want],
                               atol=1e-8, rtol=0)
    np.testing.assert_allclose(xs.numpy(), np.asarray(sols.xs)[want],
                               atol=1e-8, rtol=0)
