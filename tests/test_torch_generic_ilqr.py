"""The host-tier generic solver (ops/generic_ilqr.py) against the JAX
package in f64: single solves on the double integrator, the unicycle and
the bicycle with the sequential and the parallel backward pass, and the
candidate sweep."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_tpu.models import (
    double_integrator as j_di, kinetic_bicycle as j_bike, unicycle as j_uni)
from ilqr_iterative_tasks_tpu.ops.generic_ilqr import (
    GenericIlqrConfig as JConfig, generic_ilqr_solve as j_solve,
    generic_ilqr_solve_candidates as j_candidates)
from ilqr_iterative_tasks_torch.models import (
    double_integrator, kinetic_bicycle, unicycle)
from ilqr_iterative_tasks_torch.ops.generic_ilqr import (
    generic_ilqr_solve, generic_ilqr_solve_candidates)
from ilqr_iterative_tasks_torch.utils import convert

torch.set_num_threads(1)
F64 = torch.float64


def _problem(name):
    """(torch step, JAX step, JAX config, x0, x_term, u_init, dt): the
    tests/test_generic_ilqr.py reach tasks."""
    def cfg(n, m, qterm=20.0, r=0.05, u_max=2.0):
        return JConfig.make(matrix_Q=jnp.zeros((n, n)),
                            matrix_R=r * jnp.eye(m),
                            matrix_Qterminal=qterm * jnp.eye(n),
                            u_lower=-u_max * jnp.ones(m),
                            u_upper=u_max * jnp.ones(m), dtype=jnp.float64)
    if name == "double_integrator":
        return (double_integrator.step, j_di.step, cfg(4, 2), np.zeros(4),
                np.asarray([5.0, 3.0, 0.0, 0.0]), np.zeros((10, 2)), 0.5)
    if name == "unicycle":
        return (unicycle.step, j_uni.step, cfg(3, 2, 30.0, 0.01, 1.5),
                np.zeros(3), np.asarray([2.0, 1.0, 0.5]),
                0.1 * np.ones((8, 2)), 0.5)
    jc = JConfig.make(
        matrix_Q=jnp.zeros((4, 4)), matrix_R=0.05 * jnp.eye(2),
        matrix_Qterminal=2.0 * jnp.diag(jnp.asarray([1.0, 1.0, 20.0, 0.02])),
        u_lower=jnp.asarray([-2.0, -1.57]), u_upper=jnp.asarray([2.0, 1.57]),
        dtype=jnp.float64)
    return (kinetic_bicycle.step, j_bike.step, jc, np.zeros(4),
            np.asarray([8.0, 0.5, 2.0, 0.1]), np.zeros((6, 2)), 1.0)


def _close(got, want):
    for f in ("us", "xs", "cost", "lamb"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-9,
                                   atol=1e-9, err_msg=f)
    np.testing.assert_array_equal(got.n_iters.numpy(),
                                  np.asarray(want.n_iters))


@pytest.mark.parametrize("backward", ["sequential", "parallel"])
@pytest.mark.parametrize("name", ["bicycle", "double_integrator",
                                  "unicycle"])
def test_solve_matches_jax(name, backward):
    step, j_step, jc, x0, xt, u0, dt = _problem(name)
    cfg = convert.generic_config(jc, device="cpu")
    got = generic_ilqr_solve(step, cfg, torch.tensor(x0), torch.tensor(xt),
                             torch.tensor(u0), 1.0, dt, backward)
    want = j_solve(j_step, jc, jnp.asarray(x0), jnp.asarray(xt),
                   jnp.asarray(u0), 1.0, dt, backward)
    _close(got, want)
    assert int(got.n_iters) > 1
    err = float(torch.linalg.norm(got.xs[-1, :2] - torch.tensor(xt[:2])))
    assert err < 1.0, err


@pytest.mark.parametrize("name", ["bicycle", "double_integrator",
                                  "unicycle"])
def test_candidates_match_jax(name):
    step, j_step, jc, x0, xt, u0, dt = _problem(name)
    rng = np.random.default_rng(4)
    terms = xt[None] + 0.5 * rng.normal(size=(5, xt.shape[0]))
    cfg = convert.generic_config(jc, device="cpu")
    got = generic_ilqr_solve_candidates(step, cfg, torch.tensor(x0),
                                        torch.tensor(terms),
                                        torch.tensor(u0), 1.0, dt)
    want = j_candidates(j_step, jc, jnp.asarray(x0), jnp.asarray(terms),
                        jnp.asarray(u0), 1.0, dt)
    assert got.us.shape == (5,) + u0.shape
    _close(got, want)
    # candidates stop on their own counts, as JAX's vmapped while_loop
    single = generic_ilqr_solve(step, cfg, torch.tensor(x0),
                                torch.tensor(terms[2]), torch.tensor(u0),
                                1.0, dt)
    assert torch.equal(single.us, got.us[2])
    assert int(single.n_iters) == int(got.n_iters[2])
