"""The suffix-scan Riccati (ops/parallel_riccati.py) against the JAX
package's associative scan and against the sequential oracle, at horizons
that are and are not powers of two, in f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_tpu.ops import parallel_riccati as jpr
from ilqr_iterative_tasks_torch.ops import parallel_riccati as tpr

torch.set_num_threads(1)


def _stages(nh, n=3, m=2, seed=0, batch=()):
    """Random stable LQR stage data (F, b, L, X, q, U, bu, P_T, p_T)."""
    rng = np.random.default_rng(seed + nh)
    sym = lambda a: a @ np.swapaxes(a, -1, -2)
    F = np.eye(n) + 0.1 * rng.normal(size=(nh,) + batch + (n, n))
    b = 0.1 * rng.normal(size=(nh,) + batch + (n,))
    L = rng.normal(size=(nh,) + batch + (n, m))
    X = sym(rng.normal(size=(nh,) + batch + (n, n))) + 0.1 * np.eye(n)
    q = rng.normal(size=(nh,) + batch + (n,))
    U = sym(rng.normal(size=(nh,) + batch + (m, m))) + 0.5 * np.eye(m)
    bu = rng.normal(size=(nh,) + batch + (m,))
    P_T = sym(rng.normal(size=batch + (n, n))) + np.eye(n)
    p_T = rng.normal(size=batch + (n,))
    return F, b, L, X, q, U, bu, P_T, p_T


@pytest.mark.parametrize("nh", [1, 2, 5, 16, 33])
def test_parallel_backward_matches_jax_and_sequential(nh):
    data = _stages(nh)
    t = [torch.tensor(a) for a in data]
    P, p = tpr.parallel_riccati_backward(*t, lamb=0.3)
    jP, jp = jpr.parallel_riccati_backward(*(jnp.asarray(a) for a in data),
                                           lamb=0.3)
    sP, sp = tpr.sequential_riccati_backward(*t, lamb=0.3)
    jsP, jsp = jpr.sequential_riccati_backward(
        *(jnp.asarray(a) for a in data), lamb=0.3)
    assert P.shape == (nh + 1, 3, 3) and p.shape == (nh + 1, 3)
    scale = float(np.abs(np.asarray(jP)).max())
    for got, want in ((P, jP), (p, jp), (sP, jsP), (sp, jsp), (P, sP),
                      (p, sp)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-9, atol=1e-10 * scale)


@pytest.mark.parametrize("nh", [5, 16])
def test_gains_match_jax_with_batch_dims(nh):
    data = _stages(nh, batch=(4,), seed=3)
    t = [torch.tensor(a) for a in data]
    lamb = torch.tensor([0.0, 0.1, 1.0, 5.0])[:, None, None]
    got = tpr.parallel_lqr_gains(*t, lamb=lamb)
    want = jpr.parallel_lqr_gains(*(jnp.asarray(a) for a in data),
                                  lamb=jnp.asarray(lamb.numpy()))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-9)
