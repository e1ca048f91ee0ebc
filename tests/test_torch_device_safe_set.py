"""The port's ``DeviceSafeSet`` (control/safe_set.py) and
``lexicographic_argmin`` (control/batched.py) against the JAX package's:
``knn``'s indices, states and Qfun equal JAX's (``lax.top_k`` order: ties
to the lower row, the invalid rows after the valid ones in row order, their
Qfun +inf), with k above a lap's length and with tied rows; ``add_lap``'s
tensors equal JAX's; ``lexicographic_argmin`` equals Python's list ``min``
and JAX's on tests/test_batched.py:21-35's cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_tpu.control.batched import (
    lexicographic_argmin as j_lexmin)
from ilqr_iterative_tasks_tpu.control.safe_set import (
    DeviceSafeSet as JDeviceSafeSet)
from ilqr_iterative_tasks_torch.control.batched import lexicographic_argmin
from ilqr_iterative_tasks_torch.control.safe_set import DeviceSafeSet
from ilqr_iterative_tasks_torch.utils import convert

B, L, T = 5, 3, 12


def _laps(rng):
    """Per scenario, two laps of ragged lengths (2 to T rows) whose states
    repeat rows (so L1 distances tie), and the guesses."""
    xs = rng.integers(0, 3, size=(2, B, T, 4)).astype(np.float64)
    us = rng.normal(size=(2, B, T, 2))
    n_valid = rng.integers(2, T + 1, size=(2, B))
    n_valid[0, 0] = 3  # a lap shorter than k
    guess = rng.integers(0, 3, size=(B, 4)).astype(np.float64)
    return xs, us, n_valid, guess


def _both(rng):
    xs, us, n_valid, guess = _laps(rng)
    jss = jax.vmap(lambda _: JDeviceSafeSet.empty(L, T, dtype=jnp.float64))(
        jnp.arange(B))
    tss = DeviceSafeSet.empty(B, L, T, dtype=torch.float64, device="cpu")
    for lap in range(2):
        jss = jax.vmap(lambda s, x, u, n: s.add_lap(x, u, n))(
            jss, jnp.asarray(xs[lap]), jnp.asarray(us[lap]),
            jnp.asarray(n_valid[lap]))
        tss.add_lap(torch.from_numpy(xs[lap]), torch.from_numpy(us[lap]),
                    torch.from_numpy(n_valid[lap]))
    return jss, tss, guess


def test_add_lap_matches_jax():
    jss, tss, _ = _both(np.random.default_rng(0))
    conv = convert.device_safe_set(jss, device="cpu")
    for name in ("states", "inputs", "qfun", "valid", "lap_len", "num_laps"):
        assert torch.equal(getattr(tss, name), getattr(conv, name)), name


@pytest.mark.parametrize("k", [4, 8, T])
def test_knn_matches_jax_top_k(k):
    """k 4, 8 and T: k above the 3-row lap of scenario 0 and up to every
    row; the states hold values in {0, 1, 2}, so many distances tie."""
    rng = np.random.default_rng(1)
    jss, tss, guess = _both(rng)
    for lap in (0, 1):
        j_idx, j_st, j_q = jax.vmap(lambda s, g: s.knn(lap, g, k))(
            jss, jnp.asarray(guess))
        idx, st, q = tss.knn(lap, torch.from_numpy(guess), k)
        assert idx.tolist() == np.asarray(j_idx).tolist()
        assert torch.equal(st, torch.from_numpy(np.array(j_st)))
        assert torch.equal(q, torch.from_numpy(np.array(j_q)))
        # per-scenario lap ids give the same rows
        assert torch.equal(tss.knn(torch.full((B,), lap),
                                   torch.from_numpy(guess), k)[0], idx)
    # the 3-row lap: its invalid rows follow in row order with +inf Qfun
    idx, _, q = tss.knn(0, torch.from_numpy(guess), k)
    assert sorted(idx[0, :3].tolist()) == [0, 1, 2]
    assert idx[0, 3:].tolist() == list(range(3, k))
    assert bool(torch.isinf(q[0, 3:]).all())


def test_knn_tie_order_is_top_k_s():
    """d = [inf, 1, inf, 1, 0.5, inf] gives [4, 1, 3, 0, 2, 5]."""
    ss = DeviceSafeSet.empty(1, 1, 6, dtype=torch.float64, device="cpu")
    xs = torch.tensor([[9.0, 1.0, 9.0, 1.0, 0.5, 9.0]]).T.expand(6, 4) / 4
    ss.add_lap(xs[None].contiguous(), torch.zeros(1, 6, 2),
               torch.tensor([6]))
    ss.valid[0, 0, [0, 2, 5]] = False
    idx, _, q = ss.knn(0, torch.zeros(1, 4, dtype=torch.float64), 6)
    assert idx.tolist() == [[4, 1, 3, 0, 2, 5]]
    assert torch.isinf(q[0, 3:]).all() and torch.isfinite(q[0, :3]).all()


def test_lexicographic_argmin_matches_python_and_jax():
    j_lex = jax.jit(j_lexmin)
    rng = np.random.default_rng(8)
    rows = rng.choice([1.0, 2.0, 3.0, np.inf, -np.inf], size=(30, 4, 5))
    valid = np.ones(4, dtype=bool)
    got = lexicographic_argmin(torch.from_numpy(rows), torch.from_numpy(valid))
    for r, g in zip(rows, got.tolist()):
        lists = [list(x) for x in r]
        assert g == lists.index(min(lists)) == int(
            j_lex(jnp.asarray(r), jnp.asarray(valid)))
    # invalid rows never win; with none valid, row 0
    rows = torch.tensor([[0.0, 0.0], [5.0, 5.0], [4.0, 9.0]])
    for v, want in (([False, True, True], 2), ([False, True, False], 1),
                    ([False, False, False], 0)):
        valid = torch.tensor(v)
        assert int(lexicographic_argmin(rows, valid)) == want == int(
            j_lexmin(jnp.asarray(rows.numpy()), jnp.asarray(valid.numpy())))
