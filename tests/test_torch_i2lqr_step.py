"""The port's control step against the JAX package.

- the selection helpers (_topk_select, _lex_argmin_rows,
  _step_solver_inputs) against the JAX helpers on rows with ties, +-inf
  and ragged prefixes;
- one whole control step in f64: the JAX simulator resumed on a given safe
  set for one step (noise off) records x_1 = step(x_0, u_0); the port's
  ``i2lqr_step_reference`` on the same safe set, followed by ``step_soa``
  on its first input, must land on the same state; at k = 8 (nsi 1, 2) and
  at the robustness sweep's k = 32 (nsi 2, 4), on four stored laps of
  which the last is shorter than 32 rows (ragged rows);
- the K1 wrapper's CPU route is the plain version, and other devices raise.
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
from ilqr_iterative_tasks_torch.control import batched_soa as tbs
from ilqr_iterative_tasks_torch.ops.fused_ilqr import obstacle_to_lanes
from ilqr_iterative_tasks_torch.ops import i2lqr_step as tstep
from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
    build_fused_i2lqr_step, i2lqr_step_reference)
from ilqr_iterative_tasks_torch.ops.ilqr_soa import step_soa
from ilqr_iterative_tasks_torch.utils import convert

torch.set_num_threads(1)
INF = np.inf


def _rows_with_ties(rng, t_rows, b):
    """(T, B) distances: small integers (many ties), invalid rows +inf,
    and per-lane valid prefixes, some shorter than k."""
    d = rng.integers(0, 6, (t_rows, b)).astype(np.float64)
    lens = rng.integers(1, t_rows + 1, b)
    lens[:4] = [1, 2, 3, 5]  # fewer valid rows than k
    d[np.arange(t_rows)[:, None] >= lens[None]] = INF
    return d


def test_topk_select_matches_jax():
    rng = np.random.default_rng(0)
    t_rows, b, k = 20, 32, 8
    d = _rows_with_ties(rng, t_rows, b)
    arrs = [rng.normal(size=(t_rows, b)) for _ in range(3)]
    ji, jd, js = jbs._topk_select(jnp.asarray(d), k,
                                  [jnp.asarray(a) for a in arrs])
    ti, td, ts = tstep._topk_select(torch.from_numpy(d), k,
                                  [torch.from_numpy(a) for a in arrs])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for a, b_ in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


def test_lex_argmin_rows_matches_jax():
    rng = np.random.default_rng(1)
    rows, k, b = 3, 6, 256
    c = rng.integers(0, 3, (rows, k, b)).astype(np.float64)
    c[rng.random((rows, k, b)) < 0.2] = INF
    # ragged tails ranked -inf (absent slots) and whole rows +inf (laps
    # not stored), as the simulator builds them
    tail = rng.integers(1, k + 1, (rows, b))
    c[np.arange(k)[None, :, None] >= tail[:, None, :]] = -INF
    c[0, :, :16] = INF
    c[:, :, 16:32] = c[:1, :, 16:32]  # identical rows: the first wins
    want = np.asarray(jbs._lex_argmin_rows(jnp.asarray(c)))
    got = tstep._lex_argmin_rows(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lap_count,nsi", [(1, 1), (1, 2), (3, 2), (2, 3)])
def test_step_solver_inputs_match_jax(lap_count, nsi):
    inactive = np.arange(10) % 3 == 0
    want = jbs._step_solver_inputs(jnp.asarray(lap_count, jnp.int32), nsi, 8,
                                   jnp.asarray(inactive), 10)
    got = tbs._step_solver_inputs(lap_count, nsi, 8,
                                  torch.from_numpy(inactive), 10, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


B, T_ROWS, MAX_LAPS, CAP = 64, 128, 8, 16


def _safe_set(rng, xcl):
    """Four stored laps: the seed lap in slot 0 and perturbed copies of
    every 2nd, 3rd and 4th row in slots 1-3, whose lengths vary per lane;
    slot 3 holds 20-31 rows, fewer than k = 32, and a few lanes store only
    5 rows in slots 1 and 3, fewer than k = 8 (the ragged rows)."""
    states = np.zeros((MAX_LAPS, T_ROWS, 4, B))
    lap_len = np.zeros((MAX_LAPS, B), np.int32)
    states[0, :121] = xcl[:, :, None]
    lap_len[0] = 121
    for slot, every, lo in ((1, 2, 55), (2, 3, 35), (3, 4, 20)):
        rows = xcl[::every]
        n = rng.integers(lo, len(rows) + 1, B)
        if slot != 2:
            n[:3] = 5
        lap = rows[:, :, None] + rng.normal(size=(len(rows), 4, B)) * [
            [0.3], [0.3], [0.05], [0.01]]
        for b in range(B):
            states[slot, :n[b], :, b] = lap[:n[b], :, b]
        lap_len[slot] = n
    t = np.arange(T_ROWS)[:, None]
    qfun = np.maximum(lap_len[:, None, :] - 1.0 - t[None], 0.0)
    valid = t[None] < lap_len[:, None, :]
    return states, qfun, valid, lap_len


def _tied_safe_set(rng, xcl):
    """Ties for the kNN: the seed lap in slot 0 and its first 60 rows each
    stored twice in slot 1 (equal distances at different rows), all on a
    0.5 grid; a third of the lanes store only 1-7 rows in slot 1, fewer
    than k = 8."""
    states = np.zeros((MAX_LAPS, T_ROWS, 4, B))
    lap_len = np.zeros((MAX_LAPS, B), np.int32)
    states[0, :121] = xcl[:, :, None]
    states[1, :120] = np.repeat(xcl[:60], 2, axis=0)[:, :, None]
    states = np.round(states * 2) / 2
    lap_len[0], lap_len[1] = 121, 120
    short = np.arange(B) % 3 == 0
    lap_len[1, short] = rng.integers(1, 8, int(short.sum()))
    t = np.arange(T_ROWS)[:, None]
    states[1] *= (t < lap_len[1][None])[:, None, :]
    qfun = np.maximum(lap_len[:, None, :] - 1.0 - t[None], 0.0)
    valid = t[None] < lap_len[:, None, :]
    return states, qfun, valid, lap_len


def _step_against_jax(nsi, ss, x0, rng, k=8, lap_count=2):
    """(port's x_1, JAX's x_1, port inputs): one control step with k
    candidates over the last nsi of ``lap_count`` laps stored in the safe
    set ``ss`` from x0 (4, B), f64; the JAX simulator resumed on ss for
    one step (noise off) records x_1 = step(x_0, u_0)."""
    opt = np.arange(B) % 3
    jo = JObstacle(x=jnp.asarray(31.0 + rng.normal(size=B) * 3),
                   y=jnp.asarray(-2.0 + rng.normal(size=B) * 3),
                   width=jnp.full((B,), 8.0), height=jnp.full((B,), 6.0),
                   spd=jnp.asarray(np.where(opt == 0, 0.0, 0.5)),
                   moving_option=jnp.asarray(opt, jnp.float64),
                   present=jnp.asarray((np.arange(B) % 8 != 7) * 1.0))
    xcl, _ = j_seed(1.0)
    jp = JParams.make(dtype=jnp.float64, num_ss_iter=nsi, num_ss_points=k)
    jl = JLimits.make(dtype=jnp.float64)
    scen = jbs.SoaScenarios(
        x0=jnp.asarray(x0), goal=jnp.broadcast_to(jnp.asarray(xcl[-1])[:, None],
                                                  (4, B)),
        obstacle=jo, noise_on=jnp.zeros((B,)))
    seed_xs = jnp.zeros((T_ROWS, 4))
    res = jbs.simulate_learning_runs_soa(
        jp, jl, scen, seed_xs, jnp.zeros((T_ROWS, 2)), 121, 1.0,
        jax.random.PRNGKey(0), num_laps=1, max_steps=T_ROWS,
        max_laps=MAX_LAPS, sim_step_budget=1, solver_max_iter=CAP,
        resume_from=(tuple(jnp.asarray(a) for a in ss), lap_count,
                     jax.random.PRNGKey(0)))
    want = np.asarray(res.safe_set[0][lap_count][1])  # recorded x_1 (4, B)

    tp, tl = convert.ilqr_params(jp, device="cpu"), convert.system_limits(jl, device="cpu")
    states, qfun, _valid, lap_len = convert.safe_set(ss, device="cpu")
    x = convert.tensor(x0, dtype=torch.float64, device="cpu").contiguous()
    lap_ids, lap_ok, skip = tbs._step_solver_inputs(lap_count, nsi, MAX_LAPS,
                                                    None, B, "cpu")
    obs = obstacle_to_lanes(convert.obstacle(jo, device="cpu"), B)
    a = (x, x, states, qfun, lap_len, lap_ids, lap_ok, obs, skip)
    us, shrink, idx, row = i2lqr_step_reference(tp, tl, 1.0, *a,
                                                max_iter=CAP)
    got = torch.stack(step_soa(tuple(x), (us[0, 0], us[0, 1]), 1.0)).numpy()
    assert idx.dtype == row.dtype == torch.int32
    assert set(row.tolist()) <= set(range(nsi))
    return got, want, tp, tl, a


@pytest.mark.parametrize("k,nsi", [(8, 1), (8, 2), (32, 2), (32, 4)],
                         ids=["1", "2", "k32-nsi2", "k32-nsi4"])
def test_control_step_matches_jax_f64(k, nsi):
    rng = np.random.default_rng(10 + nsi + (k - 8))
    xcl, _ = j_seed(1.0)
    ss = _safe_set(rng, xcl)
    # lanes 0-2 sit at the start of the lap, where the short stored laps
    # hold candidates; the rest anywhere along the seed lap
    rows = rng.integers(0, 100, B)
    rows[:3] = 1
    x0 = (xcl[rows] + rng.normal(size=(B, 4)) * [0.5, 0.5, 0.1, 0.02]).T
    got, want, tp, tl, a = _step_against_jax(nsi, ss, x0, rng, k=k,
                                             lap_count=4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)

    # the K1 wrapper's CPU route is this plain version, exactly
    k1 = build_fused_i2lqr_step(tp, tl, 1.0, num_horizon=6, max_steps=T_ROWS,
                                max_laps=MAX_LAPS, max_iter=CAP)
    skip = (torch.arange(B) % 5 == 0).to(torch.float32)
    a = (*a[:8], skip)
    for g, w in zip(k1(*a), i2lqr_step_reference(tp, tl, 1.0, *a,
                                                 max_iter=CAP)):
        assert torch.equal(g, w)
    assert float(k1(*a)[0][:, :, ::5].abs().max()) == 0.0  # skip lanes: zeros
    assert k1.launches == 0
    # trip counts: one (nsi*k, B) tensor per relaxation pass, 0 on skip lanes
    trips = []
    for g, w in zip(i2lqr_step_reference(tp, tl, 1.0, *a, max_iter=CAP,
                                         trips=trips), k1(*a)):
        assert torch.equal(g, w)
    live = skip < 0.5
    assert len(trips) == 3
    for t in trips:
        assert t.shape == (nsi * k, B)
        assert int(t[:, ~live].abs().max()) == 0
        assert 1 <= int(t[:, live].min()) and int(t.max()) <= CAP
    with pytest.raises(ValueError, match="unsupported device"):
        k1(*(t.to("meta") for t in a))


@pytest.mark.parametrize("nsi", [1, 2])
def test_control_step_with_tied_distances_matches_jax_f64(nsi):
    """The plain step on a safe set full of equal kNN distances and short
    laps, where K1's kNN merge has to order ties as the plain step does."""
    rng = np.random.default_rng(20 + nsi)
    xcl, _ = j_seed(1.0)
    ss = _tied_safe_set(rng, xcl)
    rows = rng.integers(0, 100, B)
    rows[:8] = rng.integers(0, 4, 8)  # where the short laps hold rows
    x0 = np.round((xcl[rows] + rng.normal(size=(B, 4))
                   * [0.5, 0.5, 0.1, 0.02]) * 2).T / 2
    # the inputs do hold ties among each lane's nearest rows
    d = np.abs(ss[0][1] - x0[None]).sum(axis=1)  # (T, B), lap 1
    d = np.where(ss[2][1], d, np.inf)
    near = np.sort(d, axis=0)[:8]
    tied = (np.isfinite(near[1:]) & (near[1:] == near[:-1])).any(axis=0)
    assert tied.mean() > 0.5
    got, want, *_ = _step_against_jax(nsi, ss, x0, rng)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
