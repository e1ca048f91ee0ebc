"""NLMPC control steps (f64, B = 64): the port's plain K2
(``nlmpc_step_reference``) plus ``advance_tail`` against the JAX simulator,
in each safe-set mode.

``solve_step_general`` is a closure of the JAX simulator, so the JAX side
is a run of simulator steps: ``resume_from`` a safe set built with numpy,
one learning lap with ``sim_step_budget`` steps, noise off; the port side
runs the same steps with the plain step, ``advance_tail`` and the plant.
The newest stored lap sets each lane's terminal guess (its row n) and warm
start (its first n inputs), batched_nlmpc_soa.py:833-836. Each lane stores
a slice of the seed lap that starts near its own x0, some shorter than k,
with its own obstacle; a few lanes start far off and have no feasible
candidate. The recorded states and inputs agree to 1e-9: one step in
spaceVarying, five in timeVarying (the window at t = 0..4), all and all
with all_iter (two stored laps and two empty slots), and three at
num_ss_iter = 2 in spaceVarying and timeVarying. Shrunk horizons are
held by tests/test_torch_lm_shooting_soa.py (``m_lanes``) and the closed
loops of tests/test_torch_batched_nlmpc_soa.py. Also: the K2 wrapper's CPU
route is the plain step, at every horizon and in every mode, and the
wrapper's factory refuses what the TPU factory refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_tpu.control import batched_nlmpc_soa as jns
from ilqr_iterative_tasks_tpu.control.batched_soa import (
    SoaScenarios as JScenarios)
from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObstacle
from ilqr_iterative_tasks_tpu.ops.pallas_nlmpc_step import (
    build_fused_nlmpc_step as j_build_fused_nlmpc_step)
from ilqr_iterative_tasks_tpu.sim.seed import seed_trajectory as j_seed
from ilqr_iterative_tasks_tpu.utils.params import (
    LmpcParams as JParams, SystemLimits as JLimits)
from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import (
    advance_tail, default_options, lap_window)
from ilqr_iterative_tasks_torch.control.batched_soa import plant_step
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    build_fused_lm_shooting, obstacle_to_lanes_nlmpc)
from ilqr_iterative_tasks_torch.ops.nlmpc_step import (
    build_fused_nlmpc_step, nlmpc_step_reference)
from ilqr_iterative_tasks_torch.utils import convert

torch.set_num_threads(1)
B, N, T_ROWS, MAX_LAPS, LAPS, CAP = 64, 6, 40, 4, 2, 12


def _problem(seed=0, stall=False):
    """Numpy safe set with LAPS stored laps, scenarios and obstacles. With
    ``stall``, lanes 1 mod 5 end their newest lap with up to 24 rows at
    their own x0 and 12 m/s faster (in reach, infeasible: a long in-reach
    window before the feasible rows), and lanes 2 mod 5 store only such
    rows (in reach, nothing feasible)."""
    rng = np.random.default_rng(seed)
    xcl, ucl = j_seed(1.0)
    start = rng.integers(0, 80, B)
    length = rng.integers(4, T_ROWS + 1, B)  # some shorter than k = 8
    states = np.zeros((MAX_LAPS, T_ROWS, 4, B))
    inputs = np.zeros((MAX_LAPS, T_ROWS, 2, B))
    lap_len = np.zeros((MAX_LAPS, B), np.int32)
    for lap in range(LAPS):
        for b in range(B):
            r = start[b] if lap == LAPS - 1 else 0
            rows = min(length[b], 120 - r)
            states[lap, :rows, :, b] = xcl[r:r + rows]
            inputs[lap, :rows, :, b] = ucl[r:r + rows]
            lap_len[lap, b] = rows
    t = np.arange(T_ROWS)[None, :, None]
    qfun = np.maximum(lap_len[:, None, :] - 1.0 - t, 0.0)
    valid = t < lap_len[:, None, :]
    x0 = (xcl[start] + rng.normal(size=(B, 4)) * [0.2, 0.2, 0.05, 0.02]).T
    x0[1, -8:] += 60.0  # far off the stored lap: all candidates infeasible
    if stall:
        lane = np.arange(B)
        n = lap_len[LAPS - 1]
        t = np.arange(T_ROWS)[:, None]
        rows = (t < n) & (((lane % 5 == 1) & (t >= n - 24))
                          | (lane % 5 == 2))
        fast = x0 + np.array([0.0, 0.0, 12.0, 0.0])[:, None]
        states[LAPS - 1] = np.where(rows[:, None, :], fast[None],
                                    states[LAPS - 1])
    opt = np.arange(B) % 3
    centre = xcl[start + 3]
    obs = dict(x=centre[:, 0] + rng.normal(size=B) * 4,
               y=centre[:, 1] + rng.normal(size=B) * 4,
               width=1.0 + 3 * rng.random(B), height=1.0 + 3 * rng.random(B),
               spd=np.where(opt == 0, 0.0, 0.5 * rng.random(B)),
               moving_option=opt.astype(float),
               present=(np.arange(B) % 10 != 9).astype(float))
    return (states, inputs, qfun, valid, lap_len), x0, obs, xcl[-1]


MODES = {"spaceVarying": {}, "timeVarying": dict(ss_option="timeVarying"),
         "all": dict(all_ss_point=True),
         "all_iter": dict(all_ss_point=True, all_ss_iter=True),
         "spaceVarying_iter": dict(all_ss_iter=True),
         "timeVarying_iter": dict(ss_option="timeVarying", all_ss_iter=True)}


def _steps_against_jax(mode, steps, stall=False, nsi=1, k4=False):
    """The recorded states (steps, 4, B) and inputs (steps, 2, B) of the
    port and of the JAX simulator, and the port's per-step feasible_any
    (steps, B) and succ (steps, B), after ``steps`` steps from the
    stored laps of ``_problem(stall=stall)``, with the last ``nsi`` of
    them in each step's window; with ``k4`` the port's candidate solves
    run through K4's CPU route."""
    ss, x0, obs, goal = _problem(stall=stall)
    jp = JParams.make(dtype=jnp.float64, num_ss_iter=nsi, **MODES[mode])
    jl = JLimits.make(dtype=jnp.float64)
    jo = JObstacle(**{k: jnp.asarray(v) for k, v in obs.items()})
    scen = JScenarios(x0=jnp.asarray(x0),
                      goal=jnp.broadcast_to(jnp.asarray(goal)[:, None],
                                            (4, B)),
                      obstacle=jo, noise_on=jnp.zeros(B))
    key = jax.random.PRNGKey(0)
    jss = tuple(jnp.asarray(a) for a in ss)
    jr = jns.simulate_nlmpc_runs_soa(
        jp, jl, scen, jss[0][0, :, :, 0], jss[1][0, :, :, 0], 121, 1.0, key,
        num_laps=1, max_steps=T_ROWS, max_laps=MAX_LAPS, goal_append=True,
        sim_step_budget=steps, max_lm_iters=CAP, resume_from=(jss, LAPS, key))
    j_xs = np.asarray(jr.safe_set[0])[LAPS, 1:steps + 1]  # recorded states
    j_us = np.asarray(jr.safe_set[1])[LAPS, :steps]  # recorded inputs

    # the port: the simulator's step body with the plain step, noise off
    tp, tl = (convert.lmpc_params(jp, device="cpu"),
              convert.system_limits(jl, device="cpu"))
    states, inputs, qfun, _valid, lap_len = convert.safe_set(ss, device="cpu")
    x = convert.tensor(x0, dtype=torch.float64, device="cpu")
    obstacle = convert.obstacle(jo, device="cpu")
    goal_t = x.new_tensor(goal)[:, None].expand(4, B)
    guess, u_warm = states[LAPS - 1, N], inputs[LAPS - 1, :N]
    lap_ids, lap_ok = lap_window(LAPS, tp.num_ss_iter, MAX_LAPS,
                                 tp.all_ss_iter, B, "cpu")
    min_cost = (lap_len[:LAPS] - 1).amin(dim=0)
    skip = torch.zeros(B)
    hzn = torch.full((B,), N, dtype=torch.int32)
    t = torch.zeros(B, dtype=torch.int32)
    u_prev = torch.zeros((2, B), dtype=torch.float64)
    no_lane = torch.zeros(B, dtype=torch.bool)
    lanes = torch.arange(B)
    cand = (build_fused_lm_shooting(tl, 1.0, num_horizon=N, max_iters=CAP)
            if k4 else None)
    xs, us, feas_s, succ_s = [], [], [], []
    for _ in range(steps):
        extra = (t, min_cost) if tp.ss_mode == "timeVarying" else ()
        us_w, feas, new_guess, idx, row, succ = nlmpc_step_reference(
            tp, tl, 1.0, x, guess, u_warm, states, qfun, lap_len, lap_ids,
            lap_ok, obstacle_to_lanes_nlmpc(obstacle, B), skip, hzn, *extra,
            max_iters=CAP, candidate_solver=cand)
        u_app = inputs[lap_ids.long()[row.long()], idx.long(), :, lanes].T
        u_sel, guess_n, u_warm, hzn = advance_tail(
            us_w, u_app, new_guess, succ > 0.5, hzn <= 1, hzn, feas > 0.5,
            guess, u_warm)
        guess = guess_n
        u = torch.where(feas[None] > 0.5, u_sel, u_prev)
        u_prev = u
        x, obstacle, _ = plant_step(x, u, 1.0, torch.zeros((2, B)), 0.0,
                                    no_lane, obstacle, goal_t)
        t = t + 1
        xs.append(x)
        us.append(u)
        feas_s.append(feas)
        succ_s.append(succ)
    return ((torch.stack(xs).numpy(), torch.stack(us).numpy()),
            (j_xs, j_us), torch.stack(feas_s).numpy() > 0.5,
            torch.stack(succ_s).numpy() > 0.5)


def test_one_step_matches_jax_f64():
    (x1, u), (j_x1, j_u), f, succ = _steps_against_jax("spaceVarying", 1)
    assert 0.5 < f.mean() < 1.0 and not f[0, -8:].any(), f
    assert 0.0 < succ.mean() < 1.0  # both guess advances
    np.testing.assert_allclose(u, j_u, rtol=0, atol=1e-9)
    np.testing.assert_allclose(x1, j_x1, rtol=0, atol=1e-9)


@pytest.mark.parametrize("mode", ["timeVarying", "all", "all_iter"])
def test_steps_match_jax_f64(mode):
    (xs, us), (j_xs, j_us), f, succ = _steps_against_jax(mode, 5)
    assert 0.1 < f.mean() < 1.0 and not f[:, -8:].any(), f.mean(axis=1)
    assert 0.0 < succ.mean() < 1.0  # both guess advances
    np.testing.assert_allclose(us, j_us, rtol=0, atol=1e-9)
    np.testing.assert_allclose(xs, j_xs, rtol=0, atol=1e-9)


@pytest.mark.parametrize("mode", ["spaceVarying_iter", "timeVarying_iter"])
@pytest.mark.parametrize("k4", [False, True], ids=["plain", "k4"])
def test_every_stored_lap_steps_match_jax_f64(mode, k4):
    """all_ss_iter without all_ss_point: the kNN or window over both
    stored laps (two empty slots), three steps, with the plain solve and
    through K4's CPU route."""
    (xs, us), (j_xs, j_us), f, succ = _steps_against_jax(mode, 3, k4=k4)
    assert 0.1 < f.mean() < 1.0 and not f[:, -8:].any(), f.mean(axis=1)
    assert 0.0 < succ.mean() < 1.0  # both guess advances
    np.testing.assert_allclose(us, j_us, rtol=0, atol=1e-9)
    np.testing.assert_allclose(xs, j_xs, rtol=0, atol=1e-9)


@pytest.mark.parametrize("mode", ["spaceVarying", "timeVarying"])
def test_steps_at_nsi_2_match_jax_f64(mode):
    """num_ss_iter = 2: both stored laps' candidates each step and the
    lexicographic row-min over them, three steps."""
    (xs, us), (j_xs, j_us), f, succ = _steps_against_jax(mode, 3, nsi=2)
    assert 0.1 < f.mean() < 1.0 and not f[:, -8:].any(), f.mean(axis=1)
    assert 0.0 < succ.mean() < 1.0  # both guess advances
    np.testing.assert_allclose(us, j_us, rtol=0, atol=1e-9)
    np.testing.assert_allclose(xs, j_xs, rtol=0, atol=1e-9)


@pytest.mark.parametrize("mode", ["all", "all_iter"])
def test_all_steps_with_long_reach_windows_match_jax_f64(mode):
    """mode all on lanes whose newest lap holds long runs of in-reach,
    infeasible rows and on lanes with nothing feasible in it, where K2
    all's descending scan crosses several of its chunks."""
    (xs, us), (j_xs, j_us), f, _ = _steps_against_jax(mode, 2, stall=True)
    lane = np.arange(B)
    assert f[0, lane % 5 == 1].any()  # a feasible row below the stalled ones
    if mode == "all":  # the newest lap only: nothing feasible on 2 mod 5
        assert not f[0, lane % 5 == 2].any()
    np.testing.assert_allclose(us, j_us, rtol=0, atol=1e-9)
    np.testing.assert_allclose(xs, j_xs, rtol=0, atol=1e-9)


def _route_inputs(mode):
    """(params, limits, step inputs, timeVarying extras) of the CPU-route
    tests: ``_problem(1)`` with 1/9 of lanes skipped, every horizon 1..n,
    and in timeVarying per-lane steps t = 0..6."""
    ss, x0, obs, _ = _problem(1)
    tp = convert.lmpc_params(JParams.make(dtype=jnp.float64, **MODES[mode]),
                             device="cpu")
    tl = convert.system_limits(JLimits.make(dtype=jnp.float64), device="cpu")
    states, inputs, qfun, _valid, lap_len = convert.safe_set(ss, device="cpu")
    lap_ids, lap_ok = lap_window(LAPS, 1, MAX_LAPS, tp.all_ss_iter, B, "cpu")
    skip = (torch.arange(B) % 9 == 0).to(torch.float32)
    hzn = (1 + torch.arange(B) % N).to(torch.int32)  # every horizon 1..n
    a = (convert.tensor(x0, dtype=torch.float64, device="cpu"),
         states[LAPS - 1, N], inputs[LAPS - 1, :N], states, qfun, lap_len,
         lap_ids, lap_ok, obstacle_to_lanes_nlmpc(
             convert.obstacle(JObstacle(**{k: jnp.asarray(v)
                                           for k, v in obs.items()}),
                              device="cpu"), B), skip, hzn)
    extra = ((torch.arange(B) % 7).to(torch.int32),
             (lap_len[:LAPS] - 1).amin(dim=0)) if tp.ss_mode == "timeVarying" \
        else ()
    return tp, tl, a, extra


class _Counted:
    """A candidate solver that counts its calls and their lanes."""

    def __init__(self, solver):
        self.solver, self.lanes = solver, []

    def __call__(self, *args):
        self.lanes.append(args[1].shape[-1])
        return self.solver(*args)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_candidate_step_is_the_plain_step_in_each_mode(mode):
    """The plain step through K4's CPU route equals it with the plain
    solve, bit for bit, on lanes at every horizon with 1/9 skipped: one
    call a step on the rows*k*B candidate lanes, or in mode all one a
    stored row (T*B) and one for the winner (B)."""
    tp, tl, a, extra = _route_inputs(mode)
    k4 = build_fused_lm_shooting(tl, 1.0, num_horizon=N, max_iters=CAP)
    cand = _Counted(k4)
    got = nlmpc_step_reference(tp, tl, 1.0, *a, *extra, max_iters=CAP,
                               candidate_solver=cand)
    want = nlmpc_step_reference(tp, tl, 1.0, *a, *extra, max_iters=CAP)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert 0.0 < float((got[1] > 0.5).double().mean()) < 1.0
    assert k4.launches == 0
    rows = LAPS if tp.all_ss_iter else 1  # stored laps the step reads
    if tp.ss_mode == "all":
        assert cand.lanes == [T_ROWS * B] * rows + [B]
    else:
        assert cand.lanes == [rows * tp.num_ss_points * B]
    with pytest.raises(ValueError, match="trips"):
        nlmpc_step_reference(tp, tl, 1.0, *a, *extra, max_iters=CAP,
                             candidate_solver=cand, trips=[])


def test_k2_cpu_route_is_the_plain_step():
    tp, tl, a, _ = _route_inputs("spaceVarying")
    skip, hzn = a[9], a[10]
    k2 = build_fused_nlmpc_step(tp, tl, 1.0, num_horizon=N,
                                max_steps=T_ROWS, max_laps=MAX_LAPS,
                                max_iters=CAP)
    got = k2(*a)
    want = nlmpc_step_reference(tp, tl, 1.0, *a, max_iters=CAP)
    assert k2.launches == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    s = skip > 0.5
    for g in got:
        assert not bool(g[..., s].any())  # skip lanes are zeros
    assert 0.0 < float((got[1][~s] > 0.5).double().mean()) < 1.0
    # trip counts of the candidate solves, summed over the two starts: 0 on
    # skipped and horizon-1 lanes
    trips = []
    for g, w in zip(nlmpc_step_reference(tp, tl, 1.0, *a, max_iters=CAP,
                                         trips=trips), got):
        assert torch.equal(g, w)
    (t,) = trips
    run = ~s & (hzn > 1)
    assert t.shape == (tp.num_ss_iter * tp.num_ss_points, B)
    assert int(t[:, ~run].abs().max()) == 0
    assert 1 <= int(t[:, run].min()) and int(t.max()) <= 2 * CAP


@pytest.mark.parametrize("mode", ["timeVarying", "all", "all_iter"])
def test_k2_cpu_route_in_each_mode(mode):
    tp, tl, a, extra = _route_inputs(mode)
    lap_len, lap_ids, skip, hzn = a[5], a[6], a[9], a[10]
    k2 = build_fused_nlmpc_step(tp, tl, 1.0, num_horizon=N,
                                max_steps=T_ROWS, max_laps=MAX_LAPS,
                                max_iters=CAP, **default_options(tp))
    assert (k2.mode, k2.all_iter) == (tp.ss_mode, tp.all_ss_iter)
    assert k2.qsort_skip == (mode == "timeVarying")
    assert k2.all_rev_skip == (mode == "all")
    if mode == "timeVarying":
        with pytest.raises(ValueError, match="min_cost"):
            k2(*a)
    got = k2(*a, *extra)
    trips, cands = [], []
    want = nlmpc_step_reference(tp, tl, 1.0, *a, *extra, max_iters=CAP,
                                trips=trips, cands=cands)
    assert k2.launches == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    s = skip > 0.5
    for g in got:
        assert not bool(g[..., s].any())  # skip lanes are zeros
    assert 0.0 < float((got[1][~s] > 0.5).double().mean()) < 1.0
    # candidate solves: one (k, B) batch, or one (T, B) batch a stored row;
    # 0 on skipped and horizon-1 lanes and where no stored point backs it
    run = ~s & (hzn > 1)
    if mode == "timeVarying":
        assert [tuple(t.shape) for t in trips] == [(tp.num_ss_points, B)]
    else:
        assert [tuple(t.shape) for t in trips] == [(T_ROWS, B)] * (
            LAPS if mode == "all_iter" else 1)
        for t, lap in zip(trips, lap_ids.tolist()):
            past = torch.arange(T_ROWS)[:, None] >= lap_len[lap][None]
            assert int(t[past].abs().max()) == 0
    t = torch.stack(trips)
    assert int(t[..., ~run].abs().max()) == 0
    assert int(t[..., run].max()) <= 2 * CAP and bool((t[..., run] > 0).any())
    # each candidate's Qfun (+inf where no stored point backs it) and
    # whether its cost is finite, shaped as the trips
    assert [key.shape for key, _ in cands] == [t.shape for t in trips]
    assert not any(bool((ok & ~torch.isfinite(key)).any())
                   for key, ok in cands)
    if mode != "all_iter":  # one row: feasible iff a candidate is
        (_, ok), = cands
        assert torch.equal(ok.any(dim=0)[~s], want[1][~s] > 0.5)


# (params, factory options) the TPU factory refuses (pallas_nlmpc_step.py
# :172-231), and so does the port's
REFUSED = [
    (dict(num_ss_iter=2), dict(qsort_skip=True)),
    ({}, dict(all_rev_skip=True)),
    (dict(ss_option="timeVarying"), dict(all_rev_skip=True)),
    (dict(all_ss_point=True, all_ss_iter=True), dict(all_rev_skip=True)),
    (dict(all_ss_point=True, num_ss_iter=2), dict(all_rev_skip=True)),
    (dict(all_ss_point=True), dict(qsort_skip=True)),
    ({}, dict(prox_skip=True, qsort_skip=True)),
    (dict(all_ss_point=True), dict(prox_skip=True)),
    (dict(num_ss_iter=2), dict(prox_skip=True)),
    ({}, dict(prox_skip=True, with_stats=True)),
]


@pytest.mark.parametrize("pkw,kw", REFUSED)
def test_factory_refuses_what_the_tpu_factory_refuses(pkw, kw):
    jp = JParams.make(dtype=jnp.float64, **pkw)
    mode = "all" if jp.all_ss_point else jp.ss_option
    sizes = dict(num_horizon=N, max_steps=T_ROWS, max_laps=MAX_LAPS)
    with pytest.raises(ValueError):
        j_build_fused_nlmpc_step(
            jp, JLimits.make(dtype=jnp.float64), 1.0, mode=mode,
            all_iter=jp.all_ss_iter, store_solutions=mode != "all",
            stream_safe_set=mode == "all", interpret=True, **sizes, **kw)
    tl = convert.system_limits(JLimits.make(dtype=jnp.float64), device="cpu")
    with pytest.raises(ValueError):
        build_fused_nlmpc_step(convert.lmpc_params(jp, device="cpu"), tl, 1.0,
                               **sizes, **kw)


# the options the factory takes beside the shipped ones (in each mode that
# has them), and the TPU kernel's VMEM trades it refuses
TAKEN = {"prox_skip": ("spaceVarying", "timeVarying"),
         "zeros_skip": ("spaceVarying", "timeVarying", "all")}
NOT_TAKEN = {"stream_safe_set": True, "store_solutions": False}


@pytest.mark.parametrize("option", ["shipped", *TAKEN, *NOT_TAKEN])
def test_factory_refuses_options_it_does_not_take(option):
    tp = convert.lmpc_params(JParams.make(dtype=jnp.float64), device="cpu")
    tl = convert.system_limits(JLimits.make(dtype=jnp.float64), device="cpu")
    sizes = dict(num_horizon=N, max_steps=T_ROWS, max_laps=MAX_LAPS)
    if option in NOT_TAKEN:
        with pytest.raises(ValueError, match=option):
            build_fused_nlmpc_step(tp, tl, 1.0, **sizes,
                                   **{option: NOT_TAKEN[option]})
        return
    if option in TAKEN:  # taken, and its CPU route is the plain step's
        for mode in TAKEN[option]:
            tpm, _, a, extra = _route_inputs(mode)
            k2 = build_fused_nlmpc_step(tpm, tl, 1.0, max_iters=2,
                                        **{option: True}, **sizes)
            assert getattr(k2, option) and k2.mode == mode
            want = nlmpc_step_reference(tpm, tl, 1.0, *a, *extra,
                                        max_iters=2, **{option: True})
            assert all(torch.equal(g, w) for g, w in zip(k2(*a, *extra),
                                                          want))
        return
    with pytest.raises(TypeError):
        build_fused_nlmpc_step(tp, tl, 1.0, **sizes, tile_rows=8)
    k2 = build_fused_nlmpc_step(tp, tl, 1.0, qsort_skip=True, **sizes)
    assert (k2.mode, k2.all_iter, k2.qsort_skip, k2.all_rev_skip) == (
        "spaceVarying", False, True, False)
    # with_stats is taken in the block modes and refused in mode all, as
    # the TPU factory refuses it there (pallas_nlmpc_step.py:189-191)
    assert build_fused_nlmpc_step(tp, tl, 1.0, with_stats=True,
                                  **sizes).with_stats
    tp_all = convert.lmpc_params(JParams.make(dtype=jnp.float64,
                                              all_ss_point=True),
                                 device="cpu")
    with pytest.raises(ValueError, match="with_stats"):
        build_fused_nlmpc_step(tp_all, tl, 1.0, with_stats=True, **sizes)


@pytest.mark.parametrize("mode", ["spaceVarying", "timeVarying",
                                  "spaceVarying_iter", "timeVarying_iter"])
def test_absent_candidates_are_a_suffix_of_each_row(mode):
    """The ragged list comparison ranks absent slots -inf in the row
    compare, which equals Python's list min only while the absent slots of
    each lap row are a per-lane suffix (batched_nlmpc_soa.py:414-421):
    held here on two stored laps, many shorter than k, over the window's
    steps t = 0..6, the last one lap or both (all_ss_iter)."""
    tp, tl, a, extra = _route_inputs(mode)
    cands = []
    nlmpc_step_reference(tp, tl, 1.0, *a, *extra, max_iters=1, cands=cands)
    (key, _), = cands
    rows = LAPS if tp.all_ss_iter else 1
    present = torch.isfinite(key).reshape(rows, tp.num_ss_points, B)
    assert bool((present[:, 1:] <= present[:, :-1]).all())  # no gap
    assert bool((~present[:, -1]).any()) and bool(present[:, 0].all())
