"""``retile_frac`` and ``tail_shrink`` in the port's NLMPC simulator
(control/batched_nlmpc_soa.py) on the CPU.

- Port with the options against port without, bit for bit (lap steps and
  done flags, the safe set, ``final_x``, ``streaks``, ``iter_stats``' useful
  trips, the noise position), mirroring tests/test_batched_nlmpc_soa.py:
  263-340 (infeasible_retire 4, with_streak_stats): spaceVarying at f64 and
  f32 on a generator (B = 64, 2 laps, budget 60, cap 10), timeVarying
  (some lanes retired by their obstacle) and all, the kNN over every
  stored lap through K4's CPU route, a K2 that counts on injected draws,
  and one lap then one resumed lap with the options against two laps
  without. Each run's permutation log shows the lanes were permuted and
  compacted.
- Against the JAX simulator with the same options (retile_frac 0.2,
  tail_shrink 16), f64, B = 64, on JAX's own draws: lap steps, done flags,
  lap lengths and streaks exactly, the stored states and inputs to 1e-7.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_tpu.control import batched_nlmpc_soa as jns
from ilqr_iterative_tasks_tpu.control.batched_soa import (
    SoaScenarios as JScenarios)
from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObstacle
from ilqr_iterative_tasks_tpu.utils.params import (
    LmpcParams as JParams, SystemLimits as JLimits)
from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import (
    simulate_nlmpc_runs_soa)
from ilqr_iterative_tasks_torch.control.batched_soa import SoaScenarios
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    build_fused_lm_shooting)
from ilqr_iterative_tasks_torch.ops.nlmpc_step import build_fused_nlmpc_step
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils import convert
from ilqr_iterative_tasks_torch.utils.params import LmpcParams, SystemLimits
from test_torch_batched_nlmpc_soa import _jax_draws

torch.set_num_threads(1)
F64 = torch.float64
T_ROWS, MAX_LAPS = 128, 8
OPTIONS = dict(retile_frac=0.2, tail_shrink=16)
KW = dict(num_laps=2, max_steps=T_ROWS, max_laps=MAX_LAPS, max_lm_iters=10,
          sim_step_budget=60, infeasible_retire=4, with_streak_stats=True)


def _seed():
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((T_ROWS, 4)), np.zeros((T_ROWS, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    return xcl, seed_xs, seed_us


def _run(b, dtype=F64, options=None, mode=None, log=None, jitter=False,
         **kw):
    """The NLMPC run of KW (and ``kw``) on B lanes at the (31, -2) 8 x 6
    obstacle (with ``jitter``, each lane's moved by N(0, 1) in x and y),
    noise from a generator of seed 11 unless ``noise`` is given."""
    xcl, seed_xs, seed_us = _seed()
    obstacle = Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=dtype, device="cpu")
    if jitter:
        scen = SoaScenarios.randomized(
            np.zeros(4), xcl[-1], obstacle, b,
            torch.Generator().manual_seed(3), x0_jitter=0.0,
            obs_pos_jitter=1.0, dtype=dtype, device="cpu")
    else:
        scen = SoaScenarios.broadcast(np.zeros(4), xcl[-1], obstacle, b,
                                      noise_on=True, dtype=dtype,
                                      device="cpu")
    if "noise" not in kw:
        kw["generator"] = torch.Generator().manual_seed(11)
    return simulate_nlmpc_runs_soa(
        LmpcParams.make(dtype=dtype, device="cpu", **(mode or {})),
        SystemLimits.make(dtype=F64, device="cpu"), scen, seed_xs, seed_us,
        121, 1.0, perm_log=log, **(options or {}), **dict(KW, **kw))


def assert_same_run(got, want):
    for name in ("lap_steps", "lap_done", "final_x"):
        g, v = getattr(got, name), getattr(want, name)
        assert g.dtype == v.dtype and torch.equal(g, v), name
    for g, v in zip(got.safe_set, want.safe_set):
        assert g.dtype == v.dtype and torch.equal(g, v)
    for g, v in zip(got.streaks, want.streaks):
        assert torch.equal(g, v)
    assert len(got.streaks) == len(want.streaks)
    assert got.lap_count == want.lap_count
    key, want_key = got.final_key, want.final_key
    assert (torch.equal(key, want_key) if isinstance(key, torch.Tensor)
            else key == want_key)


def assert_fired(log, laps):
    """The options permuted the lanes, and compacted them in some lap."""
    assert len(log) == laps
    assert sum(e["perms"] for e in log) > 0
    assert any(e["compacted"] for e in log)
    assert all(len(e["perm_ms"]) == e["perms"] for e in log)


@pytest.mark.parametrize("dtype", [F64, torch.float32], ids=["f64", "f32"])
def test_space_varying_options_equal_the_run_without(dtype):
    base, log = _run(64, dtype), []
    assert_same_run(_run(64, dtype, OPTIONS, log=log), base)
    assert_fired(log, 2)
    assert bool(base.streaks[0].any() | base.streaks[1].any())


class _InfeasibleNear:
    """A timeVarying K2 (its CPU route) that reports every lane whose
    obstacle lies left of x = 30 all-infeasible from its ``start``-th call
    on: those lanes retire and run to the budget while the rest end their
    lap together (timeVarying follows the stored lap's time index), so the
    options permute and compact. The rule reads the lane's own inputs, so
    it follows a lane through any permutation."""

    def __init__(self, k2, start):
        self.k2, self.start, self.calls = k2, start, 0

    def __getattr__(self, name):
        return getattr(self.k2, name)

    def __call__(self, *args, **kw):
        out = list(self.k2(*args, **kw))
        self.calls += 1
        if self.calls > self.start:
            obs_x = args[8][0]
            out[1] = torch.where(obs_x < 30.0, 0.0, out[1])
        return tuple(out)


def _time_varying(b, start):
    k2 = build_fused_nlmpc_step(
        LmpcParams.make(ss_option="timeVarying", dtype=F64, device="cpu"),
        SystemLimits.make(dtype=F64, device="cpu"), 1.0, num_horizon=6,
        max_steps=T_ROWS, max_laps=MAX_LAPS, max_iters=KW["max_lm_iters"],
        qsort_skip=True)
    return _InfeasibleNear(k2, start)


@pytest.mark.parametrize("mode,b,kw", [
    ("timeVarying", 32, dict(sim_step_budget=121, num_laps=1)),
    ("all", 16, dict(sim_step_budget=40)),
    ("every_lap", 16, dict(sim_step_budget=40))],
    ids=["timeVarying", "all", "every_lap"])
def test_other_safe_set_modes_options_equal_the_run_without(mode, b, kw):
    """timeVarying (one lap of 111 steps, B = 32, obstacles jittered, the
    lanes left of x = 30 retired from step 20: ``_InfeasibleNear``), all
    (every point of the last lap) and the kNN over every stored lap
    through K4's CPU route (the default backend on the card for it), these
    two at B = 16, 2 laps of at most 40 steps; tail_shrink b / 2 and 4."""
    params = dict(timeVarying=dict(ss_option="timeVarying"),
                  all=dict(all_ss_point=True),
                  every_lap=dict(all_ss_iter=True))[mode]
    tail = 4
    if mode == "every_lap":
        kw = dict(kw, candidate_solver=build_fused_lm_shooting(
            SystemLimits.make(dtype=F64, device="cpu"), 1.0, num_horizon=6,
            max_iters=KW["max_lm_iters"]))
    if mode == "timeVarying":
        kw = dict(kw, jitter=True)
        tail = b // 2
    runs = []
    for options in ({}, dict(retile_frac=0.2, tail_shrink=tail)):
        log = []
        if mode == "timeVarying":
            kw["step_solver"] = _time_varying(b, 20)
        runs.append((_run(b, options=options, mode=params, log=log, **kw),
                     log))
    assert_same_run(runs[1][0], runs[0][0])
    assert_fired(runs[1][1], kw.get("num_laps", 2))


def test_counting_k2_options_keep_the_useful_trips():
    """A K2 built with_stats (its CPU route: the plain step), on injected
    draws: the records and each lane's useful trips equal the run without
    the options; the executed thread-trips count the warps the lanes
    share, which the permutation changes."""
    b = 64
    noise = torch.tensor(np.random.default_rng(5).normal(size=(130, 2, b)))
    k2 = build_fused_nlmpc_step(
        LmpcParams.make(dtype=F64, device="cpu"),
        SystemLimits.make(dtype=F64, device="cpu"), 1.0, num_horizon=6,
        max_steps=T_ROWS, max_laps=MAX_LAPS, max_iters=KW["max_lm_iters"],
        qsort_skip=True, with_stats=True)
    base, log = _run(b, noise=noise, step_solver=k2), []
    got = _run(b, options=OPTIONS, log=log, noise=noise, step_solver=k2)
    assert_same_run(got, base)
    assert_fired(log, 2)
    assert torch.equal(got.iter_stats[0], base.iter_stats[0])
    assert int(base.iter_stats[0].sum()) > 0
    assert bool((got.iter_stats[0] <= got.iter_stats[1]).all())


def test_resumed_lap_with_options_equals_two_laps():
    b = 64
    two = _run(b)
    log = []
    one = _run(b, options=OPTIONS, log=log, num_laps=1)
    g = torch.Generator().manual_seed(11)
    g.set_state(one.final_key)
    xcl, seed_xs, seed_us = _seed()
    scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1],
        Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=F64, device="cpu"), b,
        noise_on=True, dtype=F64, device="cpu")
    resumed = simulate_nlmpc_runs_soa(
        LmpcParams.make(dtype=F64, device="cpu"),
        SystemLimits.make(dtype=F64, device="cpu"), scen, seed_xs, seed_us,
        121, 1.0, generator=g, perm_log=log,
        resume_from=(one.safe_set, one.lap_count, one.final_key),
        **OPTIONS, **dict(KW, num_laps=1))
    for g_, v in zip(resumed.safe_set, two.safe_set):
        assert torch.equal(g_, v)
    assert torch.equal(resumed.lap_steps[0], two.lap_steps[1])
    assert torch.equal(resumed.final_x, two.final_x)
    assert torch.equal(resumed.final_key, two.final_key)
    assert_fired(log, 2)


def test_options_are_taken_and_checked():
    with pytest.raises(ValueError, match="tail_shrink"):
        _run(4, options=dict(tail_shrink=4), num_laps=1, sim_step_budget=2)
    with pytest.raises(TypeError, match="dedup_passes"):
        _run(4, options=dict(dedup_passes=True), num_laps=1)


def test_options_match_the_jax_simulator_f64():
    """JAX's simulator and the port's with retile_frac 0.2 and tail_shrink
    16, f64, B = 64 (tests/test_batched_nlmpc_soa.py:263-315's run), the
    port on JAX's own draws: the port permutes, and the records agree:
    lap steps, done flags, lap lengths (so Qfun and the valid rows) and
    streaks exactly, the stored states and inputs to 1e-7 (the one-lap
    comparison's 1e-9, tests/test_torch_batched_nlmpc_soa.py, grows over
    the second lap's steps: XLA's and torch's sin / cos differ in the
    last bit). One JAX compile: ~35 s on one CPU thread."""
    b, budget = 64, 60
    xcl, seed_xs, seed_us = _seed()
    scen = JScenarios.broadcast(
        np.zeros(4), xcl[-1],
        JObstacle.make(31.0, -2.0, 8.0, 6.0, dtype=jnp.float64), b,
        noise_on=True, dtype=jnp.float64)
    key = jax.random.PRNGKey(11)
    kw = dict(num_laps=2, max_steps=T_ROWS, max_laps=MAX_LAPS,
              max_lm_iters=10, sim_step_budget=budget, infeasible_retire=4,
              with_streak_stats=True)
    jp, jl = JParams.make(dtype=jnp.float64), JLimits.make(dtype=jnp.float64)
    t0 = time.perf_counter()
    jr = jns.simulate_nlmpc_runs_soa(
        jp, jl, scen, jnp.asarray(seed_xs), jnp.asarray(seed_us), 121, 1.0,
        key, **OPTIONS, **kw)
    jax.block_until_ready(jr.lap_steps)
    print(f"JAX run {time.perf_counter() - t0:.1f} s")
    log = []
    tr = simulate_nlmpc_runs_soa(
        convert.lmpc_params(jp, device="cpu"),
        convert.system_limits(jl, device="cpu"),
        convert.scenarios(scen, device="cpu"), seed_xs, seed_us, 121, 1.0,
        noise=torch.from_numpy(_jax_draws(key, 2 * budget, b)),
        perm_log=log, **OPTIONS, **kw)
    assert_fired(log, 2)
    np.testing.assert_array_equal(tr.lap_steps.numpy(),
                                  np.asarray(jr.lap_steps))
    np.testing.assert_array_equal(tr.lap_done.numpy(),
                                  np.asarray(jr.lap_done))
    for i in (2, 3, 4):  # Qfun, valid rows, lap lengths
        np.testing.assert_array_equal(tr.safe_set[i].numpy(),
                                      np.asarray(jr.safe_set[i]))
    for i in (0, 1):  # stored states and inputs
        np.testing.assert_allclose(tr.safe_set[i].numpy(),
                                   np.asarray(jr.safe_set[i]), rtol=0,
                                   atol=1e-7)
    for g, v in zip(tr.streaks, jr.streaks):
        np.testing.assert_array_equal(g.numpy(), np.asarray(v))
