"""K2's ``with_stats`` on the CPU: the plain step's counts
(``nlmpc_step_reference``), the factory, and the NLMPC simulator's
``iter_stats``.

- The counts leave the outputs alone: on ``headlines.k2_option_lanes``
  (laps shorter than k, shrunk horizons down to 1, skipped lanes, lanes
  with nothing feasible, a lap not yet stored at nsi = 2), B = 128, LM cap
  12, spaceVarying and timeVarying, with and without ``qsort_skip``, nsi 1
  and 2, the outputs equal the plain step's bit for bit in f64 and f32,
  and the counts hold their invariants.
- Against the JAX kernel (ops/pallas_nlmpc_step.py) with ``with_stats`` in
  interpret mode, f32, one tile of 128 lanes, on the same inputs (run in a
  fresh process, tests/_jax_step_stats.py): spaceVarying in the plain
  order and timeVarying with ``qsort_skip``. The decisions (feasible_any,
  idx_sel, row_sel, succ) equal JAX's on every live lane. The f32 LM
  trips follow XLA:CPU's arithmetic (FMA contraction, its sin / cos), and
  the port's K2 enters a candidate that no stored row backs done where
  the TPU kernel's plain order solves it (csrc/nlmpc_step.cu): so
  ``iters_useful`` is held by its sum, within 2 % of JAX's under
  timeVarying's qsort_skip (both solve the ranks up to the first feasible
  one) and within 5 % in spaceVarying's plain order, and every live lane
  within 24 trips (two starts of up to 12) under qsort_skip.
- mode ``all`` refuses ``with_stats``, as the TPU factory does.
- A closed loop through the NLMPC simulator with a K2 that counts: the
  records are the plain run's, and ``iter_stats`` is populated.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import (
    simulate_nlmpc_runs_soa)
from ilqr_iterative_tasks_torch.control.batched_soa import SoaScenarios
from ilqr_iterative_tasks_torch.experiments.headlines import (
    k2_option_lanes, lap_records_hash, live_share, stats_summary)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.nlmpc_step import (
    build_fused_nlmpc_step, nlmpc_step_reference)
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import LmpcParams, SystemLimits

torch.set_num_threads(1)
CAP = 12
TESTS = os.path.dirname(os.path.abspath(__file__))
MODES = {"space": "spaceVarying", "time": "timeVarying"}


def _args(mode, a):
    return a if mode == "timeVarying" else a[:11] + (None, None)


@functools.lru_cache(maxsize=None)
def _case(mode, nsi, lap_count, dtype):
    p = LmpcParams.make(num_ss_iter=nsi, ss_option=mode, device="cpu",
                        dtype=dtype)
    lim = SystemLimits.make(device="cpu", dtype=torch.float64)
    a = k2_option_lanes(nsi, lap_count, "cpu", dtype=dtype)
    plain = nlmpc_step_reference(p, lim, 1.0, *_args(mode, a),
                                 max_iters=CAP)
    return p, lim, a, plain


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("mode,nsi,lap_count,qsort", [
    ("space", 1, 2, False), ("space", 1, 2, True), ("time", 1, 2, False),
    ("time", 1, 2, True), ("space", 2, 2, False), ("time", 2, 1, False)])
def test_counts_keep_the_outputs(mode, nsi, lap_count, qsort, dtype):
    mode = MODES[mode]
    p, lim, a, plain = _case(mode, nsi, lap_count, dtype)
    got = nlmpc_step_reference(p, lim, 1.0, *_args(mode, a), max_iters=CAP,
                               qsort_skip=qsort, with_stats=True)
    assert len(got) == 8
    for g, w in zip(got[:6], plain):
        assert g.dtype == w.dtype and torch.equal(g, w)
    useful, executed = got[6:]
    assert useful.dtype == executed.dtype == torch.int32
    skipped = a[9] > 0.5
    h1 = a[10] <= 1
    assert bool((useful <= executed).all())
    assert int(useful[skipped | h1].abs().sum()) == 0
    assert int(executed[skipped].abs().sum()) == 0
    assert int(useful.sum()) > 0
    if qsort and mode == "timeVarying":  # the ranks up to the first feasible
        every = nlmpc_step_reference(p, lim, 1.0, *_args(mode, a),
                                     max_iters=CAP, with_stats=True)
        assert int(useful.sum()) < int(every[6].sum())


def test_all_mode_refuses_with_stats():
    lim = SystemLimits.make(device="cpu", dtype=torch.float64)
    p = LmpcParams.make(all_ss_point=True, device="cpu")
    with pytest.raises(ValueError, match="with_stats"):
        build_fused_nlmpc_step(p, lim, 1.0, num_horizon=6, max_steps=40,
                               max_laps=4, with_stats=True)
    a = k2_option_lanes(1, 2, "cpu")
    with pytest.raises(ValueError, match="with_stats"):
        nlmpc_step_reference(p, lim, 1.0, *a[:11], max_iters=CAP,
                             with_stats=True)
    k2 = build_fused_nlmpc_step(LmpcParams.make(device="cpu"), lim, 1.0,
                                num_horizon=6, max_steps=40, max_laps=4,
                                with_stats=True)
    assert k2.with_stats and len(k2(*a[:11])) == 8


@pytest.fixture(scope="module")
def jax_k2(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_k2") / "k2.npz"
    run = subprocess.run(
        [sys.executable, os.path.join(TESTS, "_jax_step_stats.py"), "k2",
         str(out)], capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(TESTS))
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("run,mode,qsort,within", [
    ("space", "spaceVarying", False, 0.05),
    ("time_qsort", "timeVarying", True, 0.02)])
def test_counts_match_the_jax_kernel(jax_k2, run, mode, qsort, within):
    p = LmpcParams.make(ss_option=mode, device="cpu", dtype=torch.float32)
    lim = SystemLimits.make(device="cpu", dtype=torch.float32)
    a = k2_option_lanes(1, 2, "cpu", dtype=torch.float32)
    got = [t.numpy() for t in nlmpc_step_reference(
        p, lim, 1.0, *_args(mode, a), max_iters=CAP, qsort_skip=qsort,
        with_stats=True)]
    live = a[9].numpy() < 0.5  # JAX writes a skipped lane's computed step
    agree = live.copy()
    for i in (1, 3, 4, 5):
        agree &= got[i] == jax_k2[f"{run}_{i}"]
    assert agree.sum() >= 0.99 * live.sum()
    mine, theirs = got[6][agree], jax_k2[f"{run}_6"][agree]
    assert abs(int(mine.sum()) - float(theirs.sum())) <= within * theirs.sum()
    if qsort:
        assert np.abs(mine - theirs).max() <= 2 * CAP


def test_closed_loop_with_a_counting_k2_keeps_the_records():
    """Seed lap + 1 learning lap (B = 4, f64, zero noise, at most 30 steps)
    through a K2 with qsort_skip and with_stats in timeVarying, launched
    through the live-share recorder, against the plain run."""
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((128, 4)), np.zeros((128, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0,
                                            dtype=torch.float64, device="cpu"),
        4, dtype=torch.float64, device="cpu")
    p = LmpcParams.make(ss_option="timeVarying", dtype=torch.float64,
                        device="cpu")
    lim = SystemLimits.make(dtype=torch.float64, device="cpu")
    kw = dict(num_laps=1, max_steps=128, max_laps=4, max_lm_iters=CAP,
              sim_step_budget=30)
    plain = simulate_nlmpc_runs_soa(p, lim, scen, seed_xs, seed_us, 121,
                                    1.0, **kw)
    k2 = live_share(build_fused_nlmpc_step(
        p, lim, 1.0, num_horizon=6, max_steps=128, max_laps=4,
        max_iters=CAP, qsort_skip=True, with_stats=True), 9, 4)
    res = simulate_nlmpc_runs_soa(p, lim, scen, seed_xs, seed_us, 121, 1.0,
                                  step_solver=k2, **kw)
    assert lap_records_hash(res) == lap_records_hash(plain)
    assert plain.iter_stats == ()
    useful, executed = res.iter_stats
    assert useful.dtype == torch.int64 and useful.shape == (4,)
    assert bool((useful <= executed).all()) and int(useful.min()) > 0
    assert 0.0 <= stats_summary(res.iter_stats)["waste"] < 1.0
    assert k2.shares()["launches"] == 30
