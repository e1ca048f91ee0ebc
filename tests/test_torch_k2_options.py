"""K2's ``prox_skip`` and ``zeros_skip`` on the CPU: the plain step
(``nlmpc_step_reference``), against the JAX kernel, and through the NLMPC
simulator.

- ``prox_skip`` (nsi 1, spaceVarying and timeVarying) gives the plain
  order's outputs bit for bit in f64 and f32 on
  ``headlines.k2_option_lanes`` (B = 128, LM cap 12), and in spaceVarying
  it solves fewer candidates (the skip fires).
- ``zeros_skip`` changes results: on the same inputs some lanes' outputs
  differ from the plain order's.
- Against the JAX kernel (ops/pallas_nlmpc_step.py) in interpret mode, f32,
  one tile of 128 lanes, on the same inputs (a fresh process,
  tests/_jax_step_stats.py ``k2opts``): ``prox_skip`` in both modes and
  spaceVarying's ``zeros_skip`` make JAX's decisions (feasible_any,
  idx_sel, row_sel, succ) on every live lane, the decision level at which
  ROADMAP Queue 3 holds f32 on the CPU (XLA:CPU's FMA contraction and its
  sin / cos move the f32 LM iterates, so the inputs are not compared).
- ``zeros_skip`` through the port's NLMPC simulator at the JAX package's
  gate (tests/test_behavior_envelope.py:38-70: spaceVarying, f32, B = 128,
  2 laps, budget 70, cap 12, JAX's draws of PRNGKey(5)): the flag changes
  some lanes' laps and ``utils/envelope.py`` rejects it, as it does in
  JAX (slow: two runs of about 20 s).
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_torch.experiments.headlines import k2_option_lanes
from ilqr_iterative_tasks_torch.ops.nlmpc_step import nlmpc_step_reference
from ilqr_iterative_tasks_torch.utils.params import LmpcParams, SystemLimits

torch.set_num_threads(1)
CAP = 12
TESTS = os.path.dirname(os.path.abspath(__file__))
MODES = {"space": "spaceVarying", "time": "timeVarying"}


def _args(mode, a):
    return a if mode == "timeVarying" else a[:11] + (None, None)


@functools.lru_cache(maxsize=None)
def _case(mode, lap_count, dtype):
    p = LmpcParams.make(ss_option=mode, device="cpu", dtype=dtype)
    lim = SystemLimits.make(device="cpu", dtype=torch.float64)
    a = k2_option_lanes(1, lap_count, "cpu", dtype=dtype)
    trips = []
    plain = nlmpc_step_reference(p, lim, 1.0, *_args(mode, a),
                                 max_iters=CAP, trips=trips)
    return p, lim, a, plain, trips[0]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("mode,lap_count", [
    ("space", 2), ("space", 1), ("time", 2), ("time", 1)])
def test_prox_skip_keeps_the_plain_order_s_outputs(mode, lap_count, dtype):
    mode = MODES[mode]
    p, lim, a, plain, plain_trips = _case(mode, lap_count, dtype)
    trips = []
    got = nlmpc_step_reference(p, lim, 1.0, *_args(mode, a), max_iters=CAP,
                               prox_skip=True, trips=trips)
    for g, w in zip(got, plain):
        assert g.dtype == w.dtype and torch.equal(g, w)
    solved, plain_solved = int((torch.cat(trips) > 0).sum()), int(
        (plain_trips > 0).sum())
    assert solved <= plain_solved
    if mode == "spaceVarying":  # the skip fires
        assert solved < plain_solved


@pytest.mark.parametrize("mode", ["space", "time"])
def test_zeros_skip_changes_some_lanes(mode):
    mode = MODES[mode]
    p, lim, a, plain, _ = _case(mode, 2, torch.float64)
    got = nlmpc_step_reference(p, lim, 1.0, *_args(mode, a), max_iters=CAP,
                               zeros_skip=True)
    live = a[9] < 0.5
    changed = (got[0] != plain[0]).any(dim=0).any(dim=0) & live
    assert 0 < int(changed.sum()) < int(live.sum())
    # a lane whose warm start did not converge solves its zeros start as
    # before: most lanes keep their step
    assert int(changed.sum()) <= 0.25 * int(live.sum())


@pytest.fixture(scope="module")
def jax_k2(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_k2opts") / "k2opts.npz"
    run = subprocess.run(
        [sys.executable, os.path.join(TESTS, "_jax_step_stats.py"), "k2opts",
         str(out)], capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(TESTS))
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("run,mode,opts", [
    ("prox_space", "spaceVarying", dict(prox_skip=True)),
    ("prox_time", "timeVarying", dict(prox_skip=True)),
    ("zskip_space", "spaceVarying", dict(zeros_skip=True))])
def test_decisions_match_the_jax_kernel(jax_k2, run, mode, opts):
    p = LmpcParams.make(ss_option=mode, device="cpu", dtype=torch.float32)
    lim = SystemLimits.make(device="cpu", dtype=torch.float32)
    a = k2_option_lanes(1, 2, "cpu", b=128, dtype=torch.float32)
    got = [t.numpy() for t in nlmpc_step_reference(
        p, lim, 1.0, *_args(mode, a), max_iters=CAP, **opts)]
    live = a[9].numpy() < 0.5
    for i in (1, 3, 4, 5):
        np.testing.assert_array_equal(got[i][live],
                                      jax_k2[f"{run}_{i}"][live])


def _jax_draws(steps, b):
    """The f32 standard-normal (v, theta) draws the JAX NLMPC simulator
    takes at each executed step from PRNGKey(5), in order: (steps, 2, b)."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")

    def body(k, _):
        k, k1, k2 = jax.random.split(k, 3)
        return k, jnp.stack([jax.random.normal(k1, (b,), jnp.float32),
                             jax.random.normal(k2, (b,), jnp.float32)])
    return np.array(jax.lax.scan(body, jax.random.PRNGKey(5), None,
                                 length=steps)[1])


@pytest.mark.slow
def test_zeros_skip_rejected_by_the_envelope():
    """The port's mirror of tests/test_behavior_envelope.py:38-70: a K2
    built with zeros_skip (its CPU route, the plain step) against one
    without, on the same scenarios and draws."""
    from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import (
        simulate_nlmpc_runs_soa)
    from ilqr_iterative_tasks_torch.control.batched_soa import SoaScenarios
    from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
    from ilqr_iterative_tasks_torch.ops.nlmpc_step import (
        build_fused_nlmpc_step)
    from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
    from ilqr_iterative_tasks_torch.utils.envelope import (
        assert_behavior_envelope, compare_runs)
    f32, b, budget = torch.float32, 128, 70
    p = LmpcParams.make(ss_option="spaceVarying", device="cpu", dtype=f32)
    lim = SystemLimits.make(device="cpu", dtype=f32)
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((128, 4)), np.zeros((128, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1],
        Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=f32, device="cpu"), b,
        noise_on=True, dtype=f32, device="cpu")
    noise = torch.from_numpy(_jax_draws(2 * budget, b))
    runs = []
    for zs in (False, True):
        k2 = build_fused_nlmpc_step(p, lim, 1.0, num_horizon=6,
                                    max_steps=128, max_laps=8, max_iters=CAP,
                                    zeros_skip=zs)
        runs.append(simulate_nlmpc_runs_soa(
            p, lim, scen, seed_xs, seed_us, 121, 1.0, num_laps=2,
            max_steps=128, max_laps=8, max_lm_iters=CAP,
            sim_step_budget=budget, step_solver=k2, noise=noise))
    rec = compare_runs(runs[0], runs[1])
    assert rec["frac_lanes_changed"] > 0.0  # the flag still perturbs
    with pytest.raises(AssertionError):
        assert_behavior_envelope(runs[0], runs[1])
