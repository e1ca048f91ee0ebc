"""The port's utils/metrics.py against the JAX package's on the same
recorded host runs: ``LatencyStats``, ``run_latency_stats``, ``LapMetrics``
and ``summary_dict`` (keys and values), and ``time_call``, the counterpart
of JAX's ``time_jitted``, on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_scripted import Scripted

from ilqr_iterative_tasks_torch.experiments import runner
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils import metrics
from ilqr_iterative_tasks_tpu.utils import metrics as jax_metrics

XCL, UCL = seed_trajectory(1.0)


def _recorded_run(us, laps, seed):
    """A scripted host run whose per-step solver times are replaced by
    seeded draws (the plant's wall clock differs run to run)."""
    res = runner.run_closed_loop(Scripted(us), laps, goal_fixup="append")
    rng = np.random.default_rng(seed)
    diag = res.plant.diagnostics
    diag["solver_time"] = [rng.exponential(0.01, len(t))
                           for t in diag["solver_time"]]
    return res


@pytest.mark.parametrize("case", ["improving", "stalled", "unfinished"])
def test_summary_dict_matches_jax_on_the_same_run(case):
    """Three recorded runs: two laps of the seed lap's inputs, 118 steps
    each (flat: monotone), the same with a slower second lap (not
    monotone), and a second lap that never reaches the goal (its budget of
    121 steps; not monotone, completion 0.5)."""
    lap = UCL[:118]  # the seed inputs reach the goal tolerance at step 118
    us = {"improving": np.concatenate([lap, lap]),
          "stalled": np.concatenate([lap, lap]),
          "unfinished": np.concatenate([lap, np.zeros((121, 2))])}[case]
    res = _recorded_run(us, 2, seed=len(case))
    if case == "stalled":
        res.lap_times[1] += 5.0
    ours, theirs = metrics.summary_dict(res), jax_metrics.summary_dict(res)
    assert list(ours) == list(theirs)
    assert ours == theirs
    assert ours["num_solves"] == sum(len(t) for t in
                                     res.plant.diagnostics["solver_time"])
    assert ours["monotone_improvement"] is (case == "improving")
    assert ours["lap_completion_rate"] == (0.5 if case == "unfinished"
                                           else 1.0)


def test_latency_stats_and_lap_metrics_match_jax():
    rng = np.random.default_rng(0)
    for samples in ([], [0.25], rng.exponential(1.0, 1000).tolist()):
        assert dataclasses.asdict(metrics.LatencyStats.from_samples(
            samples)) == dataclasses.asdict(
                jax_metrics.LatencyStats.from_samples(samples))
    res = _recorded_run(np.concatenate([UCL, UCL, UCL]), 3, seed=1)
    assert dataclasses.asdict(metrics.run_latency_stats(res)) == \
        dataclasses.asdict(jax_metrics.run_latency_stats(res))
    assert dataclasses.asdict(metrics.LapMetrics.from_result(res)) == \
        dataclasses.asdict(jax_metrics.LapMetrics.from_result(res))
    empty = runner.run_closed_loop(Scripted(UCL), 0)
    ours = metrics.LapMetrics.from_result(empty)
    theirs = jax_metrics.LapMetrics.from_result(empty)
    assert np.isnan(ours.converged_time) and np.isnan(theirs.converged_time)
    assert ours.completion_rate == theirs.completion_rate == 0.0


def test_time_call_on_the_cpu():
    calls = []

    def fn(a, scale=1.0):
        calls.append(1)
        return torch.ones(64, 64) @ a * scale

    stats = metrics.time_call(fn, torch.eye(64), reps=4, warmup=2,
                              device="cpu", scale=2.0)
    assert len(calls) == 6
    assert stats.n == 4 and 0 < stats.p50 <= stats.max
    assert set(dataclasses.asdict(stats)) == set(dataclasses.asdict(
        jax_metrics.LatencyStats.from_samples([1.0])))
