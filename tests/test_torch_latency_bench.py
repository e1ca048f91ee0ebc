"""The port's latency bench (experiments/latency_bench.py) on the CPU
against the JAX package's: the report's keys (the card-only whole-step
entry aside), K3's throughput lanes and LM cap, the batched run's sizes,
the NLMPC per-step latency run, and the device-count scaling over 1 and 2
ranks (gloo subprocesses) at a tiny size. The full CPU report and the
i2LQR per-step run (full i2LQR laps on the CPU route) are ``slow``."""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from _torch_scripted import Scripted

from ilqr_iterative_tasks_torch.control import batched_soa
from ilqr_iterative_tasks_torch.experiments import latency_bench as lb
from ilqr_iterative_tasks_torch.experiments import runner
from ilqr_iterative_tasks_torch.ops.i2lqr_step import i2lqr_step_reference
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_tpu.experiments import latency_bench as jax_lb
from ilqr_iterative_tasks_tpu.utils import metrics as jax_metrics

XCL, UCL = seed_trajectory(1.0)


def _jax_report_keys(monkeypatch, argv):
    """The keys of the JAX bench's report for ``argv``, with its measuring
    functions stubbed (the keys come from its ``main``)."""
    monkeypatch.setattr(jax_lb, "bench_solver_throughput",
                        lambda batches: {str(b): 1.0 for b in batches})
    monkeypatch.setattr(jax_lb, "bench_device_scaling",
                        lambda counts: {str(c): 1.0 for c in counts})
    out = io.StringIO()
    with redirect_stdout(out):
        jax_lb.main(argv)
    return json.loads(out.getvalue())


def test_report_keys_match_jax(monkeypatch):
    """``main(["--device", "cpu", "--skip-latency", "--batches", "64"])``:
    the JAX report's keys and sub-keys, "backend" "cpu". K3's throughput
    runs for real (its plain version); the batched learning run, two runs
    of ~1.5 min on the CPU route, is recorded and not run here (the slow
    test runs it): its one rank runs in this process, on the one-rank mesh
    of no process group."""
    calls = []

    def recorded(params, limits, scs, seed_xs, seed_us, seed_len, dt, **kw):
        calls.append((scs.x0.shape[-1], seed_len, dt, kw))
        b, laps = scs.x0.shape[-1], kw["num_laps"]
        z = lambda *shape, dtype=torch.float32: torch.zeros(shape,
                                                            dtype=dtype)
        return batched_soa.SoaRunResult(
            lap_steps=z(laps, b, dtype=torch.int32),
            lap_done=z(laps, b, dtype=torch.bool), final_x=z(4, b),
            safe_set=(z(8, 128, 4, b), z(8, 128, b),
                      z(8, 128, b, dtype=torch.bool),
                      z(8, b, dtype=torch.int32)), lap_count=1 + laps)

    def one_rank_here(target, world, *args, backend, **kw):
        assert (target, world, backend) == (
            f"{lb.__name__}:scaling_rank", 1, "gloo")
        return [lb.scaling_rank(*args)]

    monkeypatch.setattr(batched_soa, "simulate_learning_runs_soa", recorded)
    monkeypatch.setattr(lb, "spawn", one_rank_here)
    argv = ["--skip-latency", "--batches", "64"]
    out, launches = io.StringIO(), {}
    with redirect_stdout(out):
        ours = lb.main(["--device", "cpu", *argv], launches=launches)
    assert json.loads(out.getvalue()) == ours
    theirs = _jax_report_keys(monkeypatch, argv)
    assert list(ours) == list(theirs)
    assert ours["backend"] == theirs["backend"] == "cpu"
    assert list(ours["soa_solves_per_s"]) == ["64"]
    assert ours["soa_solves_per_s"]["64"] > 0
    assert list(ours["lap_sims_per_s_by_devices"]) == list(
        theirs["lap_sims_per_s_by_devices"]) == ["1"]
    # a kernel counts only its launches on the card: none on the CPU route
    assert launches == {"soa_solves_per_s": {"64": 0},
                        "lap_sims_per_s_by_devices": {"1": 0}}
    # a warm run and a timed one, at JAX's sizes: 8 lanes a device on the
    # CPU, 2 laps, LM cap 40, 128 steps, 8 laps of room
    assert len(calls) == 2
    for b, seed_len, dt, kw in calls:
        assert (b, seed_len, dt) == (8, len(XCL), 1.0)
        assert (kw["num_laps"], kw["solver_max_iter"], kw["max_steps"],
                kw["max_laps"]) == (2, 40, 128, 8)


def test_device_scaling_runs_each_count_on_its_ranks():
    """``bench_device_scaling([1, 2])`` on the CPU spawns 1 and 2 gloo
    ranks (here 2 lanes a rank, 1 lap cut at 1 step): a rate for each
    count, no K1 launch on the CPU route."""
    launches = {}
    out = lb.bench_device_scaling([1, 2], device="cpu", launches=launches,
                                  per_device=2, num_laps=1, sim_step_budget=1)
    assert list(out) == ["1", "2"] and all(r > 0 for r in out.values())
    assert launches == {"lap_sims_per_s_by_devices": {"1": 0, "2": 0}}


def test_whole_step_latency_is_card_only():
    assert lb.bench_device_step_latency(device="cpu") is None


def test_throughput_lanes_and_cap_are_jax_s():
    """K3 at the JAX call's LM cap (``ilqr_solve_soa``'s default, the
    params' 150) on JAX's draws: terminal states uniform in [0, 30)^4 from
    seed 0, batch after batch."""
    k3 = lb.build_throughput_solver("cpu")
    assert (k3.max_iter, k3.num_horizon) == (150, 6)
    rng, want = np.random.default_rng(0), np.random.default_rng(0)
    for b in (16, 8):
        x0, xts, u0, obs = lb.solver_throughput_inputs(b, rng, "cpu")
        np.testing.assert_array_equal(
            xts.numpy(), want.uniform(0, 30, (4, b)).astype(np.float32))
        assert not x0.any() and not u0.any() and u0.shape == (6, 2, b)
        assert obs[:2, 0].tolist() == [31.0, -2.0]
    out = lb.bench_solver_throughput([16], device="cpu")
    assert list(out) == ["16"] and out["16"] > 0


def test_device_step_inputs_hold_the_seed_lap():
    """The whole-step bench's inputs (here at 2 lanes on the CPU): the
    seed lap stored as lap 0 with Qfun 120 down to 0, and K1's CPU route
    gives the plain step."""
    k1, args = lb.device_step_inputs(2, "cpu")
    x, g0, states, qfun, lap_len, lap_ids, lap_ok, obs, skip = args
    assert (k1.k, k1.nsi, k1.max_iter) == (8, 1, lb.K1_MAX_ITER)
    np.testing.assert_array_equal(states[0, :len(XCL), :, 1].numpy(),
                                  XCL.astype(np.float32))
    assert qfun[0, :3, 0].tolist() == [120.0, 119.0, 118.0]
    assert lap_len[0].tolist() == [len(XCL)] * 2
    got = k1(*args)
    want = i2lqr_step_reference(k1.params, k1.limits, 1.0, *args,
                                max_iter=lb.K1_MAX_ITER)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bool(torch.isfinite(got[0]).all())


def test_nlmpc_step_latency_on_the_cpu():
    """The NLMPC per-step run (f32, spaceVarying, 3 laps; its K4 on the
    CPU route): the JAX summary's keys, every lap finished, one latency
    sample a step of the 3 laps."""
    launches = {}
    out = lb.bench_step_latency_nlmpc(device="cpu", launches=launches)
    keys = jax_metrics.summary_dict(runner.run_closed_loop(
        Scripted(UCL), 0)).keys()
    assert list(out) == list(keys)
    assert out["lap_completion_rate"] == 1.0
    assert out["seed_time_s"] == 120.0
    assert out["num_solves"] == sum(out["lap_times_s"])
    assert out["lap_times_s"][-1] <= 24.0
    counted = launches["per_step_latency_nlmpc"]
    assert counted["k4"] == 0 and 0 < counted["solving_steps"] <= sum(
        out["lap_times_s"])


@pytest.mark.slow
def test_main_on_the_cpu():
    """The whole CPU report: both per-step runs, K3's throughput and the
    batched learning run at 8 lanes."""
    report = lb.main(["--device", "cpu", "--batches", "64"])
    assert report["per_step_latency"]["lap_completion_rate"] == 1.0
    assert report["per_step_latency_nlmpc"]["lap_completion_rate"] == 1.0
    assert report["lap_sims_per_s_by_devices"]["1"] > 0
