"""``retile_frac`` and ``tail_shrink`` in the port's i2LQR simulator
(control/batched_soa.py) on the CPU, and the permutation bookkeeping
(``LaneOrder``).

Port with the options against port without, bit for bit (lap steps, done
flags, the safe set, the noise position), mirroring
tests/test_batched.py:350-415: 48 randomized lanes, 2 laps, budget 50,
cap 12, noise on. f64 on a generator at retile_frac 0.2 and at both
options; tail_shrink 24 alone on draws equal across the lanes (it does not
route the draws, as JAX's simulator does not; at 16 no lap's not-done
lanes fit the prefix before the budget at f64); f32 on injected draws through a K1 that counts (its CPU route,
the plain step launched over the prefix once the lap compacts), whose
useful trips are held too; one lap, then one resumed lap with the
options, against two laps without. Each run's permutation log shows the
lanes were permuted (and, where it says so, compacted).
"""

import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_torch.control.batched_soa import (
    LaneOrder, SoaScenarios, simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.i2lqr_step import build_fused_i2lqr_step
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits

torch.set_num_threads(1)
B, T_ROWS, MAX_LAPS, CAP = 48, 128, 8, 12
KW = dict(num_laps=2, max_steps=T_ROWS, max_laps=MAX_LAPS,
          solver_max_iter=CAP, sim_step_budget=50)
F64 = torch.float64


def _setup(dtype):
    xcl, _ = seed_trajectory(1.0)
    seed_xs = np.zeros((T_ROWS, 4))
    seed_xs[:121] = xcl
    scen = SoaScenarios.randomized(
        np.zeros(4), xcl[-1],
        Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=dtype, device="cpu"), B,
        torch.Generator().manual_seed(42), noise_on=True, dtype=dtype,
        device="cpu")
    return (IlqrParams.make(dtype=dtype, device="cpu"),
            SystemLimits.make(dtype=dtype, device="cpu"), scen, seed_xs)


def _run(dtype, options=None, log=None, **kw):
    p, lim, scen, seed_xs = _setup(dtype)
    if "noise" not in kw:
        kw["generator"] = torch.Generator().manual_seed(7)
    return simulate_learning_runs_soa(p, lim, scen, seed_xs, None, 121, 1.0,
                                      perm_log=log, **(options or {}),
                                      **dict(KW, **kw))


def assert_same_run(got, want):
    for name in ("lap_steps", "lap_done", "final_x"):
        g, v = getattr(got, name), getattr(want, name)
        assert g.dtype == v.dtype and torch.equal(g, v), name
    for g, v in zip(got.safe_set, want.safe_set):
        assert g.dtype == v.dtype and torch.equal(g, v)
    assert got.lap_count == want.lap_count
    key, want_key = got.final_key, want.final_key
    assert (torch.equal(key, want_key) if isinstance(key, torch.Tensor)
            else key == want_key)


@pytest.fixture(scope="module")
def base():
    return _run(F64)


@pytest.mark.parametrize("options", [
    dict(retile_frac=0.2), dict(tail_shrink=24),
    dict(retile_frac=0.2, tail_shrink=24)], ids=["retile", "tail", "both"])
def test_options_equal_the_run_without_f64(base, options):
    log = []
    if "retile_frac" in options:
        assert_same_run(_run(F64, options, log), base)
    else:
        # tail_shrink alone gives the lane at position p of a compacted lap
        # draw p, as JAX's i2LQR simulator does (tests/
        # test_torch_retile_jax.py holds the run to JAX's): on draws equal
        # across the lanes that is the run without the option
        rows = np.random.default_rng(8).normal(size=(100, 2, 1))
        noise = torch.tensor(np.repeat(rows, B, axis=2), dtype=F64)
        assert_same_run(_run(F64, options, log, noise=noise),
                        _run(F64, noise=noise))
    assert len(log) == 2 and sum(e["perms"] for e in log) > 0
    assert any(e["compacted"] for e in log) == ("tail_shrink" in options)


def test_options_on_injected_draws_with_counts_f32():
    """f32, noise injected, through a K1 built with_stats: records, noise
    rows and each lane's useful trips equal the run without the options
    (the executed and floor counts count the warps and groups the lanes
    share, which the permutation changes)."""
    p, lim, _, _ = _setup(torch.float32)
    noise = torch.tensor(np.random.default_rng(8).normal(size=(100, 2, B)),
                         dtype=torch.float32)

    def k1():
        return build_fused_i2lqr_step(
            p, lim, 1.0, num_horizon=6, max_steps=T_ROWS, max_laps=MAX_LAPS,
            max_iter=CAP, with_stats=True)

    want = _run(torch.float32, noise=noise, step_solver=k1())
    log = []
    got = _run(torch.float32, dict(retile_frac=0.2, tail_shrink=16), log,
               noise=noise, step_solver=k1())
    assert_same_run(got, want)
    assert torch.equal(got.iter_stats[0], want.iter_stats[0])
    assert int(want.iter_stats[0].sum()) > 0
    assert sum(e["perms"] for e in log) > 0
    assert any(e["compacted"] for e in log)


def test_resumed_lap_with_options_equals_two_laps(base):
    options, log = dict(retile_frac=0.2, tail_shrink=24), []
    one = _run(F64, options, log, num_laps=1)
    p, lim, scen, seed_xs = _setup(F64)
    resumed = simulate_learning_runs_soa(
        p, lim, scen, seed_xs, None, 121, 1.0,
        generator=torch.Generator(), perm_log=log,
        resume_from=(one.safe_set, one.lap_count, one.final_key),
        **options, **dict(KW, num_laps=1))
    for g, v in zip(resumed.safe_set, base.safe_set):
        assert torch.equal(g, v)
    assert torch.equal(resumed.lap_steps[0], base.lap_steps[1])
    assert torch.equal(resumed.final_key, base.final_key)
    assert len(log) == 2 and any(e["compacted"] for e in log)


def test_tail_shrink_checks():
    p, lim, scen, seed_xs = _setup(F64)
    with pytest.raises(ValueError, match="stall_reseed"):
        simulate_learning_runs_soa(p, lim, scen, seed_xs, None, 121, 1.0,
                                   tail_shrink=8, stall_reseed=3, **KW)
    with pytest.raises(ValueError, match="must be < batch"):
        _run(F64, dict(tail_shrink=B), sim_step_budget=2)
    with pytest.raises(TypeError, match="dedup_passes"):
        _run(F64, dict(dedup_passes=True))


def test_lane_order_bookkeeping():
    """The 3-way order (active, skipped not done, done) and the stable
    partition; a permutation moves lanes and the stored safe-set slots
    only; to_original and finish undo it; the retile block and the
    once-a-lap compaction fire as JAX's trigger does."""
    order = LaneOrder(6, 0.5, 3, "cpu", log=[])
    skipf = torch.tensor([True, False, True, False, True, False])
    done = torch.tensor([True, False, False, False, True, False])
    assert order.source(skipf, done).tolist() == [1, 3, 5, 2, 0, 4]
    assert LaneOrder(6, 0.5, None, "cpu").source(skipf, done).tolist() == [
        1, 3, 5, 0, 2, 4]
    order.start_lap()
    assert order.block == 3 and not order.fires(2, 6)
    assert order.fires(3, 5) and not order.fires(5, 4)  # block from 3
    assert order.lanes() == 6
    assert order.fires(5, 3) and order.lanes() == 3  # compacts once
    assert not order.fires(5, 2) and order.log[-1]["compacted"]
    ss = (torch.arange(24.0).view(2, 2, 6).clone(),)
    x = torch.arange(6.0)
    src = order.source(skipf, done)
    (moved,) = order.permute(src, [x], ss, 1)
    assert moved.tolist() == [1.0, 3.0, 5.0, 2.0, 0.0, 4.0]
    assert ss[0][0, 0].tolist() == moved.tolist()
    assert ss[0][1, 0].tolist() == list(range(12, 18))  # not stored
    assert torch.equal(order.to_original(moved), x)
    order.finish(ss, 1)
    assert torch.equal(ss[0].view(-1), torch.arange(24.0))
    assert order.log[-1]["perms"] == 1 and len(order.log[-1]["perm_ms"]) == 1
    assert torch.equal(order.route(torch.stack([x, -x])),
                       torch.stack([moved, -moved]))


@pytest.mark.slow
def test_iter_stats_against_the_jax_simulator(tmp_path):
    """The repair-pass read of ROADMAP Queue 3: the JAX i2LQR simulator
    through its K1 with_stats (interpreted, f32, B = 128, one learning lap
    of at most 60 steps; tests/_jax_step_stats.py ``sim``), without and
    with retile_frac 0.2, against the port's (K1 with_stats, queue_floor
    at JAX's 128 lanes) on JAX's draws. The lap steps agree; each side's
    counts with retile equal its own without; JAX's f32 sums and the
    port's int64 ones differ lane by lane (the f32 trips follow each
    framework's arithmetic) and its executed counts a tile of 128 lanes,
    the port's a warp: the sums are printed and held within 5 %.
    ~90 s (the JAX compile in a subprocess)."""
    import os
    import subprocess
    import sys

    out = tmp_path / "sim.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    run = subprocess.run(
        [sys.executable, os.path.join(tests, "_jax_step_stats.py"), "sim",
         str(out)], capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(tests))
    assert run.returncode == 0, run.stderr[-4000:]
    j = dict(np.load(out))
    f32, b = torch.float32, j["draws"].shape[-1]
    xcl, _ = seed_trajectory(1.0)
    seed_xs = np.zeros((T_ROWS, 4))
    seed_xs[:121] = xcl
    scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1],
        Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=f32, device="cpu"), b,
        noise_on=True, dtype=f32, device="cpu")
    p = IlqrParams.make(dtype=f32, device="cpu")
    lim = SystemLimits.make(dtype=f32, device="cpu")
    got = {}
    for name, opts in (("plain", {}), ("retile", dict(retile_frac=0.2))):
        k1 = build_fused_i2lqr_step(p, lim, 1.0, num_horizon=6,
                                    max_steps=T_ROWS, max_laps=4,
                                    max_iter=8, with_stats=True,
                                    floor_width=128)
        got[name] = simulate_learning_runs_soa(
            p, lim, scen, seed_xs, None, 121, 1.0, num_laps=1,
            max_steps=T_ROWS, max_laps=4, solver_max_iter=8,
            sim_step_budget=60, step_solver=k1,
            noise=torch.from_numpy(j["draws"]), **opts)
        np.testing.assert_array_equal(got[name].lap_steps.numpy(),
                                      j[f"{name}_lap_steps"])
    for i, what in enumerate(("useful", "executed", "queue_floor")):
        assert torch.equal(got["plain"].iter_stats[i],
                           got["retile"].iter_stats[i])
        np.testing.assert_array_equal(j[f"plain_stats_{i}"],
                                      j[f"retile_stats_{i}"])
        mine = int(got["plain"].iter_stats[i].sum())
        theirs = float(j[f"plain_stats_{i}"].sum())
        print(f"{what}: port {mine}, JAX {theirs:.0f}, "
              f"{mine / theirs:.4f}")
        assert abs(mine - theirs) <= 0.05 * theirs
