"""The port's scenario-sharded simulators (parallel/sharded_soa.py) against
its unsharded ones, on the CPU.

Four ranks (gloo on loopback, in subprocesses started by
parallel/launch.py; no process group enters the pytest process), two
2-rank meshes at once, run the ``_sharded`` wrappers at f64, B = 16, LM cap
8: i2LQR (ranks 0-1) and NLMPC spaceVarying (ranks 2-3) over one learning
lap on the same injected noise, and NLMPC over three laps on a generator
(every rank seeded alike, each drawing the global (2, B) row a step and
keeping its columns, the ranks agreeing on each lap's rows). Every rank's
gathered result must equal the unsharded run bit for bit: lap steps, done
flags, final states, the safe set, ``streaks``, the lap count and the
noise position; an i2LQR run over two short laps through a K1 that
counts (``with_stats``) gathers the unsharded run's ``iter_stats``; and
i2LQR with ``tail_shrink`` alone over two laps (staggered starts, so that
both laps compact), at a prefix below a rank's share and at one above it,
is the unsharded run too. Meanwhile this process computes the unsharded
runs.
One-rank meshes (no group) and the column bookkeeping run in process.
"""

import os

import numpy as np
import pytest
import torch

import _torch_distributed_worker as w
from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import (
    simulate_nlmpc_runs_soa)
from ilqr_iterative_tasks_torch.control.batched_soa import (
    simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.parallel.launch import Ranks
from ilqr_iterative_tasks_torch.parallel.mesh import Mesh, make_mesh
from ilqr_iterative_tasks_torch.parallel.sharded_soa import (
    ColumnDraws, shard_seed, shard_soa_scenarios,
    simulate_learning_runs_soa_shardmap, simulate_learning_runs_soa_sharded,
    simulate_nlmpc_runs_soa_shardmap, simulate_nlmpc_runs_soa_sharded)

torch.set_num_threads(1)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_distributed_worker.py")
RUNS = ("i2lqr", "nlmpc", "nlmpc_generator")


def _unsharded():
    ip, lp, lim, sx, su, scen = w.setup(w.SHARDED_B)
    noise = w.global_noise(w.SHARDED_B)
    return dict(
        i2lqr=simulate_learning_runs_soa(ip, lim, scen, sx, su, 121, 1.0,
                                         noise=noise, **w.I2LQR_KW),
        nlmpc=simulate_nlmpc_runs_soa(lp, lim, scen, sx, su, 121, 1.0,
                                      noise=noise, with_streak_stats=True,
                                      **w.NLMPC_KW),
        nlmpc_generator=simulate_nlmpc_runs_soa(
            lp, lim, scen, sx, su, 121, 1.0,
            generator=torch.Generator().manual_seed(7),
            **dict(w.NLMPC_KW, num_laps=3)),
        i2lqr_stats=simulate_learning_runs_soa(
            ip, lim, scen, sx, su, 121, 1.0, noise=noise,
            step_solver=w.stats_solver(ip, lim),
            **w.STATS_KW),
        **{f"i2lqr_tail{tail}": w.tail_run(*w.tail_setup(w.SHARDED_B), tail,
                                            simulate_learning_runs_soa)
           for tail in w.TAILS},
        **{f"nlmpc_tail{w.TAILS[-1]}": w.tail_run(
            *w.tail_setup(w.SHARDED_B, nlmpc=True), w.TAILS[-1],
            simulate_nlmpc_runs_soa)})


@pytest.fixture(scope="module")
def runs():
    ranks = Ranks(f"{WORKER}:sharded_runs", 4, backend="gloo", threads=1,
                  timeout=300, init_timeout=60)
    try:
        want = _unsharded()
    except BaseException:
        ranks.close()
        raise
    return ranks.wait(), want


def assert_same_run(got, want):
    for name in ("lap_steps", "lap_done", "final_x"):
        g, v = getattr(got, name), getattr(want, name)
        assert g.dtype == v.dtype and torch.equal(g, v), name
    assert len(got.safe_set) == len(want.safe_set)
    for g, v in zip(got.safe_set, want.safe_set):
        assert g.dtype == v.dtype and torch.equal(g, v)
    assert len(getattr(got, "streaks", ())) == len(getattr(want, "streaks",
                                                           ()))
    for g, v in zip(getattr(got, "streaks", ()), getattr(want, "streaks",
                                                         ())):
        assert torch.equal(g, v)
    assert got.lap_count == want.lap_count


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("run", RUNS)
def test_sharded_run_is_the_unsharded_run(runs, run, index):
    got, want = runs
    rank = index if run == "i2lqr" else 2 + index
    assert (got[rank]["index"], got[rank]["size"]) == (index, 2)
    assert_same_run(got[rank][run], want[run])
    key, want_key = got[rank][run].final_key, want[run].final_key
    if run == "nlmpc_generator":  # the generator where the run left it
        assert torch.equal(key, want_key)
    else:  # the injected rows consumed
        assert key == want_key and isinstance(key, int)


@pytest.mark.parametrize("index", [0, 1])
def test_sharded_run_carries_iter_stats(runs, index):
    """A ``_sharded`` i2LQR run through a K1 built with_stats (and dedup),
    2 laps of at most 20 steps, each rank's 8 lanes a whole queue_floor
    group: the gathered
    ``iter_stats`` (summed over the rank's lap-by-lap runs) are the
    unsharded run's, and the records too."""
    got, want = runs
    g, v = got[index]["i2lqr_stats"], want["i2lqr_stats"]
    assert_same_run(g, v)
    assert len(v.iter_stats) == 3 and len(g.iter_stats) == 3
    for a, b in zip(g.iter_stats, v.iter_stats):
        assert torch.equal(a, b)
    useful, executed, floor = v.iter_stats
    assert int(useful.sum()) > 0 and bool((useful <= executed).all())
    assert bool((floor > 0).all())


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("run", ["i2lqr", "nlmpc_generator"])
def test_sharded_run_with_lane_permutations_is_the_unsharded_run(
        runs, run, index):
    """``retile_frac`` and ``tail_shrink`` through the ``_sharded``
    wrappers: each rank permutes its own 8 lanes (the retile block and the
    prefix its own) and routes its own columns' draws; the gathered run
    equals the unsharded run without the options bit for bit, the noise
    position included, and the rank's lanes were permuted (the NLMPC
    rank's also compacted in some lap; the i2LQR lanes end their one lap
    together)."""
    got, want = runs
    rank = index if run == "i2lqr" else 2 + index
    g, log = got[rank][f"{run}_options"]
    assert_same_run(g, want[run])
    if run == "i2lqr":
        assert g.final_key == want[run].final_key
    else:
        assert torch.equal(g.final_key, want[run].final_key)
    assert sum(e["perms"] for e in log) > 0
    assert run == "i2lqr" or any(e["compacted"] for e in log)


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("tail", w.TAILS)
def test_sharded_tail_shrink_alone_is_the_unsharded_run(runs, tail, index):
    """``tail_shrink`` alone through the i2LQR ``_sharded`` wrapper over two
    laps, at a prefix below a rank's 8 lanes and at one above: the
    compaction is the unsharded run's (its trigger on the global not-done
    count, each lane at its global position, the lane at position p taking
    column p of the global draw, the lane order carried into the next
    lap), so every rank's gathered run equals the unsharded run bit for
    bit, the noise position included."""
    got, want = runs
    g = got[index][f"i2lqr_tail{tail}"]
    assert not isinstance(g, str), g
    (g, log), (v, want_log) = g, want[f"i2lqr_tail{tail}"]
    assert_same_run(g, v)
    assert g.final_key == v.final_key and isinstance(g.final_key, int)
    assert [e["compacted"] for e in want_log] == [True, True]
    assert any(e["compacted"] for e in log)


@pytest.mark.parametrize("index", [0, 1])
def test_sharded_nlmpc_takes_a_prefix_above_a_rank_s_lanes(runs, index):
    """The NLMPC ``_sharded`` wrapper with ``tail_shrink`` 12 over 8 lanes
    a rank (JAX's wrapper takes any P below B): the NLMPC simulator routes
    its draws by lane id, so a rank whose lanes all fit the prefix runs
    them without one, and the gathered run is the unsharded run with the
    option, bit for bit."""
    got, want = runs
    tail = w.TAILS[-1]
    g = got[2 + index][f"nlmpc_tail{tail}"]
    assert not isinstance(g, str), g
    (g, log), (v, want_log) = g, want[f"nlmpc_tail{tail}"]
    assert_same_run(g, v)
    assert g.final_key == v.final_key
    assert any(e["compacted"] for e in want_log) and not log


def test_the_runs_exercise_what_they_check(runs):
    """In a lap before the last, the two ranks' lanes end at different
    steps (so the next lap's noise rows must be agreed), and the streaks
    are not empty."""
    got, want = runs
    steps = want["nlmpc_generator"].lap_steps[:-1]
    assert bool((steps[:, :8].amax(1) != steps[:, 8:].amax(1)).any())
    assert bool(want["nlmpc"].streaks[0].any() | want["nlmpc"].streaks[1]
                .any())
    assert got[0]["i2lqr"].lap_done.all()
    assert "nlmpc" not in got[0] and "i2lqr" not in got[2]


def _mesh(index, n):
    return Mesh(ranks=tuple(range(n)), shape=(n,), axis_names=("scenario",),
                rank=index, device=torch.device("cpu"))


def test_shard_soa_scenarios_takes_the_rank_s_columns():
    *_, scen = w.setup(12)
    scen = type(scen)(x0=torch.arange(48.0).reshape(4, 12), goal=scen.goal,
                      obstacle=scen.obstacle.map(lambda a: a + torch.arange(
                          12.0)), noise_on=torch.arange(12.0))
    local = shard_soa_scenarios(scen, _mesh(1, 3))
    assert torch.equal(local.x0, scen.x0[:, 4:8])
    assert torch.equal(local.noise_on, torch.arange(4.0, 8.0))
    assert torch.equal(local.obstacle.x, scen.obstacle.x[4:8])
    assert local.x0.is_contiguous()
    with pytest.raises(ValueError, match="does not divide"):
        shard_soa_scenarios(w.setup(10)[-1], _mesh(0, 4))


def test_one_rank_mesh_needs_no_group_and_is_the_unsharded_run(runs):
    """Without a process group, make_mesh() is one rank: the ``_sharded``
    NLMPC run over 2 laps on a generator equals the unsharded run, so does
    the ``_sharded`` i2LQR run with ``tail_shrink`` alone over 2 laps (its
    lane order carried from one lap into the next), and the ``_shardmap``
    run is the unsharded run on shard 0's seed."""
    mesh = make_mesh()
    tail = w.TAILS[0]
    got = w.tail_run(*w.tail_setup(w.SHARDED_B), tail,
                     simulate_learning_runs_soa_sharded, mesh)
    (got, _), (want, _) = got, runs[1][f"i2lqr_tail{tail}"]
    assert_same_run(got, want)
    assert got.final_key == want.final_key
    assert (mesh.size, mesh.axis_index(), mesh.device.type) == (1, 0, "cpu")
    _, lp, lim, sx, su, scen = w.setup(4)
    kw = dict(w.NLMPC_KW, num_laps=2, sim_step_budget=30)
    want = simulate_nlmpc_runs_soa(lp, lim, scen, sx, su, 121, 1.0,
                                   generator=torch.Generator().manual_seed(3),
                                   **kw)
    got = simulate_nlmpc_runs_soa_sharded(
        lp, lim, scen, sx, su, 121, 1.0, mesh,
        generator=torch.Generator().manual_seed(3), **kw)
    assert_same_run(got, want)
    assert torch.equal(got.final_key, want.final_key)
    want = simulate_nlmpc_runs_soa(
        lp, lim, scen, sx, su, 121, 1.0,
        generator=torch.Generator().manual_seed(shard_seed(3, 0)), **kw)
    got = simulate_nlmpc_runs_soa_shardmap(
        lp, lim, scen, sx, su, 121, 1.0, mesh,
        generator=torch.Generator().manual_seed(3), **kw)
    assert_same_run(got, want)
    assert got.final_key is None


def test_shardmap_refuses_resume_and_seeds_each_shard():
    ip, _, lim, sx, su, scen = w.setup(4)
    with pytest.raises(NotImplementedError, match="resume_from"):
        simulate_learning_runs_soa_shardmap(
            ip, lim, scen, sx, su, 121, 1.0, make_mesh(), num_laps=1,
            resume_from=((), 1, None))
    seeds = {shard_seed(s, i) for s in (0, 1) for i in range(4)}
    assert len(seeds) == 8 and shard_seed(5, 2) == shard_seed(5, 2)


def test_column_draws_are_the_global_draws_columns():
    """Row r of ColumnDraws is the r-th global (2, B) draw's columns, rows
    skipped are drawn and dropped, a row drawn before is refused."""
    g = torch.Generator().manual_seed(9)
    rows = [torch.randn((2, 6), generator=g, dtype=torch.float64)
            for _ in range(5)]
    d = ColumnDraws(torch.Generator().manual_seed(9), 6, slice(2, 4),
                    torch.float64, "cpu")
    assert torch.equal(d[0], rows[0][:, 2:4])
    assert torch.equal(d[1], rows[1][:, 2:4])
    assert torch.equal(d[1], rows[1][:, 2:4])  # the same row again
    assert torch.equal(d[4], rows[4][:, 2:4])
    with pytest.raises(ValueError, match="drawn before"):
        d[2]
    assert np.iinfo(np.int64).max == d.shape[0] and d.shape[2] == 2
