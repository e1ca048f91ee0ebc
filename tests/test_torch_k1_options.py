"""K1's options at k = 8 on the CPU: ``dedup``, ``qsort_skip``,
``with_stats``, ``reuse_extract``, ``dom_skip`` and ``group`` of the plain
step (``i2lqr_step_reference``) and the K1 factory.

- ``reuse_extract``, ``dom_skip`` and ``group`` (with ``dedup`` too) give
  the plain order's outputs bit for bit in f64 and f32 on the same
  inputs; reuse_extract keeps the kNN of the lanes whose guess did not
  move (it fires), dom_skip solves fewer candidates.
- The factory takes every option but the TPU kernel's two VMEM trades,
  with the JAX factory's guards (pallas_i2lqr_step.py:192-208): the same
  combinations raise in both.
- The schedules change which candidate solves run, never the outputs: on
  ``headlines.k1_option_lanes`` (ties in distance and in Qfun, lanes far
  from every stored point that fall back to slot 0, skipped lanes, laps
  shorter than k, laps not yet stored), B = 128, LM cap 8, each option
  gives the plain order's outputs bit for bit in f64 and f32, and the
  counts hold their invariants.
- Against the JAX kernel (ops/pallas_i2lqr_step.py) with ``with_stats`` in
  interpret mode, f32, one tile of 128 lanes, on the inputs of
  tests/test_pallas_i2lqr_step.py:171-215 (its with_stats test; run in a
  fresh process, tests/_jax_step_stats.py): in the plain order and with
  ``qsort_skip`` the decisions (shrink, idx_sel, row_sel) equal JAX's on
  every live lane and ``queue_floor`` at JAX's tile (128 lanes) equals
  JAX's. ``iters_useful`` follows the f32 LM's convergence iteration,
  which XLA:CPU's arithmetic (FMA contraction, its own sin / cos / exp)
  moves by a few trips on some lanes (ROADMAP, Queue 3: f32 on the CPU is
  held only at decision level): equal on >= 85 % of the live lanes,
  within 8 trips on every one, the sums within 1 %.
- A two-lap closed loop through the simulator with a K1 that counts (and
  both schedules) on the CPU: the records are the plain run's, and
  ``iter_stats`` is populated.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_torch.control.batched_soa import (
    SoaScenarios, default_step_solver, simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.experiments.headlines import (
    MAX_LAPS, MAX_STEPS, k1_block_lanes, k1_option_lanes, lap_records_hash,
    live_share, stats_summary)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
    LANE_QUEUE_FROM, build_fused_i2lqr_step, i2lqr_step_reference,
    queue_floor, warp_executed)
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits

torch.set_num_threads(1)
CAP = 8
TESTS = os.path.dirname(os.path.abspath(__file__))
OPTIONS = {"dedup": dict(dedup=True), "qsort_skip": dict(qsort_skip=True),
           "dedup_qsort": dict(dedup=True, qsort_skip=True),
           "with_stats": {}}


@functools.lru_cache(maxsize=None)
def _case(nsi, lap_count, dtype):
    p = IlqrParams.make(num_ss_iter=nsi, device="cpu", dtype=dtype)
    lim = SystemLimits.make(device="cpu", dtype=dtype)
    a = k1_option_lanes(nsi, lap_count, "cpu", dtype=dtype)
    plain = i2lqr_step_reference(p, lim, 1.0, *a, max_iter=CAP,
                                 with_stats=True)
    return p, lim, a, plain


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("nsi,lap_count,option", [
    (1, 3, "dedup"), (1, 3, "qsort_skip"), (1, 3, "dedup_qsort"),
    (1, 1, "dedup_qsort"), (2, 3, "dedup"), (2, 1, "dedup"),
    (2, 3, "with_stats")])
def test_options_keep_the_plain_order_s_outputs(nsi, lap_count, option,
                                                dtype):
    p, lim, a, plain = _case(nsi, lap_count, dtype)
    got = i2lqr_step_reference(p, lim, 1.0, *a, max_iter=CAP,
                               with_stats=True, **OPTIONS[option])
    for g, w in zip(got[:4], plain[:4]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert len(i2lqr_step_reference(p, lim, 1.0, *a, max_iter=1,
                                    **OPTIONS[option])) == 4
    useful, executed, floor = got[4:]
    skipped = a[8] > 0.5
    assert bool((useful <= executed).all())
    assert int(useful[skipped].abs().sum() + executed[skipped].abs().sum()) \
        == 0
    assert int(useful.sum()) > 0 and bool((floor[~skipped] > 0).all())
    if option != "with_stats":  # a schedule solves fewer candidates
        assert int(useful.sum()) < int(plain[4].sum())


def test_the_edge_cases_are_in_the_inputs():
    """k1_option_lanes holds what the options' tie and fallback rules turn
    on: lanes whose every candidate is out of reach (the slot-0
    fallback), Qfun tied within a row, laps shorter than k, winners that
    dedup takes from the cache and so solves again."""
    p, lim, a, plain = _case(1, 3, torch.float64)
    live = a[8] < 0.5
    cands = []
    i2lqr_step_reference(p, lim, 1.0, *a, max_iter=CAP, cands=cands)
    idx, fin, win = cands[-1]
    far = live & (a[0][0] > 400)
    assert bool(far.any()) and bool((win[far] == 0).all())
    q = a[3][a[5].long()[0]].gather(0, idx)  # (k, B) Qfun of the slots
    assert bool(((q[1:] == q[:-1]) & fin[1:] & live).any())
    assert bool((~fin & live).any())  # a lap shorter than k
    trips = []
    i2lqr_step_reference(p, lim, 1.0, *a, max_iter=CAP, dedup=True,
                         trips=trips)
    assert len(trips) == 4  # three passes and the winners solved again


def test_count_helpers():
    """queue_floor: per pass the max over aligned groups, summed, for every
    lane of the group; warp_executed: each round's warp max times the
    threads a lane, live lanes only."""
    up = torch.tensor([[1, 5, 2, 0, 3], [4, 0, 0, 0, 7]])
    assert queue_floor(up, 2).tolist() == [9, 9, 2, 2, 10]
    assert queue_floor(up, 8).tolist() == [12] * 5
    rounds = [torch.tensor([3, 1, 0, 2, 5]), torch.tensor([0, 0, 4, 0, 0])]
    active = torch.tensor([True, True, True, False, True])
    # 16 threads a lane: 2 lanes a warp
    assert warp_executed(rounds, active, 16).tolist() == [48, 48, 96, 0, 80]


# the options the factory takes beside the shipped ones, and the TPU
# kernel's VMEM trades it refuses
TAKEN = {"dom_skip": True, "group": 2, "reuse_extract": True}
REFUSED = {"stream_safe_set": True, "store_solutions": False}


@pytest.mark.parametrize("option", ["shipped", *TAKEN, *REFUSED])
def test_factory_takes_the_shipped_options_and_refuses_the_rest(option):
    cpu = "cpu"
    lim = SystemLimits.make(device=cpu)
    sizes = dict(num_horizon=6, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                 max_iter=CAP)
    p1 = IlqrParams.make(device=cpu)
    if option in REFUSED:
        with pytest.raises(ValueError, match=option):
            build_fused_i2lqr_step(p1, lim, 1.0, **sizes,
                                   **{option: REFUSED[option]})
        return
    if option in TAKEN:  # taken, and its CPU route is the plain step's
        k1 = build_fused_i2lqr_step(p1, lim, 1.0, **sizes,
                                    **{option: TAKEN[option]})
        assert getattr(k1, option) == TAKEN[option]
        a = k1_option_lanes(1, 3, cpu, b=32)
        want = i2lqr_step_reference(p1, lim, 1.0, *a, max_iter=CAP)
        assert all(torch.equal(g, w) for g, w in zip(k1(*a), want))
        return
    k1 = build_fused_i2lqr_step(p1, lim, 1.0, dedup=True, qsort_skip=True,
                                with_stats=True, floor_width=128, **sizes)
    assert (k1.dedup, k1.qsort_skip, k1.with_stats, k1.floor_width) == (
        True, True, True, 128)
    with pytest.raises(TypeError):
        build_fused_i2lqr_step(p1, lim, 1.0, tile_rows=8, **sizes)
    p2 = IlqrParams.make(num_ss_iter=2, device=cpu)
    with pytest.raises(ValueError, match="qsort_skip"):
        build_fused_i2lqr_step(p2, lim, 1.0, qsort_skip=True, **sizes)
    with pytest.raises(ValueError, match="qsort_skip"):
        i2lqr_step_reference(p2, lim, 1.0, *k1_option_lanes(2, 3, cpu),
                             max_iter=CAP, qsort_skip=True)
    p32 = IlqrParams.make(num_ss_points=32, num_ss_iter=4, device=cpu)
    assert build_fused_i2lqr_step(p32, lim, 1.0, dedup=True, **sizes).dedup
    # k = 32 counts too: a lane's warp's thread-trips over the block's
    # pooled solves, which a skipped lane's warp runs as well
    k32 = build_fused_i2lqr_step(p32, lim, 1.0, with_stats=True, **sizes)
    a = k1_block_lanes(4, 4, cpu, b=12)
    useful, executed, floor = k32(*a)[4:]
    live = a[8] < 0.5
    assert int(useful[~live].abs().sum()) == 0 and bool((floor > 0).all())
    assert bool((useful[live] > 0).all()) and bool((executed > 0).all())
    assert bool((executed % 32 == 0).all())


@pytest.fixture(scope="module")
def jax_k1(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_k1") / "k1.npz"
    run = subprocess.run(
        [sys.executable, os.path.join(TESTS, "_jax_step_stats.py"), "k1",
         str(out)], capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(TESTS))
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(out))


def _jax_test_lanes(obs):
    """tests/_jax_step_stats.py ``k1_lanes`` as the port's tensors."""
    b, t_rows, max_laps = 128, 32, 2
    rng = np.random.default_rng(3)
    states = rng.uniform(0, 12, (max_laps, t_rows, 4, b)).astype(np.float32)
    qfun = (np.maximum(20 - np.arange(t_rows), 0)[None, :, None]
            * np.ones((max_laps, 1, b))).astype(np.float32)
    x = rng.uniform(0, 5, (4, b)).astype(np.float32)
    skip = np.zeros(b, np.float32)
    skip[96:] = 1.0
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    return (t(x), t(x), t(states), t(qfun),
            torch.full((max_laps, b), 20, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32),
            t(obs), t(skip))


@pytest.mark.parametrize("run,options", [("plain", {}),
                                         ("qsort", dict(qsort_skip=True))])
def test_counts_match_the_jax_kernel(jax_k1, run, options):
    p = IlqrParams.make(device="cpu", dtype=torch.float32)
    lim = SystemLimits.make(device="cpu", dtype=torch.float32)
    a = _jax_test_lanes(jax_k1["obs"])
    got = [t.numpy() for t in i2lqr_step_reference(
        p, lim, 1.0, *a, max_iter=CAP, with_stats=True, floor_width=128,
        **options)]
    live = a[8].numpy() < 0.5  # JAX writes a skipped lane's computed step
    agree = live.copy()
    for i in (1, 2, 3):
        agree &= got[i] == jax_k1[f"{run}_{i}"]
    assert agree.sum() >= 0.99 * live.sum()
    np.testing.assert_array_equal(got[6], jax_k1[f"{run}_6"])
    mine, theirs = got[4][agree], jax_k1[f"{run}_4"][agree]
    assert (mine == theirs).mean() >= 0.85
    assert np.abs(mine - theirs).max() <= 8
    assert abs(int(mine.sum()) - float(theirs.sum())) <= 0.01 * theirs.sum()


@pytest.fixture(scope="module")
def jax_k32(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_k32") / "k32.npz"
    run = subprocess.run(
        [sys.executable, os.path.join(TESTS, "_jax_step_stats.py"), "k32",
         str(out)], capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(TESTS))
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(out))


def test_k32_counts_match_the_jax_kernel(jax_k1, jax_k32):
    """K1 at k = 32, nsi 2 (tests/_jax_step_stats.py ``k32``: the k1 lanes
    with their lap stored twice, 20 rows for 32 slots): the plain step
    with with_stats against the JAX kernel's. iters_useful and
    queue_floor keep their per-lane meaning at k = 32 (iters_executed is
    the port's warps', not JAX's tiles'): the decisions, queue_floor and
    the sums hold at the k1 comparison's tolerances. A lane here sums 192
    solves (8x k = 8's), each row's solve recurring in both stored copies
    and all three passes, so one solve's f32 convergence trip (XLA:CPU's
    arithmetic against torch's) moves a lane's sum by 6 a trip: 77 % of
    the live lanes equal (k = 8's bar: 85 %), the largest difference 78
    (13 trips), ROADMAP Queue 3."""
    p = IlqrParams.make(num_ss_points=32, num_ss_iter=2, device="cpu",
                        dtype=torch.float32)
    lim = SystemLimits.make(device="cpu", dtype=torch.float32)
    a = list(_jax_test_lanes(jax_k1["obs"]))
    a[2] = a[2].clone()
    a[2][1] = a[2][0]
    a[5], a[6] = torch.arange(2, dtype=torch.int32), torch.ones(
        2, dtype=torch.int32)
    got = [t.numpy() for t in i2lqr_step_reference(
        p, lim, 1.0, *a, max_iter=CAP, with_stats=True, floor_width=128)]
    live = a[8].numpy() < 0.5
    agree = live.copy()
    for i in (1, 2, 3):
        agree &= got[i] == jax_k32[f"plain_{i}"]
    assert agree.sum() >= 0.99 * live.sum()
    np.testing.assert_array_equal(got[6], jax_k32["plain_6"])
    mine, theirs = got[4][agree], jax_k32["plain_4"][agree]
    assert abs(int(mine.sum()) - float(theirs.sum())) <= 0.01 * theirs.sum()
    assert (mine == theirs).mean() >= 0.75
    assert np.all((mine - theirs) % 6 == 0)
    assert np.abs(mine - theirs).max() <= 6 * 2 * CAP


def test_the_simulator_s_k1_switch():
    """The simulator's own K1 takes dedup + qsort_skip, whose lane queue
    runs from LANE_QUEUE_FROM lanes on (the headline's 49 152 among them)
    and the plain order below; a stall_reseed run's K1 runs the plain
    order at every batch, 49 152 included."""
    cpu = "cpu"
    p, lim = IlqrParams.make(device=cpu), SystemLimits.make(device=cpu)
    sizes = dict(max_steps=MAX_STEPS, max_laps=MAX_LAPS, max_iter=CAP)
    k1 = default_step_solver(p, lim, 1.0, **sizes)
    reseeded = default_step_solver(p, lim, 1.0, reseeded=True, **sizes)
    assert k1.dedup and k1.qsort_skip and reseeded is not k1
    assert not (reseeded.dedup or reseeded.qsort_skip)
    assert default_step_solver(p, lim, 1.0, reseeded=True, **sizes) \
        is reseeded
    for b in (4096, LANE_QUEUE_FROM - 1, LANE_QUEUE_FROM, 49152, 1 << 20):
        assert k1.lane_queue_runs(b) == (b >= LANE_QUEUE_FROM)
        assert not reseeded.lane_queue_runs(b)
    assert k1.lane_queue_runs(49152)


def test_closed_loop_with_a_counting_k1_keeps_the_records():
    """Seed lap + 2 learning laps (B = 4, f64, noise on injected draws, at
    most 16 steps a lap) through a K1 with both schedules and with_stats,
    launched through the live-share recorder, against the plain run."""
    cpu, b = "cpu", 4
    p = IlqrParams.make(dtype=torch.float64, device=cpu)
    lim = SystemLimits.make(dtype=torch.float64, device=cpu)
    xcl, _ = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((MAX_STEPS, 4)), np.zeros((MAX_STEPS, 2))
    seed_xs[:121] = xcl
    scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0,
                                            dtype=torch.float64, device=cpu),
        b, noise_on=True, dtype=torch.float64, device=cpu)
    noise = torch.tensor(np.random.default_rng(4).normal(size=(80, 2, b)))
    kw = dict(num_laps=2, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
              solver_max_iter=CAP, sim_step_budget=16, noise=noise)
    plain = simulate_learning_runs_soa(p, lim, scen, seed_xs, seed_us, 121,
                                       1.0, **kw)
    k1 = live_share(build_fused_i2lqr_step(
        p, lim, 1.0, num_horizon=6, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
        max_iter=CAP, dedup=True, qsort_skip=True, with_stats=True), 8, b)
    res = simulate_learning_runs_soa(p, lim, scen, seed_xs, seed_us, 121,
                                     1.0, step_solver=k1, **kw)
    assert lap_records_hash(res) == lap_records_hash(plain)
    assert plain.iter_stats == ()
    useful, executed, floor = res.iter_stats
    assert useful.dtype == torch.int64 and useful.shape == (b,)
    assert bool((useful <= executed).all()) and int(useful.min()) > 0
    summary = stats_summary(res.iter_stats)
    assert 0.0 <= summary["waste"] < 1.0 and summary["queue_floor"] > 0
    shares = k1.shares()
    assert shares["launches"] == 32 and 0.0 < shares["min"] <= 1.0


# (params, options) that the JAX factory refuses (pallas_i2lqr_step.py
# :192-208), and so does the port's
GUARDED = [
    (dict(num_ss_iter=2), dict(dom_skip=True)),
    ({}, dict(qsort_skip=True, dom_skip=True)),
    ({}, dict(qsort_skip=True, group=2)),
    ({}, dict(group=3)),
    ({}, dict(group=2, with_stats=True)),
    (dict(num_ss_iter=2), dict(qsort_skip=True)),
]


@pytest.mark.parametrize("pkw,kw", GUARDED)
def test_factory_guards_are_the_tpu_factory_s(pkw, kw):
    from ilqr_iterative_tasks_tpu.ops.pallas_i2lqr_step import (
        build_fused_i2lqr_step as j_build)
    from ilqr_iterative_tasks_tpu.utils.params import (
        IlqrParams as JParams, SystemLimits as JLimits)
    sizes = dict(num_horizon=6, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                 max_iter=CAP)
    with pytest.raises(ValueError):
        j_build(JParams.make(**pkw), JLimits.make(), 1.0, interpret=True,
                **sizes, **kw)
    with pytest.raises(ValueError):
        build_fused_i2lqr_step(IlqrParams.make(device="cpu", **pkw),
                               SystemLimits.make(device="cpu"), 1.0,
                               **sizes, **kw)
    with pytest.raises(ValueError):  # and the plain version
        i2lqr_step_reference(IlqrParams.make(device="cpu", **pkw),
                             SystemLimits.make(device="cpu"), 1.0,
                             *k1_option_lanes(pkw.get("num_ss_iter", 1), 3,
                                              "cpu", b=8),
                             max_iter=CAP, **kw)


# the options ported last, alone and together (with dedup, qsort_skip)
NEW_OPTIONS = {"reuse": dict(reuse_extract=True),
               "reuse_dedup_qsort": dict(reuse_extract=True, dedup=True,
                                         qsort_skip=True),
               "dom": dict(dom_skip=True),
               "dom_dedup": dict(dom_skip=True, dedup=True),
               "group2_dedup": dict(group=2, dedup=True),
               "group8": dict(group=8),
               "dom_group2_dedup": dict(dom_skip=True, group=2, dedup=True),
               "group16_dedup_reuse": dict(group=16, dedup=True,
                                           reuse_extract=True)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("nsi,lap_count,option", [
    (1, 3, "reuse"), (2, 3, "reuse"), (1, 1, "reuse_dedup_qsort"),
    (1, 3, "dom"), (1, 3, "dom_dedup"), (1, 1, "dom_dedup"),
    (1, 3, "group2_dedup"), (1, 3, "group8"), (1, 3, "dom_group2_dedup"),
    (2, 3, "group16_dedup_reuse")])
def test_new_options_keep_the_plain_order_s_outputs(nsi, lap_count, option,
                                                    dtype):
    """reuse_extract, dom_skip and group against the options off, bit for
    bit, on k1_option_lanes (B = 128, cap 8); with counts where the option
    takes them: reuse_extract keeps the counts, dom_skip solves fewer
    candidates. reuse_extract fires: in pass 2 some live lane keeps its
    kNN."""
    p, lim, a, plain = _case(nsi, lap_count, dtype)
    o = NEW_OPTIONS[option]
    counted = o.get("group", 1) == 1
    reused = []
    got = i2lqr_step_reference(p, lim, 1.0, *a, max_iter=CAP,
                               with_stats=counted, reused=reused, **o)
    for g, w in zip(got[:4], plain[:4]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if o.get("reuse_extract"):
        assert len(reused) == 2 and bool(reused[1].any())
        assert not bool(reused[1][a[8] > 0.5].any())
    if o == dict(reuse_extract=True):  # the counts of the plain order
        assert all(torch.equal(g, w) for g, w in zip(got[4:], plain[4:]))
    if o.get("dom_skip") and counted:
        assert int(got[4].sum()) < int(plain[4].sum())
        assert bool((got[4] <= got[5]).all())
