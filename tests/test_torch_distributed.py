"""The port's multi-process runtime (parallel/distributed.py, mesh.py,
launch.py) and its shardmap runs and sharded kNN against the JAX package,
on the CPU.

Four ranks (gloo on loopback, subprocesses of parallel/launch.py; no
process group enters the pytest process) run, at once on two 2-rank
meshes, the port's ``_shardmap`` i2LQR (ranks 0-1) and NLMPC spaceVarying
(ranks 2-3) learning laps (f64, B = 8, 1 lap, LM cap 8), each shard fed the
JAX package's draws of ``fold_in(key, shard)`` split per step as its
simulator splits them; then ``sharded_knn`` over meshes of 1, 2 and 4
ranks. Meanwhile this process runs the JAX package's shardmap simulators
on a 2-device virtual mesh (conftest's 8 CPU devices, as
tests/test_sharded_soa.py runs them) and its ``sharded_knn``. Lap steps and
done flags must be equal, the safe set within 1e-9; the kNN must give the
stable argsort's rows (ties by row) and JAX's distances within 1e-6 (f32)
/ 1e-12 (f64). The meshed NLMPC controller's pinned laps (JAX's
tests/test_nlmpc.py:153-173) and the NLMPC ``all`` shardmap with streak
statistics are ``slow``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_distributed_worker as w
from ilqr_iterative_tasks_tpu.control.batched_soa import (
    SoaScenarios as JScenarios)
from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObstacle
from ilqr_iterative_tasks_tpu.parallel.mesh import make_mesh as j_make_mesh
from ilqr_iterative_tasks_tpu.parallel.sharded_safe_set import (
    sharded_knn as j_sharded_knn)
from ilqr_iterative_tasks_tpu.parallel.sharded_soa import (
    simulate_learning_runs_soa_shardmap as j_i2lqr_shardmap,
    simulate_nlmpc_runs_soa_shardmap as j_nlmpc_shardmap)
from ilqr_iterative_tasks_tpu.sim.seed import seed_trajectory as j_seed
from ilqr_iterative_tasks_tpu.utils.params import (
    IlqrParams as JIlqr, LmpcParams as JLmpc, SystemLimits as JLimits)
from ilqr_iterative_tasks_torch.parallel import distributed
from ilqr_iterative_tasks_torch.parallel.launch import Ranks, spawn

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_distributed_worker.py")
KEY, K, T, BATCH = 3, 8, 256, 12
NOISE_ROWS = 128


def _jax_draws(key, steps, b):
    """The (v, theta) standard-normal draws the JAX simulators take at each
    executed step (``split(key, 3)``, batched_soa.py:833-836): (steps, 2,
    b)."""
    def body(k, _):
        k, k1, k2 = jax.random.split(k, 3)
        return k, jnp.stack([jax.random.normal(k1, (b,), jnp.float64),
                             jax.random.normal(k2, (b,), jnp.float64)])
    return np.array(jax.jit(lambda k: jax.lax.scan(
        body, k, None, length=steps)[1])(key))


def shard_draws(key, shards, b):
    """Each shard's draws of ``fold_in(key, shard)``, side by side in its
    columns: (NOISE_ROWS, 2, b)."""
    return np.concatenate([_jax_draws(jax.random.fold_in(key, i), NOISE_ROWS,
                                      b // shards) for i in range(shards)],
                          axis=-1)


def _jax_setup(b):
    f64 = jnp.float64
    xcl, ucl = j_seed(1.0)
    seed_xs = jnp.zeros((128, 4), f64).at[:121].set(jnp.asarray(xcl, f64))
    seed_us = jnp.zeros((128, 2), f64).at[:120].set(jnp.asarray(ucl, f64))
    scen = JScenarios.broadcast(np.zeros(4), xcl[-1], JObstacle.make(
        31.0, -2.0, 8.0, 6.0, dtype=f64), b, noise_on=True, dtype=f64)
    return JLimits.make(dtype=f64), seed_xs, seed_us, scen


def jax_shardmap(which, mesh_size=2, **extra):
    """JAX's shardmap run of tests/test_distributed.py's configuration on a
    virtual mesh of ``mesh_size`` devices (B = 8, 1 lap, LM cap 8)."""
    lim, sx, su, scen = _jax_setup(w.SHARDMAP_B)
    mesh, key = j_make_mesh(mesh_size), jax.random.PRNGKey(KEY)
    if which == "i2lqr":
        return j_i2lqr_shardmap(JIlqr.make(dtype=jnp.float64), lim, scen, sx,
                                su, 121, 1.0, key, mesh, **w.I2LQR_KW)
    params = extra.pop("params", JLmpc.make(ss_option="spaceVarying"))
    return j_nlmpc_shardmap(params, lim, scen, sx, su, 121, 1.0, key, mesh,
                            **dict(w.NLMPC_KW, **extra))


def knn_cases():
    """JAX's test inputs (tests/test_parallel_riccati.py:84-104: T = 256,
    20 % invalid rows), rows with exact ties across the shards (32 distinct
    rows on a grid, each 8 times), and five valid rows, in f32 and f64:
    name -> (states (T, 4), valid, qfun, x_guess)."""
    rng = np.random.default_rng(3)
    states = rng.normal(size=(T, 4)) * 10
    valid = rng.random(T) > 0.2
    qfun = np.arange(T)[::-1].astype(float)
    x = rng.normal(size=4) * 5
    grid = np.random.default_rng(4).integers(-3, 4, (32, 4)).astype(float)
    tied = grid[np.arange(T) % 32]
    few = np.zeros(T, bool)
    few[[3, 70, 140, 141, 250]] = True
    out = {}
    for dt in (np.float32, np.float64):
        name = np.dtype(dt).name
        out[f"jax_inputs_{name}"] = (states.astype(dt), valid, qfun.astype(dt),
                                     x.astype(dt))
        out[f"ties_{name}"] = (tied.astype(dt), valid, qfun.astype(dt),
                               (grid[5] + 0.5).astype(dt))
        out[f"few_valid_{name}"] = (states.astype(dt), few, qfun.astype(dt),
                                    x.astype(dt))
    return out


@pytest.fixture(scope="module")
def checks():
    cases = knn_cases()
    ranks = Ranks(f"{WORKER}:distributed_checks", 4,
                  shard_draws(jax.random.PRNGKey(KEY), 2, w.SHARDMAP_B),
                  shard_draws(jax.random.PRNGKey(KEY), 2, w.SHARDMAP_B),
                  cases, K, BATCH, backend="gloo", threads=1, timeout=300,
                  init_timeout=60)
    try:
        want = dict(i2lqr=jax_shardmap("i2lqr"), nlmpc=jax_shardmap("nlmpc"))
        for n in (1, 2, 4):
            mesh = j_make_mesh(n, axis_name="history")
            for name, (s, v, q, x) in cases.items():
                want[(n, name)] = [np.asarray(a) for a in j_sharded_knn(
                    jnp.asarray(s), jnp.asarray(v), jnp.asarray(q),
                    jnp.asarray(x), K, mesh)]
    except BaseException:
        ranks.close()
        raise
    return ranks.wait(), want, cases


def assert_near_jax(got, want):
    np.testing.assert_array_equal(got.lap_steps.numpy(),
                                  np.asarray(want.lap_steps))
    np.testing.assert_array_equal(got.lap_done.numpy(),
                                  np.asarray(want.lap_done))
    assert len(got.safe_set) == len(want.safe_set)
    for g, v in zip(got.safe_set, want.safe_set):
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(g.numpy(), v, rtol=0, atol=1e-9)
        else:
            np.testing.assert_array_equal(g.numpy(), v)
    assert got.lap_count == int(want.lap_count) and got.final_key is None


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("which", ["i2lqr", "nlmpc"])
def test_shardmap_matches_jax_s_shardmap(checks, which, index):
    got, want, _ = checks
    rank = index if which == "i2lqr" else 2 + index
    assert_near_jax(got[rank]["shardmap"][which], want[which])
    assert got[rank]["shardmap"][which].lap_done.any()


def _l1(states, x):
    a = np.abs(states - x[None, :])
    return ((a[:, 0] + a[:, 1]) + a[:, 2]) + a[:, 3]


@pytest.mark.parametrize("case", list(knn_cases()))
@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_knn_is_the_stable_argsort_and_jax_s(checks, n, case):
    got, want, cases = checks
    states, valid, qfun, x = cases[case]
    gidx, pts, qs, dist = (t.numpy() for t in got[0]["knn"][(n, case)])
    d = np.where(valid, _l1(states, x), np.inf)
    order = np.argsort(d, kind="stable")[:K]
    order = order[np.isfinite(d[order])]
    np.testing.assert_array_equal(gidx, order)
    np.testing.assert_array_equal(dist, d[order])
    np.testing.assert_array_equal(pts, states[order])
    np.testing.assert_array_equal(qs, qfun[order])
    assert dist.dtype == states.dtype
    j_idx, _, _, j_dist = want[(n, case)]
    finite = np.isfinite(j_dist)
    assert finite.sum() == len(order)
    tol = 1e-6 if states.dtype == np.float32 else 1e-12
    np.testing.assert_allclose(dist, j_dist[finite], rtol=tol, atol=tol)
    assert set(j_idx[finite].tolist()) == set(gidx.tolist()) or \
        case.startswith("ties")  # JAX's top_k may pick other tied rows
    if case.startswith("ties"):
        assert len(set(dist.tolist())) < len(dist)  # ties among the k


def test_host_local_batch_slice_tiles_the_batch(checks):
    got, _, _ = checks
    slices = [g["slice"] for g in got]
    assert slices == [slice(3 * r, 3 * r + 3) for r in range(4)]
    assert distributed.host_local_batch_slice(BATCH) == slice(0, BATCH)


def test_mesh_2d_lines_gather_their_ranks(checks):
    got, _, _ = checks
    for r, g in enumerate(got):
        s, c = divmod(r, 2)
        assert g["mesh_2d_index"] == (s, c)
        assert g["mesh_2d"]["candidate"] == [2 * s, 2 * s + 1]
        assert g["mesh_2d"]["scenario"] == [c, 2 + c]


def test_nccl_beyond_the_visible_cards_is_refused(monkeypatch):
    """Two NCCL ranks on a host of one card raise before any group forms;
    so does NCCL on a host with none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="backend='gloo'"):
        distributed.initialize_distributed("localhost:1", 2, 0,
                                           backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="0 visible"):
        distributed.initialize_distributed("tcp://localhost:1", 1, 0,
                                           backend="nccl")
    assert not torch.distributed.is_initialized()


def test_a_failing_rank_fails_the_run():
    """A rank that raises ends the run with its output, at once, while the
    other ranks wait in a collective."""
    with pytest.raises(RuntimeError, match="exited non-zero") as err:
        spawn(f"{WORKER}:fail_on_rank_1", 2, backend="gloo", timeout=120,
              init_timeout=60)
    assert "rank 1 fails on purpose" in str(err.value)


@pytest.mark.slow
@pytest.mark.parametrize("mode, want", [("space", [120.0, 32.0, 23.0]),
                                        ("all", [120.0, 26.0, 22.0])])
def test_meshed_controller_gives_jax_s_pinned_laps(mode, want):
    """NlmpcController(mesh=) on 2 ranks, f64, zero noise: the JAX
    package's pinned meshed laps (tests/test_nlmpc.py:153-173), with one
    K4 launch a rank over its half of each step's candidates."""
    got = spawn(f"{WORKER}:meshed_controller", 2, mode, backend="gloo",
                threads=1, timeout=900)
    for g in got:
        assert g["laps"] == want and all(g["finished"])
    assert got[0]["launch_lanes"] == got[1]["launch_lanes"]


@pytest.mark.slow
def test_nlmpc_all_shardmap_with_streaks_matches_jax():
    """The NLMPC ``all`` mode with streak statistics through the port's
    ``_shardmap`` on 2 ranks against JAX's on 2 devices (B = 8, budget
    40): lap steps, done flags and streaks equal, the safe set within
    1e-9."""
    kw = dict(with_streak_stats=True, sim_step_budget=40)
    got = spawn(f"{WORKER}:all_mode_shardmap",
                2, shard_draws(jax.random.PRNGKey(KEY), 2, w.SHARDMAP_B),
                kw, backend="gloo", threads=1, timeout=900)
    want = jax_shardmap("nlmpc", params=JLmpc.make(all_ss_point=True), **kw)
    for g in got:
        assert_near_jax(g, want)
        for a, b in zip(g.streaks, want.streaks):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
