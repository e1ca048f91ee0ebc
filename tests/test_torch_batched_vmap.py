"""The port's vmap tiers (control/batched.py, control/batched_nlmpc.py)
against the JAX package's, in f64 on the CPU, at small shapes (k 4, B 4,
laps from near the seed lap's end in a 14-step budget, 2 learning laps,
LM cap 40), x0 jittered, plant noise on, each scenario fed its JAX key
chain's draws (replayed as the JAX tier splits it, control/batched.py:
237-245): lap steps, done flags and lap lengths equal; states, inputs,
final states and the safe set within 1e-9. The candidate solves run through the K3 / K4
wrappers' plain versions (CPU tensors). The ``slow`` tests hold the
nominal f64 laps (zero noise, obstacle (31, -2, 8, 6)): i2LQR [55, 28,
23], NLMPC [33, 24, 24], the JAX tiers' on XLA:CPU."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_tpu.control.batched import (
    make_batch_scenarios as j_scenarios, simulate_learning_batch as j_i2lqr)
from ilqr_iterative_tasks_tpu.control.batched_nlmpc import (
    simulate_nlmpc_batch as j_nlmpc)
from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObstacle
from ilqr_iterative_tasks_tpu.sim.seed import seed_trajectory as j_seed
from ilqr_iterative_tasks_tpu.utils.params import (
    IlqrParams as JParams, LmpcParams as JLmpc, SystemLimits as JLimits)
from ilqr_iterative_tasks_torch.control.batched import (
    lane_normals, make_batch_scenarios, simulate_learning_batch,
    simulate_learning_run)
from ilqr_iterative_tasks_torch.control.batched_nlmpc import (
    simulate_nlmpc_batch)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.fused_ilqr import build_fused_ilqr
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils import convert
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, LmpcParams, SystemLimits)

torch.set_num_threads(1)
# small shapes: the JAX dry run's k 4 and B 4 (parallel/sharded.py:130-148)
# on the nominal seed lap, each scenario starting near seed row 108 (x0
# jittered by 0.1) so that laps end, or run out of a 14-step budget, within
# the test's time; the LM cap 40 on both sides (``max_ilqr_iter``)
B, K, MAX_STEPS, MAX_LAPS, BUDGET, LAPS, CAP = 4, 4, 128, 4, 14, 2, 40
START, JITTER = 108, 0.1
SEED_LEN = 121


def seed_lap(start=START):
    """The nominal seed lap: (seed_xs, seed_us, x0 at row ``start``, goal)
    numpy, padded to MAX_STEPS rows."""
    xcl, ucl = j_seed(1.0)
    seed_xs, seed_us = np.zeros((MAX_STEPS, 4)), np.zeros((MAX_STEPS, 2))
    seed_xs[:SEED_LEN], seed_us[:SEED_LEN - 1] = xcl, ucl
    return seed_xs, seed_us, xcl[start], xcl[-1]


def jax_scenarios(key=3, dtype=jnp.float64, batch=B, start=START):
    """JAX's scenario batch (x0 jittered, noise on) and the jitter draws
    it took (keys[0], control/batched.py:266-271)."""
    _, _, x0, goal = seed_lap(start)
    obstacle = JObstacle.make(31.0, -2.0, 8.0, 6.0, dtype=dtype)
    k = jax.random.PRNGKey(key)
    sc = j_scenarios(x0, goal, obstacle, batch, k, x0_jitter=JITTER,
                     noise_on=True, dtype=dtype)
    z = jax.random.normal(jax.random.split(k, batch + 1)[0], (batch, 4),
                          dtype)
    return sc, np.asarray(z)


@partial(jax.jit, static_argnums=(1, 2))
def _chains(keys, steps, dtype):
    def one(key):
        def body(key, _):
            key, k1, k2 = jax.random.split(key, 3)
            return key, jnp.stack([jax.random.normal(k1, dtype=dtype),
                                   jax.random.normal(k2, dtype=dtype)])
        return jax.lax.scan(body, key, None, length=steps)[1]
    return jax.vmap(one)(keys)


def lane_draws(keys, steps, dtype=jnp.float64) -> np.ndarray:
    """(B, steps, 2): each scenario's n-th step draws (v, theta) of its
    own key chain, the draws the JAX tier takes at that scenario's n-th
    step over its whole run."""
    return np.asarray(_chains(keys, steps, dtype))


F64 = torch.float64
TOL = 1e-9
KW = dict(num_laps=LAPS, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
          sim_step_budget=BUDGET)


def _inputs(start=START, laps=LAPS):
    sc, z = jax_scenarios(start=start)
    seed_xs, seed_us, _, _ = seed_lap()
    draws = lane_draws(sc.noise_key, laps * BUDGET)
    return (sc, z, seed_xs, seed_us,
            convert.scenario_spec(sc, dtype=F64, device="cpu"),
            torch.from_numpy(draws.copy()))


def _held(got, want):
    """Lap steps, done flags and lap lengths equal; the rest within TOL."""
    assert got.lap_steps.tolist() == np.asarray(want.lap_steps).tolist()
    assert got.lap_done.tolist() == np.asarray(want.lap_done).tolist()
    ss, jss = got.safe_set, want.safe_set
    assert ss.lap_len.tolist() == np.asarray(jss.lap_len).tolist()
    assert ss.num_laps.tolist() == np.asarray(jss.num_laps).tolist()
    assert torch.equal(ss.valid, torch.from_numpy(np.array(jss.valid)))
    for name in ("states", "inputs", "qfun"):
        np.testing.assert_allclose(getattr(ss, name).numpy(),
                                   np.asarray(getattr(jss, name)),
                                   atol=TOL, rtol=0, err_msg=name)


def test_i2lqr_tier_matches_jax_on_its_draws():
    sc, z, seed_xs, seed_us, tsc, draws = _inputs()
    jp = JParams.make(num_ss_points=K, max_ilqr_iter=CAP, dtype=jnp.float64)
    jl = JLimits.make(dtype=jnp.float64)
    want = j_i2lqr(jp, jl, sc, jnp.asarray(seed_xs), jnp.asarray(seed_us),
                   SEED_LEN, 1.0, **KW)
    tp = convert.ilqr_params(jp, device="cpu")
    tl = convert.system_limits(jl, device="cpu")
    k3 = build_fused_ilqr(tp, tl, 1.0, num_horizon=tp.num_horizon,
                          max_iter=tp.max_ilqr_iter)
    got = simulate_learning_batch(tp, tl, tsc, seed_xs, seed_us, SEED_LEN,
                                  1.0, candidate_solver=k3, noise=draws, **KW)
    _held(got, want)
    # laps that end and laps that run out of the budget
    assert got.lap_done.any() and not got.lap_done.all()
    np.testing.assert_allclose(got.final_x.numpy(), np.asarray(want.final_x),
                               atol=TOL, rtol=0)
    assert k3.launches == 0  # the CPU route launches no kernel
    # the jitter is injected as JAX draws it: x0 equal bit for bit
    obs = convert.obstacle(sc.obstacle, dtype=F64, device="cpu").map(
        lambda t: t[0])
    mine = make_batch_scenarios(seed_lap()[2], np.asarray(sc.goal[0]), obs, B,
                                x0_jitter=JITTER, noise_on=True, dtype=F64,
                                device="cpu", draws=z)
    assert torch.equal(mine.x0, tsc.x0)
    # one scenario alone runs its row of the batch (its first lap)
    one = simulate_learning_run(tp, tl, tsc.map(lambda t: t[2]), seed_xs,
                                seed_us, SEED_LEN, 1.0, noise=draws[2],
                                **dict(KW, num_laps=1))
    assert torch.equal(one.lap_steps, got.lap_steps[2, :1])
    assert torch.equal(one.safe_set.states[:2], got.safe_set.states[2, :2])


def test_nlmpc_tier_matches_jax_on_its_draws():
    sc, _, seed_xs, seed_us, tsc, draws = _inputs()
    jp = JLmpc.make(num_ss_points=K)
    jl = JLimits.make(dtype=jnp.float64)
    want = j_nlmpc(jp, jl, sc, jnp.asarray(seed_xs), jnp.asarray(seed_us),
                   SEED_LEN, 1.0, **KW)
    got = simulate_nlmpc_batch(convert.lmpc_params(jp, device="cpu"),
                               convert.system_limits(jl, device="cpu"), tsc,
                               seed_xs, seed_us, SEED_LEN, 1.0, noise=draws,
                               **KW)
    _held(got, want)
    assert got.lap_done.any() and not got.lap_done.all()


# the repair pass over the cross-lap code at nsi 2 and k 8 (lap_rows,
# knn_candidates, select_candidate against JAX batched.py:124-165 and
# batched_nlmpc.py:86-91): three learning laps from seed row 116, whose
# laps are shorter than k, so that each tier meets the first learning
# lap's clipped, invalid lap id -1, a stored lap shorter than k (overflow
# Qfun +inf) and an exact tie between the two laps' least costs
NSI2, K8, START_SHORT, LAPS_SHORT = 2, 8, 116, 3


@pytest.mark.parametrize("tier", ["i2lqr", "nlmpc"])
def test_tiers_at_nsi_2_and_k_8_match_jax(tier, monkeypatch):
    from ilqr_iterative_tasks_torch.control import batched, batched_nlmpc
    sc, _, seed_xs, seed_us, tsc, draws = _inputs(START_SHORT, LAPS_SHORT)
    kw = dict(KW, num_laps=LAPS_SHORT)
    jl = JLimits.make(dtype=jnp.float64)
    tl = convert.system_limits(jl, device="cpu")
    seen = []
    select = batched.select_candidate

    def tapped(cost, q, idx, rows):
        seen.append((cost, q, rows.valid))
        return select(cost, q, idx, rows)

    monkeypatch.setattr(batched, "select_candidate", tapped)
    monkeypatch.setattr(batched_nlmpc, "select_candidate", tapped)
    if tier == "i2lqr":
        jp = JParams.make(num_ss_points=K8, num_ss_iter=NSI2,
                          max_ilqr_iter=CAP, dtype=jnp.float64)
        want = j_i2lqr(jp, jl, sc, jnp.asarray(seed_xs),
                       jnp.asarray(seed_us), SEED_LEN, 1.0, **kw)
        tp = convert.ilqr_params(jp, device="cpu")
        k3 = build_fused_ilqr(tp, tl, 1.0, num_horizon=tp.num_horizon,
                              max_iter=tp.max_ilqr_iter)
        got = simulate_learning_batch(tp, tl, tsc, seed_xs, seed_us,
                                      SEED_LEN, 1.0, candidate_solver=k3,
                                      noise=draws, **kw)
        np.testing.assert_allclose(got.final_x.numpy(),
                                   np.asarray(want.final_x), atol=TOL, rtol=0)
    else:
        jp = JLmpc.make(num_ss_points=K8, num_ss_iter=NSI2)
        want = j_nlmpc(jp, jl, sc, jnp.asarray(seed_xs),
                       jnp.asarray(seed_us), SEED_LEN, 1.0, **kw)
        got = simulate_nlmpc_batch(convert.lmpc_params(jp, device="cpu"), tl,
                                   tsc, seed_xs, seed_us, SEED_LEN, 1.0,
                                   noise=draws, **kw)
    _held(got, want)
    first = sum(int((~valid).any()) for _, _, valid in seen)
    short = sum(int((~torch.isfinite(q[:, valid])).any())
                for _, q, valid in seen)
    ties = 0
    for cost, _, valid in seen:
        least = cost.amin(dim=2)
        if valid.all():
            ties += int(((least[:, 0] == least[:, 1])
                         & torch.isfinite(least[:, 0])).sum())
    print(f"{tier}: laps {got.lap_steps.tolist()}, selections "
          f"{len(seen)}: first lap {first}, a lap shorter than k {short}, "
          f"lane ties between the laps {ties}")
    assert first > 0 and short > 0 and ties > 0
    assert (got.safe_set.lap_len[:, 1:] < K8).any()


def test_lane_noise_is_each_scenario_s_own():
    """A scenario's n-th draw is a function of (its seed, n): the same in a
    batch of one, in any order, and standard normal in bulk."""
    seeds = make_batch_scenarios(np.zeros(4), np.zeros(4),
                                 Obstacle.make(device="cpu"), 64, key=7,
                                 device="cpu").noise_key
    counts = torch.arange(64) % 5
    z = lane_normals(seeds, counts, F64)
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(0))
    assert torch.equal(lane_normals(seeds[perm], counts[perm], F64), z[perm])
    assert torch.equal(lane_normals(seeds[3:4], counts[3:4], F64), z[3:4])
    big = lane_normals(seeds.repeat(500), torch.arange(32000), F64)
    assert abs(float(big.mean())) < 0.02 and abs(float(big.std()) - 1) < 0.02
    assert len(set(seeds.tolist())) == 64


def _nominal(dtype):
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((128, 4)), np.zeros((128, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    scen = make_batch_scenarios(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=dtype,
                                            device="cpu"),
        2, dtype=dtype, device="cpu")
    return seed_xs, seed_us, scen


@pytest.mark.slow
def test_i2lqr_tier_nominal_f64_laps():
    """[55, 28, 23]: the JAX tier's f64 laps (and the SoA sweep's pin)."""
    seed_xs, seed_us, scen = _nominal(F64)
    res = simulate_learning_batch(
        IlqrParams.make(dtype=F64, device="cpu"),
        SystemLimits.make(dtype=F64, device="cpu"), scen, seed_xs, seed_us,
        121, 1.0, num_laps=3, max_steps=128, max_laps=8)
    assert res.lap_steps.tolist() == [[55, 28, 23]] * 2
    assert bool(res.lap_done.all())
    assert res.safe_set.lap_len[0, :4].tolist() == [121, 57, 30, 25]


@pytest.mark.slow
def test_nlmpc_tier_nominal_f64_laps():
    """[33, 24, 24]: the JAX tier's f64 laps (its horizon never shrinks,
    so not the SoA simulator's [32, 23, 23])."""
    seed_xs, seed_us, scen = _nominal(F64)
    res = simulate_nlmpc_batch(
        LmpcParams.make(dtype=F64, device="cpu"),
        SystemLimits.make(dtype=F64, device="cpu"), scen, seed_xs, seed_us,
        121, 1.0, num_laps=3, max_steps=128, max_laps=8)
    assert res.lap_steps.tolist() == [[33, 24, 24]] * 2
    assert bool(res.lap_done.all())


@pytest.mark.slow
@pytest.mark.parametrize("tier", ["i2lqr", "nlmpc"])
def test_tier_nominal_f32_laps(tier):
    """The port's f32 laps on the CPU: i2LQR [55, 28, 22] (the H100's
    too), NLMPC [32, 23, 23], the JAX tier's own (below). They are the
    witnesses of chip_smoke.py phases 33-34's f32 bands."""
    seed_xs, seed_us, scen = _nominal(torch.float32)
    lim = SystemLimits.make(dtype=torch.float32, device="cpu")
    if tier == "i2lqr":
        res = simulate_learning_batch(
            IlqrParams.make(dtype=torch.float32, device="cpu"), lim, scen,
            seed_xs, seed_us, 121, 1.0, num_laps=3, max_steps=128,
            max_laps=8)
        assert res.lap_steps.tolist() == [[55, 28, 22]] * 2
    else:
        res = simulate_nlmpc_batch(
            LmpcParams.make(dtype=torch.float32, device="cpu"), lim, scen,
            seed_xs, seed_us, 121, 1.0, num_laps=3, max_steps=128,
            max_laps=8)
        assert res.lap_steps.tolist() == [[32, 23, 23]] * 2
    assert bool(res.lap_done.all())


@pytest.mark.slow
def test_jax_tiers_nominal_f32_laps():
    """The JAX tiers' f32 laps on XLA:CPU with x64 on, as these tests run
    JAX: [55, 28, 24] and [32, 23, 23]. With x64 off, which changes no f32
    operation of either tier, XLA:CPU gives [55, 28, 25] and [34, 23,
    22]: f32 laps follow the compilation's last bits (docs/PARITY.md)."""
    from ilqr_iterative_tasks_tpu.control.batched import (
        make_batch_scenarios as j_scen)
    from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObs
    f32 = jnp.float32
    xcl, ucl = seed_trajectory(1.0)
    seed_xs = jnp.zeros((128, 4), f32).at[:121].set(jnp.asarray(xcl, f32))
    seed_us = jnp.zeros((128, 2), f32).at[:120].set(jnp.asarray(ucl, f32))
    sc = j_scen(np.zeros(4), xcl[-1], JObs.make(31.0, -2.0, 8.0, 6.0,
                                                dtype=f32), 2,
                jax.random.PRNGKey(0), dtype=f32)
    kw = dict(num_laps=3, max_steps=128, max_laps=8)
    lim = JLimits.make(dtype=f32)
    i2 = j_i2lqr(JParams.make(dtype=f32), lim, sc, seed_xs, seed_us, 121,
                 1.0, **kw)
    nl = j_nlmpc(JLmpc.make(dtype=f32), lim, sc, seed_xs, seed_us, 121, 1.0,
                 **kw)
    assert np.asarray(i2.lap_steps).tolist() == [[55, 28, 24]] * 2
    assert np.asarray(nl.lap_steps).tolist() == [[32, 23, 23]] * 2


@pytest.mark.slow
def test_jax_tiers_nominal_f64_laps():
    """The pins above are the JAX tiers' own f64 laps on XLA:CPU."""
    from ilqr_iterative_tasks_tpu.control.batched import (
        make_batch_scenarios as j_scen)
    from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObs
    xcl, ucl = seed_trajectory(1.0)
    seed_xs = jnp.zeros((128, 4)).at[:121].set(jnp.asarray(xcl))
    seed_us = jnp.zeros((128, 2)).at[:120].set(jnp.asarray(ucl))
    sc = j_scen(np.zeros(4), xcl[-1], JObs.make(31.0, -2.0, 8.0, 6.0,
                                                dtype=jnp.float64), 2,
                jax.random.PRNGKey(0), dtype=jnp.float64)
    kw = dict(num_laps=3, max_steps=128, max_laps=8)
    lim = JLimits.make(dtype=jnp.float64)
    i2 = j_i2lqr(JParams.make(dtype=jnp.float64), lim, sc, seed_xs, seed_us,
                 121, 1.0, **kw)
    nl = j_nlmpc(JLmpc.make(), lim, sc, seed_xs, seed_us, 121, 1.0, **kw)
    assert np.asarray(i2.lap_steps).tolist() == [[55, 28, 23]] * 2
    assert np.asarray(nl.lap_steps).tolist() == [[33, 24, 24]] * 2
