"""The JAX package's whole-step kernels with ``with_stats``, in interpret
mode (``tile_rows=1``: one tile of 128 lanes, f32), on the port's edge-case
inputs: K1 on those of tests/test_pallas_i2lqr_step.py:171-215
(``k1_lanes``), K2 on experiments/headlines.py ``k2_option_lanes``; run
in a fresh process: the JAX package's own tests run these compiles
in a process of their own (tests/test_isolated_kernel_modules.py).

    python tests/_jax_step_stats.py k1|k32|k2|sim|k1opts|k2opts OUT.npz

k1: K1 in the plain order and with ``qsort_skip`` (its obstacle lanes
saved too); k32: K1 at k = 32, nsi 2, in the plain order, on the same
lanes with a second stored lap (``k32_lanes``); sim: the JAX i2LQR
simulator through K1 with ``with_stats`` over one learning lap, with and
without ``retile_frac`` (``sim``); k2: K2 spaceVarying in the plain order
and timeVarying with ``qsort_skip`` (nsi 1, two stored laps); k1opts: K1
on the k1 lanes with ``reuse_extract``, ``dom_skip`` and ``group=2``
(without counts); k2opts: K2 on the k2 lanes with ``prox_skip`` in both
modes and spaceVarying with ``zeros_skip``. Each run's outputs are saved
under its name and the output's index (``plain_4``: plain order,
iters_useful).
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(ROOT, ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ilqr_iterative_tasks_torch.experiments.headlines import (  # noqa: E402
    k2_option_lanes)

B, K1_CAP, K2_CAP = 128, 8, 12
K1_RUNS = {"plain": {}, "qsort": dict(qsort_skip=True)}
K2_RUNS = {"space": ("spaceVarying", {}),
           "time_qsort": ("timeVarying", dict(qsort_skip=True))}
K1_OPT_RUNS = {"reuse": dict(reuse_extract=True), "dom": dict(dom_skip=True),
               "group2": dict(group=2)}
K2_OPT_RUNS = {"prox_space": ("spaceVarying", dict(prox_skip=True)),
               "prox_time": ("timeVarying", dict(prox_skip=True)),
               "zskip_space": ("spaceVarying", dict(zeros_skip=True))}


def k1_lanes():
    """The inputs of tests/test_pallas_i2lqr_step.py:171-215 (its
    with_stats test), numpy f32: B = 128 lanes, one stored lap of 20 random
    rows in [0, 12)^4 of a 32-row safe set of 2 laps, Qfun 20 - t, x in
    [0, 5)^4, lanes 96-127 skipped, the (31, -2) 8 x 6 obstacle. Returns
    (x, states, qfun, lap_len, lap_ids, lap_ok, skip)."""
    b, t_rows, max_laps = B, 32, 2
    rng = np.random.default_rng(3)
    states = rng.uniform(0, 12, (max_laps, t_rows, 4, b)).astype(np.float32)
    qfun = (np.maximum(20 - np.arange(t_rows), 0)[None, :, None]
            * np.ones((max_laps, 1, b))).astype(np.float32)
    lap_len = np.full((max_laps, b), 20, np.int32)
    x = rng.uniform(0, 5, (4, b)).astype(np.float32)
    skip = np.zeros(b, np.float32)
    skip[96:] = 1.0
    return (x, states, qfun, lap_len, np.zeros(1, np.int32),
            np.ones(1, np.int32), skip)


def k32_lanes():
    """``k1_lanes`` at nsi 2: its lap stored twice (lap_ids (0, 1), both
    stored), so each lap row has 20 rows for 32 slots (12 without a
    row)."""
    x, states, qfun, lap_len, _, _, skip = k1_lanes()
    states = states.copy()
    states[1] = states[0]
    return (x, states, qfun, lap_len, np.arange(2, dtype=np.int32),
            np.ones(2, np.int32), skip)


def k32():
    from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle
    from ilqr_iterative_tasks_tpu.ops.pallas_i2lqr_step import (
        build_fused_i2lqr_step)
    from ilqr_iterative_tasks_tpu.ops.pallas_ilqr import obstacle_to_lanes
    from ilqr_iterative_tasks_tpu.utils.params import (
        IlqrParams, SystemLimits)
    x, states, qfun, lap_len, lap_ids, lap_ok, skip = k32_lanes()
    obs = obstacle_to_lanes(Obstacle.make(31.0, -2.0, 8.0, 6.0,
                                          dtype=jnp.float32), B)
    ja = [jnp.asarray(v) for v in (x, x, states, qfun, lap_len, lap_ids,
                                   lap_ok)] + [obs, jnp.asarray(skip)]
    p = IlqrParams.make(num_ss_points=32, num_ss_iter=2, dtype=jnp.float32)
    f = build_fused_i2lqr_step(
        p, SystemLimits.make(dtype=jnp.float32), 1.0, num_horizon=6,
        max_steps=states.shape[1], max_laps=states.shape[0],
        max_iter=K1_CAP, tile_rows=1, interpret=True, with_stats=True)
    return {f"plain_{i}": np.asarray(v) for i, v in enumerate(f(*ja))}


SIM_B, SIM_BUDGET = 128, 60


def sim():
    """The JAX i2LQR simulator (seed lap + 1 learning lap of at most
    SIM_BUDGET steps, SIM_B lanes at the (31, -2) 8 x 6 obstacle, noise on,
    f32, cap K1_CAP) through K1 built ``with_stats`` (interpret, one tile),
    without and with ``retile_frac`` 0.2 (whose partial sums ride the
    permutation, batched_soa.py:927-939): each run's lap steps and
    ``iter_stats``, and the run's draws (``draws``: (steps, 2, B))."""
    from ilqr_iterative_tasks_tpu.control.batched_soa import (
        SoaScenarios, simulate_learning_runs_soa)
    from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle
    from ilqr_iterative_tasks_tpu.ops.pallas_i2lqr_step import (
        build_fused_i2lqr_step)
    from ilqr_iterative_tasks_tpu.sim.seed import seed_trajectory
    from ilqr_iterative_tasks_tpu.utils.params import (
        IlqrParams, SystemLimits)
    f32 = jnp.float32
    xcl, _ = seed_trajectory(1.0)
    seed_xs = jnp.zeros((128, 4), f32).at[:121].set(jnp.asarray(xcl, f32))
    scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=f32),
        SIM_B, noise_on=True, dtype=f32)
    p, lim = IlqrParams.make(dtype=f32), SystemLimits.make(dtype=f32)
    k1 = build_fused_i2lqr_step(p, lim, 1.0, num_horizon=6, max_steps=128,
                                max_laps=4, max_iter=K1_CAP, tile_rows=1,
                                interpret=True, with_stats=True)
    key = jax.random.PRNGKey(3)
    out = {}
    for name, opts in (("plain", {}), ("retile", dict(retile_frac=0.2))):
        r = simulate_learning_runs_soa(
            p, lim, scen, seed_xs, jnp.zeros((128, 2), f32), 121, 1.0, key,
            num_laps=1, max_steps=128, max_laps=4, solver_max_iter=K1_CAP,
            sim_step_budget=SIM_BUDGET, pallas_step_solver=k1, **opts)
        out[f"{name}_lap_steps"] = np.asarray(r.lap_steps)
        for i, v in enumerate(r.iter_stats):
            out[f"{name}_stats_{i}"] = np.asarray(v)

    def body(k, _):
        k, k1_, k2_ = jax.random.split(k, 3)
        return k, jnp.stack([jax.random.normal(k1_, (SIM_B,), f32),
                             jax.random.normal(k2_, (SIM_B,), f32)])
    out["draws"] = np.asarray(jax.lax.scan(body, key, None,
                                           length=SIM_BUDGET)[1])
    return out


def k1(runs=K1_RUNS, with_stats=True):
    from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle
    from ilqr_iterative_tasks_tpu.ops.pallas_i2lqr_step import (
        build_fused_i2lqr_step)
    from ilqr_iterative_tasks_tpu.ops.pallas_ilqr import obstacle_to_lanes
    from ilqr_iterative_tasks_tpu.utils.params import (
        IlqrParams, SystemLimits)
    x, states, qfun, lap_len, lap_ids, lap_ok, skip = k1_lanes()
    obs = obstacle_to_lanes(Obstacle.make(31.0, -2.0, 8.0, 6.0,
                                          dtype=jnp.float32), B)
    ja = [jnp.asarray(v) for v in (x, x, states, qfun, lap_len, lap_ids,
                                   lap_ok)] + [obs, jnp.asarray(skip)]
    p = IlqrParams.make(dtype=jnp.float32)
    lim = SystemLimits.make(dtype=jnp.float32)
    out = {"obs": np.asarray(obs)}
    for name, opts in runs.items():
        f = build_fused_i2lqr_step(
            p, lim, 1.0, num_horizon=6, max_steps=states.shape[1],
            max_laps=states.shape[0], max_iter=K1_CAP, tile_rows=1,
            interpret=True, with_stats=with_stats, **opts)
        for i, v in enumerate(f(*ja)):
            out[f"{name}_{i}"] = np.asarray(v)
    return out


def k2(runs=K2_RUNS, with_stats=True):
    from ilqr_iterative_tasks_tpu.ops.pallas_nlmpc_step import (
        build_fused_nlmpc_step)
    from ilqr_iterative_tasks_tpu.utils.params import (
        LmpcParams, SystemLimits)
    a = k2_option_lanes(1, 2, "cpu", b=B, dtype=torch.float32)
    ja = [jnp.asarray(t.numpy()) for t in a]
    lim = SystemLimits.make(dtype=jnp.float32)
    out = {}
    for name, (mode, opts) in runs.items():
        p = LmpcParams.make(dtype=jnp.float32, ss_option=mode)
        f = build_fused_nlmpc_step(
            p, lim, 1.0, num_horizon=6, max_steps=a[3].shape[1],
            max_laps=a[3].shape[0], max_iters=K2_CAP, tile_rows=1,
            interpret=True, mode=mode, with_stats=with_stats, **opts)
        args = ja if mode == "timeVarying" else ja[:11]
        for i, v in enumerate(f(*args)):
            out[f"{name}_{i}"] = np.asarray(v)
    return out


if __name__ == "__main__":
    which, path = sys.argv[1], sys.argv[2]
    np.savez(path, **{
        "k1": k1, "k32": k32, "k2": k2, "sim": sim,
        "k1opts": lambda: k1(K1_OPT_RUNS, with_stats=False),
        "k2opts": lambda: k2(K2_OPT_RUNS, with_stats=False)}[which]())
