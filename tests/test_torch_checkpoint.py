"""Checkpoint and exact resume of the batched learning runs
(``utils/checkpoint.py``, the simulators' ``resume_from``), f64 on the CPU.

- A run cut by a checkpoint equals the run in one piece bit for bit (lap
  records, final states, the safe set, the noise position), for both
  simulators, with the noise from a generator and injected. The i2LQR
  runs are cut to a 20-step budget (every lane runs to it) to keep the
  plain step's CPU time down; the NLMPC runs take the full budget.
- A checkpoint that the JAX package's ``save_soa_run`` wrote, resumed by
  the port on the draws of the JAX key it holds, equals JAX's own resumed
  run: lap steps and done flags exactly, states within 1e-9.
- The file keeps the JAX key names and layout, and round-trips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_tpu.control import batched_nlmpc_soa as jns
from ilqr_iterative_tasks_tpu.control import batched_soa as jbs
from ilqr_iterative_tasks_tpu.models.obstacle import Obstacle as JObstacle
from ilqr_iterative_tasks_tpu.sim.seed import seed_trajectory as j_seed
from ilqr_iterative_tasks_tpu.utils import checkpoint as jck
from ilqr_iterative_tasks_tpu.utils.params import (
    IlqrParams as JIlqrParams, LmpcParams as JLmpcParams,
    SystemLimits as JLimits)
from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import (
    simulate_nlmpc_runs_soa)
from ilqr_iterative_tasks_torch.control.batched_soa import (
    simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.utils import convert
from ilqr_iterative_tasks_torch.utils.checkpoint import (
    load_soa_run, save_soa_run)

torch.set_num_threads(1)
B, T_ROWS, MAX_LAPS, CAP = 4, 128, 8, 12
JAX_KEYS = {"lap_count", "lap_steps", "lap_done", "num_ss_tensors"}


def _jax_draws(key, steps, b):
    """The (v, theta) standard-normal draws the JAX simulators take at each
    executed step, in order: (steps, 2, b)."""
    def body(k, _):
        k, k1, k2 = jax.random.split(k, 3)
        return k, jnp.stack([jax.random.normal(k1, (b,), jnp.float64),
                             jax.random.normal(k2, (b,), jnp.float64)])
    return np.array(jax.jit(lambda k: jax.lax.scan(
        body, k, None, length=steps)[1])(key))


def _setup(nlmpc):
    xcl, ucl = j_seed(1.0)
    seed_xs, seed_us = np.zeros((T_ROWS, 4)), np.zeros((T_ROWS, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    jp = (JLmpcParams if nlmpc else JIlqrParams).make(dtype=jnp.float64)
    jl = JLimits.make(dtype=jnp.float64)
    scen = jbs.SoaScenarios.broadcast(
        np.zeros(4), xcl[-1],
        JObstacle.make(31.0, -2.0, 8.0, 6.0, dtype=jnp.float64), B,
        noise_on=True, dtype=jnp.float64)
    scen = scen.replace(noise_on=jnp.asarray([0.0, 1.0, 1.0, 1.0]))
    return jp, jl, scen, seed_xs, seed_us


def _port_run(nlmpc, laps, **kw):
    """A port run of ``laps`` learning laps on the CPU."""
    jp, jl, scen, seed_xs, seed_us = _setup(nlmpc)
    tl = convert.system_limits(jl, device="cpu")
    ts = convert.scenarios(scen, device="cpu")
    if nlmpc:
        return simulate_nlmpc_runs_soa(
            convert.lmpc_params(jp, device="cpu"), tl, ts, seed_xs, seed_us,
            121, 1.0, num_laps=laps, max_steps=T_ROWS, max_laps=MAX_LAPS,
            max_lm_iters=CAP, with_streak_stats=True, **kw)
    return simulate_learning_runs_soa(
        convert.ilqr_params(jp, device="cpu"), tl, ts, seed_xs, None, 121,
        1.0, num_laps=laps, max_steps=T_ROWS, max_laps=MAX_LAPS,
        solver_max_iter=CAP, sim_step_budget=20, **kw)


def _noise(kind, steps):
    """Fresh keyword arguments of one noise source."""
    if kind == "generator":
        return dict(generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    return dict(noise=torch.from_numpy(rng.normal(size=(steps, 2, B))))


@pytest.mark.parametrize("kind", ["generator", "noise"])
@pytest.mark.parametrize("nlmpc", [False, True], ids=["i2lqr", "nlmpc"])
def test_resume_is_exact(nlmpc, kind, tmp_path):
    """first + rest laps, checkpointed between them, equal first + rest
    laps in one run, bit for bit."""
    first, rest = (2, 1) if nlmpc else (1, 1)
    steps = (first + rest) * 121
    whole = _port_run(nlmpc, first + rest, **_noise(kind, steps))
    part = _port_run(nlmpc, first, **_noise(kind, steps))
    path = str(tmp_path / "run.npz")
    save_soa_run(path, part)
    ck, part_steps, part_done = load_soa_run(path, device="cpu")
    resume_kw = _noise(kind, steps)
    if kind == "generator":  # any generator: the checkpoint sets its state
        resume_kw["generator"].manual_seed(99)
        assert isinstance(ck[2], torch.Tensor)
    else:
        assert ck[2] == int(part.final_key) > 0
    resumed = _port_run(nlmpc, rest, resume_from=ck, **resume_kw)
    assert torch.equal(torch.cat([torch.from_numpy(part_steps),
                                  resumed.lap_steps]), whole.lap_steps)
    assert torch.equal(torch.cat([torch.from_numpy(part_done),
                                  resumed.lap_done]), whole.lap_done)
    assert torch.equal(resumed.final_x, whole.final_x)
    for a, b in zip(resumed.safe_set, whole.safe_set):
        assert torch.equal(a, b)
    assert resumed.lap_count == whole.lap_count == 1 + first + rest
    if kind == "generator":
        assert torch.equal(resumed.final_key, whole.final_key)
    else:
        assert resumed.final_key == whole.final_key
    if nlmpc:  # the lap's own statistics
        for a, b in zip(resumed.streaks, whole.streaks):
            assert torch.equal(a, b[first:])
    # the caller's safe set is not written into
    for a, b in zip(ck[0], part.safe_set):
        assert torch.equal(a, b)


def test_resume_needs_the_noise_its_key_names():
    part = _port_run(True, 1, **_noise("noise", 121))
    with pytest.raises(ValueError, match="noise rows"):
        _port_run(True, 1, resume_from=(part.safe_set, part.lap_count,
                                        part.final_key),
                  **_noise("generator", 0))
    part = _port_run(True, 1, **_noise("generator", 0))
    with pytest.raises(ValueError, match="generator"):
        _port_run(True, 1, resume_from=(part.safe_set, part.lap_count,
                                        part.final_key),
                  **_noise("noise", 242))


def test_checkpoint_keeps_the_jax_layout(tmp_path):
    part = _port_run(True, 1, **_noise("noise", 121))
    path = str(tmp_path / "run.npz")
    save_soa_run(path, part)
    with np.load(path) as z:
        assert set(z.files) == JAX_KEYS | {f"ss_{i}" for i in range(5)} | {
            "noise_rows"}
        assert int(z["num_ss_tensors"]) == 5 and int(z["lap_count"]) == 2
        for i, t in enumerate(part.safe_set):
            assert z[f"ss_{i}"].dtype == t.numpy().dtype
            np.testing.assert_array_equal(z[f"ss_{i}"], t.numpy())
    (ss, lap_count, key), steps, done = load_soa_run(path, device="cpu")
    assert lap_count == 2 and key == part.final_key
    np.testing.assert_array_equal(steps, part.lap_steps.numpy())
    np.testing.assert_array_equal(done, part.lap_done.numpy())
    for a, b in zip(ss, part.safe_set):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nlmpc", [False, True], ids=["i2lqr", "nlmpc"])
def test_jax_checkpoint_resumes_on_jax_draws_f64(nlmpc, tmp_path):
    """JAX runs a learning lap and checkpoints it (its save_soa_run); JAX
    and the port each resume it for one more lap, the port on the draws
    of the key in the file."""
    jp, jl, scen, seed_xs, seed_us = _setup(nlmpc)
    if nlmpc:
        sim = jns.simulate_nlmpc_runs_soa
        kw = dict(max_steps=T_ROWS, max_laps=MAX_LAPS, max_lm_iters=CAP)
        args = (jnp.asarray(seed_xs), jnp.asarray(seed_us))
    else:
        sim = jbs.simulate_learning_runs_soa
        kw = dict(max_steps=T_ROWS, max_laps=MAX_LAPS, solver_max_iter=CAP)
        args = (jnp.asarray(seed_xs), jnp.zeros((T_ROWS, 2)))
    part = sim(jp, jl, scen, *args, 121, 1.0, jax.random.PRNGKey(4),
               num_laps=1, **kw)
    path = str(tmp_path / "jax.npz")
    jck.save_soa_run(path, part)
    jresume, _, _ = jck.load_soa_run(path)
    jrest = sim(jp, jl, scen, *args, 121, 1.0, jresume[2], num_laps=1,
                resume_from=jresume, **kw)
    ck, steps, done = load_soa_run(path, device="cpu")
    assert ck[1] == 2 and ck[2] is None  # JAX's key drives JAX's noise
    np.testing.assert_array_equal(steps, np.asarray(part.lap_steps))
    noise = torch.from_numpy(_jax_draws(jresume[2], 121, B))
    tl = convert.system_limits(jl, device="cpu")
    ts = convert.scenarios(scen, device="cpu")
    if nlmpc:
        tr = simulate_nlmpc_runs_soa(
            convert.lmpc_params(jp, device="cpu"), tl, ts, None, None, 121,
            1.0, num_laps=1, noise=noise, resume_from=ck, **kw)
    else:
        tr = simulate_learning_runs_soa(
            convert.ilqr_params(jp, device="cpu"), tl, ts, None, None, 121,
            1.0, num_laps=1, noise=noise, resume_from=ck, **kw)
    np.testing.assert_array_equal(tr.lap_steps.numpy(),
                                  np.asarray(jrest.lap_steps))
    np.testing.assert_array_equal(tr.lap_done.numpy(),
                                  np.asarray(jrest.lap_done))
    assert tr.lap_count == int(jrest.lap_count) == 3
    np.testing.assert_allclose(tr.final_x.numpy(), np.asarray(jrest.final_x),
                               rtol=0, atol=1e-9)
    for t, j in zip(tr.safe_set, jrest.safe_set):
        np.testing.assert_allclose(t.numpy().astype(np.float64),
                                   np.asarray(j).astype(np.float64), rtol=0,
                                   atol=1e-9)
