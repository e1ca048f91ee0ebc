"""The host half of the port's utils/checkpoint.py against the JAX
package's, in f64 on the CPU: ``save_run`` writes the JAX file's keys and
arrays (for a scripted run through each package's runner, and for
controllers that hold the same seed lap plus one JAX learning lap), each
package loads and resumes from the other's file, and a committed JAX
artifact (``data/ego_*.npz``) resumes a port controller whose safe set
equals the resumed JAX controller's and whose next ``calc_input`` matches
it to 1e-8. The 2 + 1 lap resume of ``tests/test_experiments.py`` is a
``slow`` mirror."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_scripted import Scripted

from ilqr_iterative_tasks_torch.control.i2lqr import I2LqrController
from ilqr_iterative_tasks_torch.control.nlmpc import NlmpcController
from ilqr_iterative_tasks_torch.control.safe_set import SafeSet
from ilqr_iterative_tasks_torch.experiments import runner
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils import checkpoint
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, LmpcParams
from ilqr_iterative_tasks_tpu.control import i2lqr as jax_i2lqr
from ilqr_iterative_tasks_tpu.control import nlmpc as jax_nlmpc
from ilqr_iterative_tasks_tpu.control.safe_set import SafeSet as JaxSafeSet
from ilqr_iterative_tasks_tpu.experiments import runner as jax_runner
from ilqr_iterative_tasks_tpu.utils import checkpoint as jax_checkpoint
from ilqr_iterative_tasks_tpu.utils.params import IlqrParams as JaxParams
from ilqr_iterative_tasks_tpu.utils.params import LmpcParams as JaxLmpc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
TOL = 1e-8
XCL, UCL = seed_trajectory(1.0)
ARTIFACTS = {"ilqr": "ego_ilqr_ss_8_static_obstacle.npz",
             "nlmpc": "ego_nlmpc_ss_8_no_obstacle.npz"}


def _same_files(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype.kind == b[key].dtype.kind, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("goal_fixup", ["snap", "append", None])
def test_save_run_of_a_scripted_run_matches_jax(goal_fixup, tmp_path):
    """Two laps of the seed lap's inputs through each package's runner:
    the two files hold the same keys and arrays (solver times aside,
    which are each plant's wall clock), every entry numeric."""
    files = []
    for mod, ck, ss in ((runner, checkpoint, SafeSet),
                        (jax_runner, jax_checkpoint, JaxSafeSet)):
        ctrl = Scripted(np.concatenate([UCL, UCL]), safe_set=ss())
        res = mod.run_closed_loop(ctrl, 2, goal_fixup=goal_fixup)
        path = str(tmp_path / f"{mod.__name__}.npz")
        ck.save_run(path, res, ctrl)
        with np.load(path, allow_pickle=False) as z:
            files.append({k: z[k] for k in z.files})
    ours, theirs = files
    for lap in range(2):
        key = f"lap_solver_time_{lap}"
        assert ours[key].shape == theirs[key].shape
        assert ours[key].dtype == np.float64
        ours[key] = theirs[key]
    _same_files(ours, theirs)
    assert int(ours["num_laps"]) == 3
    assert ours["ss_x_0"].shape == (4, len(XCL))


@pytest.fixture(scope="module")
def jax_lap():
    """One zero-noise f64 learning lap of the JAX host i2LQR controller
    (CI configuration): its result and controller."""
    ctrl = jax_i2lqr.I2LqrController(
        JaxParams.make(dtype=jnp.float64),
        obstacle=jax_runner.default_obstacle(1.0), dtype=jnp.float64)
    res = jax_runner.run_closed_loop(ctrl, 1, goal_fixup="append")
    return res, ctrl


def _port_holding(jax_ctrl):
    """A port controller on the CPU holding the JAX controller's laps."""
    ours = I2LqrController(IlqrParams.make(dtype=F64, device="cpu"),
                           obstacle=runner.default_obstacle(1.0), dtype=F64,
                           device="cpu")
    for x, u in zip(jax_ctrl.safe_set.ss, jax_ctrl.safe_set.u_ss):
        ours.add_trajectory(x.T, u.T)
    return ours


def test_save_run_of_a_learning_lap_matches_jax(jax_lap, tmp_path):
    res, jax_ctrl = jax_lap
    ours = _port_holding(jax_ctrl)
    checkpoint.save_run(str(tmp_path / "ours.npz"), res, ours)
    jax_checkpoint.save_run(str(tmp_path / "theirs.npz"), res, jax_ctrl)
    _same_files(checkpoint.load_run(str(tmp_path / "ours.npz")),
                jax_checkpoint.load_run(str(tmp_path / "theirs.npz")))


def _same_safe_set(ours, theirs):
    assert ours.num_laps == theirs.num_laps
    for name in ("ss", "u_ss", "Qfun"):
        for a, b in zip(getattr(ours, name), getattr(theirs, name)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    assert ours.iter_cost == theirs.iter_cost


def test_each_package_loads_and_resumes_from_the_others_file(jax_lap,
                                                              tmp_path):
    res, jax_ctrl = jax_lap
    ours_path, theirs_path = str(tmp_path / "o.npz"), str(tmp_path / "t.npz")
    checkpoint.save_run(ours_path, res, _port_holding(jax_ctrl))
    jax_checkpoint.save_run(theirs_path, res, jax_ctrl)
    _same_files(checkpoint.load_run(theirs_path),
                jax_checkpoint.load_run(ours_path))
    for a, b in zip(checkpoint.restore_safe_set(theirs_path),
                    jax_checkpoint.restore_safe_set(ours_path)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    resumed = checkpoint.resume_controller(
        I2LqrController(IlqrParams.make(dtype=F64, device="cpu"), dtype=F64,
                        device="cpu"), theirs_path)
    jax_resumed = jax_checkpoint.resume_controller(
        jax_i2lqr.I2LqrController(JaxParams.make(dtype=jnp.float64),
                                  dtype=jnp.float64), ours_path)
    assert resumed.iter == jax_resumed.iter == 2
    _same_safe_set(resumed.safe_set, jax_resumed.safe_set)
    _same_safe_set(resumed.safe_set, jax_ctrl.safe_set)
    np.testing.assert_array_equal(resumed.x_terminal_guess,
                                  jax_resumed.x_terminal_guess)


def _artifact_controllers(kind):
    """A port controller (CPU, f64) and a JAX one, in the configuration
    the artifact was run in (experiments/scenarios.py), each resumed from
    the committed file."""
    path = os.path.join(REPO, "data", ARTIFACTS[kind])
    if kind == "ilqr":
        obstacle = runner.default_obstacle(1.0)
        ours = I2LqrController(IlqrParams.make(dtype=F64, device="cpu"),
                               obstacle=obstacle, dtype=F64, device="cpu")
        theirs = jax_i2lqr.I2LqrController(
            JaxParams.make(dtype=jnp.float64),
            obstacle=jax_runner.default_obstacle(1.0), dtype=jnp.float64)
    else:
        ours = NlmpcController(LmpcParams.make(device="cpu"), dtype=F64,
                               device="cpu")
        theirs = jax_nlmpc.NlmpcController(JaxLmpc.make(),
                                           dtype=jnp.float64)
    for c, ck in ((ours, checkpoint), (theirs, jax_checkpoint)):
        ck.resume_controller(c, path)
        c.set_timestep(1.0)
        c.set_state(np.zeros(4))
    return ours, theirs


@pytest.mark.parametrize("kind", ["ilqr", "nlmpc"])
def test_a_committed_jax_artifact_resumes_a_port_controller(kind):
    ours, theirs = _artifact_controllers(kind)
    assert ours.iter == theirs.iter == 9  # the seed lap and 8 laps
    _same_safe_set(ours.safe_set, theirs.safe_set)
    ours.calc_input()
    theirs.calc_input()
    for name in ("u", "x_pred", "u_pred"):
        np.testing.assert_allclose(getattr(ours, name),
                                   np.asarray(getattr(theirs, name)),
                                   rtol=0, atol=TOL, err_msg=name)
    assert ours.num_horizon == theirs.num_horizon


def test_every_payload_entry_is_numeric(jax_lap, tmp_path):
    """The plant's per-lap records are numeric ndarrays: the file loads
    with allow_pickle=False, each entry's dtype a number or a bool."""
    res, jax_ctrl = jax_lap
    path = str(tmp_path / "run.npz")
    checkpoint.save_run(path, res, _port_holding(jax_ctrl))
    data = checkpoint.load_run(path)
    assert all(v.dtype.kind in "biuf" for v in data.values())
    assert data["lap_feasibility_0"].dtype.kind == "i"


@pytest.mark.slow
def test_checkpoint_roundtrip_and_resume(tmp_path):
    """tests/test_experiments.py::test_checkpoint_roundtrip_and_resume on
    the port (f32, CPU): 2 laps, a checkpoint, a fresh controller resumed
    from it for 1 lap no slower than the last uninterrupted one."""
    make = lambda: I2LqrController(IlqrParams.make(device="cpu"),
                                   obstacle=runner.default_obstacle(1.0),
                                   device="cpu")
    ctrl = make()
    res = runner.run_closed_loop(ctrl, lap_number=2, goal_fixup="append")
    path = str(tmp_path / "run.npz")
    checkpoint.save_run(path, res, ctrl)
    assert int(checkpoint.load_run(path)["num_laps"]) == 3
    ctrl2 = checkpoint.resume_controller(make(), path)
    assert ctrl2.iter == 3
    np.testing.assert_allclose(ctrl2.safe_set.ss[1], ctrl.safe_set.ss[1])
    res2 = runner.run_closed_loop(ctrl2, lap_number=1, goal_fixup="append",
                                  seed_safe_set=False)
    assert res2.lap_finished[-1]
    assert res2.lap_times[-1] <= res.lap_times[-1]


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["ilqr", "nlmpc"])
def test_the_pinned_resume_laps_are_the_jax_package_s(kind, tmp_path):
    """chip_smoke.py's RESUME_FIRST / RESUME_LAP (and, for NLMPC,
    ARTIFACT_RESUMED_LAP): the JAX package's host controllers in f64, 2
    laps, ``save_run``, a fresh controller resumed, 1 lap (how the
    constants were made)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if kind == "ilqr":
        make = lambda obstacle: jax_i2lqr.I2LqrController(
            JaxParams.make(dtype=jnp.float64), obstacle=obstacle,
            dtype=jnp.float64)
        fixup = "append"
    else:
        make = lambda obstacle: jax_nlmpc.NlmpcController(
            JaxLmpc.make(), obstacle=obstacle, dtype=jnp.float64)
        fixup = None
    ctrl = make(jax_runner.default_obstacle(1.0))
    res = jax_runner.run_closed_loop(ctrl, 2, goal_fixup=fixup)
    path = str(tmp_path / "run.npz")
    jax_checkpoint.save_run(path, res, ctrl)
    resumed = jax_checkpoint.resume_controller(
        make(jax_runner.default_obstacle(1.0)), path)
    res2 = jax_runner.run_closed_loop(resumed, 1, goal_fixup=fixup,
                                      seed_safe_set=False)
    assert [int(t) for t in res.lap_times] == cs.RESUME_FIRST[kind]
    assert [int(t) for t in res2.lap_times] == cs.RESUME_LAP[kind]
    if kind == "nlmpc":
        artifact = jax_checkpoint.resume_controller(
            make(None), os.path.join(REPO, "data", ARTIFACTS["nlmpc"]))
        res3 = jax_runner.run_closed_loop(artifact, 1, goal_fixup=None,
                                          seed_safe_set=False)
        assert [int(t) for t in res3.lap_times] == cs.ARTIFACT_RESUMED_LAP
