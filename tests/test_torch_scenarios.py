"""The paper scenarios of the port (experiments/scenarios.py) against the
JAX package's: the moving geometries and the scenario list, each
scenario's obstacle schedule under a scripted controller over 7 laps
(which obstacle each lap sees, its motion and its per-lap trail), the
runner's ``obstacle_schedule`` and ``seed_safe_set`` hooks, and the file
``run_scenario`` writes. The i2LQR runs of tests/test_experiments.py are
a ``slow`` mirror."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_scripted import Scripted

from ilqr_iterative_tasks_torch.control.i2lqr import I2LqrController
from ilqr_iterative_tasks_torch.experiments import runner
from ilqr_iterative_tasks_torch.experiments import scenarios as scn
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import IlqrParams
from ilqr_iterative_tasks_tpu.control import i2lqr as jax_i2lqr
from ilqr_iterative_tasks_tpu.experiments import runner as jax_runner
from ilqr_iterative_tasks_tpu.experiments import scenarios as jax_scn
from ilqr_iterative_tasks_tpu.utils.params import IlqrParams as JaxParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XCL, UCL = seed_trajectory(1.0)
LAPS = 7  # laps 0-6: the injection at lap 5 and the removal at lap 6
CASES = [("no_obstacle", "up"), ("static_obstacle", "up"),
         ("add_static_obstacle", "up"), ("add_moving_obstacle", "up"),
         ("add_moving_obstacle", "left")]


def test_geometries_and_scenarios_match_jax():
    assert scn.MOVING_GEOMETRY == jax_scn.MOVING_GEOMETRY
    assert scn.SCENARIOS == jax_scn.SCENARIOS
    up, left = scn.MOVING_GEOMETRY["up"], scn.MOVING_GEOMETRY["left"]
    assert (up["x"], up["y"], up["width"], up["height"], up["spd"],
            up["moving_option"]) == (35.0, -16.0, 34.0, 34.0, 1.0, 1)
    assert (left["x"], left["y"], left["width"], left["height"],
            left["spd"], left["moving_option"]) == (50.0, -1.0, 35.0, 35.0,
                                                    0.2, 2)
    with pytest.raises(ValueError, match="unknown scenario"):
        scn.build_schedule("moving", 1.0)


def _run(mod, scenarios, scenario, option):
    """A scripted run of a scenario's schedule; returns the result and the
    obstacle the controller held at each lap's start."""
    obstacle, schedule = scenarios.build_schedule(scenario, 1.0, option)
    ctrl, seen = Scripted(np.concatenate([UCL] * LAPS), obstacle), []

    def logged(lap, controller):
        if schedule is not None:
            schedule(lap, controller)
        seen.append(controller.obstacle)

    res = mod.run_closed_loop(ctrl, LAPS, goal_fixup="snap",
                              obstacle_schedule=logged)
    return res, seen


def _geometry(obs):
    return None if obs is None else (obs.x0, obs.y0, obs.width, obs.height,
                                     obs.spd, obs.moving_option)


@pytest.mark.parametrize("scenario,option", CASES)
def test_schedules_match_jax_at_every_lap(scenario, option):
    (res, ours), (jres, theirs) = (_run(runner, scn, scenario, option),
                                   _run(jax_runner, jax_scn, scenario,
                                        option))
    assert res.all_lap_times == jres.all_lap_times
    assert res.lap_finished == jres.lap_finished == [True] * LAPS
    assert len(ours) == len(theirs) == LAPS
    present = [o is not None for o in ours]
    assert present == [o is not None for o in theirs]
    for a, b in zip(ours, theirs):
        assert _geometry(a) == _geometry(b)
        if a is not None:
            # the trail of every lap the obstacle was in
            assert len(a.lap_states) == len(b.lap_states) > 0
            for sa, sb in zip(a.lap_states, b.lap_states):
                np.testing.assert_array_equal(sa, sb)
    if scenario in ("add_static_obstacle", "add_moving_obstacle"):
        assert present == [lap == scn.INJECT_LAP for lap in range(LAPS)]
        trail = ours[scn.INJECT_LAP].lap_states
        assert len(trail) == 1 and len(trail[0]) == len(UCL) + 1
        moved = trail[0][-1] - trail[0][0]
        want = {"up": [0.0, 1.0], "left": [-0.2, 0.0]}.get(option)
        if scenario == "add_moving_obstacle":
            np.testing.assert_allclose(moved, np.array(want) * len(UCL))
    elif scenario == "static_obstacle":
        assert all(o is ours[0] for o in ours)
        assert len(ours[0].lap_states) == LAPS
    else:
        assert not any(present)


def test_seed_safe_set_false_leaves_the_safe_set_alone():
    for mod in (runner, jax_runner):
        ctrl = Scripted(UCL)
        res = mod.run_closed_loop(ctrl, 1, seed_safe_set=False)
        assert len(ctrl.laps) == 1 and res.lap_finished == [True]
        ctrl = Scripted(UCL)
        mod.run_closed_loop(ctrl, 1)
        assert len(ctrl.laps) == 2


def test_default_obstacle_signature_matches_jax():
    for for_nlmpc in (False, True):
        ours = runner.default_obstacle(1.0, for_nlmpc=for_nlmpc)
        theirs = jax_runner.default_obstacle(1.0, for_nlmpc=for_nlmpc)
        assert _geometry(ours) == _geometry(theirs)


LOCKSTEP_STEPS = 12  # of the moving lap; all of laps 5-7 in the slow test


def _recorded(option):
    """The JAX package's f64 i2LQR run of the moving scenario (8 laps),
    as its ``save_run`` wrote it: the slow test
    test_the_recorded_jax_f64_runs_are_the_jax_package_s remakes it."""
    return os.path.join(REPO, "data", "jax_f64",
                        f"ego_ilqr_ss_8_add_moving_obstacle_{option}.npz")


def _f64_i2lqr(option):
    obstacle, schedule = scn.build_schedule("add_moving_obstacle", 1.0,
                                            option)
    return I2LqrController(IlqrParams.make(dtype=torch.float64,
                                           device="cpu"),
                           obstacle=obstacle, dtype=torch.float64,
                           device="cpu"), schedule


@pytest.mark.parametrize("option", ["up", "left"])
def test_moving_lap_decisions_match_jax_in_lockstep(option):
    """The i2LQR moving-obstacle lap in f64 on the CPU route, in lockstep
    with the JAX package's recorded run: the port's controller holds the
    JAX run's seed lap and 5 laps before the injection, is given the JAX
    run's state at every step and makes the JAX controller's decision:
    its input within 1e-8 of the recorded one over the first steps of the
    moving lap, where the obstacle sweeps the track (all of laps 5-7 in
    test_the_whole_moving_run_matches_jax_in_lockstep)."""
    ctrl, schedule = _f64_i2lqr(option)
    worst = scn.replay_lockstep(ctrl, _recorded(option), scn.INJECT_LAP,
                                schedule, steps=LOCKSTEP_STEPS)
    assert len(worst) == 1 and worst[0] <= 1e-8, worst
    assert ctrl.obstacle is not None and ctrl.obstacle.spd > 0


@pytest.mark.parametrize("shift", [0.0, 0.25])
def test_replay_lockstep_holds_a_recorded_run(shift, tmp_path):
    """replay_lockstep on a scripted run of the moving scenario (7 laps,
    recorded with save_run): a controller that repeats the recorded
    inputs meets them exactly on laps 5 and 6, one whose inputs are
    shifted misses them by the shift; ``steps`` stops within lap 5; the
    replayed controller ends holding the recorded run's safe set."""
    from ilqr_iterative_tasks_torch.control.safe_set import SafeSet
    from ilqr_iterative_tasks_torch.utils.checkpoint import load_run, save_run
    obstacle, schedule = scn.build_schedule("add_moving_obstacle", 1.0, "up")
    ctrl = Scripted(np.concatenate([UCL] * LAPS), obstacle, SafeSet())
    res = runner.run_closed_loop(ctrl, LAPS, goal_fixup="snap",
                                 obstacle_schedule=schedule)
    path = str(tmp_path / "run.npz")
    save_run(path, res, ctrl)
    rec = load_run(path)
    us = np.concatenate([rec["lap_input_5"], rec["lap_input_6"]])
    replay = Scripted(us + shift)
    assert scn.replay_lockstep(replay, path, scn.INJECT_LAP,
                               schedule) == [shift, shift]
    assert len(replay.laps) == len(ctrl.laps) == LAPS + 1
    for (x, u), (x_rec, u_rec) in zip(replay.laps, ctrl.laps):
        np.testing.assert_array_equal(x, x_rec)
        np.testing.assert_array_equal(u, u_rec)
    assert replay.obstacle is None
    short = Scripted(us + shift)
    assert scn.replay_lockstep(short, path, scn.INJECT_LAP, schedule,
                               steps=3) == [shift]
    assert short.k == 3 and short.obstacle.spd == 1.0


@pytest.mark.slow
@pytest.mark.parametrize("option", ["up", "left"])
def test_the_whole_moving_run_matches_jax_in_lockstep(option):
    """As above over every step of the moving lap and the two laps after
    it (77 + 86 + 62 steps up, 39 + 37 + 35 left): each of the port's
    inputs within 1e-8 of the JAX run's, so every decision (the kNN
    candidates, the relaxation buckets, the horizon) is JAX's. Closed
    loop the port's laps from the injection on differ all the same
    (chip_smoke.py's SCENARIO_F64_CPU_PORT): the JAX run itself changes
    its laps under a perturbation of 1e-12 (the test below)."""
    ctrl, schedule = _f64_i2lqr(option)
    worst = scn.replay_lockstep(ctrl, _recorded(option), scn.INJECT_LAP,
                                schedule)
    assert len(worst) == 3 and max(worst) <= 1e-8, worst


def _jax_moving_run(option, save_path=None, laps=8, first=None, axis=0,
                    eps=0.0):
    """The JAX package's f64 i2LQR run of the moving scenario; with
    ``first`` (a saved run), resumed from its seed lap and laps 0-4 and
    run on over laps 5-7 with the state at the first step of lap 5 moved
    by ``eps`` along ``axis``."""
    from ilqr_iterative_tasks_tpu.utils import checkpoint as jax_ckpt
    obstacle, schedule = jax_scn.build_schedule("add_moving_obstacle", 1.0,
                                                option)
    ctrl = jax_i2lqr.I2LqrController(JaxParams.make(dtype=jnp.float64),
                                     obstacle=obstacle, dtype=jnp.float64)
    if first is None:
        res = jax_runner.run_closed_loop(ctrl, laps, goal_fixup="snap",
                                         obstacle_schedule=schedule)
        if save_path is not None:
            jax_ckpt.save_run(save_path, res, ctrl)
        return [int(t) for t in res.lap_times]
    for x, u in jax_ckpt.restore_safe_set(first)[:scn.INJECT_LAP + 1]:
        ctrl.add_trajectory(x, u)
    set_state, moved = ctrl.set_state, []

    def perturbed(x):
        x = np.array(x, dtype=np.float64)
        if not moved:
            moved.append(True)
            x[axis] += eps
        set_state(x)

    ctrl.set_state = perturbed
    res = jax_runner.run_closed_loop(
        ctrl, laps - scn.INJECT_LAP, goal_fixup="snap", seed_safe_set=False,
        obstacle_schedule=lambda lap, c: schedule(lap + scn.INJECT_LAP, c))
    return [int(t) for t in res.lap_times]


@pytest.mark.slow
@pytest.mark.parametrize("option", ["up", "left"])
def test_the_recorded_jax_f64_runs_are_the_jax_package_s(option, tmp_path):
    """data/jax_f64/: the JAX package's run, remade here, gives the same
    laps, safe set, states and inputs (the solver's wall times aside)."""
    path = tmp_path / "run.npz"
    laps = _jax_moving_run(option, save_path=str(path))
    assert laps == _chip_smoke().SCENARIO_F64["ilqr", option]
    with np.load(path) as z, np.load(_recorded(option)) as rec:
        assert sorted(z.files) == sorted(rec.files)
        for key in z.files:
            if not key.startswith("lap_solver_time"):
                np.testing.assert_array_equal(z[key], rec[key], err_msg=key)


@pytest.mark.slow
@pytest.mark.parametrize("axis,eps", [
    (0, 0.0), (0, 1e-12), (1, 1e-12), (2, 1e-12), (3, 1e-12), (0, -1e-12),
    (1, 1e-14), (2, 1e-15)])
@pytest.mark.parametrize("option", ["up", "left"])
def test_jax_itself_follows_last_bits_on_the_moving_lap(option, axis, eps):
    """The JAX package's own run resumed before the injection gives its
    recorded laps 5-7 exactly, and other laps once the state at the
    moving lap's first step moves by 1e-15 to 1e-12 along one axis (on
    XLA:CPU, up: lap 5 of 66-89 steps and laps 6-7 unfinished, against
    [77, 86, 62]; left: laps 6-7 of 36-121 steps, against [39, 37, 35])."""
    want = _chip_smoke().SCENARIO_F64["ilqr", option][scn.INJECT_LAP:]
    laps = _jax_moving_run(option, first=_recorded(option), axis=axis,
                           eps=eps)
    print(option, axis, eps, laps)
    assert (laps == want) == (eps == 0.0), laps


@pytest.mark.parametrize("kind,laps", [("ilqr", 0), ("nlmpc", 1)])
def test_run_scenario_writes_one_file_with_the_jax_keys(kind, laps,
                                                        tmp_path):
    """The port's run on the CPU and the JAX package's each write one
    ``ego_*.npz`` of the same name, keys, dtypes, shapes and lap records
    (i2LQR: the seed lap only; NLMPC: one learning lap, whose f32 states
    agree only at decision level, CPU f32 against XLA:CPU f32: equal lap
    times and feasibility)."""
    ours_dir, theirs_dir = tmp_path / "ours", tmp_path / "theirs"
    res = scn.run_scenario(kind, "static_obstacle", lap_number=laps,
                           save_dir=str(ours_dir), device="cpu")
    jres = jax_scn.run_scenario(kind, "static_obstacle", lap_number=laps,
                                save_dir=str(theirs_dir))
    assert res.all_lap_times == jres.all_lap_times
    files = os.listdir(ours_dir)
    assert files == os.listdir(theirs_dir) == [
        f"ego_{kind}_ss_8_static_obstacle.npz"]
    with np.load(ours_dir / files[0], allow_pickle=False) as z, \
            np.load(theirs_dir / files[0], allow_pickle=False) as jz:
        assert sorted(z.files) == sorted(jz.files)
        for key in z.files:
            assert z[key].dtype.kind == jz[key].dtype.kind, key
            assert z[key].shape == jz[key].shape, key
            if key in ("num_laps", "lap_times", "seed_time", "lap_finished",
                       "ss_x_0", "ss_u_0") or key.startswith(
                           "lap_feasibility"):
                np.testing.assert_array_equal(z[key], jz[key], err_msg=key)


def test_the_default_save_directory_is_apart_from_the_jax_artifacts():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert scn.SAVE_DIR == os.path.join(repo, "data", "torch")
    assert scn.scenario_tag("ilqr", "add_moving_obstacle", 8, "left") == \
        "ilqr_ss_8_add_moving_obstacle_left"


@pytest.mark.slow
@pytest.mark.parametrize("scenario", ["no_obstacle", "add_static_obstacle"])
def test_scenarios_run(scenario, tmp_path):
    """tests/test_experiments.py::test_scenarios_run on the port (CPU)."""
    res = scn.run_scenario("ilqr", scenario, lap_number=3,
                           save_dir=str(tmp_path), device="cpu")
    assert all(res.lap_finished)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".npz")


def _chip_smoke():
    """chip_smoke.py as a module, for the laps it pins."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["ilqr", "nlmpc"])
def test_the_pinned_f32_scenario_laps_are_the_jax_package_s(kind):
    """chip_smoke.py's SCENARIO_F32: the JAX package's ``run_scenario`` on
    XLA:CPU in f32, 8 laps a scenario (how the constants were made)."""
    cs = _chip_smoke()
    for scenario, option in cs.SCENARIO_CASES:
        res = jax_scn.run_scenario(kind, scenario, lap_number=8,
                                   moving_option=option, save_dir=None)
        tag = scn.scenario_tag(kind, scenario, 8, option)
        assert ([int(t) for t in res.lap_times],
                [bool(f) for f in res.lap_finished]) == cs.SCENARIO_F32[tag]


@pytest.mark.slow
@pytest.mark.parametrize("kind,option", [("ilqr", "up"), ("ilqr", "left"),
                                         ("nlmpc", "up"), ("nlmpc", "left")])
def test_the_pinned_f64_moving_laps(kind, option):
    """chip_smoke.py's SCENARIO_F64 (the JAX package's f64 laps, every lap
    finished) and SCENARIO_F64_CPU_PORT (the port's CPU route, where it
    differs: i2LQR, whose laps from the injection on follow last bits),
    each through build_schedule and run_closed_loop, 8 laps."""
    cs = _chip_smoke()
    laps = {}
    for mod, scenarios in ((runner, scn), (jax_runner, jax_scn)):
        obstacle, schedule = scenarios.build_schedule(
            "add_moving_obstacle", 1.0, option)
        if kind == "nlmpc":
            from ilqr_iterative_tasks_torch.control.nlmpc import (
                NlmpcController)
            from ilqr_iterative_tasks_torch.utils.params import LmpcParams
            from ilqr_iterative_tasks_tpu.control import nlmpc as jax_nlmpc
            from ilqr_iterative_tasks_tpu.utils.params import (
                LmpcParams as JaxLmpc)
            ctrl = (NlmpcController(LmpcParams.make(device="cpu"),
                                    obstacle=obstacle, dtype=torch.float64,
                                    device="cpu") if mod is runner else
                    jax_nlmpc.NlmpcController(JaxLmpc.make(),
                                              obstacle=obstacle,
                                              dtype=jnp.float64))
            fixup = None
        else:
            ctrl = (I2LqrController(IlqrParams.make(dtype=torch.float64,
                                                    device="cpu"),
                                    obstacle=obstacle, dtype=torch.float64,
                                    device="cpu") if mod is runner else
                    jax_i2lqr.I2LqrController(
                        JaxParams.make(dtype=jnp.float64), obstacle=obstacle,
                        dtype=jnp.float64))
            fixup = "snap"
        res = mod.run_closed_loop(ctrl, 8, goal_fixup=fixup,
                                  obstacle_schedule=schedule)
        laps[mod is runner] = [int(t) for t in res.lap_times]
        if mod is jax_runner:
            assert all(res.lap_finished)
    assert laps[False] == cs.SCENARIO_F64[kind, option]
    assert laps[True] == cs.SCENARIO_F64_CPU_PORT.get(
        (kind, option), cs.SCENARIO_F64[kind, option])
