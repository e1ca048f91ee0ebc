"""The host tier's numpy side against the JAX package's: the safe set, the
plant (noise draws and states on one numpy seed), the obstacle, the lap
simulator (121-step budget, goal tolerance 0.8), the runner's goal fix-ups
with a scripted controller, the recorded-lap loader, and the plant's one
caught exception (a kernel, build or CUDA error fails the run)."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from ilqr_iterative_tasks_torch.control.safe_set import SafeSet
from ilqr_iterative_tasks_torch.experiments import runner
from ilqr_iterative_tasks_torch.sim import plant as plant_mod
from ilqr_iterative_tasks_torch.sim.seed import (
    load_recorded_trajectory, seed_trajectory)
from ilqr_iterative_tasks_torch.sim.simulator import Simulator
from ilqr_iterative_tasks_tpu.control.safe_set import SafeSet as JaxSafeSet
from ilqr_iterative_tasks_tpu.experiments import runner as jax_runner
from ilqr_iterative_tasks_tpu.sim import plant as jax_plant
from ilqr_iterative_tasks_tpu.sim.seed import (
    load_recorded_trajectory as jax_load)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XCL, UCL = seed_trajectory(1.0)


@pytest.fixture
def jax_plant_writable(monkeypatch):
    """The JAX plant adds its noise into ``np.asarray`` of a JAX array,
    which this JAX version hands out read-only: give it a writable copy
    of the same step (its dynamics and noise code unchanged)."""
    step = jax_plant.dyn.step
    monkeypatch.setattr(jax_plant, "dyn", SimpleNamespace(
        step=lambda x, u, dt: np.array(step(x, u, dt))))


class Scripted:
    """A controller of the ControlBase API that applies ``us`` in turn
    (the last one after they run out) and stores every lap it is given."""

    def __init__(self, us, obstacle=None, fail=None):
        self.us, self.k, self.obstacle, self.fail = us, 0, obstacle, fail
        self.laps = []
        self.u = None

    def set_timestep(self, dt):
        self.dt = dt

    def set_state(self, x):
        self.x = np.asarray(x)

    def calc_input(self):
        if self.fail is not None and self.k == 3:
            self.k += 1
            raise self.fail
        self.u = np.asarray(self.us[min(self.k, len(self.us) - 1)])
        self.k += 1

    def get_input(self):
        return self.u

    def add_trajectory(self, x, u):
        self.laps.append((np.asarray(x).copy(), np.asarray(u).copy()))


def _both_safe_sets(laps):
    ours, theirs = SafeSet(), JaxSafeSet()
    for x, u in laps:
        ours.add_trajectory(x, u)
        theirs.add_trajectory(x, u)
    return ours, theirs


def test_safe_set_qfun_knn_ties_and_windows():
    rng = np.random.default_rng(0)
    x2 = XCL[::2].copy()
    x2[5:9] = x2[5]  # repeated states: L1 ties in the kNN
    laps = [(XCL, UCL), (x2, UCL[: len(x2) - 1])]
    ours, theirs = _both_safe_sets(laps)
    assert ours.num_laps == theirs.num_laps == 2
    for a, b in zip(ours.Qfun, theirs.Qfun):
        np.testing.assert_array_equal(a, b)
    assert ours.iter_cost == theirs.iter_cost
    for lap in range(2):
        for guess in [x2[5], XCL[40] + rng.normal(size=4), np.zeros(4)]:
            for k in (1, 8, 200):
                np.testing.assert_array_equal(
                    ours.select_close(lap, guess, k),
                    theirs.select_close(lap, guess, k))
        pts, q, idx = ours.select_points(lap, x2[5], 8)
        jpts, jq, jidx = theirs.select_points(lap, x2[5], 8)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(pts, jpts)
        np.testing.assert_array_equal(q, jq)
    for all_pts in (False, True):
        for a, b in zip(ours.time_varying_windows(6, 8, all_pts),
                        theirs.time_varying_windows(6, 8, all_pts)):
            np.testing.assert_array_equal(a, b)


def _drive(mod, rng_seed, zero_noise, us, steps):
    plant = mod.BicyclePlant(rng=np.random.default_rng(rng_seed))
    plant.set_state(np.zeros(4))
    plant.set_timestep(1.0)
    if zero_noise:
        plant.set_zero_noise()
    plant.set_ctrl_policy(Scripted(us))
    for _ in range(steps):
        plant.forward_one_step()
    return plant


@pytest.mark.parametrize("zero_noise", [False, True])
def test_plant_noise_draws_and_states_match_jax(zero_noise,
                                                jax_plant_writable):
    ours = _drive(plant_mod, 3, zero_noise, UCL, 40)
    theirs = _drive(jax_plant, 3, zero_noise, UCL, 40)
    np.testing.assert_allclose(np.stack(ours.states), np.stack(theirs.states),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(np.stack(ours.inputs),
                                  np.stack(theirs.inputs))
    assert ours.feasibility == theirs.feasibility == [1] * 40
    # the same draws were consumed: the generators agree afterwards
    assert ours.rng.standard_normal() == theirs.rng.standard_normal()


def test_obstacle_motion_and_reset_match_jax():
    for option, spd in [(1, 0.5), (2, 1.5), (None, 0)]:
        ours = plant_mod.ObstacleSim(10.0, -6.0, 3.0, 2.0, spd=spd,
                                     timestep=1.0, moving_option=option)
        theirs = jax_plant.ObstacleSim(10.0, -6.0, 3.0, 2.0, spd=spd,
                                       timestep=1.0, moving_option=option)
        for lap in range(2):
            for _ in range(3 + lap):
                ours.update()
                theirs.update()
            assert (ours.x, ours.y) == (theirs.x, theirs.y)
            ours.reset()
            theirs.reset()
            assert (ours.x, ours.y) == (10.0, -6.0)
        for a, b in zip(ours.lap_states, theirs.lap_states):
            np.testing.assert_array_equal(a, b)
        obs = ours.as_pytree(device="cpu")
        assert float(obs.present) == 1.0 and float(obs.width) == 3.0


def test_simulator_budget_and_goal_tolerance():
    # zero input: the car never moves, the lap ends at the 121-step budget
    plant = plant_mod.BicyclePlant()
    plant.set_state(np.zeros(4))
    plant.set_timestep(1.0)
    plant.set_zero_noise()
    plant.set_ctrl_policy(Scripted([np.zeros(2)]))
    sim = Simulator()
    sim.set_robotic(plant)
    sim.set_timestep(1.0)
    sim.set_goal(XCL[-1])
    assert sim.sim(0, sim_time=5.0) is False  # the budget, not sim_time
    assert len(plant.data["timestamp"][-1]) == 121
    # a goal 0.8 away is reached at once, 0.81 away never
    for dist, finished, steps in [(0.8, True, 1), (0.81, False, 121)]:
        sim.set_goal(np.array([dist, 0.0, 0.0, 0.0]))
        assert sim.sim(1) is finished
        assert len(plant.data["timestamp"][-1]) == steps
    assert sim.lap_finished == [False, True, False]


@pytest.mark.parametrize("goal_fixup", ["snap", "append", None])
@pytest.mark.parametrize("zero_noise", [True, False])
def test_run_closed_loop_with_a_scripted_controller_matches_jax(
        goal_fixup, zero_noise, jax_plant_writable):
    """The seed lap's inputs replayed twice: lap records, goal fix-ups and
    the controller's stored laps equal the JAX runner's."""
    out = []
    for mod in (runner, jax_runner):
        ctrl = Scripted(np.concatenate([UCL, UCL]))
        res = mod.run_closed_loop(ctrl, 2, zero_noise=zero_noise,
                                  goal_fixup=goal_fixup,
                                  rng=np.random.default_rng(5))
        out.append((res, ctrl))
    (res, ctrl), (jres, jctrl) = out
    assert res.all_lap_times == jres.all_lap_times
    assert res.lap_finished == jres.lap_finished
    for key in ("state", "input", "timestamp"):
        for a, b in zip(res.plant.data[key], jres.plant.data[key]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    assert len(ctrl.laps) == len(jctrl.laps) == 3
    for (x, u), (jx, ju) in zip(ctrl.laps, jctrl.laps):
        np.testing.assert_allclose(x, jx, rtol=0, atol=1e-10)
        np.testing.assert_array_equal(u, ju)
    first = res.plant.data["state"][0]
    if goal_fixup == "snap":
        np.testing.assert_array_equal(first[-1], XCL[-1])
    elif goal_fixup == "append":
        np.testing.assert_array_equal(first[-1], XCL[-1])
        assert len(first) == len(res.plant.data["input"][0]) + 2


def test_load_recorded_trajectory_matches_jax():
    paths = (os.path.join(REPO, "data", "closed_loop_multi_laps.txt"),
             os.path.join(REPO, "data", "input_multi_laps.txt"))
    xcl, ucl = load_recorded_trajectory(*paths)
    jx, ju = jax_load(*paths)
    assert xcl.shape[1] == 4 and ucl.shape[1] == 2
    assert xcl.shape[0] == ucl.shape[0] + 1
    np.testing.assert_array_equal(xcl, jx)
    np.testing.assert_array_equal(ucl, ju)


def test_plant_records_only_infeasible_steps_and_propagates_errors(
        jax_plant_writable):
    """InfeasibleStep is recorded (feasibility 0, previous input held);
    any other RuntimeError, as a failed kernel launch raises, propagates
    (the JAX plant would record it as an infeasible step)."""
    plant = plant_mod.BicyclePlant()
    plant.set_state(np.zeros(4))
    plant.set_timestep(1.0)
    plant.set_zero_noise()
    err = plant_mod.InfeasibleStep("no feasible candidate")
    plant.set_ctrl_policy(Scripted(UCL, fail=err))
    for _ in range(5):
        plant.forward_one_step()
    assert plant.feasibility == [1, 1, 1, 0, 1]
    np.testing.assert_array_equal(plant.inputs[3], plant.inputs[2])
    assert plant.infeasible_errors == [err]

    launch_failed = RuntimeError("fused_ilqr: CUDA launch failed")
    for mod, caught in ((plant_mod, False), (jax_plant, True)):
        p = mod.BicyclePlant()
        p.set_state(np.zeros(4))
        p.set_timestep(1.0)
        p.set_ctrl_policy(Scripted(UCL, fail=launch_failed))
        for _ in range(3):
            p.forward_one_step()
        if caught:
            p.forward_one_step()
            assert p.feasibility[-1] == 0
        else:
            with pytest.raises(RuntimeError, match="launch failed"):
                p.forward_one_step()
