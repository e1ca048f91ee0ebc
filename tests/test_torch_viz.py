"""The port's utils/viz.py on a scripted host run under Agg (a mirror of
tests/test_experiments.py::test_viz_smoke): the figures render and save,
and every plotted line equals the JAX package's plot of the same run,
the moving obstacle's fading trail among them."""

import matplotlib
import numpy as np
import pytest
from _torch_scripted import Scripted

from ilqr_iterative_tasks_torch.experiments import runner
from ilqr_iterative_tasks_torch.sim.plant import ObstacleSim
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils import viz
from ilqr_iterative_tasks_tpu.utils import viz as jax_viz

XCL, UCL = seed_trajectory(1.0)


def _lines(fig):
    return [(ax_i, np.asarray(line.get_xydata()), line.get_alpha())
            for ax_i, ax in enumerate(fig.axes) for line in ax.get_lines()]


@pytest.fixture
def agg():
    backend = matplotlib.get_backend()
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    yield plt
    plt.close("all")
    matplotlib.use(backend)


@pytest.mark.parametrize("obstacle", [None, "moving"])
def test_viz_renders_and_matches_jax(obstacle, tmp_path, agg):
    obs = (None if obstacle is None else
           ObstacleSim(35.0, -16.0, 34.0, 34.0, spd=1.0, timestep=1.0,
                       moving_option=1))
    ctrl = Scripted(UCL, obs)
    res = runner.run_closed_loop(ctrl, lap_number=1, goal_fixup="append")
    figs = [viz.plot_inputs(res.plant, show=False),
            viz.plot_closed_loop(res.plant, ctrl, seed_xcl=XCL, show=False)]
    want = [jax_viz.plot_inputs(res.plant, show=False),
            jax_viz.plot_closed_loop(res.plant, ctrl, seed_xcl=XCL,
                                     show=False)]
    for i, (fig, jfig) in enumerate(zip(figs, want)):
        ours, theirs = _lines(fig), _lines(jfig)
        assert len(ours) == len(theirs) > 0
        for (ax, xy, alpha), (jax_ax, jxy, jalpha) in zip(ours, theirs):
            assert ax == jax_ax and alpha == jalpha
            np.testing.assert_array_equal(xy, jxy)
        path = tmp_path / f"fig{i}.png"
        fig.savefig(path)
        assert path.stat().st_size > 0
    # beside the two trajectories, one ellipse every 5 of the obstacle's
    # centres over the lap
    trail = 0 if obs is None else len(range(0, len(obs.lap_states[0]), 5))
    assert len(_lines(figs[1])) == 2 + trail
