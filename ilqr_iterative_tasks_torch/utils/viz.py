"""Optional matplotlib plots of a host run.

The port's own copy of ilqr_iterative_tasks_tpu/utils/viz.py (numpy and
matplotlib only): the inputs of every recorded lap, the last lap's
trajectory against the seed lap, and the obstacle's ellipse trail with a
fading alpha. The library never imports this module; the demo CLIs do
under ``--plotting``.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use(matplotlib.get_backend())
    import matplotlib.pyplot as plt
    return plt


def plot_inputs(plant, show=True):
    """Acceleration and steering across every recorded lap."""
    plt = _plt()
    fig, axs = plt.subplots(2, figsize=(8, 7))
    inputs = np.vstack([u for u in plant.data["input"] if len(u)])
    times = np.arange(len(inputs))
    axs[0].plot(times, inputs[:, 0], "-o", linewidth=1, markersize=1)
    axs[0].set_xlabel("time [s]", fontsize=14)
    axs[0].set_ylabel("$a$ [m/s^2]", fontsize=14)
    axs[1].plot(times, inputs[:, 1], "-o", linewidth=1, markersize=1)
    axs[1].set_xlabel("time [s]", fontsize=14)
    axs[1].set_ylabel(r"$\delta$ [rad]", fontsize=14)
    if show:
        plt.show()
    return fig


def plot_obstacle_trail(obstacle, ax, stride=5):
    """Fading ellipse trail over the obstacle's last-lap motion."""
    theta = np.linspace(0, 2 * np.pi, 200)
    if not obstacle.lap_states:
        centers = [np.array([obstacle.x, obstacle.y])]
    else:
        centers = list(obstacle.lap_states[-1])
    for count, c in enumerate(centers):
        if count % stride:
            continue
        ax.plot(c[0] + obstacle.width * np.cos(theta),
                c[1] + obstacle.height * np.sin(theta),
                "-k", linewidth=3, alpha=max(0.05, 1 - count / 90))


def plot_closed_loop(plant, controller=None, seed_xcl=None, show=True):
    """The last lap's trajectory against the seed lap's, with the
    controller's obstacle trail."""
    plt = _plt()
    fig, ax = plt.subplots()
    obstacle = getattr(controller, "obstacle", None) if controller else None
    if obstacle is not None:
        plot_obstacle_trail(obstacle, ax)
    last = plant.data["state"][-1]
    (l1,) = ax.plot(last[:, 0], last[:, 1],
                    label="trajectory at last iteration")
    handles = [l1]
    if seed_xcl is not None:
        (l2,) = ax.plot(seed_xcl[:, 0], seed_xcl[:, 1],
                        label="initial trajectory")
        handles.append(l2)
    ax.legend(handles=handles)
    if show:
        plt.show()
    return fig
