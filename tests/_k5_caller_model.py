"""A caller's model for K5 beyond the tests' others: a car with quadratic
drag, x = (px, py, theta, v), u = (a, kappa). Its step multiplies a state
by itself (the drag v * v) and puts an input in the angle's row (theta
turns by v * kappa * dt). ``comps(cos, sin)`` gives its component step for
either framework; ``DragCar`` is the port's model with the CUDA_STEP struct
K5 builds."""

import torch

DRAG = 0.1


def comps(cos, sin):
    """The component step with the given cos / sin (torch's or jnp's)."""
    def step_comps(x, u, dt):
        px, py, th, v = x
        a, kappa = u
        return (px + v * cos(th) * dt,
                py + v * sin(th) * dt,
                th + v * kappa * dt,
                v + (a - DRAG * v * v) * dt)
    return step_comps


class DragCar:
    X_DIM, U_DIM = 4, 2
    CUDA_STEP = """
struct DragCar {
  static constexpr int NX = 4, NU = 2, ANGLE = 2;
  template <typename S, typename T>
  ILQR_HD static void step(const S* x, const S* u, T dt, T sn, T cs, S* y) {
    y[0] = x[0] + x[3] * mcos(x[2], sn, cs) * dt;
    y[1] = x[1] + x[3] * msin(x[2], sn, cs) * dt;
    y[2] = x[2] + x[3] * u[1] * dt;
    y[3] = x[3] + (u[0] - (T)0.1 * x[3] * x[3]) * dt;
  }
};
"""
    step_comps = staticmethod(comps(torch.cos, torch.sin))


def task(b, nh, seed=4):
    """K5 settings and f64 numpy (x0, x_term, u_init) of ``b`` reach tasks
    at horizon ``nh``: from speed 1 at the origin to targets about
    (3, 1, 0.5, 1)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n, m = 4, 2
    kw = dict(n=n, m=m, num_horizon=nh, matrix_Q=0.05 * np.eye(n),
              matrix_R=0.05 * np.eye(m), matrix_Qterminal=25.0 * np.eye(n),
              u_lower=-1.5 * np.ones(m), u_upper=1.5 * np.ones(m), dt=0.5,
              max_iter=40)
    x0 = np.zeros((n, b))
    x0[3] = 1.0
    xt = (np.array([3.0, 1.0, 0.5, 1.0])[:, None]
          + np.array([1.0, 1.0, 0.3, 0.3])[:, None] * rng.normal(size=(n, b)))
    return kw, x0, xt, 0.1 * np.ones((nh, m, b))
