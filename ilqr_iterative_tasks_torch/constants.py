"""State-space constants of the kinematic bicycle task.

The port's own copy of ilqr_iterative_tasks_tpu/constants.py (the port
imports nothing of the JAX package).
"""

X_DIM = 4
U_DIM = 2

# State layout: [x, y, v, theta]
X_ID = {"x": 0, "y": 1, "v": 2, "theta": 3}
# Input layout: [accel, delta]
U_ID = {"accel": 0, "delta": 1}
