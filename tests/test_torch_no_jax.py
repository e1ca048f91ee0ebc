"""The torch port runs without JAX: in a fresh interpreter, import the port,
run a tiny i2LQR and a tiny NLMPC learning run on the CPU, and check that
no jax module was loaded (the port imports only the jax-free leaf
``constants.py`` of the JAX package)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import sys
import numpy as np
import torch
import ilqr_iterative_tasks_torch.control.batched_nlmpc_soa as bns
import ilqr_iterative_tasks_torch.control.batched_soa as bs
import ilqr_iterative_tasks_torch.ops.fused_ilqr
import ilqr_iterative_tasks_torch.ops.fused_lm_shooting
import ilqr_iterative_tasks_torch.ops.i2lqr_step
import ilqr_iterative_tasks_torch.ops.nlmpc_step
import ilqr_iterative_tasks_torch.utils.convert
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, LmpcParams, SystemLimits)

torch.set_num_threads(1)
xcl, ucl = seed_trajectory(1.0)
seed = np.zeros((128, 4))
seed[:121] = xcl
sc = bs.SoaScenarios.broadcast(np.zeros(4), xcl[-1],
                               Obstacle.make(31.0, -2.0, 8.0, 6.0), 2,
                               noise_on=True)
res = bs.simulate_learning_runs_soa(
    IlqrParams.make(), SystemLimits.make(), sc, seed, None, 121, 1.0,
    num_laps=1, max_laps=4, sim_step_budget=20, solver_max_iter=16,
    generator=torch.Generator().manual_seed(0))
assert res.lap_steps.tolist() == [[20, 20]], res.lap_steps
assert torch.isfinite(res.safe_set[0][1]).all()
seed_u = np.zeros((128, 2))
seed_u[:120] = ucl
res = bns.simulate_nlmpc_runs_soa(
    LmpcParams.make(), SystemLimits.make(), sc, seed, seed_u, 121, 1.0,
    num_laps=1, max_laps=4, sim_step_budget=20, max_lm_iters=12,
    infeasible_retire=8, generator=torch.Generator().manual_seed(0))
assert res.lap_steps.tolist() == [[20, 20]], res.lap_steps
assert torch.isfinite(res.safe_set[1][1]).all()
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m.startswith("jaxlib") or m.startswith("flax"))
assert not loaded, loaded
print("ok")
"""


def test_port_imports_and_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
