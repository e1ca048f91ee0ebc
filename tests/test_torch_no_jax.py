"""The torch port runs without JAX and without the JAX package: in a fresh
interpreter, import every module of the port, run a tiny i2LQR and a tiny
NLMPC learning run and a tiny generic-system solve on the CPU, and check
that no module of jax or of ``ilqr_iterative_tasks_tpu`` was loaded. A
source scan holds the same rule for every file of the port and for
chip_smoke.py."""

import ast
import os
import pathlib
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "ilqr_iterative_tasks_tpu")

CODE = """
import pkgutil
import sys
import numpy as np
import torch
import ilqr_iterative_tasks_torch
for mod in pkgutil.walk_packages(ilqr_iterative_tasks_torch.__path__,
                                 "ilqr_iterative_tasks_torch."):
    __import__(mod.name)
import ilqr_iterative_tasks_torch.control.batched_nlmpc_soa as bns
import ilqr_iterative_tasks_torch.control.batched_soa as bs
from ilqr_iterative_tasks_torch.models import double_integrator
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.fused_generic_ilqr import (
    build_fused_generic_ilqr)
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, LmpcParams, SystemLimits)

torch.set_num_threads(1)
cpu = "cpu"
xcl, ucl = seed_trajectory(1.0)
seed = np.zeros((128, 4))
seed[:121] = xcl
sc = bs.SoaScenarios.broadcast(np.zeros(4), xcl[-1],
                               Obstacle.make(31.0, -2.0, 8.0, 6.0, device=cpu),
                               2, noise_on=True, device=cpu)
res = bs.simulate_learning_runs_soa(
    IlqrParams.make(device=cpu), SystemLimits.make(device=cpu), sc, seed,
    None, 121, 1.0, num_laps=1, max_laps=4, sim_step_budget=20,
    solver_max_iter=16, generator=torch.Generator().manual_seed(0))
assert res.lap_steps.tolist() == [[20, 20]], res.lap_steps
assert torch.isfinite(res.safe_set[0][1]).all()
seed_u = np.zeros((128, 2))
seed_u[:120] = ucl
res = bns.simulate_nlmpc_runs_soa(
    LmpcParams.make(device=cpu), SystemLimits.make(device=cpu), sc, seed,
    seed_u, 121, 1.0, num_laps=1, max_laps=4, sim_step_budget=20,
    max_lm_iters=12, infeasible_retire=8,
    generator=torch.Generator().manual_seed(0))
assert res.lap_steps.tolist() == [[20, 20]], res.lap_steps
assert torch.isfinite(res.safe_set[1][1]).all()
solve = build_fused_generic_ilqr(
    double_integrator, n=4, m=2, matrix_Q=np.zeros((4, 4)),
    matrix_R=0.05 * np.eye(2), matrix_Qterminal=20.0 * np.eye(4),
    u_lower=[-2.0, -2.0], u_upper=[2.0, 2.0], dt=0.5, num_horizon=6,
    max_iter=30)
xt = torch.tensor([[1.0, -1.0], [0.5, 2.0], [0.0, 0.0], [0.0, 0.0]],
                  dtype=torch.float64)
us, x_last, cost, iters = solve(torch.zeros_like(xt), xt,
                                torch.zeros((6, 2, 2), dtype=torch.float64))
assert torch.isfinite(us).all() and bool((iters > 0).all())
assert float((x_last - xt).abs().max()) < 0.1, x_last
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {FORBIDDEN})
assert not loaded, loaded
print("ok")
""".replace("{FORBIDDEN}", repr(set(FORBIDDEN)))


def test_port_imports_and_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def _imports(path: pathlib.Path):
    """Top-level package names that a Python file imports anywhere."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_port_sources_import_no_jax_package():
    root = pathlib.Path(REPO)
    files = sorted((root / "ilqr_iterative_tasks_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 20
    bad = {str(f.relative_to(root)): sorted(set(_imports(f)) & set(FORBIDDEN))
           for f in files}
    bad = {f: names for f, names in bad.items() if names}
    assert not bad, bad
