"""The torch port runs without JAX and without the JAX package: in a fresh
interpreter, import every module of the port (the scale-out package
``parallel`` among them), run a tiny i2LQR and a tiny NLMPC learning run,
two steps of each host controller, tiny generic-system solves (the two
3-input tasks of generic_bench.k5_task among them), the sharded kNN and
a sharded NLMPC run on a one-rank mesh, both vmap tiers (the i2LQR one
sharded on that mesh) and the candidate sweep on one rank on the CPU
(experiments/batch_probe.py imported), the round-4 and round-5 probes
(one's ``permute`` at 8 lanes), and check that no module
of jax or of ``ilqr_iterative_tasks_tpu`` was loaded. A source scan holds
the same rule for every file of the port, for chip_smoke.py and for the
multi-process tests' rank functions (tests/_torch_distributed_worker.py),
and holds the CUDA sources (csrc/ and the K5 translation units the port
writes for each model of generic_bench.K5_MODELS) to include only the
port's own headers and CUDA's."""

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
from ilqr_iterative_tasks_torch.experiments.generic_bench import (
    K5_MODELS, k5_task)
from ilqr_iterative_tasks_torch.ops.fused_generic_ilqr import k5_source
for name in ("holonomic", "point_mass"):  # the m > 2 branch
    model, kw, a = k5_task(name, 3, 4, cpu)
    us, x_last, cost, iters = build_fused_generic_ilqr(model, **kw)(*a)
    assert torch.isfinite(us).all() and bool((iters > 0).all()), name
for model in K5_MODELS.values():
    assert '#include "generic_ilqr.cuh"' in k5_source(model, 5)
from ilqr_iterative_tasks_torch.control.i2lqr import I2LqrController
from ilqr_iterative_tasks_torch.control.nlmpc import NlmpcController
from ilqr_iterative_tasks_torch.experiments.runner import default_obstacle
from ilqr_iterative_tasks_torch.sim.plant import true_step
f64 = torch.float64
for ctrl in (
        I2LqrController(IlqrParams.make(dtype=f64, device=cpu),
                        obstacle=default_obstacle(1.0), dtype=f64,
                        device=cpu),
        NlmpcController(LmpcParams.make(device=cpu),
                        obstacle=default_obstacle(1.0), dtype=f64,
                        device=cpu)):
    ctrl.add_trajectory(xcl, ucl)
    ctrl.set_timestep(1.0)
    x = np.zeros(4)
    for _ in range(2):
        ctrl.set_state(x)
        ctrl.calc_input()
        x = true_step(x, ctrl.get_input(), 1.0)
    assert np.isfinite(x).all() and x[0] > 0.5, x
    assert len(ctrl.solve_seconds) == 2, ctrl.solve_seconds
from ilqr_iterative_tasks_torch.parallel import (
    distributed, launch, mesh, sharded_safe_set, sharded_soa)
one = mesh.make_mesh()
assert one.size == 1 and not torch.distributed.is_initialized()
states = torch.tensor([[3.0, 0, 0, 0], [1.0, 0, 0, 0], [2.0, 0, 0, 0]])
rows = sharded_safe_set.sharded_knn(
    states, torch.tensor([True, True, False]), torch.arange(3.0),
    torch.zeros(4), 2, one)[0]
assert rows.tolist() == [1, 0], rows
res = sharded_soa.simulate_nlmpc_runs_soa_sharded(
    LmpcParams.make(device=cpu), SystemLimits.make(device=cpu), sc, seed,
    seed_u, 121, 1.0, one, num_laps=1, max_laps=4, sim_step_budget=3,
    max_lm_iters=12, generator=torch.Generator().manual_seed(0))
assert res.lap_steps.tolist() == [[3, 3]], res.lap_steps
from ilqr_iterative_tasks_torch.control import batched, batched_nlmpc
from ilqr_iterative_tasks_torch.experiments import batch_probe
from ilqr_iterative_tasks_torch.parallel import sharded
vs = batched.make_batch_scenarios(
    np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0, device=cpu), 2,
    key=1, noise_on=True, device=cpu)
seed_l = (seed, seed_u, 121, 1.0)
vkw = dict(num_laps=1, max_laps=4, sim_step_budget=3)
r1 = sharded.simulate_learning_batch_sharded(
    IlqrParams.make(max_ilqr_iter=16, device=cpu), SystemLimits.make(
        device=cpu), vs, *seed_l, one, **vkw)
assert r1.lap_steps.tolist() == [[3], [3]], r1.lap_steps
r2 = batched_nlmpc.simulate_nlmpc_batch(
    LmpcParams.make(device=cpu), SystemLimits.make(device=cpu), vs, *seed_l,
    max_lm_iters=12, **vkw)
assert r2.lap_steps.tolist() == [[3], [3]], r2.lap_steps
assert torch.isfinite(r2.safe_set.states[:, 1]).all()
us, xs, cost, idx = sharded.sharded_candidate_sweep(
    IlqrParams.make(max_ilqr_iter=16, device=cpu), SystemLimits.make(
        device=cpu), Obstacle.make(device=cpu), torch.zeros(4),
    torch.tensor(xcl[5:9], dtype=torch.float32), torch.arange(4.0),
    torch.zeros(6, 2), 1.0, 1.0, num_horizon=6,
    mesh=sharded.local_mesh("candidate", cpu))
assert us.shape == (6, 2) and xs.shape == (7, 4) and int(idx) == 0
assert callable(batch_probe.run)
from ilqr_iterative_tasks_torch.experiments import round4_probe, round5_probe
assert len(round4_probe.COMMANDS) + len(round5_probe.COMMANDS) == 14
p = round5_probe.main(["permute", "--device", "cpu", "--batch", "8",
                       "--reps", "0"])
assert p.lines[-1]["probe"] == "lane_permute_cost", p.lines
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
    files += [root / "chip_smoke.py",
              root / "tests" / "_torch_distributed_worker.py"]
    assert len(files) > 20
    assert {"distributed.py", "launch.py", "mesh.py", "sharded.py",
            "sharded_safe_set.py", "sharded_soa.py"} <= {
        f.name for f in files if f.parent.name == "parallel"}
    assert {"batched.py", "batched_nlmpc.py", "safe_set.py"} <= {
        f.name for f in files if f.parent.name == "control"}
    assert {"batch_probe.py", "round4_probe.py", "round5_probe.py"} <= {
        f.name for f in files if f.parent.name == "experiments"}
    bad = {str(f.relative_to(root)): sorted(set(_imports(f)) & set(FORBIDDEN))
           for f in files}
    bad = {f: names for f, names in bad.items() if names}
    assert not bad, bad


def test_cuda_sources_include_only_the_port():
    from ilqr_iterative_tasks_torch.experiments.generic_bench import (
        K5_MODELS)
    from ilqr_iterative_tasks_torch.ops.fused_generic_ilqr import k5_source
    csrc = pathlib.Path(REPO) / "ilqr_iterative_tasks_torch" / "csrc"
    texts = {f.name: f.read_text() for f in sorted(csrc.iterdir())}
    texts.update({f"k5 {name} N6": k5_source(model, 6)
                  for name, model in K5_MODELS.items()})
    assert "generic_ilqr.cuh" in texts and len(texts) > 15
    system = {"cuda_runtime.h", "math.h", "stdint.h", "cstdint"}
    for name, text in texts.items():
        for line in text.splitlines():
            if line.startswith("#include"):
                inc = line.split()[1].strip('"<>')
                assert inc in texts or inc in system, (name, inc)
