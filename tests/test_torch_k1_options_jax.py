"""K1's ``reuse_extract``, ``dom_skip`` and ``group`` against the JAX
kernel (ops/pallas_i2lqr_step.py) in interpret mode: f32, one tile of 128
lanes, on the inputs of tests/test_pallas_i2lqr_step.py:171-215 (run in a
fresh process, tests/_jax_step_stats.py ``k1opts``), without counts
(``group`` takes none). The port's plain step with the same option makes
JAX's decisions (shrink, idx_sel, row_sel) on every live lane; its inputs
there follow XLA:CPU's f32 arithmetic (FMA contraction, its own sin / cos /
exp), so they are held within 0.05 (the LM's f32 iterates, ROADMAP Queue
3: f32 on the CPU is held at decision level).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_k1_options import CAP, _jax_test_lanes

from ilqr_iterative_tasks_torch.ops.i2lqr_step import i2lqr_step_reference
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
RUNS = {"reuse": dict(reuse_extract=True), "dom": dict(dom_skip=True),
        "group2": dict(group=2)}


@pytest.fixture(scope="module")
def jax_k1(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_k1opts") / "k1opts.npz"
    run = subprocess.run(
        [sys.executable, os.path.join(TESTS, "_jax_step_stats.py"), "k1opts",
         str(out)], capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(TESTS))
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("run", list(RUNS))
def test_decisions_match_the_jax_kernel(jax_k1, run):
    p = IlqrParams.make(device="cpu", dtype=torch.float32)
    lim = SystemLimits.make(device="cpu", dtype=torch.float32)
    a = _jax_test_lanes(jax_k1["obs"])
    got = [t.numpy() for t in i2lqr_step_reference(
        p, lim, 1.0, *a, max_iter=CAP, **RUNS[run])]
    live = a[8].numpy() < 0.5  # JAX writes a skipped lane's computed step
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[i][live],
                                      jax_k1[f"{run}_{i}"][live])
    dus = np.abs(got[0] - jax_k1[f"{run}_0"]).max(axis=(0, 1))[live]
    assert dus.max() <= 0.05
