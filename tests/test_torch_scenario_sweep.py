"""The robustness sweep's report and its noisy-run gate against the JAX
package.

- the port's copy of ``utils/envelope.py`` gives the JAX module's records
  and verdicts on the same runs (identical, within the envelope, and
  outside it by each of its gates);
- the port's ``run_sweep`` runs on the CPU at B = 8 and returns the JAX
  sweep's report keys, with values of their shapes.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_tpu.experiments import scenario_sweep as jsweep
from ilqr_iterative_tasks_tpu.utils import envelope as jenv
from ilqr_iterative_tasks_torch.control.batched_soa import SoaRunResult
from ilqr_iterative_tasks_torch.experiments.scenario_sweep import run_sweep
from ilqr_iterative_tasks_torch.utils import envelope as tenv

torch.set_num_threads(1)


def _runs():
    """(name, base, cand) lap records (L, B) as numpy: a base run and
    candidates inside and outside the envelope by each gate."""
    rng = np.random.default_rng(0)
    steps = rng.integers(20, 60, (3, 256))
    done = rng.random((3, 256)) > 0.02
    out = []

    def cand(name, s, d=done):
        out.append((name, (steps, done), (s, d)))

    cand("identical", steps)
    moved = steps.copy()
    moved[1, :3] += [1, -1, 2]  # noise-level moves of a few lanes
    cand("noise_level", moved)
    d2 = done.copy()
    d2[0, :8] = ~d2[0, :8]
    cand("completion", steps, d2)
    m = steps.copy()
    m[2] += 1
    cand("mean_and_median", m)
    far = steps.copy()
    far[0, 5] += 9
    cand("delta_max", far)
    best = steps.copy()
    best[-1, np.argmin(best[-1])] -= 1
    cand("best_final", best)
    return out


def _port_result(steps, done):
    return SoaRunResult(lap_steps=torch.tensor(steps, dtype=torch.int32),
                        lap_done=torch.tensor(done), final_x=None,
                        safe_set=(), lap_count=0)


@pytest.mark.parametrize("name,base,cand", _runs(),
                         ids=[r[0] for r in _runs()])
def test_envelope_gives_the_jax_verdicts(name, base, cand):
    jb, jc = (SimpleNamespace(lap_steps=s, lap_done=d) for s, d in (base,
                                                                    cand))
    tb, tc = _port_result(*base), _port_result(*cand)
    assert tenv.compare_runs(tb, tc) == jenv.compare_runs(jb, jc)
    assert tenv.DEFAULTS == jenv.DEFAULTS
    for kw in ({}, dict(tol_steps_max=10, tol_mean_steps=1.5,
                        tol_completion=0.05)):
        try:
            want = jenv.assert_behavior_envelope(jb, jc, **kw)
        except AssertionError as e:
            with pytest.raises(AssertionError) as got:
                tenv.assert_behavior_envelope(tb, tc, **kw)
            assert str(got.value) == str(e)
        else:
            assert tenv.assert_behavior_envelope(tb, tc, **kw) == want
    inside = name in ("identical", "noise_level")
    try:
        tenv.assert_behavior_envelope(tb, tc)
        assert inside
    except AssertionError:
        assert not inside


def test_run_sweep_on_the_cpu_reports_the_jax_keys():
    want = jsweep.run_sweep(8, 1, moving=True, use_pallas=False, quiet=True)
    got = run_sweep(8, 1, moving=True, quiet=True, device="cpu")
    assert sorted(got) == sorted(want)
    assert jax.default_backend() == want["backend"] == got["backend"] == "cpu"
    for key in ("batch", "num_laps", "moving", "num_ss_iter",
                "num_ss_points", "x0_jitter", "obs_pos_jitter",
                "stall_reseed"):
        assert got[key] == want[key], key
    assert 0.0 <= got["completion_rate"] <= 1.0
    assert len(got["lap_steps_p50"]) == len(got["lap_steps_p95"]) == 1
    assert 0 < got["final_lap_mean"] <= 121
