"""Behaviour-level closed-loop parity envelope.

Port of ilqr_iterative_tasks_tpu/utils/envelope.py (``compare_runs`` :41,
``assert_behavior_envelope`` :64), a copy of its numpy: the same gates and
tolerances, on the port's run results (``SoaRunResult``, torch tensors on
any device) or anything with ``lap_steps`` (L, B) and ``lap_done`` (L, B).

Bitwise parity gates changes that are provably decision-identical. Changes
that move floating-point trajectories but not BEHAVIOUR (the
``stall_reseed`` guard on nominal scenarios, an alternate but equally
feasible winner) need a statistical gate instead: two full learning runs
over the SAME scenario batch and noise draws must agree on

1. completion rate (within ``tol_completion``),
2. per-lap mean lap steps (within ``tol_mean_steps``),
3. per-lap MEDIAN lap steps (exactly: the typical lane is unchanged),
4. per-lane lap-step deltas (p99 <= ``tol_steps_p99``, max <=
   ``tol_steps_max``), calibrated against a noise-level control: the same
   run with only the plant-noise key changed measured delta_p99 = 3,
   delta_max = 4, 26 % of lanes changed (B = 128, NLMPC, 2 laps, noise
   on),
5. the learned optimum: the best final-lap time over the batch (exactly).

The aggregate gates (1-3, 5) are strict: a change may move individual
noisy lanes by noise-level amounts, but the population behaviour and the
learned optimum must be indistinguishable.
"""

from __future__ import annotations

import numpy as np
import torch

# tail tolerances = the measured noise-level control (module docstring)
DEFAULTS = dict(tol_completion=0.005, tol_mean_steps=0.25,
                tol_steps_p99=3, tol_steps_max=4)


def _f64(a) -> np.ndarray:
    """A run record as a float64 numpy array (torch tensors from any
    device)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def compare_runs(base, cand):
    """Numeric comparison record between two run results (any object with
    ``lap_steps`` (L, B) and ``lap_done`` (L, B))."""
    bs, cs = _f64(base.lap_steps), _f64(cand.lap_steps)
    bd, cd = _f64(base.lap_done), _f64(cand.lap_done)
    delta = np.abs(bs - cs)
    return dict(
        completion_base=float(bd.mean()),
        completion_cand=float(cd.mean()),
        mean_steps_base=[float(v) for v in bs.mean(-1)],
        mean_steps_cand=[float(v) for v in cs.mean(-1)],
        median_steps_base=[float(v) for v in np.median(bs, -1)],
        median_steps_cand=[float(v) for v in np.median(cs, -1)],
        delta_p99=float(np.quantile(delta, 0.99)),
        delta_max=float(delta.max()),
        frac_lanes_changed=float((delta.max(0) > 0).mean()),
        best_final_base=float(bs[-1].min()),
        best_final_cand=float(cs[-1].min()),
    )


def assert_behavior_envelope(base, cand, *, tol_completion=None,
                             tol_mean_steps=None, tol_steps_p99=None,
                             tol_steps_max=None):
    """Raise AssertionError with the full comparison record when ``cand``
    leaves the behaviour envelope of ``base``. Returns the record."""
    t = dict(DEFAULTS)
    for k, v in (("tol_completion", tol_completion),
                 ("tol_mean_steps", tol_mean_steps),
                 ("tol_steps_p99", tol_steps_p99),
                 ("tol_steps_max", tol_steps_max)):
        if v is not None:
            t[k] = v
    rec = compare_runs(base, cand)
    msg = f"behavior envelope violated: {rec}"
    assert abs(rec["completion_cand"] - rec["completion_base"]) \
        <= t["tol_completion"], msg
    for mb, mc in zip(rec["mean_steps_base"], rec["mean_steps_cand"]):
        assert abs(mb - mc) <= t["tol_mean_steps"], msg
    assert rec["median_steps_base"] == rec["median_steps_cand"], msg
    assert rec["delta_p99"] <= t["tol_steps_p99"], msg
    assert rec["delta_max"] <= t["tol_steps_max"], msg
    assert rec["best_final_base"] == rec["best_final_cand"], msg
    return rec
