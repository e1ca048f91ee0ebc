"""The port's round-4 and round-5 probes (experiments/round4_probe.py,
round5_probe.py) against the JAX package's, on the CPU.

Each of the 14 subcommands runs in the port with ``--device cpu`` at B = 8,
one learning lap, LM cap 4, a 6-step budget and no timed run beside the
warm one. Its JSON records must hold every key of the JAX probe's records
(the port adds the device, the card, each kernel's schedule and
launches). JAX's keys come from its own subcommand run with its
simulators, kernel factories and TPU timing replaced by stand-ins that
return results of the right shapes at once (a probe's JAX run takes
minutes). Where JAX's computation is cheap, its values too: the lane
permutation on a 2 x 64 array (``jnp.take`` against both of the port's
forms, the stable partition against JAX's ``_stable_partition``) and the
canary's rows, which JAX's probe reads from the port's own sweep reports.
"""

import json
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_torch.experiments import round4_probe, round5_probe

torch.set_num_threads(1)
SMALL = ["--device", "cpu", "--batch", "8", "--laps", "1", "--cap", "4",
         "--budget", "6", "--reps", "0"]
# (module, subcommand and its positional arguments, the JAX probe's)
CASES = [
    ("round4", ["stats"], None), ("round4", ["reuse"], None),
    ("round4", ["cap"], None), ("round4", ["stall"], None),
    ("round4", ["canary"], None), ("round4", ["nlmpc_modes"], None),
    ("round5", ["permute"], None), ("round5", ["retile", "0.125"], None),
    ("round5", ["retile_nlmpc", "0.125"], None), ("round5", ["prox"], None),
    ("round5", ["tail"], None), ("round5", ["all_rev"], ["all_rev", "8"]),
    ("round5", ["all_mc", "1", "1"], None), ("round5", ["f32_bisect"], None),
]
PORT = {"round4": round4_probe, "round5": round5_probe}


def _fake_result(laps=3, b=4):
    """A JAX run's result as the probes read it."""
    return SimpleNamespace(
        lap_done=np.ones((laps, b), bool),
        lap_steps=np.full((laps, b), 30, np.int32),
        iter_stats=tuple(np.full((b,), v, np.int32) for v in (3, 4, 5)))


def _jax_records(module, argv, monkeypatch, capsys, sweeps=()):
    """The JSON records JAX's subcommand ``argv`` prints with its runs
    replaced by stand-ins; ``sweeps``: the reports its canary's run_sweep
    returns, in turn."""
    import ilqr_iterative_tasks_tpu.control.batched_nlmpc_soa as jnl
    import ilqr_iterative_tasks_tpu.control.batched_soa as jbs
    import ilqr_iterative_tasks_tpu.control.nlmpc as jnlmpc
    import ilqr_iterative_tasks_tpu.experiments.runner as jrunner
    import ilqr_iterative_tasks_tpu.experiments.scenario_sweep as jsweep
    import ilqr_iterative_tasks_tpu.ops.pallas_nlmpc_step as jk2
    if module == "round4":
        import ilqr_iterative_tasks_tpu.experiments.round4_probe as jp
        monkeypatch.setattr(jp, "_run", lambda *a, **k: (
            _fake_result(), 1.0, 0.5))
        monkeypatch.setattr(jp, "_run_kw", lambda *a, **k: (
            _fake_result(), 1.0))
    else:
        import ilqr_iterative_tasks_tpu.experiments.round5_probe as jp
        monkeypatch.setattr(jp, "_chain_time", lambda *a, **k: 1e-3)
        for name in ("_headline_i2lqr", "_headline_nlmpc"):
            monkeypatch.setattr(jp, name, lambda *a, **k: (
                _fake_result(), 1.0))

        class SmallRng:  # permute's arrays at 2 lanes
            def __init__(self, seed):
                self.rng = np.random.default_rng(seed)

            def permutation(self, b):
                return self.rng.permutation(b)

            def random(self, b):
                return self.rng.random(b)

            def normal(self, size):
                return self.rng.normal(size=(size[0], 2))

        class SmallNp:  # numpy, with SmallRng
            random = SimpleNamespace(default_rng=SmallRng)

            def __getattr__(self, name):
                return getattr(np, name)

        monkeypatch.setattr(jp, "np", SmallNp())
    monkeypatch.setattr(jk2, "build_fused_nlmpc_step", lambda *a, **k: None)
    monkeypatch.setattr(jnl, "simulate_nlmpc_runs_soa",
                        lambda *a, **k: _fake_result())
    monkeypatch.setattr(jbs, "simulate_learning_runs_soa",
                        lambda *a, **k: _fake_result())
    reports = iter(sweeps)
    monkeypatch.setattr(jsweep, "run_sweep", lambda *a, **k: next(reports))
    monkeypatch.setattr(jnlmpc, "NlmpcController", lambda *a, **k: None)
    monkeypatch.setattr(jrunner, "run_closed_loop", lambda *a, **k: (
        SimpleNamespace(lap_times=[26.0], lap_finished=[True],
                        plant=SimpleNamespace(diagnostics=dict(
                            feasibility=[np.ones(26)])))))
    monkeypatch.setattr(sys, "argv", ["probe", *argv])
    capsys.readouterr()
    {**jp.__dict__}[f"cmd_{argv[0]}"]()
    return [json.loads(line) for line in capsys.readouterr().out.split("\n")
            if line.startswith("{")]


def _held_keys(got, want, where):
    """Every key of JAX's record ``want`` is in the port's ``got``, dicts
    within dicts alike."""
    for key, value in want.items():
        assert key in got, f"{where}: {key!r} missing from {sorted(got)}"
        if isinstance(value, dict):
            _held_keys(got[key], value, f"{where}.{key}")


@pytest.mark.parametrize("module,argv,jax_argv", CASES,
                         ids=[" ".join(c[1][:1]) for c in CASES])
def test_probe_has_jax_s_keys(module, argv, jax_argv, monkeypatch, capsys):
    capsys.readouterr()
    p = PORT[module].main([*argv, *SMALL])
    lines = p.lines
    assert lines and lines == [
        json.loads(line) for line in capsys.readouterr().out.split("\n")
        if line.startswith("{")]
    last = lines[-1]
    assert last["device"] == "cpu" and last["card"] == "cpu"
    sweeps = ()
    if argv[0] == "canary":  # JAX's probe reads the port's reports
        sweeps = [dict(completion_rate=last[sr]["completion"],
                       final_lap_mean=last[sr]["final_lap_mean"])
                  for sr in ("None", "3", "5")]
    want = _jax_records(module, jax_argv or argv, monkeypatch, capsys,
                        sweeps)
    if argv[0] == "cap":  # JAX's ladder 16, 15, 14; the port's from --cap 4
        want[-1] = {{"cap16": "cap4", "cap15": "cap3",
                     "cap14": "cap2"}.get(k, k): v
                    for k, v in want[-1].items()}
    _held_keys(last, want[-1], argv[0])
    _held_keys(lines[0], want[0], argv[0])
    assert len(lines) == len(want)
    if argv[0] == "canary":
        for sr in ("None", "3", "5"):
            assert {k: last[sr][k] for k in want[-1][sr]} == want[-1][sr]
    if argv[0] == "f32_bisect":  # every row, the islands' on the CPU
        assert all(last[tag]["device"] == "cpu"
                   for tag, _, _ in round5_probe.F32_VARIANTS)


def test_lane_permutation_is_jax_s_take():
    """On a 2 x 64 array: both of the port's forms are ``jnp.take`` along
    the lane axis (JAX's two forms, round5_probe.py:71-75), and the
    stable partition is JAX's ``_stable_partition``'s source order."""
    from ilqr_iterative_tasks_tpu.control.batched_soa import (
        _stable_partition)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 64)).astype(np.float32)
    perm = rng.permutation(64)
    want = np.asarray(jnp.take(jnp.asarray(a), jnp.asarray(perm), axis=-1))
    assert np.array_equal(want, np.asarray(jnp.take(
        jnp.asarray(a).T, jnp.asarray(perm), axis=0).T))
    ta, tp = torch.from_numpy(a), torch.from_numpy(perm)
    assert np.array_equal(round5_probe.lane_permute(ta, tp).numpy(), want)
    assert np.array_equal(round5_probe.lane_permute_t(ta, tp).numpy(), want)
    flags = rng.random(64) < 0.7
    _, src, n_first = _stable_partition(jnp.asarray(flags))
    got = round5_probe.stable_partition(torch.from_numpy(flags))
    assert int(n_first) == int((~flags).sum())
    assert np.array_equal(got.numpy(), np.asarray(src))


def test_probes_need_a_card_unless_told_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        round4_probe.main(["cap"])
