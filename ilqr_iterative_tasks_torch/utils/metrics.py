"""Metrics: per-step solve latency percentiles, lap statistics, and a
timing harness for a torch callable.

Port of ilqr_iterative_tasks_tpu/utils/metrics.py. ``LatencyStats``,
``run_latency_stats``, ``LapMetrics`` and ``summary_dict`` are numpy only
and keep the JAX keys. ``solver_time`` (the source of
``run_latency_stats``) is the plant's wall time of every ``calc_input``,
replay steps included (sim/plant.py), not the controllers'
``solve_seconds``, which count only the steps that solved. ``time_call``
takes the place of JAX's ``time_jitted``: it synchronises the card (where
there is one) after the warm-up calls and after every timed call, as
``block_until_ready`` waits for a jitted call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np
import torch


@dataclass
class LatencyStats:
    p50: float
    p90: float
    p99: float
    mean: float
    max: float
    n: int

    @classmethod
    def from_samples(cls, samples) -> "LatencyStats":
        s = np.asarray(list(samples), dtype=np.float64)
        if s.size == 0:
            return cls(0.0, 0.0, 0.0, 0.0, 0.0, 0)
        return cls(
            p50=float(np.percentile(s, 50)),
            p90=float(np.percentile(s, 90)),
            p99=float(np.percentile(s, 99)),
            mean=float(s.mean()),
            max=float(s.max()),
            n=int(s.size),
        )


def run_latency_stats(result) -> LatencyStats:
    """Latency stats over every per-step ``calc_input`` of a host run."""
    samples: List[float] = []
    for lap in result.plant.diagnostics["solver_time"]:
        samples.extend(np.asarray(lap).ravel().tolist())
    return LatencyStats.from_samples(samples)


@dataclass
class LapMetrics:
    lap_times: List[float]
    seed_time: float
    monotone: bool
    converged_time: float
    completion_rate: float

    @classmethod
    def from_result(cls, result) -> "LapMetrics":
        t = list(result.lap_times)
        return cls(
            lap_times=t,
            seed_time=result.seed_time,
            monotone=all(b <= a for a, b in zip(t, t[1:])),
            converged_time=t[-1] if t else float("nan"),
            completion_rate=float(np.mean(result.lap_finished))
            if result.lap_finished else 0.0,
        )


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_call(fn: Callable, *args, reps: int = 5, warmup: int = 1,
              device=None, **kwargs) -> LatencyStats:
    """Host-clock seconds of ``fn(*args, **kwargs)``: ``warmup`` calls,
    then ``reps`` timed calls, each ended by a synchronise of the CUDA
    ``device`` (the current one when ``device`` is None and there is a
    card; none on the CPU)."""
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync(device)
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync(device)
        samples.append(time.perf_counter() - t0)
    return LatencyStats.from_samples(samples)


def summary_dict(result) -> Dict:
    """One flat dict: lap metrics and latency percentiles, for JSON."""
    lat = run_latency_stats(result)
    laps = LapMetrics.from_result(result)
    return {
        "seed_time_s": laps.seed_time,
        "lap_times_s": laps.lap_times,
        "converged_lap_s": laps.converged_time,
        "monotone_improvement": laps.monotone,
        "lap_completion_rate": laps.completion_rate,
        "solve_latency_p50_s": lat.p50,
        "solve_latency_p90_s": lat.p90,
        "solve_latency_p99_s": lat.p99,
        "solve_latency_max_s": lat.max,
        "num_solves": lat.n,
    }
