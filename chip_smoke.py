#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ilqr_iterative_tasks_torch/csrc/, checks
each against its plain torch version on the card, and drives the port's main
path: the batched i2LQR learning run (seed lap + 3 learning laps, plant noise
on, f32) through the whole-step kernel K1. Phases:

1. device: the card's name and power limit;
2. build: nvcc of both kernels, with its seconds;
3. K3 (per-candidate solve) against the plain solve on 393 216 random
   candidate lanes, f64 and f32;
4. K1 (whole control step) against the plain step on safe sets captured from
   the headline run (early lap 1, mid lap 2, late lap 3), f32 as captured
   and f64 cast up, with both per-step times;
5. a zero-noise closed loop through K1 (f32, 1024 identical lanes, cap 150)
   against the known lap sequence;
6. the headline run through K1 (B = 49 152, cap 16): one warm run, whose K1
   launches are counted, and two timed runs; lap-sims/s = B * laps / s.

Every phase raises on failure, so the script exits non-zero. It prints the
card line and a JSON line of the kernels before its last line, which is
{"ok": true, "device": {...}}. It needs a CUDA device and the repository.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, LAPS, MAX_STEPS, MAX_LAPS, CAP, N = 49152, 3, 128, 8, 16, 6
K3_LANES = 8 * BATCH
# (learning lap, control step within it) where phase 4 captures K1's inputs
CAPTURES = {1: 5, 2: 14, 3: 18}
ZERO_NOISE_LAPS = [55, 28, 24]  # CPU XLA f32 family, docs/PARITY.md:146


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps):
    """Mean milliseconds per call on the card's clock, after one warm call."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Capture:
    """Step solver that delegates to K1 and keeps a copy of its inputs at
    the CAPTURES points (the simulator only sees K1's attributes)."""

    def __init__(self, k1):
        self.k1 = k1
        for a in ("k", "nsi", "num_horizon", "max_steps", "max_laps",
                  "max_iter"):
            setattr(self, a, getattr(k1, a))
        self.calls = {}
        self.captured = {}

    def __call__(self, *args):
        lap = int(args[5][-1]) + 1  # lap_ids[-1] = laps stored - 1
        i = self.calls.get(lap, 0)
        self.calls[lap] = i + 1
        if CAPTURES.get(lap) == i:
            self.captured[lap] = [a.clone() for a in args]
        return self.k1(*args)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    from ilqr_iterative_tasks_torch.control.batched_soa import (
        SoaScenarios, simulate_learning_runs_soa)
    from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
    from ilqr_iterative_tasks_torch.ops import _build
    from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
        build_fused_ilqr, fused_ilqr_reference, obstacle_to_lanes)
    from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
        build_fused_i2lqr_step, i2lqr_step_reference)
    from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
    from ilqr_iterative_tasks_torch.utils.params import (
        IlqrParams, SystemLimits)

    dev = torch.device("cuda", 0)
    # ---- 1. device ----
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # ---- 2. build ----
    path, build_s = _build.build()
    print(f"[2 build] {build_s:.1f} s nvcc {' '.join(_build.NVCC_FLAGS)}",
          flush=True)
    with open(path[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("   ", line.strip())
    _build.library()

    params, limits = IlqrParams.make(), SystemLimits.make()
    xcl, _ = seed_trajectory(1.0)
    rng = np.random.default_rng(0)

    # ---- 3. K3 against the plain solve ----
    b = K3_LANES
    rows = rng.integers(0, 100, b)
    x0 = np.ascontiguousarray(
        (xcl[rows] + rng.normal(size=(b, 4)) * [0.5, 0.5, 0.2, 0.05]).T)
    xt = np.ascontiguousarray(
        (xcl[rows + rng.integers(1, 9, b)]
         + rng.normal(size=(b, 4)) * [0.3, 0.3, 0.1, 0.02]).T)
    opt = np.arange(b) % 3
    obs = Obstacle(
        x=31.0 + rng.normal(size=b) * 4, y=-2.0 + rng.normal(size=b) * 4,
        width=np.full(b, 8.0), height=np.full(b, 6.0),
        spd=np.where(opt == 0, 0.0, 0.5 + rng.random(b)),
        moving_option=opt.astype(float),
        present=(np.arange(b) % 8 != 7).astype(float)).map(
            lambda a: torch.tensor(a, dtype=torch.float64, device=dev))
    obs = obstacle_to_lanes(obs, b).contiguous()
    k3 = build_fused_ilqr(params, limits, 1.0, num_horizon=N, max_iter=CAP)
    k3_stats = {}
    for dtype in (torch.float64, torch.float32):
        a = (torch.tensor(x0, dtype=dtype, device=dev),
             torch.tensor(xt, dtype=dtype, device=dev),
             torch.zeros((N, 2, b), dtype=dtype, device=dev),
             obs.to(dtype))
        out = k3(*a)
        ref = fused_ilqr_reference(params, limits, 1.0, *a, num_horizon=N,
                                   max_iter=CAP)
        torch.cuda.synchronize()
        for t in out:
            require(bool(torch.isfinite(t).all()), "K3: non-finite output")
        dus = (out[0] - ref[0]).abs().amax(dim=(0, 1))
        dcost = (out[2] - ref[2]).abs()
        us_share = float((dus <= 1e-6).double().mean())
        cost_share = float((dcost <= 1e-3 * ref[2].abs()).double().mean())
        bitwise = float((dus == 0).double().mean())
        print(f"[3 K3 {str(dtype)[6:]}] lanes {b}: max|dus|<=1e-6 "
              f"{us_share:.6f}, |dcost|<=1e-3|cost| {cost_share:.6f}, "
              f"bitwise us {bitwise:.6f}, max|dus| {float(dus.max()):.3e}",
              flush=True)
        if dtype == torch.float64:
            require(us_share >= 0.999, "K3 f64: < 99.9 % of lanes agree")
        else:
            require(cost_share >= 0.99, "K3 f32: < 99 % of lanes agree")
            k3_stats = dict(
                max_abs_err=float(dus.max()),
                ms=cuda_ms(lambda: k3(*a), 5),
                plain_ms=cuda_ms(lambda: fused_ilqr_reference(
                    params, limits, 1.0, *a, num_horizon=N, max_iter=CAP), 2))
    print(f"[3 K3 f32] kernel {k3_stats['ms']:.3f} ms, plain "
          f"{k3_stats['plain_ms']:.3f} ms per call of {b} lanes", flush=True)

    # ---- 6a. headline warm run through K1 (captures phase 4's inputs) ----
    seed_xs = np.zeros((MAX_STEPS, 4))
    seed_xs[:121] = xcl
    scen = SoaScenarios.broadcast(np.zeros(4), xcl[-1],
                                  Obstacle.make(31.0, -2.0, 8.0, 6.0),
                                  BATCH, noise_on=True, device=dev)
    k1 = build_fused_i2lqr_step(params, limits, 1.0, num_horizon=N,
                                max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                                max_iter=CAP)
    kw = dict(num_laps=LAPS, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
              solver_max_iter=CAP)

    def headline(seed, solver):
        g = torch.Generator(device=dev).manual_seed(seed)
        res = simulate_learning_runs_soa(params, limits, scen, seed_xs, None,
                                         121, 1.0, step_solver=solver,
                                         generator=g, **kw)
        torch.cuda.synchronize()
        return res

    cap = Capture(k1)
    k1.launches = k3.launches = 0
    t0 = time.perf_counter()
    warm = headline(0, cap)
    warm_s = time.perf_counter() - t0
    k1_launches, k3_launches = k1.launches, k3.launches  # K3: off the path
    require(k1_launches > 0, "K1 was not launched by the main path")
    completion = float(warm.lap_done.float().mean())
    mean_steps = warm.lap_steps.float().mean(dim=1).tolist()
    require(bool(torch.isfinite(warm.safe_set[0]).all()),
            "non-finite safe set")
    print(f"[6 headline warm] B={BATCH} {warm_s:.2f} s, K1 launches "
          f"{k1_launches}, completion {completion:.4f}, mean lap steps "
          f"{[round(v, 2) for v in mean_steps]}", flush=True)
    require(completion >= 0.99, "headline lap completion < 0.99")

    # ---- 4. K1 against the plain step on the captured safe sets ----
    require(sorted(cap.captured) == sorted(CAPTURES),
            f"captured {sorted(cap.captured)}")
    k1_err, k1_ms, k1_plain_ms = 0.0, None, None
    for lap, args in sorted(cap.captured.items()):
        active = args[8] < 0.5
        n_act = int(active.sum())
        require(n_act > 0, f"capture lap {lap}: no active lane")
        for dtype in (torch.float32, torch.float64):
            a = [t.to(dtype) if t.is_floating_point() and i != 8 else t
                 for i, t in enumerate(args)]
            out = k1(*a)
            ref = i2lqr_step_reference(params, limits, 1.0, *a, max_iter=CAP)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(out[0]).all()), "K1: non-finite us")
            agree = ((out[1] == ref[1]) & (out[2] == ref[2])
                     & (out[3] == ref[3]))[active]
            dus = (out[0] - ref[0]).abs().amax(dim=(0, 1))[active][agree]
            share = float(agree.double().mean())
            maxd = float(dus.max()) if dus.numel() else 0.0
            line = (f"[4 K1 lap {lap} step {CAPTURES[lap]} "
                    f"{str(dtype)[6:]}] active {n_act}: decisions agree "
                    f"{share:.6f}, max|dus| on them {maxd:.3e}")
            if dtype == torch.float64:
                require(share >= 0.999 and maxd <= 1e-6,
                        f"K1 f64 lap {lap}: agreement {share}, {maxd}")
            else:
                require(share >= 0.99, f"K1 f32 lap {lap}: {share}")
                k1_err = max(k1_err, maxd)
                ms = cuda_ms(lambda: k1(*a), 10)
                plain = cuda_ms(lambda: i2lqr_step_reference(
                    params, limits, 1.0, *a, max_iter=CAP), 2)
                line += f"; kernel {ms:.3f} ms, plain {plain:.3f} ms per step"
                if lap == 2:
                    k1_ms, k1_plain_ms = ms, plain
            print(line, flush=True)
    del cap

    # ---- 5. zero-noise closed loop through K1 ----
    k1_zero = build_fused_i2lqr_step(params, limits, 1.0, num_horizon=N,
                                     max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                                     max_iter=150)
    scen0 = SoaScenarios.broadcast(np.zeros(4), xcl[-1],
                                   Obstacle.make(31.0, -2.0, 8.0, 6.0), 1024,
                                   noise_on=False, device=dev)
    res0 = simulate_learning_runs_soa(
        params, limits, scen0, seed_xs, None, 121, 1.0, step_solver=k1_zero,
        num_laps=LAPS, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
        solver_max_iter=150)
    steps0 = res0.lap_steps.cpu().numpy()
    laps0 = steps0[:, 0].tolist()
    print(f"[5 zero-noise] B=1024 cap 150 lap steps {laps0}, all lanes "
          f"identical {bool((steps0 == steps0[:, :1]).all())}, all done "
          f"{bool(res0.lap_done.all())}", flush=True)
    require(bool((steps0 == steps0[:, :1]).all()), "zero-noise lanes differ")
    require(bool(res0.lap_done.all()), "zero-noise lanes not done")
    require(all(abs(a - b) <= 2 for a, b in zip(laps0, ZERO_NOISE_LAPS)),
            f"zero-noise laps {laps0} not within 2 of {ZERO_NOISE_LAPS}")

    # ---- 6b. headline timed runs ----
    times = []
    for seed in (1, 2):
        t0 = time.perf_counter()
        headline(seed, k1)
        times.append(time.perf_counter() - t0)
    best = min(times)
    rate = BATCH * LAPS / best
    print(f"[6 headline] {rate:.1f} lap-sims/s, {best:.3f} s per batch "
          f"(runs {[round(t, 3) for t in times]}), completion "
          f"{completion:.4f}, K1 launches {k1_launches}, card {card}",
          flush=True)

    kernels = [
        dict(name="i2lqr_step (K1)", route="cuda",
             source="ilqr_iterative_tasks_torch/csrc/i2lqr_step.cu",
             replaces="ilqr_iterative_tasks_tpu/ops/pallas_i2lqr_step.py:221",
             launches=k1_launches, max_abs_err=k1_err, ms=k1_ms,
             plain_ms=k1_plain_ms),
        dict(name="fused_ilqr (K3)", route="cuda",
             source="ilqr_iterative_tasks_torch/csrc/fused_ilqr.cu",
             replaces="ilqr_iterative_tasks_tpu/ops/pallas_ilqr.py:87",
             launches=k3_launches, on_main_path=False, **k3_stats),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
