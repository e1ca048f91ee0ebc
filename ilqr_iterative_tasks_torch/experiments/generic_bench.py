"""Generic-system tier benchmarks on the card, each printed as one JSON line
with the card's name and power limit.

Port of ilqr_iterative_tasks_tpu/experiments/generic_bench.py:

1. ``--throughput``: solves/s of the double integrator through the K5
   kernel at the JAX bench's ``generic_soa_solves_per_s`` row
   (bench.py:223-248): B = 32 768, N = 6, max_iter 150, Q = 0, R and
   Qterminal from IlqrParams, bounds +-a_max / +-delta_max_r, dt 1,
   x0 = (0, 0, 1, 0), x_terminal uniform(-20, 20) from
   ``np.random.default_rng(0)``.
2. ``--kernel`` (the counterpart of ``--pallas``, generic_bench.py:164-221):
   at B = 131 072, N = 6, max_iter 150, the bicycle through K5, the double
   integrator through K5, and K3 (the hand-scalarized bicycle solve with its
   barrier costs) on the same bicycle lanes with an absent obstacle; the
   ratio is K5-bicycle time over K3 time.
3. ``--crossover`` (generic_bench.py:115-161): one host-tier generic solve
   (ops/generic_ilqr.py, plain torch) of 256 candidates, max_iter 8, with
   the sequential and the parallel backward pass, at horizons 16-1024.

Times are host-clock seconds around calls that end in a synchronize, best
of 3 after a warm call. The K5 rows carry ``warp_trips`` of the call's
``n_iters``: the LM trips a kernel that runs 32 consecutive lanes in
lockstep, each warp to its slowest lane, would execute against those the
lanes need. The runs go to the current CUDA device unless
``--device`` names another.

    python -m ilqr_iterative_tasks_torch.experiments.generic_bench --throughput
    python -m ilqr_iterative_tasks_torch.experiments.generic_bench --kernel
    python -m ilqr_iterative_tasks_torch.experiments.generic_bench --crossover
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ilqr_iterative_tasks_torch.models import (
    double_integrator, kinetic_bicycle, unicycle)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.fused_generic_ilqr import (
    build_fused_generic_ilqr)
from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
    build_fused_ilqr, obstacle_to_lanes)
from ilqr_iterative_tasks_torch.ops.generic_ilqr import (
    GenericIlqrConfig, generic_ilqr_solve_candidates)
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.device import resolve
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits


def card_line(device: torch.device) -> str:
    """``name, power limit`` of the card as nvidia-smi gives them, or "cpu".
    The nvidia-smi row is the one with the device's PCI address or UUID
    (CUDA_VISIBLE_DEVICES renumbers torch's devices, not nvidia-smi's).
    Where nvidia-smi hides both, it is its only row; among several such
    rows the card is not identified, and the line says so."""
    if device.type != "cuda":
        return "cpu"
    p = torch.cuda.get_device_properties(device)
    pci = f"{p.pci_domain_id:08X}:{p.pci_bus_id:02X}:{p.pci_device_id:02X}.0"
    uuid = f"GPU-{getattr(p, 'uuid', '')}"
    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=pci.bus_id,uuid,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    rows = [row.split(", ", 2) for row in rows]
    for addr, gid, line in rows:
        if addr.strip().upper() == pci or gid.strip() == uuid:
            return line
    if len(rows) == 1:
        return rows[0][2]
    return (f"{torch.cuda.get_device_name(device)}, power limit not "
            f"identified (nvidia-smi hides the cards' PCI addresses)")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def best_seconds(fn, device, reps=3):
    """(best host-clock time of ``reps`` synchronized calls after a warm
    one, the last call's result)."""
    fn()
    _sync(device)
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best, out


def warp_trips(n_iters: torch.Tensor, max_iter: int, warp: int = 32) -> dict:
    """LM trips of lanes run ``warp`` consecutive lanes at a time, each
    group to its slowest lane, from each lane's own trip count
    ``n_iters``: the mean trips a lane, the lanes at ``max_iter``, the mean
    of a group's slowest lane, and executed over useful trips, where a
    group executes its lanes' count times its slowest lane's trips (the
    ragged last group has fewer lanes)."""
    t = n_iters.detach().to("cpu", torch.float64).flatten()
    groups = torch.split(t, warp)
    slowest = torch.stack([g.max() for g in groups])
    executed = sum(float(g.numel() * m) for g, m in zip(groups, slowest))
    return {"mean_trips": float(t.mean()),
            "lanes_at_cap": int((t >= max_iter).sum()),
            "mean_warp_max": float(slowest.mean()),
            "executed_over_useful": executed / float(t.sum())}


def candidates(batch: int, rng, device) -> torch.Tensor:
    """(4, batch) f32 terminal states: seed-lap rows 4-29 plus N(0, 0.25)."""
    xcl, _ = seed_trajectory(1.0)
    rows = xcl[rng.integers(4, 30, size=batch)]
    rows = rows + rng.normal(size=rows.shape) * 0.25
    return torch.tensor(np.ascontiguousarray(rows.T), dtype=torch.float32,
                        device=device)


def generic_kwargs(params: IlqrParams, limits: SystemLimits, *, max_iter,
                   matrix_Q=None) -> dict:
    """K5 settings of the JAX bench: IlqrParams costs (``matrix_Q``
    overrides Q), bounds +-a_max / +-delta_max_r, dt 1, N 6."""
    f = lambda t: t.detach().cpu().double().numpy()
    return dict(n=4, m=2,
                matrix_Q=f(params.matrix_Q) if matrix_Q is None else matrix_Q,
                matrix_R=f(params.matrix_R),
                matrix_Qterminal=f(params.matrix_Qterminal),
                u_lower=[-float(limits.a_max), -float(limits.delta_max_r)],
                u_upper=[float(limits.a_max), float(limits.delta_max_r)],
                dt=1.0, max_iter=max_iter, num_horizon=6)


class Holonomic:
    """A caller's model with three inputs (K5's m > 2 branch): a planar
    vehicle that drives, turns and slides sideways. x = (px, py, theta),
    u = (v, omega, s)."""
    X_DIM, U_DIM = 3, 3
    CUDA_STEP = """
struct Holonomic {
  static constexpr int NX = 3, NU = 3, ANGLE = 2;
  template <typename S, typename T>
  ILQR_HD static void step(const S* x, const S* u, T dt, T sn, T cs, S* y) {
    y[0] = x[0] + u[0] * mcos(x[2], sn, cs) * dt - u[2] * msin(x[2], sn, cs) * dt;
    y[1] = x[1] + u[0] * msin(x[2], sn, cs) * dt + u[2] * mcos(x[2], sn, cs) * dt;
    y[2] = x[2] + u[1] * dt;
  }
};
"""

    @staticmethod
    def step_comps(x, u, dt):
        px, py, th = x
        v, w, s = u
        return (px + v * torch.cos(th) * dt - s * torch.sin(th) * dt,
                py + v * torch.sin(th) * dt + s * torch.cos(th) * dt,
                th + w * dt)


class PointMass:
    """A caller's model with three inputs and no transcendental: a 3-D
    point mass, x = (p, v), u = a; p' = p + v dt + a dt^2 / 2,
    v' = v + a dt."""
    X_DIM, U_DIM = 6, 3
    CUDA_STEP = """
struct PointMass {
  static constexpr int NX = 6, NU = 3, ANGLE = -1;
  template <typename S, typename T>
  ILQR_HD static void step(const S* x, const S* u, T dt, T, T, S* y) {
    for (int c = 0; c < 3; ++c) {
      y[c] = x[c] + x[3 + c] * dt + (T)0.5 * u[c] * dt * dt;
      y[3 + c] = x[3 + c] + u[c] * dt;
    }
  }
};
"""

    @staticmethod
    def step_comps(x, u, dt):
        p, v = x[:3], x[3:]
        return (tuple(p[c] + v[c] * dt + 0.5 * u[c] * dt * dt
                      for c in range(3))
                + tuple(v[c] + u[c] * dt for c in range(3)))


K5_MODELS = {"double_integrator": double_integrator, "unicycle": unicycle,
             "bicycle": kinetic_bicycle, "holonomic": Holonomic,
             "point_mass": PointMass}


def k5_task(name: str, nh: int, b: int, device):
    """(model, K5 settings, f64 (x0, x_term, u_init)) of a small task for
    each model of ``K5_MODELS`` at horizon ``nh``, ``b`` lanes drawn from
    ``np.random.default_rng(nh)``: the reach tasks of the JAX package's
    tests/test_generic_ilqr.py with jittered targets (double integrator,
    unicycle), the bicycle with IlqrParams costs, and two models a caller
    gives with three inputs: the holonomic vehicle with
    tests/test_torch_generic_ilqr_soa.py's 3-input costs and the point mass
    with the double integrator's; cap 60."""
    rng = np.random.default_rng(nh)
    model = K5_MODELS[name]
    n, m = model.X_DIM, model.U_DIM
    x0, u0 = np.zeros((n, b)), np.zeros((nh, m, b))
    if name in ("double_integrator", "point_mass"):
        kw = dict(matrix_Q=np.zeros((n, n)), matrix_R=0.05 * np.eye(m),
                  matrix_Qterminal=20.0 * np.eye(n), u_lower=-2.0 * np.ones(m),
                  u_upper=2.0 * np.ones(m), dt=0.5)
        xt = rng.uniform(-4, 4, (n, b))
    elif name == "unicycle":
        kw = dict(matrix_Q=np.zeros((n, n)), matrix_R=0.01 * np.eye(m),
                  matrix_Qterminal=30.0 * np.eye(n),
                  u_lower=-1.5 * np.ones(m), u_upper=1.5 * np.ones(m), dt=0.5)
        xt = np.array([2.0, 1.0, 0.5])[:, None] + 0.5 * rng.normal(
            size=(n, b))
        u0 = u0 + 0.1
    elif name == "holonomic":
        kw = dict(matrix_Q=0.1 * np.eye(n),
                  matrix_R=0.05 * np.eye(m) + 0.01 * np.ones((m, m)),
                  matrix_Qterminal=25.0 * np.eye(n),
                  u_lower=-1.5 * np.ones(m), u_upper=1.5 * np.ones(m), dt=0.5)
        xt = rng.uniform(-2, 2, (n, b))
        u0 = u0 + 0.1
    else:
        p, lim = IlqrParams.make(device="cpu"), SystemLimits.make(device="cpu")
        kw = generic_kwargs(p, lim, max_iter=60)
        x0[2] = 1.0
        xt = (np.array([20.0, 2.0, 3.0, 0.2])[:, None]
              + np.array([8.0, 8.0, 2.0, 0.3])[:, None] * rng.normal(
                  size=(n, b)))
    kw.update(n=n, m=m, num_horizon=nh, max_iter=60)
    f = lambda a: torch.tensor(a, dtype=torch.float64, device=device)
    return model, kw, (f(x0), f(xt), f(u0))


def throughput_inputs(batch: int, device):
    """(x0, x_terminal, u_init) of the bench.py:237-241 row."""
    rng = np.random.default_rng(0)
    xts = torch.tensor(rng.uniform(-20, 20, (4, batch)), dtype=torch.float32,
                       device=device)
    x0 = torch.tensor([0.0, 0.0, 1.0, 0.0], device=device)[:, None].expand(
        4, batch).contiguous()
    return x0, xts, torch.zeros((6, 2, batch), device=device)


def bench_throughput(batch: int = 32768, max_iter: int = 150,
                     device=None) -> dict:
    """The double integrator through K5 at the bench.py generic row."""
    device = resolve(device)
    params = IlqrParams.make(device=device)
    limits = SystemLimits.make(device=device)
    g_di = build_fused_generic_ilqr(
        double_integrator, **generic_kwargs(params, limits, max_iter=max_iter,
                                            matrix_Q=np.zeros((4, 4))))
    args = throughput_inputs(batch, device)
    t, (_, _, _, iters) = best_seconds(lambda: g_di(*args), device)
    return {"bench": "generic_throughput", "card": card_line(device),
            "device": str(device), "batch": batch, "max_iter": max_iter,
            "double_integrator_k5_solves_per_s": round(batch / t, 1),
            "seconds": t, "mean_iters": float(iters.double().mean()),
            "max_iters": int(iters.max()),
            "warp_trips": warp_trips(iters, max_iter),
            "k5_launches": g_di.launches}


def bench_kernel(batch: int = 131072, max_iter: int = 150,
                 device=None) -> dict:
    """K5 on the bicycle and the double integrator against K3 on the same
    bicycle lanes (absent obstacle)."""
    device = resolve(device)
    rng = np.random.default_rng(0)
    params = IlqrParams.make(device=device)
    limits = SystemLimits.make(device=device)
    xts = candidates(batch, rng, device)
    x0 = torch.tensor([0.0, 0.0, 1.0, 0.0], device=device)[:, None].expand(
        4, batch).contiguous()
    u_init = torch.zeros((6, 2, batch), device=device)
    gkw = generic_kwargs(params, limits, max_iter=max_iter)
    k3 = build_fused_ilqr(params, limits, 1.0, num_horizon=6,
                          max_iter=max_iter)
    obs = obstacle_to_lanes(Obstacle.absent(device=device), batch)
    t_bike, _ = best_seconds(lambda: k3(x0, xts, u_init, obs), device)
    g_bike = build_fused_generic_ilqr(kinetic_bicycle, **gkw)
    t_gb, out_gb = best_seconds(lambda: g_bike(x0, xts, u_init), device)
    g_di = build_fused_generic_ilqr(double_integrator, **gkw)
    t_di, out_di = best_seconds(lambda: g_di(x0, xts, u_init), device)
    return {"bench": "generic_k5_vs_bicycle_kernel",
            "card": card_line(device), "device": str(device),
            "batch": batch, "max_iter": max_iter,
            "bicycle_k3_solves_per_s": round(batch / t_bike, 1),
            "bicycle_k5_solves_per_s": round(batch / t_gb, 1),
            "double_integrator_k5_solves_per_s": round(batch / t_di, 1),
            "k5_vs_k3_time_ratio": round(t_gb / t_bike, 3),
            "bicycle_k5_warp_trips": warp_trips(out_gb[3], max_iter),
            "double_integrator_k5_warp_trips": warp_trips(out_di[3],
                                                          max_iter),
            "k5_launches": g_bike.launches + g_di.launches,
            "k3_launches": k3.launches}


def bench_crossover(batch: int = 256, horizons=(16, 64, 256, 1024),
                    device=None) -> dict:
    """Host-tier solve ms by horizon, sequential against parallel."""
    device = resolve(device)
    rng = np.random.default_rng(1)
    rows = {}
    for nh in horizons:
        cfg = GenericIlqrConfig.make(
            matrix_Q=np.zeros((4, 4)), matrix_R=0.05 * np.eye(2),
            matrix_Qterminal=20.0 * np.eye(4), u_lower=-2.0 * np.ones(2),
            u_upper=2.0 * np.ones(2), max_iter=8, device=device)
        x0 = torch.zeros(4, device=device)
        xts = torch.tensor(rng.uniform(-20, 20, (batch, 4)),
                           dtype=torch.float32, device=device)
        u_init = torch.zeros((nh, 2), device=device)
        times = {mode: best_seconds(
            lambda mode=mode: generic_ilqr_solve_candidates(
                double_integrator.step, cfg, x0, xts, u_init, 1.0, 0.1,
                mode), device, reps=2)[0]
            for mode in ("sequential", "parallel")}
        rows[nh] = {m: round(v * 1e3, 2) for m, v in times.items()}
        rows[nh]["speedup"] = round(times["sequential"] / times["parallel"],
                                    2)
    return {"bench": "riccati_backward_crossover",
            "card": card_line(device), "device": str(device),
            "batch": batch, "solve_ms_by_horizon": rows}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--throughput", action="store_true")
    ap.add_argument("--kernel", action="store_true")
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--max-iter", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    args = ap.parse_args(argv)
    if args.throughput or not (args.kernel or args.crossover):
        print(json.dumps(bench_throughput(batch=args.batch or 32768,
                                          max_iter=args.max_iter,
                                          device=args.device)), flush=True)
    if args.kernel:
        print(json.dumps(bench_kernel(batch=args.batch or 131072,
                                      max_iter=args.max_iter,
                                      device=args.device)), flush=True)
    if args.crossover:
        print(json.dumps(bench_crossover(batch=args.batch or 256,
                                         device=args.device)), flush=True)


if __name__ == "__main__":
    main()
