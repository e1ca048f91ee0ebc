"""K1, K2 `all`, K2 spaceVarying / timeVarying, K3, K4 and K5 of this checkout
against those of another checkout (an earlier commit) and of edited copies
of this checkout's sources, in turns on one card.

    python -m ilqr_iterative_tasks_torch.experiments.kernel_ab \\
        --other DIR [--generic] [--also NAME DIR ...] \\
        [--variant NAME FILE OLD NEW ...] [--out chiprun_out/kernel_ab.json]

DIR holds the other checkout (``DIR/ilqr_iterative_tasks_torch/csrc``, whose
launchers keep the same C interface); ``--also`` names more checkouts, timed
as every kernel beside it (the SASS is compared with the first). A variant
is a copy of this
checkout's csrc/ in which the text OLD of FILE is replaced by NEW (it must
occur once), for instance K2 timeVarying at another tile width:

    --variant TV_G2 nlmpc_step.cu "K2_TV_G = 1;" "K2_TV_G = 2;"

Edits given under one NAME make one copy. A variant of ``i2lqr_step.cu`` is
timed as K1, one of ``nlmpc_step_all.cu`` as K2 `all`, one of
``nlmpc_step.cu`` as K2 spaceVarying and timeVarying, one of
``fused_ilqr.cu`` as K3, one of ``fused_lm_shooting.cu`` as K4, one of
``generic_ilqr.cu`` or ``dual.cuh`` as K5, one of any other file as all of
them. Every library is built at once (one
nvcc a source); the simulators and the plain steps are this checkout's, and
only the library the wrappers launch from changes between turns.

K3 and K5 (all of it with ``--generic``, which leaves out K1 and K2): on the
lanes of ``generic_bench.py --throughput`` (K5, the double integrator) and
``--kernel`` (K5 on the bicycle and the double integrator, K3 with an absent
obstacle), and on the tasks of ``generic_bench.k5_task`` (every K5
instantiation, f32 and f64, 1 000 lanes), every library's outputs must
equal this checkout's bit for bit; then each kernel's ms a call by CUDA
events in turns, and the generic headline (``bench_throughput`` and
``bench_kernel``) through each library in turns. The trips the lanes take
(``generic_bench.warp_trips``) come from K5's ``n_iters`` and, for K3, from
the plain solve on the first 32 768 ``--kernel`` lanes.

On the inputs ``chip_smoke.py`` captures (its rule, experiments/headlines.py)
from the i2LQR headline (K1), the robustness sweep's k32_nsi4 run (K1 at
k = 32, timed only for the libraries that instantiate it), the `all`
headline (K2 `all_rev_skip` and the forward scan), an `all_iter` run and
the NLMPC headlines (K2 spaceVarying and timeVarying with qsort_skip, as
the simulator builds them, and without it), every library's outputs must
equal this checkout's bit for bit; then
each kernel's ms a step by CUDA events over repeated launches, in turns (A
B ... B A). Then the i2LQR, `all`, NLMPC (spaceVarying) and timeVarying
headlines through each library in turns, one seed a turn (two seeds, five
for timeVarying as chip_smoke.py's phase 15; spaceVarying also in the
plain order, whose lap records must equal qsort_skip's, through the two
checkouts only), and the i2LQR and NLMPC spaceVarying headlines through the
per-candidate path (K3, K4; chip_smoke.py phases 22-23): host seconds,
lap-sims/s, the
lap records' hash (which must agree between libraries for the same seed)
and, but for K1's, the kernel's CUDA-event spans (which hold the wrapper's
host time where the card waits for it); then one more run each under
``torch.profiler``, whose trace gives the kernel's own device seconds, the
card's busy seconds (every kernel and copy) and the run's host seconds
under the profiler. Registers, local memory and resident warps an SM come
from the CUDA runtime for the libraries that export ``*_attributes``; for a
library without them, registers and spill stores from the ``-Xptxas -v``
log of its build, when this process built it. The kernels both checkouts
build under the same name are compared by their SASS (``cuobjdump
-sass``), and the f32 K3 and K5 kernels of every library counted
(instructions, local loads and stores). Printed as lines and one JSON object (also written to
``--out``), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import os
import re
import shutil
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ilqr_iterative_tasks_torch.control import batched_nlmpc_soa, batched_soa
from ilqr_iterative_tasks_torch.experiments.generic_bench import (
    bench_kernel, bench_throughput, candidates, card_line, generic_kwargs,
    k5_task, throughput_inputs, warp_trips)
from ilqr_iterative_tasks_torch.experiments.headlines import (
    ALL_BATCH, BATCH, CAP, K2_ATTRS, LAPS, MAX_LAPS, MAX_STEPS, N, NL_CAP,
    SWEEP_BATCH, SWEEP_LAPS, Headlines, cuda_ms, k1_capture, k2_capture,
    lap_records_hash, require, sweep_capture, sweep_step_solver)
from ilqr_iterative_tasks_torch.experiments.nlmpc_profile import EventTimed
from ilqr_iterative_tasks_torch.experiments.scenario_sweep import run_sweep
from ilqr_iterative_tasks_torch.models import double_integrator, kinetic_bicycle
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops import _build
from ilqr_iterative_tasks_torch.ops.fused_generic_ilqr import (
    MODEL_CODES, build_fused_generic_ilqr)
from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
    build_fused_ilqr, obstacle_to_lanes)
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    build_fused_lm_shooting)
from ilqr_iterative_tasks_torch.ops.ilqr_soa import ilqr_solve_soa
from ilqr_iterative_tasks_torch.ops.nlmpc_step import build_fused_nlmpc_step
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, LmpcParams, SystemLimits)

# the kernels a variant of each file is timed as (any other file: all)
GROUPS = {"i2lqr_step.cu": ("k1",), "nlmpc_step_all.cu": ("all",),
          "nlmpc_step.cu": ("k2",), "fused_ilqr.cu": ("k3",),
          "fused_lm_shooting.cu": ("k4",), "generic_ilqr.cu": ("k5",),
          "dual.cuh": ("k5",)}
# the f32 kernels whose resources are reported, by their attributes entry
# and its arguments and, in a build log, by their name's prefix (K2
# spaceVarying and timeVarying: qsort_skip, nsi 1)
RESOURCES = {
    "k1": ("i2lqr_step_attributes", (0, N, 8, 1),
           f"i2lqr_step_kernel<float,{N},8,1>"),
    "k1_k32": ("i2lqr_step_attributes", (0, N, 32, 4),
               f"i2lqr_step_block_kernel<float,{N},4,4>"),
    "k2_all": ("nlmpc_step_all_attributes", (0, N),
               f"nlmpc_step_all_kernel<float,{N}"),
    "k2_sv": ("nlmpc_step_attributes", (0, N, 8, 1, 0, 1),
              f"nlmpc_step_kernel<float,{N},8,1>"),
    "k2_tv": ("nlmpc_step_attributes", (0, N, 8, 1, 1, 1),
              f"nlmpc_step_kernel<float,{N},8,1>"),
    "k3": ("fused_ilqr_attributes", (0, N), f"fused_ilqr_kernel<float,{N}"),
    "k4": ("fused_lm_shooting_attributes", (0, N),
           f"fused_lm_shooting_kernel<float,{N}"),
    "k5_double_integrator": (
        "generic_ilqr_attributes", (0, MODEL_CODES["double_integrator"], N),
        f"generic_ilqr_kernel<float,DoubleIntegrator,{N}"),
    "k5_bicycle": ("generic_ilqr_attributes", (0, MODEL_CODES["bicycle"], N),
                   f"generic_ilqr_kernel<float,Bicycle,{N}"),
}
# the (model, horizon) K5 instantiations, as csrc/generic_ilqr.cu's table
K5_INSTANTIATIONS = (("bicycle", 6), ("double_integrator", 6),
                     ("double_integrator", 10), ("unicycle", 6),
                     ("unicycle", 8))
G_LANES, G_KERNEL_LANES, G_CAP = 32768, 131072, 150


def variant_csrc(name: str, edits) -> str:
    """A copy of this checkout's csrc/ with, for each (file, old, new) of
    ``edits``, ``old`` replaced by ``new`` in ``file``, under build/;
    returns its directory."""
    out = os.path.join(os.path.dirname(_build.BUILD_DIR), "kernel_ab", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, out)
    for file, old, new in edits:
        path = os.path.join(out, file)
        with open(path) as f:
            text = f.read()
        require(text.count(old) == 1, f"variant {name}: {old!r} is not in "
                                      f"{file} exactly once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return out


def log_registers(log_path: str) -> dict:
    """{kernel<type,sizes>: (registers, spill-store bytes)} from the
    ``-Xptxas -v`` lines of a build log."""
    out, name, spill = {}, None, 0
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '_ZN4ilqr\d+(\w+?)I"
                          r"([fd])(?:NS_\d+([A-Za-z]+)E)?((?:Li\d+E)+)E",
                          line)
            if m:
                sizes = re.findall(r"Li(\d+)E", m.group(4))
                dtype = "float" if m.group(2) == "f" else "double"
                model = [m.group(3)] if m.group(3) else []
                name = f"{m.group(1)}<{','.join([dtype, *model, *sizes])}>"
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name] = (int(m.group(1)), spill)
                name, spill = None, 0
    return out


def resources(lib, path: str, built_here: bool) -> dict:
    """The f32 resources of RESOURCES' kernels in one library (module
    docstring)."""
    out = {}
    for key, (entry, sizes, prefix) in RESOURCES.items():
        if hasattr(lib, entry):
            try:
                out[key] = dict(_build.attributes(lib, entry, *sizes),
                                source="CUDA runtime")
            except ValueError:  # not instantiated in this library
                pass
        elif built_here:
            regs = log_registers(path[:-3] + ".log")
            name = next((k for k in regs if k.startswith(prefix)), None)
            if name is not None:
                out[key] = dict(registers=regs[name][0],
                                spill_stores=regs[name][1], kernel=name,
                                source="-Xptxas -v of this build")
    return out


def sass(path: str) -> dict | None:
    """{kernel: its SASS} of a built library (``cuobjdump -sass``), or
    None without cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif "....." in line:
            name = None
        elif name:
            funcs[name].append(line.strip())
    return {k: "\n".join(v) for k, v in funcs.items()}


def sass_counts(funcs: dict, prefixes=("_ZN4ilqr17fused_ilqr_kernelIf",
                                        "_ZN4ilqr19generic_ilqr_kernelIf")):
    """{kernel: (instructions, local loads, local stores)} of the f32 K3 and
    K5 kernels in a library's SASS (``sass``)."""
    out = {}
    for name, text in funcs.items():
        if name.startswith(prefixes):
            ops = re.findall(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", text)
            out[name] = (len(ops), ops.count("LDL"), ops.count("STL"))
    return out


def device_seconds(fn, key: str) -> tuple[float, float, float]:
    """(seconds the card spent in kernels whose name holds ``key``, in
    every kernel and copy, host seconds) of one call of ``fn`` under
    ``torch.profiler``, from its trace."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
    dev = [(e.key, getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0)))
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(t for k, t in dev if key in k) / 1e6,
            sum(t for _, t in dev) / 1e6, host)


@contextlib.contextmanager
def launching(lib):
    """The wrappers launch from ``lib`` inside the block."""
    keep = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = keep


def generic_ab(dev, libs, names_k3, names_k5) -> dict:
    """K3 and K5 of each library on the generic benches' lanes and on
    ``k5_task``'s tasks, then the generic headline, in turns (module
    docstring)."""
    params, limits = IlqrParams.make(device=dev), SystemLimits.make(device=dev)
    bench_kw = generic_kwargs(params, limits, max_iter=G_CAP)
    kernel_in = (torch.tensor([0.0, 0.0, 1.0, 0.0], device=dev)[:, None]
                 .expand(4, G_KERNEL_LANES).contiguous(),
                 candidates(G_KERNEL_LANES, np.random.default_rng(0), dev),
                 torch.zeros((N, 2, G_KERNEL_LANES), device=dev))
    obs = obstacle_to_lanes(Obstacle.absent(device=dev),
                            G_KERNEL_LANES).contiguous()
    k3 = build_fused_ilqr(params, limits, 1.0, num_horizon=N,
                          max_iter=G_CAP)
    cases = [
        ("K5 --throughput double_integrator", "k5", 20,
         build_fused_generic_ilqr(double_integrator, **generic_kwargs(
             params, limits, max_iter=G_CAP, matrix_Q=np.zeros((4, 4)))),
         throughput_inputs(G_LANES, dev)),
        ("K5 --kernel bicycle", "k5", 3,
         build_fused_generic_ilqr(kinetic_bicycle, **bench_kw), kernel_in),
        ("K5 --kernel double_integrator", "k5", 5,
         build_fused_generic_ilqr(double_integrator, **bench_kw), kernel_in),
        ("K3 --kernel", "k3", 5, k3, (*kernel_in, obs)),
    ]
    for name, nh in K5_INSTANTIATIONS:
        model, kw, inputs = k5_task(name, nh, 1000, dev)
        k5 = build_fused_generic_ilqr(model, **kw)
        for dtype in (torch.float32, torch.float64):
            cases.append((f"K5 task {name} N{nh} {str(dtype)[6:]}", "k5", 5,
                          k5, tuple(t.to(dtype) for t in inputs)))
    out = {"calls": {}, "trips": {}}
    for tag, kind, reps, kern, a in cases:
        names = names_k3 if kind == "k3" else names_k5
        with launching(libs["this"]):
            ref = kern(*a)
        for name in names:
            with launching(libs[name]):
                got = kern(*a)
            require(all(torch.equal(g, w) for g, w in zip(got, ref)),
                    f"{tag}: {name} differs from this checkout's kernel")
        ms = {name: [] for name in names}
        for name in names + names[::-1]:
            with launching(libs[name]):
                ms[name].append(cuda_ms(lambda: kern(*a), reps))
        out["calls"][tag] = ms
        if kind == "k5" and "task" not in tag:
            out["trips"][tag] = warp_trips(ref[3], G_CAP)
        print(f"[{tag}] bitwise equal; ms a call "
              + ", ".join(f"{n} {v[0]:.3f}/{v[1]:.3f}" for n, v in ms.items())
              + (f"; trips {json.dumps(out['trips'][tag])}"
                 if tag in out["trips"] else ""), flush=True)
    # K3's trips: the plain solve's own counts on the first 32 768 lanes
    a = tuple(t[..., :G_LANES].contiguous() for t in (*kernel_in, obs))
    trips = ilqr_solve_soa(params, limits, a[3], a[0], a[1], a[2],
                           float(params.lamb), 1.0, num_horizon=N,
                           max_iter=G_CAP).lane_iters
    out["trips"]["K3 --kernel (plain, first 32 768 lanes)"] = warp_trips(
        trips, G_CAP)
    print(f"[K3 --kernel trips, plain solve, {G_LANES} lanes] "
          f"{json.dumps(warp_trips(trips, G_CAP))}", flush=True)
    # the generic headline in turns
    heads = {name: [] for name in names_k5}
    for name in names_k5 + names_k5[::-1]:
        with launching(libs[name]):
            thr = bench_throughput(G_LANES, G_CAP, device=dev)
            ker = bench_kernel(G_KERNEL_LANES, G_CAP, device=dev)
        keys = ("double_integrator_k5_solves_per_s",
                "bicycle_k5_solves_per_s", "bicycle_k3_solves_per_s")
        row = {"throughput_" + keys[0]: thr[keys[0]],
               **{"kernel_" + k: ker[k] for k in keys}}
        heads[name].append(row)
        print(f"[generic headline {name}] {json.dumps(row)}", flush=True)
    out["headline"] = heads
    return out


def k1_k2_ab(dev, libs, names) -> dict:
    """K1 and K2 of each library at the headlines' captures, then their
    headlines, in turns (module docstring)."""
    report = {}
    # ---- captures, through this checkout's kernels ----
    hl = Headlines(dev)
    sizes = dict(max_steps=MAX_STEPS, max_laps=MAX_LAPS)
    k1 = batched_soa.default_step_solver(hl.params, hl.limits, 1.0, **sizes,
                                         max_iter=CAP)

    def k2_of(lp, **opts):
        return build_fused_nlmpc_step(lp, hl.nl_limits, 1.0, num_horizon=N,
                                      max_iters=NL_CAP, **sizes, **opts)

    all_p = LmpcParams.make(all_ss_point=True)
    iter_p = LmpcParams.make(all_ss_point=True, all_ss_iter=True)
    sv_p, tv_p = LmpcParams.make(), LmpcParams.make(ss_option="timeVarying")
    # the all headline's K2 as the simulator builds it (all_rev_skip)
    k2_all = batched_nlmpc_soa.default_step_solver(
        all_p, hl.nl_limits, 1.0, **sizes, max_iters=NL_CAP)
    k2_fwd, k2_iter = k2_of(all_p), k2_of(iter_p)
    # spaceVarying and timeVarying as the simulator builds them
    # (qsort_skip), and in the plain order
    k2_sv, k2_tv = (batched_nlmpc_soa.default_step_solver(
        lp, hl.nl_limits, 1.0, **sizes, max_iters=NL_CAP)
        for lp in (sv_p, tv_p))
    require(k2_sv.qsort_skip and k2_tv.qsort_skip,
            "the simulator's K2 without qsort_skip")
    k2_sv_plain, k2_tv_plain = k2_of(sv_p), k2_of(tv_p)
    cap1 = k1_capture(k1)
    hl.i2lqr(0, cap1)
    with sweep_step_solver(32, 4, sweep_capture, device=dev) as (k32, cap32):
        run_sweep(SWEEP_BATCH, SWEEP_LAPS, moving=True, num_ss_points=32,
                  num_ss_iter=4, quiet=True, device=dev)
    out3 = (ctypes.c_int * 3)()
    names_k32 = [n for n in names["k1"] if libs[n].i2lqr_step_attributes(
        0, N, 32, 4, out3) == 0]
    caps = {}
    for tag, lp, sc, kern, it in (
            ("all", all_p, hl.scen_all, k2_all, False),
            ("all_iter", iter_p, hl.scen_all, k2_iter, True),
            ("spaceVarying", sv_p, hl.scen, k2_sv, False),
            ("timeVarying", tv_p, hl.scen, k2_tv, False)):
        cap = k2_capture(kern, all_iter=it)
        hl.nlmpc(0, lp, sc, cap)
        caps[tag] = cap.captured

    # ---- steps at every capture, every library in turns ----
    def steps(tag, kern, captured, names, reps):
        """ms a step of ``kern`` launched from each library of ``names``
        (turns A B ... B A), after checking each library's outputs equal
        this checkout's bit for bit."""
        rows = {}
        for lap, (step, a) in sorted(captured.items()):
            with launching(libs["this"]):
                ref = kern(*a)
            for name in names:
                with launching(libs[name]):
                    got = kern(*a)
                require(all(torch.equal(g, w) for g, w in zip(got, ref)),
                        f"{tag} lap {lap}: {name} differs from this "
                        f"checkout's kernel")
            ms = {name: [] for name in names}
            for name in names + names[::-1]:
                with launching(libs[name]):
                    ms[name].append(cuda_ms(lambda: kern(*a), reps))
            rows[f"lap{lap}_step{step}"] = ms
            print(f"[{tag} lap {lap} step {step}] bitwise equal; ms a step "
                  + ", ".join(f"{n} {v[0]:.3f}/{v[1]:.3f}"
                              for n, v in ms.items()), flush=True)
        return rows

    report["steps"] = dict(
        k1=steps("K1", k1, cap1.captured, names["k1"], 10),
        k1_k32=steps("K1 k32 nsi4", k32, cap32.captured, names_k32, 10),
        all_rev_skip=steps("K2 all_rev_skip", k2_all, caps["all"],
                           names["all"], 5),
        all_forward=steps("K2 all forward", k2_fwd, caps["all"],
                          names["all"], 3),
        all_iter=steps("K2 all_iter", k2_iter, caps["all_iter"],
                       names["all"], 3),
        spaceVarying=steps("K2 spaceVarying", k2_sv, caps["spaceVarying"],
                           names["k2"], 10),
        spaceVarying_plain=steps("K2 spaceVarying plain order", k2_sv_plain,
                                 caps["spaceVarying"], ["other", "this"], 5),
        timeVarying=steps("K2 timeVarying", k2_tv, caps["timeVarying"],
                          names["k2"], 10),
        timeVarying_plain=steps("K2 timeVarying plain order", k2_tv_plain,
                                caps["timeVarying"], ["other", "this"], 5))

    # ---- headlines in turns, one seed a turn, then one profiled run ----
    def headlines(tag, run, kern, kernel_name, names, b, seeds=(1, 2),
                  attrs=K2_ATTRS):
        spans = kern is not k1  # CUDA-event spans around each call
        out = {name: dict(s=[], lap_sims_per_s=[], hash=[], event_k2_s=[])
               for name in names}
        order = [(n, seed) for i, seed in enumerate(seeds)
                 for n in (names if i % 2 == 0 else names[::-1])]
        for name, seed in order:
            timed = EventTimed(kern, attrs) if spans else kern
            with launching(libs[name]):
                t0 = time.perf_counter()
                res = run(seed, timed)
                sec = time.perf_counter() - t0
            r = out[name]
            r["s"].append(sec)
            r["lap_sims_per_s"].append(b * LAPS / sec)
            r["hash"].append(lap_records_hash(res))
            if spans:
                r["event_k2_s"].append(timed.seconds())
            print(f"[{tag} headline {name} seed {seed}] {sec:.3f} s, "
                  f"{b * LAPS / sec:.1f} lap-sims/s, hash "
                  f"{r['hash'][-1]}"
                  + (f", {kernel_name} event spans "
                     f"{r['event_k2_s'][-1]:.3f} s" if spans else ""),
                  flush=True)
            del res
        for i in range(len(seeds)):
            require(len({out[n]["hash"][i] for n in names}) == 1,
                    f"{tag} headline: lap records differ between "
                    f"libraries")
        for name in names:
            with launching(libs[name]):
                k_s, busy_s, host_s = device_seconds(lambda: run(1, kern),
                                                     kernel_name)
            out[name].update(device_s=k_s, busy_s=busy_s,
                             profiled_host_s=host_s)
            print(f"[{tag} headline {name} profiled] {kernel_name} "
                  f"{k_s:.4f} s of the card a run; the card busy "
                  f"{busy_s:.4f} s of {host_s:.3f} s under the profiler",
                  flush=True)
        return out

    def nlmpc(lp, sc):
        return lambda s, k: hl.nlmpc(s, lp, sc, k)

    # the per-candidate path's kernels, as chip_smoke.py builds them
    k3p = build_fused_ilqr(hl.params, hl.limits, 1.0, num_horizon=N,
                           max_iter=CAP)
    k4p = build_fused_lm_shooting(hl.nl_limits, 1.0, num_horizon=N,
                                  max_iters=NL_CAP)

    report["headlines"] = dict(
        i2lqr=headlines("i2lqr", lambda s, k: hl.i2lqr(s, k), k1,
                        "i2lqr_step_kernel", names["k1"], BATCH),
        all=headlines("all", nlmpc(all_p, hl.scen_all), k2_all,
                      "nlmpc_step_all_kernel", names["all"], ALL_BATCH),
        spaceVarying=headlines("spaceVarying", nlmpc(sv_p, hl.scen), k2_sv,
                               "nlmpc_step_kernel", names["k2"], BATCH),
        spaceVarying_plain=headlines(
            "spaceVarying plain order", nlmpc(sv_p, hl.scen), k2_sv_plain,
            "nlmpc_step_kernel", ["other", "this"], BATCH),
        timeVarying=headlines("timeVarying", nlmpc(tv_p, hl.scen), k2_tv,
                              "nlmpc_step_kernel", names["k2"], BATCH,
                              seeds=(1, 2, 3, 4, 5)),
        i2lqr_k3=headlines(
            "i2lqr through K3", lambda s, k: hl.i2lqr(s, None, k), k3p,
            "fused_ilqr_kernel", names["k3"], BATCH,
            attrs=("max_iter", "with_skip")),
        spaceVarying_k4=headlines(
            "spaceVarying through K4",
            lambda s, k: hl.nlmpc(s, sv_p, hl.scen, None, k), k4p,
            "fused_lm_shooting_kernel", names["k4"], BATCH,
            attrs=("max_iters", "with_skip", "with_hzn")))
    hl_sv = report["headlines"]
    require(hl_sv["spaceVarying_plain"]["this"]["hash"]
            == hl_sv["spaceVarying"]["this"]["hash"],
            "spaceVarying headline: qsort_skip changed the lap records")
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--generic", action="store_true",
                    help="K3 and K5 only (no K1, no K2)")
    ap.add_argument("--also", nargs=2, action="append", default=[],
                    metavar=("NAME", "DIR"))
    ap.add_argument("--variant", nargs=4, action="append", default=[],
                    metavar=("NAME", "FILE", "OLD", "NEW"))
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "kernel_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    card = card_line(dev)

    # ---- every library, built at once ----
    dirs = {"this": _build.CSRC_DIR,
            "other": os.path.join(args.other, "ilqr_iterative_tasks_torch",
                                  "csrc")}
    names = {g: ["other", "this"]
             for g in ("k1", "all", "k2", "k3", "k4", "k5")}
    for name, d in args.also:
        dirs[name] = os.path.join(d, "ilqr_iterative_tasks_torch", "csrc")
        for g in names:
            names[g].append(name)
    edits = {}
    for name, file, old, new in args.variant:
        edits.setdefault(name, []).append((file, old, new))
    for name, ed in edits.items():
        dirs[name] = variant_csrc(name, ed)
        for g in sorted({g for file, _, _ in ed
                         for g in GROUPS.get(file, names)}):
            names[g].append(name)
    t0 = time.perf_counter()
    # four libraries at a time, each one nvcc a source: enough to keep the
    # host's cores busy without holding every compiler's memory at once
    with concurrent.futures.ThreadPoolExecutor(min(len(dirs), 4)) as ex:
        built = {name: f.result() for name, f in
                 {n: ex.submit(_build.build, d) for n, d in dirs.items()}
                 .items()}
    build_s = time.perf_counter() - t0
    libs = {name: _build.load(path) for name, (path, _) in built.items()}
    report = dict(card=card, build_s=build_s, resources={
        name: resources(libs[name], path, sec > 0)
        for name, (path, sec) in built.items()})
    print(f"[kernel_ab] {card}; build {build_s:.1f} s", flush=True)
    for name, res in report["resources"].items():
        print(f"[resources {name}] {json.dumps(res)}", flush=True)
    # the kernels both checkouts build under one name: same SASS?
    this_sass, other_sass = sass(built["this"][0]), sass(built["other"][0])
    if this_sass is not None:
        report["same_sass"] = {k: this_sass[k] == other_sass[k]
                               for k in sorted(other_sass) if k in this_sass}
        print(f"[same SASS as the other checkout] "
              f"{json.dumps(report['same_sass'])}", flush=True)
        report["sass_counts"] = {
            name: sass_counts({"this": this_sass, "other": other_sass}.get(
                name) or sass(path)) for name, (path, _) in built.items()}
        for name, counts in report["sass_counts"].items():
            print(f"[SASS instructions, local loads, local stores {name}] "
                  f"{json.dumps(counts)}", flush=True)

    report["generic"] = generic_ab(dev, libs, names["k3"], names["k5"])
    if not args.generic:
        report.update(k1_k2_ab(dev, libs, names))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
