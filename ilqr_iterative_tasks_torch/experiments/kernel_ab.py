"""K1, K2 `all`, K2 spaceVarying / timeVarying, K3, K4 and K5 of this checkout
against those of another checkout (an earlier commit) and of edited copies
of this checkout's sources, in turns on one card.

    python -m ilqr_iterative_tasks_torch.experiments.kernel_ab \\
        --other DIR [--generic | --k4 | --k32] [--also NAME DIR ...] \\
        [--variant NAME FILE OLD NEW ...] [--out chiprun_out/kernel_ab.json]

DIR holds the other checkout (``DIR/ilqr_iterative_tasks_torch/csrc``, whose
launchers keep the same C interface); ``--also`` names more checkouts, timed
as every kernel beside it (the SASS is compared with the first). A variant
is a copy of this
checkout's csrc/ in which the text OLD of FILE is replaced by NEW (it must
occur once), for instance K2 timeVarying at another tile width, or K4
capped at 168 registers:

    --variant TV_G2 nlmpc_step.cu "K2_TV_G = 1;" "K2_TV_G = 2;"
    --variant K4_CAP3 fused_lm_shooting.cu "__launch_bounds__(128)" \\
        "__launch_bounds__(128, 3)"

Edits given under one NAME make one copy. A variant of ``i2lqr_step.cu`` is
timed as K1, one of ``nlmpc_step_all.cu`` as K2 `all`, one of
``nlmpc_step.cu`` as K2 spaceVarying and timeVarying, one of
``fused_ilqr.cu`` as K3, one of ``fused_lm_shooting.cu`` as K4, one of
``generic_ilqr.cuh`` or ``dual.cuh`` as K5, one of any other file as all of
them. Every library is built at once (one
nvcc a source); the simulators and the plain steps are this checkout's, and
only the library the wrappers launch from changes between turns. K5 is a
library a (model, horizon) where the checkout has csrc/generic_ilqr.cuh,
built against that checkout's header with the rest, and the one library's
table of five (model, horizon) in an earlier checkout (``TableK5``).

K3 and K5 (all of it with ``--generic``, which leaves out K1, K2 and K4;
left out by ``--k4``, which runs only K4's group): on the
lanes of ``generic_bench.py --throughput`` (K5, the double integrator) and
``--kernel`` (K5 on the bicycle and the double integrator, K3 with an absent
obstacle), and on the tasks of ``generic_bench.k5_task`` (the five (model,
horizon) an earlier checkout's table holds, f32 and f64, 1 000 lanes),
every library's outputs must
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
checkouts only), and the i2LQR headline through the per-candidate path
(K3, chip_smoke.py phase 22).

K4: on phase 7's random lanes (chip_smoke.py, ``random_k4_lanes``) and on
the lanes of K4's call at the lap-2 captures (chip_smoke.py's rules) of
the NLMPC spaceVarying headline through the per-candidate path (phase 23)
and of the spaceVarying run over every stored lap (``all_ss_iter``,
B = 8 192, phase 24), in f64 and f32, this checkout's K4 must equal its
plain version and every library's this checkout's bit for bit; then the
f32 ms a call in turns, with the lanes and live lanes; then those
headlines and the timeVarying one over every stored lap through each
library in turns.

K1 at k = 32 (all of it with ``--k32``, which leaves out the rest): on
the k32_nsi4 sweep's captures (chip_smoke.py phase 19's rule), at nsi 4
and, on their last two stored laps, nsi 2, every library that
instantiates it must equal this checkout's bit for bit; then the f32 ms a
step in turns, beside the solves a live lane-step that a counting build of
this checkout runs on the card (``headlines.counted_solves``), the
distinct ones the step needs (``headlines.k32_distinct``) and the
3 x nsi x 32 of the plain order; then the k32_nsi4 sweep (B = 4 096, 4
laps, moving obstacle, seed 0; ``scenario_sweep.run_sweep``) through each
library in turns, two runs each, whose lap records must agree, with the
run's host seconds, then one more run each under the profiler.

For every headline: host seconds, lap-sims/s, the
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
-sass``), and the f32 K3, K4 and K5 kernels of every library counted
(instructions, local loads and stores). Printed as lines and one JSON object (also written to
``--out``), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import shutil
import subprocess
import time

import numpy as np
import torch

from ilqr_iterative_tasks_torch.control import batched_nlmpc_soa, batched_soa
from ilqr_iterative_tasks_torch.experiments.generic_bench import (
    K5_MODELS, bench_kernel, bench_throughput, candidates, card_line,
    generic_kwargs, k5_task, throughput_inputs, warp_trips)
from ilqr_iterative_tasks_torch.experiments.headlines import (
    ALL_BATCH, BATCH, CAP, EVERY_CAPTURES, K1_COUNT, K2_ATTRS, K3_ATTRS,
    K4_ATTRS, LAPS, MAX_LAPS, MAX_STEPS, N, NL_CAP, NL_CAPTURES, SWEEP_BATCH,
    SWEEP_LAPS, SWEEP_CAP, Headlines, Recorder, counted_solves, cuda_ms,
    device_seconds, k1_capture, k2_capture, k32_distinct, lap_records_hash,
    launching, random_k4_lanes, require, sweep_capture, sweep_step_solver,
    tap_step, want_capture)
from ilqr_iterative_tasks_torch.experiments.nlmpc_profile import EventTimed
from ilqr_iterative_tasks_torch.experiments.scenario_sweep import run_sweep
from ilqr_iterative_tasks_torch.models import (
    double_integrator, kinetic_bicycle, unicycle)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops import _build
from ilqr_iterative_tasks_torch.ops.fused_generic_ilqr import (
    build_fused_generic_ilqr, k5_source)
from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
    build_fused_ilqr, obstacle_to_lanes)
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    build_fused_lm_shooting, fused_lm_shooting_reference)
from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
    build_fused_i2lqr_step, i2lqr_step_reference)
from ilqr_iterative_tasks_torch.ops.ilqr_soa import ilqr_solve_soa
from ilqr_iterative_tasks_torch.ops.nlmpc_step import (
    build_fused_nlmpc_step, nlmpc_step_reference)
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, LmpcParams, SystemLimits)

# the kernels a variant of each file is timed as (any other file: all)
GROUPS = {"i2lqr_step.cu": ("k1",), "nlmpc_step_all.cu": ("all",),
          "nlmpc_step.cu": ("k2",), "fused_ilqr.cu": ("k3",),
          "fused_lm_shooting.cu": ("k4",), "generic_ilqr.cuh": ("k5",),
          "dual.cuh": ("k5",)}
# the f32 kernels whose resources are reported, by their attributes entry
# and its arguments and, in a build log, by their name's prefix (K2
# spaceVarying and timeVarying: qsort_skip, nsi 1)
RESOURCES = {
    "k1": ("i2lqr_step_attributes", (0, N, 8, 1),
           f"i2lqr_step_kernel<float,{N},8,1>"),
    "k1_k32": ("i2lqr_step_attributes", (0, N, 32, 4),
               f"i2lqr_step_block_kernel<float,{N},4"),
    "k2_all": ("nlmpc_step_all_attributes", (0, N),
               f"nlmpc_step_all_kernel<float,{N}"),
    "k2_sv": ("nlmpc_step_attributes", (0, N, 8, 1, 0, 1),
              f"nlmpc_step_kernel<float,{N},8,1>"),
    "k2_tv": ("nlmpc_step_attributes", (0, N, 8, 1, 1, 1),
              f"nlmpc_step_kernel<float,{N},8,1>"),
    "k3": ("fused_ilqr_attributes", (0, N), f"fused_ilqr_kernel<float,{N}"),
    "k4": ("fused_lm_shooting_attributes", (0, N),
           f"fused_lm_shooting_kernel<float,{N}"),
}
# the (model, horizon) of an earlier checkout's K5 table (its
# generic_ilqr.cu), whose model codes these are; the K5 tasks timed
K5_INSTANTIATIONS = (("bicycle", 6), ("double_integrator", 6),
                     ("double_integrator", 10), ("unicycle", 6),
                     ("unicycle", 8))
TABLE_CODES = {double_integrator: 0, unicycle: 1, kinetic_bicycle: 2}
# the f32 K5 kernels whose resources are reported
K5_RESOURCES = {"k5_double_integrator": (double_integrator, N),
                "k5_bicycle": (kinetic_bicycle, N)}


class TableK5:
    """An earlier checkout's K5 for one (model, horizon) of its table, with
    a generated library's C interface."""

    def __init__(self, lib, model, nh):
        self.lib, self.code, self.nh = lib, TABLE_CODES[model], nh

    def k5_launch(self, dtype, *rest):
        return self.lib.generic_ilqr_launch(dtype, self.code, self.nh, *rest)

    def k5_attributes(self, dtype, out):
        return self.lib.generic_ilqr_attributes(dtype, self.code, self.nh,
                                                out)


def k5_sources():
    """The K5 translation units the generic A/B launches."""
    tasks = K5_INSTANTIATIONS + tuple(
        (name, N) for name in ("double_integrator", "bicycle"))
    return sorted({k5_source(K5_MODELS[name], nh) for name, nh in tasks})


def k5_libraries(lib, csrc_dir):
    """(model, horizon) -> the K5 library of a checkout: generated against
    its csrc/generic_ilqr.cuh, else its one library's table."""
    if os.path.exists(os.path.join(csrc_dir, "generic_ilqr.cuh")):
        return lambda model, nh: _build.generic_library(
            k5_source(model, nh), csrc_dir)
    return lambda model, nh: TableK5(lib, model, nh)


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


def resources(lib, path: str, built_here: bool, k5) -> dict:
    """The f32 resources of RESOURCES' kernels in one library and of
    K5_RESOURCES' in its K5 libraries ``k5`` (module docstring)."""
    out = {}
    for key, (model, nh) in K5_RESOURCES.items():
        try:
            out[key] = dict(_build.attributes(k5(model, nh), "k5_attributes",
                                              0), source="CUDA runtime")
        except AttributeError:  # an earlier library without attributes
            pass
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


def sass_counts(funcs: dict, prefixes=(
        "_ZN4ilqr17fused_ilqr_kernelIf", "_ZN4ilqr24fused_lm_shooting_kernelIf",
        "_ZN4ilqr19generic_ilqr_kernelIf")):
    """{kernel: (instructions, local loads, local stores)} of the f32 K3, K4
    and K5 kernels in a library's SASS (``sass``)."""
    out = {}
    for name, text in funcs.items():
        if name.startswith(prefixes):
            ops = re.findall(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", text)
            out[name] = (len(ops), ops.count("LDL"), ops.count("STL"))
    return out


def generic_ab(dev, libs, k5libs, names_k3, names_k5) -> dict:
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
        with launching(libs["this"], k5libs["this"]):
            ref = kern(*a)
        for name in names:
            with launching(libs[name], k5libs[name]):
                got = kern(*a)
            require(all(torch.equal(g, w) for g, w in zip(got, ref)),
                    f"{tag}: {name} differs from this checkout's kernel")
        ms = {name: [] for name in names}
        for name in names + names[::-1]:
            with launching(libs[name], k5libs[name]):
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
        with launching(libs[name], k5libs[name]):
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


def headlines(libs, tag, run, kern, kernel_name, names, b, seeds=(1, 2),
              attrs=K2_ATTRS, spans=True):
    """``run(seed, kernel)`` through each library of ``names`` in turns,
    one seed a turn, with CUDA-event spans around each call of ``kern``
    (``spans``), then once more each under the profiler (module
    docstring); the lap records must agree between libraries."""
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


def capture_steps(libs, tag, kern, captured, names, reps):
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


def k32_names(libs, names):
    """Those of ``names`` whose library instantiates K1 at k = 32."""
    out3 = (ctypes.c_int * 3)()
    return [n for n in names
            if libs[n].i2lqr_step_attributes(0, N, 32, 4, out3) == 0]


def k32_ab(dev, libs, names, counting) -> dict:
    """K1 at k = 32 of each library on the k32_nsi4 sweep's captures, then
    that sweep in turns (module docstring); ``counting`` is this
    checkout's counting library."""
    names = k32_names(libs, names)

    def sweep(result=None):
        return run_sweep(SWEEP_BATCH, SWEEP_LAPS, moving=True,
                         num_ss_points=32, num_ss_iter=4, quiet=True,
                         device=dev, result=result)

    with sweep_step_solver(32, 4, sweep_capture, device=dev) as (k32, cap32):
        sweep()
    limits = SystemLimits.make(device=dev)
    p2 = IlqrParams.make(num_ss_points=32, num_ss_iter=2, device=dev)
    k32_2 = build_fused_i2lqr_step(p2, limits, 1.0, num_horizon=N,
                                   max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                                   max_iter=SWEEP_CAP)
    nsi2 = {}
    solves = {}
    for lap, (step, a) in sorted(cap32.captured.items()):
        a2 = list(a)
        a2[5], a2[6] = a[5][-2:].contiguous(), a[6][-2:].contiguous()
        nsi2[lap] = (step, a2)
        n_act = int((a[8] < 0.5).sum())
        for tag, kern, args in (("nsi4", k32, a), ("nsi2", k32_2, a2)):
            cands = []
            i2lqr_step_reference(kern.params, limits, 1.0, *args,
                                 max_iter=SWEEP_CAP, cands=cands)
            need = sum(int(m.sum()) for m in k32_distinct(args[5], args[6],
                                                          cands))
            ran = counted_solves(counting, lambda: kern(*args))
            require(need <= ran <= need + 4 * n_act,
                    f"K1 k32 {tag} lap {lap}: {ran} solves, {need} needed")
            row = dict(solves=ran / n_act, distinct=need / n_act,
                       plain_solves=3 * kern.nsi * 32, lap_ok=args[6].tolist())
            solves[f"{tag}_lap{lap}_step{step}"] = row
            print(f"[K1 k32 {tag} lap {lap} step {step} solves a live "
                  f"lane-step] {json.dumps(row)}", flush=True)
    report = dict(solves=solves, steps=dict(
        nsi4=capture_steps(libs, "K1 k32 nsi4", k32, cap32.captured, names,
                           10),
        nsi2=capture_steps(libs, "K1 k32 nsi2", k32_2, nsi2, names, 10)))
    runs = {name: dict(s=[], hash=[]) for name in names}
    for name in names + names[::-1] + names + names[::-1]:
        res = []
        with launching(libs[name]):
            t0 = time.perf_counter()
            sweep(res)
            sec = time.perf_counter() - t0
        runs[name]["s"].append(sec)
        runs[name]["hash"].append(lap_records_hash(res[0]))
        print(f"[k32_nsi4 sweep {name}] {sec:.3f} s, hash "
              f"{runs[name]['hash'][-1]}", flush=True)
        del res
    require(len({h for r in runs.values() for h in r["hash"]}) == 1,
            "k32_nsi4 sweep: lap records differ between runs")
    for name in names:
        with launching(libs[name]):
            k_s, busy_s, host_s = device_seconds(sweep,
                                                 "i2lqr_step_block_kernel")
        runs[name].update(device_s=k_s, busy_s=busy_s,
                          profiled_host_s=host_s)
        print(f"[k32_nsi4 sweep {name} profiled] i2lqr_step_block_kernel "
              f"{k_s:.4f} s of the card a run; the card busy {busy_s:.4f} "
              f"s of {host_s:.3f} s under the profiler", flush=True)
    report["sweep"] = runs
    return report


def k1_k2_ab(dev, libs, names) -> dict:
    """K1 and K2 of each library at the headlines' captures, then their
    headlines, in turns (module docstring)."""
    report = {}
    # ---- captures, through this checkout's kernels ----
    hl = Headlines(dev)
    sizes = dict(max_steps=MAX_STEPS, max_laps=MAX_LAPS)
    # K1 in the plain order, the kernel every library has (the simulator's
    # own K1 takes dedup and qsort_skip, csrc/i2lqr_step_opts.cu)
    k1 = build_fused_i2lqr_step(hl.params, hl.limits, 1.0, num_horizon=N,
                                **sizes, max_iter=CAP)

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
    names_k32 = k32_names(libs, names["k1"])
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
    report["steps"] = dict(
        k1=capture_steps(
            libs, "K1", k1, cap1.captured, names["k1"], 10),
        k1_k32=capture_steps(
            libs, "K1 k32 nsi4", k32, cap32.captured, names_k32, 10),
        all_rev_skip=capture_steps(
            libs, "K2 all_rev_skip", k2_all, caps["all"],
            names["all"], 5),
        all_forward=capture_steps(
            libs, "K2 all forward", k2_fwd, caps["all"],
            names["all"], 3),
        all_iter=capture_steps(
            libs, "K2 all_iter", k2_iter, caps["all_iter"],
            names["all"], 3),
        spaceVarying=capture_steps(
            libs, "K2 spaceVarying", k2_sv, caps["spaceVarying"],
            names["k2"], 10),
        spaceVarying_plain=capture_steps(
            libs, "K2 spaceVarying plain order", k2_sv_plain,
            caps["spaceVarying"], ["other", "this"], 5),
        timeVarying=capture_steps(
            libs, "K2 timeVarying", k2_tv, caps["timeVarying"],
            names["k2"], 10),
        timeVarying_plain=capture_steps(
            libs, "K2 timeVarying plain order", k2_tv_plain,
            caps["timeVarying"], ["other", "this"], 5))

    # ---- headlines in turns, one seed a turn, then one profiled run ----
    def nlmpc(lp, sc):
        return lambda s, k: hl.nlmpc(s, lp, sc, k)

    # the per-candidate path's K3, as chip_smoke.py builds it
    k3p = build_fused_ilqr(hl.params, hl.limits, 1.0, num_horizon=N,
                           max_iter=CAP)

    report["headlines"] = dict(
        i2lqr=headlines(libs, "i2lqr", lambda s, k: hl.i2lqr(s, k), k1,
                        "i2lqr_step_kernel", names["k1"], BATCH,
                        spans=False),
        all=headlines(libs, "all", nlmpc(all_p, hl.scen_all), k2_all,
                      "nlmpc_step_all_kernel", names["all"], ALL_BATCH),
        spaceVarying=headlines(libs, "spaceVarying", nlmpc(sv_p, hl.scen),
                               k2_sv, "nlmpc_step_kernel", names["k2"],
                               BATCH),
        spaceVarying_plain=headlines(
            libs, "spaceVarying plain order", nlmpc(sv_p, hl.scen),
            k2_sv_plain, "nlmpc_step_kernel", ["other", "this"], BATCH),
        timeVarying=headlines(libs, "timeVarying", nlmpc(tv_p, hl.scen),
                              k2_tv, "nlmpc_step_kernel", names["k2"], BATCH,
                              seeds=(1, 2, 3, 4, 5)),
        i2lqr_k3=headlines(
            libs, "i2lqr through K3", lambda s, k: hl.i2lqr(s, None, k), k3p,
            "fused_ilqr_kernel", names["k3"], BATCH, attrs=K3_ATTRS))
    hl_sv = report["headlines"]
    require(hl_sv["spaceVarying_plain"]["this"]["hash"]
            == hl_sv["spaceVarying"]["this"]["hash"],
            "spaceVarying headline: qsort_skip changed the lap records")
    return report


def k4_capture(hl, lp, sc, want, all_iter, k4, candidate_solver=None):
    """K4's inputs at the lap-2 capture of a seed-0 run of the NLMPC
    per-candidate path (``lp`` on ``sc``, through ``candidate_solver`` or
    the simulator's default K4): the plain step's inputs tapped by the
    rule ``want`` and the step replayed with ``k4`` under a Recorder."""
    with tap_step(batched_nlmpc_soa, "nlmpc_step_reference", 6, want,
                  all_iter=all_iter) as tap:
        hl.nlmpc(0, lp, sc, None, candidate_solver)
    rec = Recorder(k4, ())
    nlmpc_step_reference(lp, hl.nl_limits, 1.0, *tap.captured[2][1],
                         max_iters=NL_CAP, candidate_solver=rec)
    require(len(rec.calls) == 1, "one K4 call a step")
    return rec.calls[0]


def k4_ab(dev, libs, names) -> dict:
    """K4 of each library on phase 7's random lanes and on the lanes of the
    lap-2 captures of the NLMPC per-candidate headline and of the
    spaceVarying run over every stored lap, then those runs' headlines,
    in turns (module docstring)."""
    hl = Headlines(dev)
    k4 = build_fused_lm_shooting(hl.nl_limits, 1.0, num_horizon=N,
                                 max_iters=NL_CAP)
    sv_p = LmpcParams.make()
    every = {m: LmpcParams.make(ss_option=m, all_ss_iter=True)
             for m in ("spaceVarying", "timeVarying")}
    inputs = dict(
        random_lanes=random_k4_lanes(dev),
        path_lap2=k4_capture(hl, sv_p, hl.scen, want_capture(NL_CAPTURES),
                             False, k4, k4),
        every_lap_lap2=k4_capture(
            hl, every["spaceVarying"], hl.scen_all,
            lambda lap, i, a: EVERY_CAPTURES.get(lap) == i, True, k4))
    report = {"calls": {}}
    for tag, a in inputs.items():
        live = int((a[4] < 0.5).sum())
        for dtype in (torch.float64, torch.float32):
            ad = tuple(t.to(dtype) if t.is_floating_point() and i != 4
                       else t for i, t in enumerate(a))
            with launching(libs["this"]):
                ref = k4(*ad)
            require(all(torch.equal(g, w) for g, w in zip(
                ref, fused_lm_shooting_reference(
                    hl.nl_limits, 1.0, *ad, num_horizon=N,
                    max_iters=NL_CAP))),
                    f"K4 {tag} {dtype}: not bitwise equal to the plain solve")
            for name in names:
                with launching(libs[name]):
                    got = k4(*ad)
                require(all(torch.equal(g, w) for g, w in zip(got, ref)),
                        f"K4 {tag} {dtype}: {name} differs from this "
                        f"checkout's kernel")
        ms = {name: [] for name in names}
        for name in names + names[::-1]:
            with launching(libs[name]):
                ms[name].append(cuda_ms(lambda: k4(*ad), 5))
        report["calls"][tag] = dict(lanes=a[1].shape[-1], live_lanes=live,
                                    ms=ms)
        print(f"[K4 {tag}] {a[1].shape[-1]} lanes ({live} live), bitwise "
              f"equal to the plain solve and between libraries; f32 ms a "
              f"call " + ", ".join(f"{n} {v[0]:.3f}/{v[1]:.3f}"
                                   for n, v in ms.items()), flush=True)
    del inputs, a, ad, ref, got
    kw = dict(attrs=K4_ATTRS)
    report["headlines"] = dict(
        spaceVarying_k4=headlines(
            libs, "spaceVarying through K4",
            lambda s, k: hl.nlmpc(s, sv_p, hl.scen, None, k), k4,
            "fused_lm_shooting_kernel", names, BATCH, **kw),
        **{f"every_lap_{m}": headlines(
            libs, f"{m} over every stored lap",
            lambda s, k, lp=lp: hl.nlmpc(s, lp, hl.scen_all, None, k), k4,
            "fused_lm_shooting_kernel", names, ALL_BATCH, **kw)
           for m, lp in every.items()})
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--generic", action="store_true",
                    help="K3 and K5 only (no K1, no K2, no K4)")
    ap.add_argument("--k4", action="store_true",
                    help="K4 only (no K1, no K2, no K3, no K5)")
    ap.add_argument("--k32", action="store_true",
                    help="K1 at k = 32 only")
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
        futures = {n: ex.submit(_build.build, d) for n, d in dirs.items()}
        generated = {n: ex.submit(_build.build_generic, k5_sources(), d)
                     for n, d in dirs.items()
                     if os.path.exists(os.path.join(d, "generic_ilqr.cuh"))}
        if args.k32:  # this checkout's counting build
            counting = ex.submit(_build.build, _build.CSRC_DIR, K1_COUNT)
        built = {name: f.result() for name, f in futures.items()}
        generated = {name: [p for p, _ in f.result()]
                     for name, f in generated.items()}
        if args.k32:
            counting = _build.load(counting.result()[0])
    build_s = time.perf_counter() - t0
    libs = {name: _build.load(path) for name, (path, _) in built.items()}
    k5libs = {name: k5_libraries(libs[name], dirs[name]) for name in libs}
    report = dict(card=card, build_s=build_s, resources={
        name: resources(libs[name], path, sec > 0, k5libs[name])
        for name, (path, sec) in built.items()})
    print(f"[kernel_ab] {card}; build {build_s:.1f} s", flush=True)
    for name, res in report["resources"].items():
        print(f"[resources {name}] {json.dumps(res)}", flush=True)
    # the kernels both checkouts build under one name: same SASS? (K5's
    # from its generated libraries where the checkout has them)
    def sass_all(name):
        out = sass(built[name][0])
        if out is not None:
            for path in generated.get(name, ()):
                out.update(sass(path))
        return out

    this_sass, other_sass = sass_all("this"), sass_all("other")
    if this_sass is not None:
        report["same_sass"] = {k: this_sass[k] == other_sass[k]
                               for k in sorted(other_sass) if k in this_sass}
        print(f"[same SASS as the other checkout] "
              f"{json.dumps(report['same_sass'])}", flush=True)
        report["sass_counts"] = {
            name: sass_counts({"this": this_sass, "other": other_sass}.get(
                name) or sass_all(name)) for name in built}
        for name, counts in report["sass_counts"].items():
            print(f"[SASS instructions, local loads, local stores {name}] "
                  f"{json.dumps(counts)}", flush=True)

    if args.k32:
        report["k32"] = k32_ab(dev, libs, names["k1"], counting)
    if not (args.k4 or args.k32):
        report["generic"] = generic_ab(dev, libs, k5libs, names["k3"],
                                       names["k5"])
    if not (args.generic or args.k4 or args.k32):
        report.update(k1_k2_ab(dev, libs, names))
    if not (args.generic or args.k32):
        report["k4"] = k4_ab(dev, libs, names["k4"])
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
