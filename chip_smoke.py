#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ilqr_iterative_tasks_torch/csrc/, checks
each against its plain torch version on the card, and drives the port's
main paths: the batched i2LQR learning run through the whole-step kernel K1,
the batched NLMPC learning run through the whole-step kernel K2 in each
safe-set mode (spaceVarying, timeVarying, all), each a seed lap + 3
learning laps with plant noise on in f32, the same i2LQR and NLMPC
headlines through the per-candidate path (the plain step's glue as torch
ops on the card around the candidate kernels K3 and K4), the NLMPC safe
set over every stored lap through K4, exact resume from a checkpoint, the
randomized moving-obstacle sweep through K1 (k = 8, with and without the
stall_reseed guard, and k = 32 over 4 stored laps), the generic-system
tier's benchmarks through the generic LM-iLQR kernel K5, and the host
tier (one robot, step by step) through K3 and K4: its controllers, the
paper scenarios with moving obstacles, host checkpoint and resume, the
latency bench (with K1), profiling and plots, and the scale-out paths on
torch.distributed (the scenario-sharded headlines through K1 and K2 and
the meshed NLMPC controller through K4 on ranks of one process each).
Phases:

1. device: the card's name and power limit;
2. build: nvcc of the kernel sources (one process per source), and at
   once of a counting build of them (K1 at k = 32 counts its solves) and
   of K5's library of each (model, horizon) phases 11-12 launch (the
   translation unit ops/fused_generic_ilqr.py writes for the model's
   CUDA_STEP; one nvcc each), with seconds (K5's build's wall time
   apart), registers and spills, and the registers, local memory and
   resident warps an SM of the loaded f32 K1 (its lane queue in f64
   too), K2 all, K2 spaceVarying /
   timeVarying (with qsort_skip), K3, K4 (f32 and f64) and K5 (the double
   integrator and the bicycle at N = 6) as the CUDA runtime reports them;
3. K3 (i2LQR per-candidate solve) against the plain solve on 393 216 random
   candidate lanes, f64 and f32;
4. K1 (whole i2LQR step) against the plain step on safe sets captured from
   the i2LQR headline run (early lap 1, mid lap 2, late lap 3), f32 as
   captured and f64 cast up, with both per-step times beside phase 2's
   registers and warps per SM; 4c. on each capture K1 (the tile, and the
   lane queue with its counts) launched over the first 4 096 and 1 024
   lanes (``lanes=``, tail_shrink's launch) equals the launch over every
   lane with the lanes past them skipped, bit for bit, with both ms;
5. a zero-noise i2LQR closed loop through K1 (f32, 1024 identical lanes,
   cap 150) against the known lap sequence;
6. the i2LQR headline through K1 (B = 49 152, cap 16): one warm run, whose
   K1 launches are counted, and two timed runs; lap-sims/s = B * laps / s;
   every run prints a hash of its lap records (lap steps, done flags,
   final states, safe set), so two commits can be shown to run alike;
   6b. through the simulator's own K1 (dedup + qsort_skip: the lane queue
   from LANE_QUEUE_FROM lanes on; which kernel each batch of
   CROSSOVER_BATCHES runs is printed) in turns against K1 without
   options, hashes equal, and one profiled run (the lane queue's device
   seconds); 6c. seed 1 with tail_shrink 4 096 and 1 024 in turns against the run
   without (A B C C B A, the simulator's own K1), each arm's hash equal in
   its two turns (tail_shrink alone gives the lane at position p of a
   compacted lap draw p, as JAX's simulator does, so its run is its own),
   each launch's lanes and ms logged: the launches over the prefix beside
   the same steps' launches over B (a tail launch's ms printed, with
   the kernel the switch gives it);
7. K4 (NLMPC per-candidate solve) against the plain solve on 393 216 random
   candidate lanes (horizons 1-6, 1/16 skipped), f64 and f32, bit for bit,
   beside the share of lanes whose verdicts and solutions agree (the
   kernels line keeps these figures beside phase 23's);
8. K2 (whole NLMPC step) against the plain step on inputs captured from the
   NLMPC headline run (lap 1 early, lap 2 mid, lap 3 once shrunk horizons,
   horizon 1 among them, are active), f32 as captured and f64 cast up,
   with both per-step times; 8b. on the same inputs K2 with qsort_skip
   (the headline's) equals K2 without it bit for bit, with both times; and
   K2 at nsi = 2 (the last two stored laps of each capture, a tile of 16
   threads a lane) against its plain step, at phase 8's gates; 8d. K2
   and its counting instantiation over a prefix, as 4c;
9. a zero-noise NLMPC closed loop through K2 (1024 identical lanes, cap 60):
   f64 must give the host controller's laps exactly, f32 within 2;
10. the NLMPC headline through K2 with qsort_skip, as the simulator builds
   it (bench.py:145-148; B = 49 152, cap 12, infeasible_retire 8): one warm
   run, whose K2 launches are counted, and timed runs with and without
   qsort_skip in turns, whose lap records must be equal (hashes printed);
   10c. as bench.py ships it (retile_frac 0.25, bench.py:131-132), and
   with tail_shrink 4 096 and 1 024, in turns against the run without, as
   6c, with the permutations a lap and their ms;
11. K5 (generic LM-iLQR) against its plain version, f64 (first 32 768
   lanes) and f32, for each instantiated model: the double integrator on
   the ``--throughput`` lanes, the unicycle reach task of
   tests/test_generic_ilqr.py:277-296 (every lane within 0.05), and the
   bicycle and the double integrator on the ``--kernel`` lanes, with kernel
   and plain times, and the trips the lanes take (each lane's n_iters,
   and what a warp of 32 lanes run to its slowest one would execute,
   generic_bench.warp_trips); then K3 as ``--kernel`` runs it (cap 150,
   absent obstacle) against its plain solve on those lanes, f64 (first
   32 768) and f32, with phase 3's agreement gates and the plain solve's
   trips;
11b. K5 for two models a caller gives with three inputs (the damped-
   Cholesky branch; generic_bench.k5_task's holonomic vehicle and 3-D
   point mass), at N = 6 on 32 768 lanes, and the holonomic vehicle also
   at N = 3, f64 and f32, each bit for bit against its plain version,
   with kernel and plain ms, trips (warp_trips), the kernel's registers,
   local memory and resident warps from the runtime and its bound (the
   plain version's operations x the trips over 67 TFLOP/s, f64 over 34);
   then the caller's path: each model's K5 from wrappers counted from 0,
   five calls each on those lanes in f32;
12. the generic headline: experiments/generic_bench.py ``--throughput``
   (the double integrator through K5, B = 32 768) and ``--kernel`` (K5 on
   the bicycle and the double integrator against K3, B = 131 072), whose
   K5 and K3 launches are counted;
13. K2 in timeVarying mode against the plain step on inputs captured from
   the timeVarying headline run (as phase 8), with and without qsort_skip,
   which must be bitwise equal, and at nsi = 2 as phase 8's; over a
   prefix as 4c;
14. a zero-noise timeVarying closed loop through K2 (1024 identical lanes,
   cap 60): f64 must give the host controller's laps exactly;
15. the timeVarying headline through K2 with qsort_skip (bench.py:207-211:
   B = 49 152, cap 12, infeasible_retire 8): a warm run, whose K2 launches
   are counted, and five timed runs back to back (best, median, lowest),
   each with K2's device seconds by CUDA events and its lap-records hash;
16. K2 in mode all against the plain step on inputs captured from the all
   headline run, all_rev_skip bitwise equal to the forward scan, and K2
   with all_iter on inputs captured from an all_iter run; the lap-2 times
   beside phase 2's registers and warps per SM; over a prefix as 4c;
17. a zero-noise all + all_iter closed loop through K2 (1024 lanes, cap
   60): f64 must give the host controller's laps exactly;
18. the all headline through K2 with all_rev_skip (bench.py:218-221: B =
   8 192, nsi 1, cap 12, infeasible_retire 8): a warm run, whose K2
   launches are counted, and two timed runs, as phase 15's; 18c. with the
   bench's retile_frac 0.25 in turns against without, as 10c;
19. K1 at k = 32 (one lane a warp, each distinct solve of a step once)
   against its plain step on inputs captured from phase 21's k32_nsi4 run
   (lap 1 early, lap 2 mid, lap 4, where most lanes' stored laps are
   shorter than 32 rows), at nsi = 4 and at nsi = 2 on the captures' last
   two stored laps: f32 bit for bit, f64 cast up at phase 4's gates, with
   both per-step times, phase 2's registers and warps, and the solves a
   live lane-step that a counting build of the kernel (built in phase 2)
   runs on the card, beside the distinct ones the step needs
   (experiments/headlines.py ``k32_distinct``; the count must lie between
   them and them plus 4 a lane) and the 3 x nsi x 32 of the plain order;
   the bound counts the distinct solves only (and, beside it, every
   candidate's); and the k = 8 K1 on inputs captured
   from the k8_nsi1_sr3 run at the first step of each lap where some
   active lane's pass-0 guess is the goal; 19b. on the three captures
   K1 k = 32's counting instantiation (with_stats) equals the plain build
   bit for bit and its counts (iters_useful, iters_executed, the queue
   floor) the plain step's integer for integer, with its ms; both builds
   over a prefix of 1 024 lanes as 4c;
20. a zero-noise i2LQR closed loop through K1 at k = 32 / nsi = 2 (f64,
   1024 identical lanes, cap 150, 4 laps): the host controller's laps
   exactly;
21. the robustness sweep (bench.py:250-270): experiments/scenario_sweep.py
   ``run_sweep`` at B = 4 096, 4 laps, moving obstacle, seed 0, in the
   canary's three configurations (k8_nsi1, k8_nsi1_sr3, k32_nsi4), each
   through K1 (the kernel each ran printed), whose launches are counted
   and must equal the simulator's
   steps with active lanes; completion, final-lap mean, lap-step p50s,
   wall seconds and lap-records hash of each; the guard and the larger
   candidate set must complete more and finish the last lap sooner than
   k8_nsi1, and each completion stay at or above its bound; then the
   i2LQR headline scenario at B = 4 096 with and without stall_reseed=3,
   which must lie within utils/envelope.py's behaviour envelope; and one
   more k32_nsi4 run under torch.profiler, whose trace gives K1's device
   seconds and the card's busy seconds; 21c. the k32_nsi4 run once more
   through the counting K1 at k = 32 (its launches counted, the lap
   records the run's): the run's useful trips, executed thread-trips and
   waste share;
22. the i2LQR headline through K3 (``candidate_solver``: the plain step's
   glue around one K3 launch a relaxation pass; seed 0 as phase 6): K3's
   launches must be three a step with active lanes (steps counted by a tap
   on the plain step, experiments/headlines.py ``tap_step``) and K1 must
   not launch; the lap-records hash should equal phase 6's K1 run (where it
   differs, the run must lie within the behaviour envelope of K1's and
   complete >= 0.99); on the run's inputs captured as phase 4's, the step
   with K3 equals the plain step bit for bit (f32, and f64 cast up); on the
   lap-2 capture's pass-0 lanes K3 equals its plain solve bit for bit, with
   its ms, the plain solve's, its bound and the step's ms; two timed runs
   with K3's device seconds by CUDA events;
23. the NLMPC headline through K4 (spaceVarying, cap 12, infeasible_retire
   8, seed 0 as phase 10; one K4 launch a step with active lanes), as
   phase 22: the hash should equal phase 10's K2 run (else the envelope
   and completion >= 0.914), the per-candidate step equals the plain step
   bit for bit on phase 8's capture rule, K4 on the lap-2 capture's lanes
   equals its plain solve, two timed runs;
24. the safe set over every stored lap (all_ss_iter without all_ss_point)
   in spaceVarying and timeVarying at B = 8 192 (cap 12, infeasible_retire
   8), through the simulator's default K4: one launch a step (the warm
   run's skip masks logged: the share of live lanes over the run),
   completion with its standard error, final-lap mean, wall seconds of a
   second seed-0 run (whose hash must be the first's), completion at or
   above its bound (0.9066 / 0.9827), the per-candidate step bit for bit
   against the plain step on the card on inputs captured at lap 1 (step
   5), lap 2 (step 14) and lap 3 (step 10, three stored laps), f32 and f64
   cast up, and K4 on the lap-2 capture's lanes bit for bit against its
   plain solve, with its ms a call; a zero-noise closed loop (1024 lanes,
   cap 60): f64 must give the JAX package's laps exactly ([32, 23, 23],
   [111, 102, 93]);
25. exact resume on the card: the i2LQR run through K1 and the NLMPC
   spaceVarying run through K2 at B = 4 096 (seed 0): 2 laps, a checkpoint
   (utils/checkpoint.py) to a temporary file, loaded and resumed for 2
   more laps on a generator of another seed, must hash as the 4-lap run;
26. the i2LQR host tier on the card: the step-by-step I2LqrController
   (control/i2lqr.py), each relaxation pass one K3 launch over every
   candidate of every lap in its window, driven by
   experiments/runner.py's ``run_closed_loop``: f64 in the CI
   configuration (obstacle (31, -2) 8 x 6, zero noise, goal appended, 5
   laps), whose laps must equal the JAX host controller's parallel-sweep
   f64 sequence; f32 over 3 laps (lap 1 <= 60, the last <= 30); and the
   demo CLI's setting (BASELINE config 1) through experiments/ilqr_test.py
   ``main([..., "--device", "cuda"])``, within 1 of [54, 29, 23]. K3's
   launches must be 3 x the steps that solved (the controller counts them;
   replay and horizon-1 steps do not solve). Each run prints its wall
   seconds, ms a solving ``calc_input`` (median, p99) and lanes a launch;
   K3 on a pass captured in the f64 run's lap 2 equals its plain version
   bit for bit, with both ms;
27. the NLMPC host tier on the card: NlmpcController (control/nlmpc.py),
   one K4 launch a solving step over every lap's candidates, f64 zero
   noise, 3 laps in spaceVarying, timeVarying and all + all_ss_iter, whose
   laps must equal the JAX host's [32, 23, 23], [111, 104, 97] and [26,
   22, 22]; K4's launches must equal the steps that solved, and every step
   recorded infeasible must come from the plant's one caught exception,
   InfeasibleStep; K4 on a step captured in the spaceVarying run's lap 2
   equals its plain version bit for bit, with both ms;
28. the paper scenarios on the card (experiments/scenarios.py): the 10
   runs {ilqr, nlmpc} x {no, static, add_static, add_moving up, add_moving
   left} obstacle, 8 laps in f32 through ``run_scenario(...,
   device="cuda")``, each writing one ego_*.npz with the JAX file's keys;
   the finished flags equal and every finished lap within 2 of the JAX
   package's f32 laps on XLA:CPU (of the moving scenarios, the laps before
   the injection; the later ones are printed beside JAX's); K3 / K4
   launches = 3 / 1 x the solving steps; the four moving scenarios again
   in f64 (build_schedule, run_closed_loop): NLMPC's laps equal the JAX
   package's, i2LQR's before the injection and the moving lap finished
   (its later laps follow last bits, printed beside JAX's and the CPU
   route's); a K3 and a K4 call captured in each moving lap (the
   obstacle's speed lanes non-zero) bit for bit against their plain
   versions, with their bounds; the i2LQR moving lap and the two after
   it step by step (``replay_lockstep``), the card's controller given the
   JAX package's recorded f64 run's state at every step (data/jax_f64/),
   every input within 1e-8 of the JAX run's;
29. host checkpoint and resume on the card (utils/checkpoint.py): i2LQR
   (CI configuration) and NLMPC spaceVarying in f64, 2 laps, save_run,
   resume_controller into a fresh controller, 1 lap with
   seed_safe_set=False, each equal to the JAX package's laps and no slower
   than the last uninterrupted lap; the NLMPC controller resumed from the
   committed data/ego_nlmpc_ss_8_no_obstacle.npz for one lap, equal to the
   JAX package's;
30. the latency bench on the card: ``latency_bench.main(["--device",
   "cuda"])`` (JAX's defaults: batches 2 048 and 32 768, one device) and
   its report; completion 1.0 in both per-step runs; the launches each
   bench function counts (``main(..., launches=)``): K3 = 3 x the i2LQR
   controller's solving steps and 4 a throughput batch, K4 = the NLMPC
   controller's solving steps, K1 launched by the whole-step bench and the
   batched run; K3 on each throughput batch's lanes and K1 on the
   whole-step bench's inputs at 1 024 lanes and at 1 lane bit for bit
   against their plain versions, with ms, plain ms, bound and the
   blocking and pipelined p50 / p99;
31. profiling and plots on the card: one solving i2LQR lap (f32) under
   ``utils/profiling.trace`` with an ``annotate`` span, whose trace must
   hold the span and K3's kernel; the card's busy share of the lap (K3's
   device seconds, and every kernel's and copy's, over the lap's wall);
   ``device_memory_stats`` reporting the card; the demo CLI with
   ``--plotting`` rendering its two figures under Agg (where the machine
   has matplotlib);
32. scale-out on torch.distributed (ilqr_iterative_tasks_torch/parallel/,
   experiments/scale_out.py): the i2LQR and NLMPC spaceVarying headlines
   (B = 49 152, phases 6 and 10's configurations) on injected noise,
   unsharded in this process and through the ``_sharded`` wrappers on 2
   ranks that share the card (gloo: NCCL refuses two ranks on one card),
   each rank launching K1 / K2 on its 24 576 lanes, whose gathered lap
   records must hash as the unsharded runs'; the same wrappers on a world
   of one NCCL rank at B = 2 048; the meshed NLMPC host controller
   (``mesh=``, f64, zero noise) in spaceVarying and all + all_ss_iter on
   the 2 ranks, whose laps must be the JAX package's pinned meshed ones
   ([120, 32, 23], [120, 26, 22]) and whose K4 launches, one a rank a
   solving step over its half of the candidates, are reported with their
   lanes; each run's wall seconds, the gather's ms, and phase 30's
   device-count rates (its batched run now spawned as one NCCL rank a
   card). Two ranks on one card measure contention, not scaling. Then
   the i2LQR headline at B = 4 096 over 2 laps with ``tail_shrink`` alone
   (1 024, under a rank's 2 048 lanes, and 3 072, over them): each rank
   keeps the whole run's lane order (the compaction on the whole run's
   not-done count, each lane its column of the whole draw), so its
   gathered lap records must hash as the unsharded run's.
33. the vmap i2LQR tier (control/batched.py) through K3: zero noise, 1 024
   identical lanes, f64 laps exactly the JAX tier's [55, 28, 23] and f32
   within 2 of its [55, 28, 25]; then the full width (B = 49 152, f32,
   plant noise on, seed lap + 3 laps, k 8, max_laps 16, K3 over 393 216
   lanes a pass at the tier's LM cap 150): a warm run (K3's device
   seconds by CUDA events, its launches against 3 a solving step, each
   launch's live share, and ``torch.profiler`` over a window of 20
   solving steps of lap 2: K3's and the card's busy seconds) and a timed
   run of the same seed, hashes equal, lap-sims/s and completion (gated 3
   standard errors under the card's seed-0 figure); 8 sampled lanes rerun as a batch of 8 equal their full-width
   records bit for bit; K3 against its plain solve on the lap-2 capture
   (learning lap 2, solving step 14, pass 0), its ms, the plain ms and
   the bound;
34. the same for the vmap NLMPC tier (control/batched_nlmpc.py) through
   K4 (cap 60, two starts, one launch a solving step): f64 [33, 24, 24]
   exactly, f32 within 2 of [34, 23, 22] (the JAX tier's, with its f32
   limits);
35. the dry run (parallel/sharded.py ``dryrun``) with the candidate sweep
   at C = 16 384: ``dryrun(1)`` on one NCCL rank and ``dryrun(2)`` on 2
   gloo ranks sharing the card, each rank's parts checked in the rank
   (the sharded vmap run bit for bit the unsharded one, the sharded sweep
   the sweep on one rank); here each rank's sweep bit for bit the one of
   this process, K3 on the sweep's 16 384 lanes against its plain solve,
   and the sweep's ms;
36. phase 22's headline through K3 with and without ``dedup_passes`` in
   turns (off, on, on, off): hashes equal, the solves skipped and K3's
   event-timed device seconds for each arm; K3 on the lap-2 capture's
   pass-1 lanes of each arm (the dedup arm's skip mask), ms and bound;
37. ``experiments/batch_probe.py`` at batches 16 384 and 49 152 (i2LQR
   through K1, and through K3 with ``dedup_passes`` at 16 384; NLMPC
   through K2 at 16 384), and ``precision_islands`` refused on CUDA
   scenarios;
38. every subcommand of ``experiments/round4_probe.py`` and
   ``round5_probe.py`` (the ports of the JAX package's round-4 and
   round-5 probes) at 1 024 lanes and one learning lap (``all_mc`` one
   seed and lap, ``f32_bisect``'s card rows at 8 lanes; its island rows
   are refused on the card), a warm and a timed run each, every K1 / K2 /
   K4 launch count positive, each JSON line printed.

The step kernels' last options (K1 reuse_extract, dom_skip, group; K2
prox_skip, zeros_skip), each a template flag of its own: phase 2 prints
each variant's registers, local memory and warps, and builds its counting
library from the step kernels' sources only (their schedules' events:
kNN kept, slots skipped, zeros starts skipped); 4d / 19c each K1 variant
on phase 4's / 19's captures bit for bit K1 without the option and its
plain version (f32), f64 on 4 096 live lanes at phase 4's gates, ms in
turns with the option off, the plain version's time, solves and bound,
reuse_extract's fire share and the card's events; 6d the i2LQR headline
through each (hashes phase 6b's) and K1's profiled device seconds with
and without reuse_extract in turns; 8e / 13b each K2 variant on phase 8's
/ 13's captures at phase 8's gates against its plain version (prox_skip
also bit for bit K2 without it); 10d / 15c the spaceVarying /
timeVarying headline through K2 with prox_skip in turns with qsort_skip
(hashes equal, K2's event-timed seconds); 10e zeros_skip at the JAX
envelope gate's configuration (B = 128, 2 laps, budget 70, cap 12,
generator seed 5) with and without it: it must change lanes and
utils/envelope.py must reject it; 16b mode all's zeros_skip builds
(all_rev_skip, the forward scan, all_iter) against their plain step; 21d
the k32_nsi4 sweep through K1 at k = 32 with reuse_extract (phase 21a's
hash).

Every simulator run of the headlines (experiments/headlines.py) and of
phases 24-25, every host controller run of phases 26-30, and every run of
each rank of phase 32 (and of phase 30's batched run), runs inside
``no_plain_solve_on_card``: a plain candidate solve that sees a CUDA
tensor raises. A rank that fails fails its phase
(parallel/launch.py kills the other ranks and raises with their output).

Every phase raises on failure, so the script exits non-zero. It prints the
card line and a JSON line of the kernels before its last line, which is
{"ok": true, "device": {...}}. Each kernel's ``bound_ms`` is the larger of
its bytes (inputs read once, outputs written once; of the safe set, K1 and
K2 read only the stored laps) over 3.35 TB/s and its
operations over 67 TFLOP/s (H100 SXM, f32 without tensor cores). The
operations are the elementwise ops of the plain version, counted on a few
lanes on the host: one pass plus one LM iteration per iteration the run's
data needed, from the trip counts the plain solves (K3-K5) and the plain
steps' candidate solves (K1, K2) report. Of K2 only the candidates its own
solve schedule solves count (``solved_by``: qsort_skip stops a lane at its
first feasible candidate in Qfun order, all_rev_skip at its last feasible
position within the reach bound, the forward all scan a row at its first
difference with the best row). K2 has one entry a mode. Each kernel's
figures come from the inputs of the run whose launches they sit beside
(K3: phase 11's ``--kernel`` lanes, and phase 22's in its ``i2lqr_path``;
K4: phase 23's, phase 7's in its ``random_lanes``; the ``host_path`` of
each, phases 26-27's runs and captured call; ``scenarios``, phases
28-29's; ``latency_bench``, phase 30's, of K1 too, and K3's traced lap,
phase 31's; ``sharded`` of K1 and K2 and ``meshed_controller`` of K4,
phase 32's launches a rank). The host tier's f64 calls are bounded at 34
TFLOP/s (f64 without tensor cores). It needs a CUDA device and the
repository.
"""

import concurrent.futures
import dataclasses
import json
import os
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import (  # noqa: E402
    lap_window)
# the headlines, capture rule, timing and lap-records hash that
# experiments/kernel_ab.py shares
from ilqr_iterative_tasks_torch.experiments.headlines import (  # noqa: E402
    ALL_BATCH, BATCH, CAP, CAPTURES, CROSSOVER_BATCHES, K1_ATTRS, LAPS,
    MAX_LAPS, MAX_STEPS, N, NL_CAP, NL_CAPTURES, NL_RETIRE, SWEEP_BATCH,
    SWEEP_CAP, SWEEP_CAPTURES,
    EVERY_CAPTURES, K3_ATTRS, K4_ATTRS, RANDOM_LANES, SWEEP_CONFIGS,
    SWEEP_LAPS, Capture, Headlines, LaunchLog, Recorder, cuda_ms,
    device_seconds, tail_launches,
    K1_COUNT, K1_COUNT_SOURCES, k1_capture, k2_capture, k4_lanes,
    kernel_events,
    lane_obstacle,
    lap_records_hash, counted_solves, k32_distinct, live_share,
    no_plain_solve_on_card, require, seed_lanes, stats_summary,
    sweep_capture, sweep_step_solver, tap_step, want_capture)

ZERO_NOISE_LAPS = [55, 28, 24]  # CPU XLA f32 family, docs/PARITY.md:146
# NLMPC headline lap completion bound. Completion follows the f32 arithmetic
# (the horizon-1 reach check at 1e-3 under noise): the port completes 0.9169
# on the H100 (seed 0; seeds 1-2 0.9172, 0.9181) and, on the same noise
# draws as the CPU port, within one standard error of it (PERF.md); the
# TPU's 0.9492 is its own f32 behaviour. The bound sits 3 standard errors of
# one B = 49 152 run (~0.0009) under the card's seed-0 figure.
NL_COMPLETION_MIN = 0.914
# host controller, f64: timeVarying and all + all_iter
# (tests/test_batched_nlmpc_soa.py:149, :159)
HOST_TV_LAPS = [111, 104, 97]
HOST_ALL_LAPS = [26, 22, 22]
# timeVarying and all headline lap completion bounds, 3 standard errors of
# one run under the card's seed-0 figure: timeVarying 0.9846 (standard
# error 0.00032; on identical draws at B = 1024 the card and the CPU port
# complete 0.9844 and 0.9837, differing on 92 of 3 072 lane-laps both ways,
# experiments/nlmpc_lane_laps.py), all 0.9446 (0.00146); PERF.md
TV_COMPLETION_MIN = 0.9836
ALL_COMPLETION_MIN = 0.940
# max|dus| and max|dguess| of K2 and K4 in f32 on the lanes whose decisions
# agree with the plain version (-fmad=false: so far bitwise)
F32_TOL = 1e-5
HOST_NLMPC_LAPS = [32, 23, 23]  # host controller, f64, tests/test_batched_nlmpc_soa.py:171
# timeVarying over every stored lap (all_ss_iter), f64: the JAX simulator's
# and host controller's laps, pinned by tests/test_torch_batched_nlmpc_soa.py
# (spaceVarying over every stored lap gives HOST_NLMPC_LAPS)
HOST_EVERY_TV_LAPS = [111, 102, 93]
# lap completion bounds over every stored lap (B = 8 192, seed 0), 3
# standard errors of one run under the card's seed-0 figures: spaceVarying
# 0.9120 (standard error 0.0018), timeVarying 0.9851 (0.0008); PERF.md
EVERY_COMPLETION_MIN = {"spaceVarying": 0.9066, "timeVarying": 0.9827}
RESUME_BATCH = 4096  # phase 25
# the JAX package's host I2LqrController, parallel sweep, f64, the CI
# configuration (obstacle (31, -2) 8 x 6, zero noise, goal appended, 5
# laps): computed on the CPU with the JAX package, as the slow test
# tests/test_torch_host_i2lqr.py::test_five_lap_parallel_matches_jax
# computes it beside the port's plain f64 loop (the same laps); the JAX
# package's own test holds it within 2 of the
# reference's [54, 27, 24, 24, 24] (tests/test_closed_loop_i2lqr.py:37)
HOST_I2LQR_F64_LAPS = [55, 28, 23, 23, 23]
# BASELINE config 1, the demo CLI (tests/test_closed_loop_i2lqr.py:119-133)
DEMO_LAPS = [54, 29, 23]
# the paper scenarios (experiments/scenarios.py, 8 laps, zero noise, dt 1):
# the JAX package's laps and finished flags, computed once on the CPU with
# its run_scenario (f32, XLA:CPU) and, for the moving obstacle in f64, its
# build_schedule + run_closed_loop, as phase 28 runs the port's
SCENARIO_CASES = (("no_obstacle", "up"), ("static_obstacle", "up"),
                  ("add_static_obstacle", "up"),
                  ("add_moving_obstacle", "up"),
                  ("add_moving_obstacle", "left"))
_T8, _T6FF, _T5FFF = [True] * 8, [True] * 6 + [False] * 2, (
    [True] * 5 + [False] * 3)
SCENARIO_F32 = {
    "ilqr_ss_8_no_obstacle": ([54, 29, 25, 23, 23, 23, 23, 23], _T8),
    "ilqr_ss_8_static_obstacle": ([55, 28, 24, 23, 23, 23, 23, 23], _T8),
    "ilqr_ss_8_add_static_obstacle": ([54, 29, 25, 23, 23, 23, 23, 23], _T8),
    "ilqr_ss_8_add_moving_obstacle_up": ([54, 29, 25, 23, 23, 79, 121, 121],
                                         _T6FF),
    "ilqr_ss_8_add_moving_obstacle_left": ([54, 29, 25, 23, 23, 45, 54, 101],
                                           _T8),
    "nlmpc_ss_8_no_obstacle": ([32] + [22] * 7, _T8),
    "nlmpc_ss_8_static_obstacle": ([32] + [22] * 7, _T8),
    "nlmpc_ss_8_add_static_obstacle": ([32] + [22] * 7, _T8),
    "nlmpc_ss_8_add_moving_obstacle_up": ([32, 22, 22, 22, 22, 26, 23, 22],
                                          _T8),
    "nlmpc_ss_8_add_moving_obstacle_left": (
        [32, 22, 22, 22, 22, 121, 121, 121], _T5FFF),
}
# the moving-obstacle scenarios in f64: the JAX package's laps (all
# finished; its i2LQR runs are data/jax_f64/) and the port's plain route
# on the CPU. The i2LQR laps from the injection on follow last bits: the
# port makes the JAX run's decision at every step of laps 5-7 given its
# states (phase 28's lockstep, tests/test_torch_scenarios.py), and the
# JAX run's own laps change under a 1e-12 move of the state
SCENARIO_F64 = {
    ("ilqr", "up"): [54, 29, 25, 23, 23, 77, 86, 62],
    ("ilqr", "left"): [54, 29, 25, 23, 23, 39, 37, 35],
    ("nlmpc", "up"): [32, 23, 23, 23, 23, 23, 23, 23],
    ("nlmpc", "left"): [32, 23, 23, 23, 23, 24, 24, 24],
}
SCENARIO_F64_CPU_PORT = {("ilqr", "up"): [54, 29, 25, 23, 23, 86, 121, 121],
                         ("ilqr", "left"): [54, 29, 25, 23, 23, 39, 37, 36]}
# host checkpoint and resume (phase 29), f64: the JAX package's host
# controllers, 2 laps, save_run, resume_controller into a fresh one, 1 lap
# with seed_safe_set=False (computed once on the CPU with the JAX package)
RESUME_FIRST = {"ilqr": [55, 28], "nlmpc": [32, 23]}
RESUME_LAP = {"ilqr": [23], "nlmpc": [23]}
# the JAX package's NLMPC controller (spaceVarying, no obstacle, f64)
# resumed from data/ego_nlmpc_ss_8_no_obstacle.npz for one lap
ARTIFACT_RESUMED_LAP = [23]
# host controller, f64, k = 32 / nsi = 2, 4 laps: the JAX package's
# I2LqrController run as tests/test_ragged_selection.py:107-146 runs it
# (computed once on the CPU; the port's plain f64 loop gives the same)
HOST_K32_LAPS = [26, 23, 23, 23]
# robustness sweep lap completion bounds (B = 4 096, 4 laps, seed 0): 3
# standard errors of one run under the card's seed-0 figure, 0.9500
# (standard error 0.0017), 0.9802 (0.0011) and 0.9943 (0.0006); the TPU's
# 0.9531 / 0.98 / 0.9957 are its own f32 (PERF.md)
SWEEP_COMPLETION_MIN = {"k8_nsi1": 0.944, "k8_nsi1_sr3": 0.976,
                        "k32_nsi4": 0.992}
G_LANES = 32768  # generic_bench --throughput (bench.py:229)
G_KERNEL_LANES = 131072  # generic_bench --kernel (generic_bench.py:164)
G_F64_LANES = 32768  # lanes of the f64 plain solve in phase 11
G_CAP = 150  # the generic benches' max_iter
# K5's (model, horizon) of phases 11 (the --throughput and --kernel lanes,
# the unicycle at N 8), 11b (the caller's 3-input models) and 12
K5_BUILDS = (("double_integrator", 6), ("unicycle", 8), ("bicycle", 6),
             ("holonomic", 6), ("point_mass", 6), ("holonomic", 3))
# phase 11b's caller models with three inputs, by (name, horizon)
K5_CALLER = (("holonomic", 6), ("point_mass", 6), ("holonomic", 3))
PEAK_F32_OPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_F64_OPS = 34e12  # H100 SXM, f64 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ELEMENTWISE = frozenset(
    "abs add ceil clamp clamp_max clamp_min cos div eq exp floor ge gt le "
    "logical_and logical_not logical_or lt maximum minimum mul ne neg pow "
    "reciprocal rsqrt rsub sign sin sqrt sub where".split())


class OpCounter(TorchDispatchMode):
    """Counts the elements that elementwise aten ops produce."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.namespace == "aten"
                and func.overloadpacket.__name__.rstrip("_") in ELEMENTWISE):
            self.ops += sum(t.numel() for t in tree_leaves(out)
                            if isinstance(t, torch.Tensor)
                            and not t._is_zerotensor())
        return out


def count_ops(fn) -> int:
    with OpCounter() as c:
        fn()
    return c.ops


def lanes_of(args, idx, b):
    """The lanes ``idx`` of every tensor whose last axis is the batch b,
    on the host."""
    return [t[..., idx].cpu() if t.dim() and t.shape[-1] == b else t.cpu()
            for t in args]


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def step_bytes(args, out, slots, nsi) -> float:
    """Bytes a whole-step kernel must move: every input once, but of the
    safe-set tensors at positions ``slots`` ((max_laps, ...) each) only
    ``nsi`` laps' worth (the stored laps that lap_ids names, or the share
    of them the kernel reads); every output once."""
    return sum(nbytes([t]) * (nsi / t.shape[0] if i in slots else 1.0)
               for i, t in enumerate(args)) + nbytes(out)


def bound(ops, bytes_moved, peak=PEAK_F32_OPS) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type (f32 by default),
    whichever is longer."""
    by_ops, by_bytes = ops / peak, bytes_moved / PEAK_BYTES
    return dict(bound_ms=1e3 * max(by_ops, by_bytes),
                bound_by="operations" if by_ops >= by_bytes else "bytes",
                ops=int(ops), bytes=int(bytes_moved), library_ms=None)


def solve_ops(plain, cap_kw, sample_lanes, lanes, iters,
              rest_share=1.0) -> float:
    """Operations of ``lanes`` lanes of a per-lane LM solve or step:
    ``plain(**{cap_kw: c})`` runs the plain version on ``sample_lanes``
    host lanes; one LM iteration of every solve of a lane costs the
    difference of caps 2 and 1, the rest cap 1 minus one iteration. Total:
    (lanes x rest x rest_share + per_iter x iters) / sample_lanes, where
    ``iters`` sums the run's per-lane iterations in those units and
    ``rest_share`` is the share of the plain version's candidates that the
    run's data needs."""
    c1 = count_ops(lambda: plain(**{cap_kw: 1}))
    c2 = count_ops(lambda: plain(**{cap_kw: 2}))
    per_iter, rest = (c2 - c1), c1 - (c2 - c1)
    return (lanes * rest * rest_share + per_iter * iters) / sample_lanes


def step_iters(trips, active, solved=None) -> tuple[float, float, float]:
    """(per-lane iterations in solve_ops' units, mean trips of a solved
    candidate, share of the candidates solved) of a whole step: ``trips``
    is the plain step's list of (C, B) trip counts, one per batched solve;
    ``solved`` (masks of the same shapes, default all) the candidates the
    kernel solves; only ``active`` lanes count."""
    t = torch.stack(trips).double()
    s = torch.ones_like(t) if solved is None else torch.stack(solved).double()
    t, s = (t * s)[..., active], s[..., active]
    return (float(t.sum()) / (t.shape[0] * t.shape[1]),
            float(t.sum() / s.sum()), float(s.mean()))


def solved_by(k2, a, cands, ref):
    """Which candidates of the plain step's batched solves the kernel
    ``k2`` solves on the inputs ``a``, one bool mask a solve (the shapes of
    its trips), from the plain step's ``cands`` (each candidate's Qfun and
    whether its cost is finite) and outputs ``ref``. qsort_skip: the
    candidates in (Qfun, slot) order up to the first feasible one, the
    first always, no invalid one after it; all_rev_skip: the positions
    below the lap's length within the reach bound, from the last down to
    the first feasible one; the forward all scan: each stored row's
    positions below its length up to its first difference with the best
    row's compare list where it ranks above it (nlmpc_step_all.cu);
    otherwise every candidate. Checks the schedule's winner against the
    plain step's where it names one."""
    active = a[9] < 0.5
    if k2.qsort_skip:  # nsi = 1: one (k, B) solve
        (key, ok), = cands
        order = torch.sort(key, dim=0, stable=True).indices
        ok_s, key_s = ok.gather(0, order).int(), key.gather(0, order)
        p = torch.arange(key.shape[0], device=key.device)[:, None]
        first = (p == 0) | ((torch.cumsum(ok_s, 0) - ok_s == 0)
                            & torch.isfinite(key_s))
        return [torch.zeros_like(ok).scatter(0, order, first)]
    if k2.mode != "all":
        return [torch.ones_like(ok) for _, ok in cands]
    t_rows = a[3].shape[1]
    t = torch.arange(t_rows, device=a[0].device)[:, None]
    if k2.all_rev_skip:  # one (T, B) row
        (key, ok), = cands
        lap, x = int(a[6][0]), a[0]
        dt, a_max, n = k2._consts[0], k2._consts[1], k2.num_horizon
        rb = (torch.tensor(n * dt, dtype=x.dtype, device=x.device)
              * x[2].abs()
              + torch.tensor(a_max * dt * dt * n * n / 2.0 + 1.0,
                             dtype=x.dtype, device=x.device))
        dx, dy = a[3][lap, :, 0] - x[0], a[3][lap, :, 1] - x[1]
        near = ((t < torch.clamp(a[5][lap], max=t_rows))
                & ~(dx * dx + dy * dy > rb * rb))
        last = torch.where(ok & near, t, -1).amax(dim=0)
        feas = active & (ref[1] > 0.5)
        require(bool((last[feas] == ref[3].long()[feas]).all()),
                "all_rev_skip schedule: winner differs from the plain step")
        return [near & (t >= last)]
    # forward scan over the stored rows (all_iter: several)
    inf = float("inf")
    b = a[0].shape[-1]
    virt = torch.ones(b, dtype=torch.bool, device=t.device)
    best_cmp = torch.full((t_rows, b), inf, dtype=a[0].dtype, device=t.device)
    best_len = torch.zeros(b, dtype=torch.long, device=t.device)
    best_row = torch.zeros(b, dtype=torch.long, device=t.device)
    solved, it = [], iter(cands)
    for r, (lap, stored) in enumerate(zip(a[6].tolist(), a[7].tolist())):
        if not stored:
            continue
        key, ok = next(it)
        ln = torch.clamp(a[5][lap].long(), max=t_rows)
        struct = t < ln
        cmp = torch.where(struct, torch.where(ok, a[10].to(key.dtype) + key,
                                              inf), -inf)
        tmax = torch.where(virt, t_rows, torch.maximum(ln, best_len))
        bv = torch.where(virt, inf, torch.where(t < best_len, best_cmp, -inf))
        diff = (cmp != bv) & (t < tmax)
        d = torch.where(diff.any(dim=0), diff.int().argmax(dim=0), t_rows)
        dc = torch.clamp(d, max=t_rows - 1)[None]
        dec = torch.where(d < t_rows, torch.where(
            cmp.gather(0, dc)[0] < bv.gather(0, dc)[0], -1, 1), 0)
        solved.append(struct & ((dec != 1) | (t <= d)))
        take = dec < 0
        best_cmp = torch.where(take, cmp, best_cmp)
        best_len = torch.where(take, ln, best_len)
        best_row = torch.where(take, r, best_row)
        virt = virt & ~take
    require(bool((best_row[active] == ref[4].long()[active]).all()),
            "forward all schedule: winning row differs from the plain step")
    return solved


SAMPLE_LANES = 64  # host lanes of an operation count


def timed_call(fn):
    """(fn(), milliseconds of that one call on the card's clock): the
    plain versions' comparison call doubles as their timing."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def k2_gate(tag, out, ref, active, dtype):
    """Phase 8's gates of a K2 output against its plain step's: >= 99.9 %
    equal decisions with max|dus| and max|dguess| <= 1e-6 in f64, >= 99 %
    and <= 1e-5 on the agreeing lanes in f32. Returns the check's line and
    max|dus|."""
    for t in out:
        require(bool(torch.isfinite(t.double()).all()),
                f"{tag}: non-finite output")
    agree = ((out[1] == ref[1]) & (out[3] == ref[3])
             & (out[4] == ref[4]) & (out[5] == ref[5]))[active]
    dus = (out[0] - ref[0]).abs().amax(dim=(0, 1))[active][agree]
    dng = (out[2] - ref[2]).abs().amax(dim=0)[active][agree]
    share = float(agree.double().mean())
    maxd = float(dus.max()) if dus.numel() else 0.0
    maxg = float(dng.max()) if dng.numel() else 0.0
    bitwise = all(torch.equal(g, w) for g, w in zip(out, ref))
    line = (f"feasible {float(ref[1][active].mean()):.4f}): decisions agree "
            f"{share:.6f}, max|dus| {maxd:.3e}, max|dguess| {maxg:.3e} on "
            f"them, bitwise {bitwise}")
    if dtype == torch.float64:
        require(share >= 0.999 and maxd <= 1e-6 and maxg <= 1e-6,
                f"{tag} f64: {share}, {maxd}, {maxg}")
    else:
        require(share >= 0.99 and maxd <= F32_TOL and maxg <= F32_TOL,
                f"{tag} f32: {share}, {maxd}, {maxg}")
    return line, maxd


def check_k2(tag, k2, alts, captured, plain, host_plain, nsi2=None):
    """K2 against its plain step on captured inputs, f32 as captured and
    f64 cast up, at phase 8's gates (k2_gate); each kernel of ``alts`` (K2
    with a bitwise-neutral option switched) equal to K2 bit for bit on
    every lane. ``plain(*a, trips=..., cands=...)`` runs the plain step on
    the card, ``host_plain(*a, max_iters=...)`` on the host. ``nsi2``: (K2
    at nsi = 2, its plain step), held to the same gates on each capture
    with the last two stored laps. Returns the kernels-line figures:
    max_abs_err over the f32 captures; ms, plain_ms, each alt's ms and the
    bound of the lap-2 capture in f32."""
    stats = dict(max_abs_err=0.0)
    for lap, (step, args) in sorted(captured.items()):
        active = args[9] < 0.5
        n_act = int(active.sum())
        n_shrunk = int((active & (args[10] < N)).sum())
        n_h1 = int((active & (args[10] <= 1)).sum())
        require(n_act > 0, f"{tag} capture lap {lap}: no active lane")
        for dtype in (torch.float32, torch.float64):
            a = cast(args, dtype, keep=(9,))
            out = k2(*a)
            trips, cands = [], []
            ref, plain_ms = timed_call(
                lambda: plain(*a, trips=trips, cands=cands))
            solved = solved_by(k2, a, cands, ref)
            torch.cuda.synchronize()
            gate, maxd = k2_gate(f"{tag} lap {lap}", out, ref, active, dtype)
            line = (f"[{tag} lap {lap} step {step} {str(dtype)[6:]}] active "
                    f"{n_act} (hzn<{N}: {n_shrunk}, hzn<=1: {n_h1}, {gate}")
            if nsi2 is not None:
                k2_2, plain_2 = nsi2
                a2 = list(a)
                a2[6], a2[7] = lap_window(int(a[6][-1]) + 1, 2, a[3].shape[0],
                                          False, a[0].shape[-1], a[0].device)
                gate2, _ = k2_gate(f"{tag} nsi 2 lap {lap}", k2_2(*a2),
                                   plain_2(*a2), active, dtype)
                line += f"; nsi 2 (lap_ok {a2[7].tolist()}: {gate2}"
            for name, alt in alts.items():
                same = all(torch.equal(g, w) for g, w in zip(out, alt(*a)))
                line += f"; {name} bitwise equal {same}"
                require(same, f"{tag} {name} lap {lap} {dtype}: not bitwise "
                        f"equal to K2")
            if dtype == torch.float32:
                stats["max_abs_err"] = max(stats["max_abs_err"], maxd)
                ms = cuda_ms(lambda: k2(*a), 5)
                alt_ms = {name: cuda_ms(lambda alt=alt: alt(*a), 5)
                          for name, alt in alts.items()}
                line += (f"; kernel {ms:.3f} ms"
                         + "".join(f", {name} {v:.3f} ms"
                                   for name, v in alt_ms.items())
                         + f", plain {plain_ms:.3f} ms per step")
                if lap == 2:
                    stats.update(ms=ms, plain_ms=plain_ms, **{
                        f"{name}_ms": v for name, v in alt_ms.items()})
                    b_all = args[0].shape[-1]
                    idx = torch.nonzero(active).flatten()[:SAMPLE_LANES]
                    sample = lanes_of(a, idx.cpu(), b_all)
                    stored = [lap_id for lap_id, ok in zip(
                        a[6].tolist(), a[7].tolist()) if ok]
                    # the timeVarying window reads k rows of a stored lap
                    rows_read = max(1, len(stored)) * (
                        k2.k / a[3].shape[1] if k2.mode == "timeVarying"
                        else 1.0)
                    # both starts run one more iteration per cap step; the
                    # one-pass part counts the candidates the kernel solves
                    iters, mean_trips, solved_share = step_iters(
                        trips, active, solved)
                    stats.update(bound(solve_ops(
                        lambda max_iters: host_plain(*sample,
                                                     max_iters=max_iters),
                        "max_iters", len(idx), n_act, iters / 2,
                        solved_share), step_bytes(a, out, (3, 4), rows_read)))
                    stats.update(mean_iters=mean_trips,
                                 solved_share=solved_share)
                    n_cand = torch.stack(trips).shape[0] * trips[0].shape[0]
                    line += (f"; bound {stats['bound_ms']:.4f} ms by "
                             f"{stats['bound_by']} "
                             f"({solved_share * n_cand:.2f} of "
                             f"{n_cand} candidates a lane solved, "
                             f"{mean_trips:.2f} LM iterations each, both "
                             f"starts)")
            print(line, flush=True)
    return stats


# K1's options at k = 8 (phase 4b), by name; "dedup_qsort" is the pair the
# JAX main path ships (bench.py:79-82), phase 6b's and the simulator's
K1_OPTION_SETS = {"dedup": dict(dedup=True),
                  "qsort_skip": dict(qsort_skip=True),
                  "dedup_qsort": dict(dedup=True, qsort_skip=True)}


def k1_with(params, limits, options, max_iter=CAP, **kw):
    """K1 at the headline's sizes with ``options``."""
    from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
        build_fused_i2lqr_step)
    return build_fused_i2lqr_step(params, limits, 1.0, num_horizon=N,
                                  max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                                  max_iter=max_iter, **options, **kw)


def check_k1_options(captured, k1, params, limits, host_params, host_limits):
    """Phase 4b: on phase 4's captures (f32 as captured; the lane queue,
    dedup_qsort, in f64 cast up too, at phase 4's gates) K1 with each
    option set of K1_OPTION_SETS, with and without with_stats, and K1's
    counting build in the plain order ("with_stats"), against K1 without
    options: the outputs bit for bit, the counts integer for integer the
    plain version's (the lane queue's iters_executed, which the plain
    version does not model, by its invariants), ms a step of each beside
    K1's, the counts' sums and the bound over the solves each schedule
    runs (its iters_useful and the solves the plain version reports).
    Returns each set's figures at the lap-2 capture."""
    from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
        i2lqr_step_reference)
    sets = {"with_stats": {}, **K1_OPTION_SETS}
    kern = {name: (k1_with(params, limits, o) if o else k1,
                   k1_with(params, limits, o, with_stats=True))
            for name, o in sets.items()}
    nc, stats = k1.nsi * k1.k, {}
    for lap, (step, args) in sorted(captured.items()):
        a = cast(args, torch.float32, keep=(8,))
        active = a[8] < 0.5
        n_act = int(active.sum())
        base = k1(*a)
        base_ms = cuda_ms(lambda: k1(*a), 10)
        print(f"[4b K1 options lap {lap} step {step} f32] active {n_act}, "
              f"K1 without options {base_ms:.3f} ms a step", flush=True)
        for name, o in sets.items():
            shipped, counted = kern[name]
            out = counted(*a)
            require(all(torch.equal(g, w) for g, w in zip(out[:4], base))
                    and all(torch.equal(g, w) for g, w in zip(shipped(*a),
                                                              base)),
                    f"4b K1 {name} lap {lap}: outputs are not K1's")
            trips = []
            ref, plain_ms = timed_call(lambda: i2lqr_step_reference(
                params, limits, 1.0, *a, max_iter=CAP, with_stats=True,
                trips=trips, **o))
            for g, w, what in zip(out[4:], ref[4:],
                                  ("useful", "executed", "queue_floor")):
                if what == "executed" and o.get("qsort_skip"):
                    require(bool((g >= out[4]).all())
                            and int(g[~active].abs().sum()) == 0,
                            f"4b K1 {name} lap {lap}: executed")
                    continue
                require(torch.equal(g, w), f"4b K1 {name} lap {lap}: "
                        f"{what} is not the plain version's")
            if o.get("qsort_skip"):  # the measured switch at the headline
                require(shipped.lane_queue_runs(a[0].shape[-1]),
                        f"4b K1 {name}: the lane queue does not run")
            ms = cuda_ms(lambda: shipped(*a), 10)
            stats_ms = cuda_ms(lambda: counted(*a), 10)
            useful, executed, floor = (float(t[active].double().sum())
                                       for t in out[4:])
            solves = float(torch.cat(trips)[:, active].gt(0).double().sum())
            line = (f"[4b K1 {name} lap {lap}] bitwise K1's, counts the "
                    f"plain version's; {ms:.3f} ms a step (counting build "
                    f"{stats_ms:.3f}, plain {plain_ms:.3f}); solves a live "
                    f"lane {solves / n_act:.2f} of {3 * nc}, useful "
                    f"{useful / n_act:.2f} trips, executed "
                    f"{executed / n_act:.2f} thread-trips, waste "
                    f"{1 - useful / executed:.4f}, queue floor (32 lanes) / "
                    f"executed {floor / executed:.4f}")
            if lap == 2:
                idx = torch.nonzero(active).flatten()[:SAMPLE_LANES]
                sample = lanes_of(a, idx.cpu(), a[0].shape[-1])
                st = bound(solve_ops(
                    lambda max_iter: i2lqr_step_reference(
                        host_params, host_limits, 1.0, *sample,
                        max_iter=max_iter), "max_iter", len(idx), n_act,
                    useful / (3 * nc), solves / (n_act * 3 * nc)),
                    step_bytes(a, out[:4], (2, 3), k1.nsi))
                st.update(ms=stats_ms if not o else ms, stats_ms=stats_ms,
                          plain_ms=plain_ms, k1_ms=base_ms,
                          max_abs_err=max_abs_err(out[:4], base),
                          solves_a_lane=solves / n_act,
                          useful_a_lane=useful / n_act,
                          executed_a_lane=executed / n_act,
                          waste=1 - useful / executed,
                          floor_over_executed=floor / executed)
                stats[name] = st
                line += (f"; bound {st['bound_ms']:.4f} ms by "
                         f"{st['bound_by']}")
            print(line, flush=True)
        # the lane queue (the simulator's own K1) in f64 cast up, with and
        # without counts: bit for bit K1 without options, at phase 4's
        # gates against the plain version
        shipped, counted = kern["dedup_qsort"]
        a = cast(args, torch.float64, keep=(8,))
        base = k1(*a)
        out = counted(*a)
        require(all(torch.equal(g, w) for g, w in zip(out[:4], base))
                and all(torch.equal(g, w) for g, w in zip(shipped(*a),
                                                          base)),
                f"4b K1 dedup_qsort lap {lap} f64: outputs are not K1's")
        ref = i2lqr_step_reference(params, limits, 1.0, *a, max_iter=CAP,
                                   with_stats=True,
                                   **K1_OPTION_SETS["dedup_qsort"])
        gate, _ = k1_gate(f"4b K1 dedup_qsort lap {lap}", out[:4], ref[:4],
                          active, torch.float64)
        # the trips follow the decisions, which phase 4's f64 gate lets
        # differ on 0.1 % of live lanes: useful is held integer for integer
        # on every lane whose decisions agree, the queue floor on every lane
        # whose group of floor_width lanes agrees whole
        agree = ((out[1] == ref[1]) & (out[2] == ref[2])
                 & (out[3] == ref[3]))
        width = counted.floor_width
        whole = agree.view(-1, width).all(dim=1).repeat_interleave(width)
        held = [int(((g != w) & m & active).sum())
                for g, w, m in ((out[4], ref[4], agree),
                                (out[6], ref[6], whole))]
        require(held == [0, 0], f"4b K1 dedup_qsort lap {lap} f64: useful "
                f"and queue floor differ from the plain version's on "
                f"{held} lanes whose decisions agree")
        print(f"[4b K1 dedup_qsort lap {lap} f64] bitwise K1's with and "
              f"without counts; against the plain version {gate}; useful "
              f"and queue floor the plain version's on the "
              f"{int((agree & active).sum())} / "
              f"{int((whole & active).sum())} live lanes whose decisions "
              f"(whose group's) agree, of {int(active.sum())}", flush=True)
    return stats


def check_k2_counts(tag, k2s, captured, lp, limits):
    """K2 with_stats on captured inputs (f32 as captured): iters_useful and
    iters_executed integer for integer the plain step's; prints their sums
    a live lane and the waste share."""
    from ilqr_iterative_tasks_torch.ops.nlmpc_step import (
        nlmpc_step_reference)
    for lap, (step, args) in sorted(captured.items()):
        a = cast(args, torch.float32, keep=(9,))
        active = a[9] < 0.5
        out = k2s(*a)
        ref = nlmpc_step_reference(lp, limits, 1.0, *a,
                                   max_iters=k2s.max_iters,
                                   qsort_skip=k2s.qsort_skip, with_stats=True)
        for g, w, what in zip(out[6:], ref[6:], ("useful", "executed")):
            require(torch.equal(g, w), f"{tag} lap {lap}: {what} is not "
                    f"the plain step's")
        useful, executed = (float(t[active].double().sum()) for t in out[6:])
        n_act = int(active.sum())
        print(f"[{tag} lap {lap} step {step}] counts the plain step's: "
              f"useful {useful / n_act:.2f}, executed {executed / n_act:.2f}"
              f" a live lane, waste {1 - useful / executed:.4f}", flush=True)


# The options of the TPU step kernels ported last (phases 4d, 6d, 8e, 10d,
# 10e, 13b, 15c, 16b, 19c, 21d). K1's kernel variants at k = 8 by name: the
# options, and the build the option off runs ("plain": K1 without options;
# "pair": the dedup + qsort_skip pair the simulator ships)
K1_VARIANTS = {
    "reuse_extract": (dict(reuse_extract=True), "plain"),
    "pair_reuse_extract": (dict(dedup=True, qsort_skip=True,
                                reuse_extract=True), "pair"),
    "dom_skip": (dict(dom_skip=True), "plain"),
    "group2_dedup": (dict(group=2, dedup=True), "plain"),
    "group4": (dict(group=4), "plain"),
    "group8": (dict(group=8), "plain"),
}
# the variants whose plain version runs with the option at the lap-2
# capture (its time, the solves it runs); group 4 and 8 solve every
# candidate as the plain order does, so they take its time and bound
K1_MEASURED = ("reuse_extract", "pair_reuse_extract", "dom_skip",
               "group2_dedup")
VARIANT_LAPS = (1, 2)  # the captures the variants run on
# K2's by name, per mode: its options, and the build the option off runs
# ("plain": the plain order; "qsort": the shipped qsort_skip)
K2_VARIANTS = {
    "spaceVarying": {
        "prox_skip": (dict(prox_skip=True), "plain"),
        "zeros_skip": (dict(zeros_skip=True), "plain"),
        "qsort_zeros_skip": (dict(qsort_skip=True, zeros_skip=True),
                             "qsort"),
        "prox_zeros_skip": (dict(prox_skip=True, zeros_skip=True), "plain")},
    "timeVarying": {
        "prox_skip": (dict(prox_skip=True), "plain"),
        "qsort_zeros_skip": (dict(qsort_skip=True, zeros_skip=True),
                             "qsort")},
}
F64_SUBSET = 4096  # live lanes of a capture held in f64 (phases 4d, 8e, 13b)


def lanes_on(args, idx, b):
    """The lanes ``idx`` of every tensor whose last axis is the batch b,
    on the card, contiguous."""
    return [t[..., idx].contiguous() if t.dim() and t.shape[-1] == b else t
            for t in args]


def in_turns(fns, reps=5) -> dict:
    """ms a call of each of ``fns`` (name -> fn), timed in turns, there and
    back (a b b a): the least of each's turns."""
    names = list(fns)
    ms = {name: [] for name in names}
    for name in names + names[::-1]:
        ms[name].append(cuda_ms(fns[name], reps))
    return {name: min(v) for name, v in ms.items()}


def k1_variant_events(kernel, fn, counting):
    """K1's events in ``fn()`` on the counting build: (lane-passes 1-2
    under reuse_extract, of them those whose kNN was kept, slots dom_skip
    passed over)."""
    if kernel.k == 32:
        return kernel_events(counting, "i2lqr_step_block_events", 2,
                             fn) + [0]
    if kernel.group > 1:
        return kernel_events(counting, "i2lqr_step_group_events", 2,
                             fn) + [0]
    return kernel_events(counting, "i2lqr_step_opts_events", 3, fn)


def variant_bound(trips, active, n_cands, plain_ops, cap_kw, sample_lanes,
                  bytes_moved, solved=None, starts=1):
    """A variant's bound over the solves its schedule runs: the plain
    version's trips with the option (each batched solve's (C, B)), of the
    candidates ``solved`` marks (default: those with a trip), in
    solve_ops' units over the ``n_cands`` candidate solves a lane-step of
    the plain order runs (``starts``: the LM starts a trip count sums,
    whose iterations solve_ops counts together). Returns bound() and the
    solves a live lane."""
    t = torch.cat(trips).double()
    s = t.gt(0) if solved is None else torch.cat(solved)
    t, s = (t * s)[:, active], s[:, active].double()
    n_lanes = int(active.sum())
    st = bound(solve_ops(plain_ops, cap_kw, sample_lanes, n_lanes,
                         float(t.sum()) / (n_cands * starts),
                         float(s.sum()) / (n_lanes * n_cands)), bytes_moved)
    st["solves_a_lane"] = float(s.sum()) / n_lanes
    return st


def check_k1_variants(tag, captured, variants, off, params, limits,
                      host_params, host_limits, counting, cap=CAP,
                      measured=K1_MEASURED, plain_bound=None):
    """K1's reuse_extract, dom_skip and group on captured inputs (phase 4d
    on phase 4's, 19c on phase 19's at k = 32): each variant of
    ``variants`` (name -> (options, the name of its option-off kernel in
    ``off``)) bit for bit the kernel without the option and its plain
    version (f32 as captured: every output, k1_gate), and in f64 on the
    first F64_SUBSET live lanes against the plain step at phase 4's gates
    (the counting build where only it runs the lane queue on so few
    lanes); ms a step of each beside its option-off kernel's, in turns; at
    the lap-2 capture the plain version with the option (its time, the
    solves it runs: the bound) for the variants ``measured`` (the others
    take the plain order's time and ``plain_bound``), the fire share of
    reuse_extract (passes 1 and 2 whose guess did not move, the plain
    version's) and the counting build's events on the card. Captures:
    VARIANT_LAPS. Returns each variant's lap-2 figures."""
    from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
        i2lqr_step_reference)
    kern = {name: k1_with(params, limits, o, max_iter=cap)
            for name, (o, _) in variants.items()}
    queue = {name: k1_with(params, limits, o, with_stats=True, max_iter=cap)
             for name, (o, _) in variants.items()
             if o.get("qsort_skip") or (o.get("dom_skip")
                                        and o.get("group", 1) == 1)}
    stats = {}
    for lap, (step, args) in sorted(captured.items()):
        if lap not in VARIANT_LAPS:
            continue
        a = cast(args, torch.float32, keep=(8,))
        b = a[0].shape[-1]
        active = a[8] < 0.5
        n_act = int(active.sum())
        ref, ref_ms = timed_call(lambda: i2lqr_step_reference(
            params, limits, 1.0, *a, max_iter=cap))
        base = {name: k(*a) for name, k in off.items()}
        idx = torch.nonzero(active).flatten()[:F64_SUBSET]
        sub = cast(lanes_on(a, idx, b), torch.float64, keep=(8,))
        ref64 = i2lqr_step_reference(params, limits, 1.0, *sub, max_iter=cap)
        for name, (o, off_name) in variants.items():
            kv = kern[name]
            out = kv(*a)
            require(all(torch.equal(g, w) for g, w in zip(out,
                                                          base[off_name])),
                    f"{tag} {name} lap {lap}: not bitwise K1 without it")
            gate, _ = k1_gate(f"{tag} {name} lap {lap}", out, ref, active,
                              torch.float32)
            gate64, _ = k1_gate(f"{tag} {name} lap {lap}",
                                queue.get(name, kv)(*sub)[:4], ref64,
                                sub[8] < 0.5, torch.float64)
            ms = in_turns({"on": lambda: kv(*a),
                           "off": lambda: off[off_name](*a)})
            line = (f"[{tag} K1 {name} lap {lap} step {step}] active "
                    f"{n_act}: bitwise K1 without it ({off_name}); f32 "
                    f"against the plain step {gate}; f64 on "
                    f"{len(idx)} live lanes {gate64}; {ms['on']:.3f} ms a "
                    f"step against {ms['off']:.3f} without, in turns")
            if lap == 2:
                trips, reused, cands = [], [], []
                if name in measured:
                    ref_o, plain_ms = timed_call(
                        lambda: i2lqr_step_reference(
                            params, limits, 1.0, *a, max_iter=cap,
                            trips=trips, reused=reused, cands=cands, **o))
                    require(all(torch.equal(g, w)
                                for g, w in zip(ref_o, ref)),
                            f"{tag} {name}: the plain version with the "
                            f"option changed its outputs")
                    sidx = idx[:SAMPLE_LANES].cpu()
                    sample = lanes_of(a, sidx, b)
                    st = variant_bound(
                        trips, active, 3 * kv.nsi * kv.k,
                        lambda max_iter: i2lqr_step_reference(
                            host_params, host_limits, 1.0, *sample,
                            max_iter=max_iter), "max_iter", len(sidx),
                        step_bytes(a, out, (2, 3), kv.nsi),
                        # at k = 32 the distinct solves, each once
                        solved=None if kv.k == 8 else k32_distinct(
                            a[5], a[6], cands))
                else:
                    plain_ms, st = ref_ms, dict(plain_bound)
                ev = k1_variant_events(kv, lambda: kv(*a), counting)
                st.update(ms=ms["on"], off_ms=ms["off"], plain_ms=plain_ms,
                          max_abs_err=max_abs_err(out, ref), events=ev)
                if o.get("reuse_extract"):
                    st["fire_share_plain"] = float(
                        sum(r.double().sum() for r in reused)
                        / (len(reused) * n_act))
                    st["fire_share_card"] = ev[1] / max(ev[0], 1)
                    require(ev[1] > 0, f"{tag} {name}: reuse_extract kept "
                            f"no kNN on the card")
                if o.get("dom_skip") and o.get("group", 1) == 1:
                    st["dominated_a_lane"] = ev[2] / n_act
                    require(ev[2] > 0, f"{tag} {name}: dom_skip skipped no "
                            f"slot on the card")
                stats[name] = st
                line += (f"; plain {plain_ms:.3f} ms; bound "
                         f"{st['bound_ms']:.4f} ms by {st['bound_by']}; "
                         f"events on the card {ev}")
                if "fire_share_plain" in st:
                    line += (f"; kNN kept on {st['fire_share_card']:.4f} of "
                             f"the live lane-passes 1-2 (plain version "
                             f"{st['fire_share_plain']:.4f})")
            print(line, flush=True)
    return stats


def check_k2_variants(tag, mode, captured, off, lp, limits, host_limits,
                      counting):
    """K2's prox_skip and zeros_skip on captured inputs (phases 8e, 13b):
    each variant of K2_VARIANTS[mode] against its plain version with the
    same options at phase 8's gates (k2_gate; f32 as captured, and f64 on
    the first F64_SUBSET live lanes) and, where the option is neutral
    (prox_skip), bit for bit the kernel without it (``off``: "plain" the
    plain order, "qsort" the shipped qsort_skip); ms a step beside it, in
    turns; at the lap-2 capture the plain version's time with the option
    and the solves it runs (the bound), the lanes zeros_skip changes and
    the counting build's events. Returns each variant's lap-2 figures."""
    from ilqr_iterative_tasks_torch.ops.nlmpc_step import (
        build_fused_nlmpc_step, nlmpc_step_reference)
    from ilqr_iterative_tasks_torch.utils.params import LmpcParams
    sizes = dict(num_horizon=N, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                 max_iters=NL_CAP)
    variants = K2_VARIANTS[mode]
    kern = {name: build_fused_nlmpc_step(lp, limits, 1.0, **sizes, **o)
            for name, (o, _) in variants.items()}
    host_lp = LmpcParams.make(device="cpu", ss_option=mode)
    stats = {}
    for lap, (step, args) in sorted(captured.items()):
        if lap not in VARIANT_LAPS:
            continue
        a = cast(args, torch.float32, keep=(9,))
        b = a[0].shape[-1]
        active = a[9] < 0.5
        n_act = int(active.sum())
        base = {name: k(*a) for name, k in off.items()}
        idx = torch.nonzero(active).flatten()[:F64_SUBSET]
        sub = cast(lanes_on(a, idx, b), torch.float64, keep=(9,))
        # the plain step without and with zeros_skip, f32 and f64 subset
        refs = {zs: (nlmpc_step_reference(lp, limits, 1.0, *a,
                                          max_iters=NL_CAP, zeros_skip=zs),
                     nlmpc_step_reference(lp, limits, 1.0, *sub,
                                          max_iters=NL_CAP, zeros_skip=zs))
                for zs in (False, True)}
        for name, (o, off_name) in variants.items():
            kv = kern[name]
            out = kv(*a)
            plain_o = dict(zeros_skip=o.get("zeros_skip", False))
            ref, ref64 = refs[plain_o["zeros_skip"]]
            gate, maxd = k2_gate(f"{tag} {name} lap {lap}", out, ref,
                                 active, torch.float32)
            gate64, _ = k2_gate(f"{tag} {name} lap {lap}", kv(*sub), ref64,
                                sub[9] < 0.5, torch.float64)
            neutral = not o.get("zeros_skip")
            same = all(torch.equal(g, w) for g, w in zip(out,
                                                         base[off_name]))
            changed = int((active & torch.stack(
                [(g != w).reshape(-1, b).any(dim=0)
                 for g, w in zip(out, base[off_name])]).any(dim=0)).sum())
            if neutral:
                require(same, f"{tag} {name} lap {lap}: not bitwise K2 "
                        f"without it")
            ms = in_turns({"on": lambda: kv(*a),
                           "off": lambda: off[off_name](*a)})
            line = (f"[{tag} K2 {name} lap {lap} step {step}] active "
                    f"{n_act}: against the plain step {gate}; f64 on "
                    f"{len(idx)} live lanes {gate64}; "
                    + (f"bitwise K2 without it ({off_name})" if neutral
                       else f"{changed} live lanes changed against K2 "
                            f"without it ({off_name})")
                    + f"; {ms['on']:.3f} ms a step against {ms['off']:.3f} "
                      f"without, in turns")
            if lap == 2:
                trips, cands = [], []
                ref_o, plain_ms = timed_call(lambda: nlmpc_step_reference(
                    lp, limits, 1.0, *a, max_iters=NL_CAP, trips=trips,
                    cands=cands, prox_skip=o.get("prox_skip", False),
                    **plain_o))
                require(all(torch.equal(g, w) for g, w in zip(ref_o, ref)),
                        f"{tag} {name}: prox_skip changed the plain step's "
                        f"outputs")
                sidx = idx[:SAMPLE_LANES].cpu()
                sample = lanes_of(a, sidx, b)
                st = variant_bound(
                    trips, active, kv.nsi * kv.k,
                    lambda max_iters: nlmpc_step_reference(
                        host_lp, host_limits, 1.0, *sample,
                        max_iters=max_iters, **plain_o), "max_iters",
                    len(sidx),
                    step_bytes(a, out, (3, 4), k2_rows_read(kv, a)),
                    solved=(solved_by(kv, a, cands, ref_o)
                            if o.get("qsort_skip") else None), starts=2)
                ev = kernel_events(counting, "nlmpc_step_events", 3,
                                   lambda: kv(*a))
                st.update(ms=ms["on"], off_ms=ms["off"], plain_ms=plain_ms,
                          max_abs_err=maxd, events=ev, lanes_changed=changed)
                if o.get("prox_skip"):
                    st["skipped_a_lane"] = ev[0] / n_act
                    st["stopped_share"] = ev[1] / n_act
                if o.get("zeros_skip"):
                    st["zeros_starts_skipped_a_lane"] = ev[2] / n_act
                    require(ev[2] > 0, f"{tag} {name}: zeros_skip skipped "
                            f"no zeros start on the card")
                stats[name] = st
                line += (f"; plain with it {plain_ms:.3f} ms; solves a "
                         f"live lane {st['solves_a_lane']:.2f}; bound "
                         f"{st['bound_ms']:.4f} ms by {st['bound_by']}; "
                         f"events on the card (slots prox_skip passed over, "
                         f"lanes it stopped early, zeros starts skipped) "
                         f"{ev}")
            print(line, flush=True)
    if mode == "spaceVarying":
        require(stats["prox_skip"]["events"][0] > 0,
                f"{tag} prox_skip skipped no slot on the card")
    return stats


def check_k2_all_zskip(tag, kernels, captured, lp, limits, counting):
    """K2 all's zeros_skip builds (``kernels``: name -> K2) on the lap-2
    capture (phase 16b) against the plain step with zeros_skip at phase 8's
    gates, f32 as captured; ms a step and the counting build's zeros
    starts skipped. Returns each build's figures."""
    from ilqr_iterative_tasks_torch.ops.nlmpc_step import (
        nlmpc_step_reference)
    stats = {}
    for lap, (step, args) in sorted(captured.items()):
        if lap != 2:
            continue
        a = cast(args, torch.float32, keep=(9,))
        active = a[9] < 0.5
        ref, plain_ms = timed_call(lambda: nlmpc_step_reference(
            lp, limits, 1.0, *a, max_iters=NL_CAP, zeros_skip=True))
        for name, kern in kernels.items():
            out = kern(*a)
            gate, maxd = k2_gate(f"{tag} {name} lap {lap}", out, ref, active,
                                 torch.float32)
            line = (f"[{tag} K2 {name} lap {lap} step {step}] active "
                    f"{int(active.sum())}: against the plain step with "
                    f"zeros_skip {gate}")
            if lap == 2:
                ms = cuda_ms(lambda: kern(*a), 3)
                ev = kernel_events(counting, "nlmpc_step_all_events", 1,
                                   lambda: kern(*a))
                require(ev[0] > 0, f"{tag} {name}: no zeros start skipped")
                stats[name] = dict(ms=ms, plain_ms=plain_ms,
                                   max_abs_err=maxd,
                                   zeros_starts_skipped=ev[0])
                line += (f"; {ms:.3f} ms a step, plain {plain_ms:.3f}; "
                         f"zeros starts skipped on the card {ev[0]}")
            print(line, flush=True)
    return stats


def k2_rows_read(k2, a) -> float:
    """The stored laps' worth of safe-set rows a K2 step reads (the
    timeVarying window k of each stored lap's T)."""
    stored = [lap for lap, ok in zip(a[6].tolist(), a[7].tolist()) if ok]
    return max(1, len(stored)) * (k2.k / a[3].shape[1]
                                  if k2.mode == "timeVarying" else 1.0)


def variant_turns(tag, run, arms, card, back=True):
    """Headline runs of kernel variants and the kernel without them, one
    seed, in turns there and back (a b c c b a; with ``back`` False once
    each): each run's seconds; the lap-record hashes all equal. ``arms``:
    name -> (the step solver, the kernel whose launches count). Returns
    name -> dict(run_s, launches, hash)."""
    names = list(arms)
    out, hashes = {name: dict(run_s=[]) for name in names}, []
    for name in names + (names[::-1] if back else []):
        solver, counted = arms[name]
        counted.launches = 0
        t0 = time.perf_counter()
        res = run(solver)
        out[name]["run_s"].append(time.perf_counter() - t0)
        out[name]["launches"] = counted.launches
        out[name]["hash"] = lap_records_hash(res)
        hashes.append(out[name]["hash"])
        del res
    require(len(set(hashes)) == 1, f"{tag}: lap records differ {hashes}")
    for name in names:
        require(out[name]["launches"] > 0, f"{tag} {name}: not launched")
    print(f"[{tag}] " + "; ".join(
        f"{name} {min(v['run_s']):.3f} s a run (runs "
        f"{[round(t, 3) for t in v['run_s']]}), launches {v['launches']}"
        for name, v in out.items())
        + f"; lap records {hashes[0]} in every run; card {card}", flush=True)
    return out


def cast(args, dtype, keep=()):
    """Floating tensors to ``dtype`` (positions in ``keep`` stay)."""
    return [t.to(dtype) if t.is_floating_point() and i not in keep else t
            for i, t in enumerate(args)]


def k1_gate(tag, out, ref, active, dtype):
    """Phase 4's gates of a K1 output against its plain step's (>= 99.9 %
    equal decisions and max|dus| <= 1e-6 on them in f64, >= 99 % in f32),
    and in f32 every output equal bit for bit. Returns the check's line
    and max|dus| on the agreeing lanes."""
    require(bool(torch.isfinite(out[0]).all()), f"{tag}: non-finite us")
    agree = ((out[1] == ref[1]) & (out[2] == ref[2])
             & (out[3] == ref[3]))[active]
    dus = (out[0] - ref[0]).abs().amax(dim=(0, 1))[active][agree]
    share = float(agree.double().mean())
    maxd = float(dus.max()) if dus.numel() else 0.0
    bitwise = all(torch.equal(g, w) for g, w in zip(out, ref))
    if dtype == torch.float64:
        require(share >= 0.999 and maxd <= 1e-6,
                f"{tag} f64: agreement {share}, {maxd}")
    else:
        require(share >= 0.99 and bitwise,
                f"{tag} f32: agreement {share}, bitwise {bitwise}")
    return (f"decisions agree {share:.6f}, max|dus| on them {maxd:.3e}, "
            f"bitwise {bitwise}"), maxd


class SkipLog(Recorder):
    """A Recorder that keeps only each call's skip mask (its input 4)."""

    def __call__(self, *args):
        self.calls.append(args[4] > 0.5)
        return self.kernel(*args)


def compaction_replay(kernel, a, masks, rows):
    """The JAX path's compaction of active lanes to the batch front
    (batched_soa.py:514-522), measured: ``kernel`` on the inputs ``a``
    (rows x B candidate lanes) under each skip mask of ``masks`` (a run's,
    in order), as the lanes lie and with each candidate row's active lanes
    first (bitwise the same outputs, checked on the first mask). Returns
    the summed ms of both and the run's mean active share."""
    b = a[1].shape[-1] // rows
    lanes = torch.arange(rows, device=a[1].device)[:, None] * b
    as_is = compacted = 0.0
    for n, m in enumerate(masks):
        skip = m.to(torch.float32).expand(rows * b // m.numel(), -1) \
            .reshape(-1).contiguous()
        order = torch.argsort(m[:b].to(torch.int8), stable=True)
        perm = (lanes + order[None]).flatten()
        x = (*a[:4], skip, *a[5:])
        xc = tuple(t[..., perm].contiguous() for t in x)
        if n == 0:
            require(all(torch.equal(g[..., perm], w)
                        for g, w in zip(kernel(*x), kernel(*xc))),
                    "compacted lanes differ")
        as_is += cuda_ms(lambda: kernel(*x), 1)
        compacted += cuda_ms(lambda: kernel(*xc), 1)
    share = float(torch.stack([~m for m in masks]).double().mean())
    return dict(steps=len(masks), mean_active_share=share, ms=as_is,
                compacted_ms=compacted)


# the prefixes of the tail_shrink runs and of the prefix launches
TAIL_PREFIXES = (4096, 1024)
# (occupancy key, registers, bytes of local memory) of the plain f32
# builds the lane prefix must leave as they were, and of K1's lane queue
# as its chunk-queue design builds (PERF.md section 6)
PLAIN_RESOURCES = (("k1", 128, 224), ("k1_k32", 128, 320),
                   ("k1_lanes", 168, 152), ("k2_sv", 245, 48),
                   ("k2_all", 255, 48))


def check_prefix(tag, kernel, args, skip_at, prefixes=TAIL_PREFIXES,
                 skip_outputs=()):
    """A K1 / K2 launch over the first P lanes of full-width inputs
    (``lanes=P``, a tail step's launch) against a launch over every lane
    with the lanes past P skipped (the same step over B): every output bit
    for bit (the lanes past P zeros in both; outputs at ``skip_outputs``
    left out: the lane queue's executed, whose warps take lanes from a
    counter), and both ms a step. Returns {P: (ms over B, ms over P)}."""
    out = {}
    for p in prefixes:
        a = list(args)
        a[skip_at] = a[skip_at].clone()
        a[skip_at][p:] = 1.0
        full, part = kernel(*a), kernel(*a, lanes=p)
        for i, (f, g) in enumerate(zip(full, part)):
            if i in skip_outputs:
                continue
            require(torch.equal(f, g) and not bool(g[..., p:].any()),
                    f"{tag} lanes={p}: output {i} differs from the launch "
                    f"over every lane")
        out[p] = (cuda_ms(lambda: kernel(*a), 3),
                  cuda_ms(lambda: kernel(*a, lanes=p), 3))
        print(f"[{tag} lanes={p}] live {int((a[skip_at] < 0.5).sum())}: "
              f"bitwise the launch over {a[0].shape[-1]} lanes; "
              f"{out[p][0]:.3f} ms over every lane, {out[p][1]:.3f} ms over "
              f"the prefix", flush=True)
    return out


def option_turns(tag, run, solver, skip_at, arms, card, own=()):
    """The headline ``run(solver, **opts)`` for each arm of ``arms``
    ({name: simulator options}) in turns, A B ... B A, on seed 1: each
    run's seconds and lap-records hash (every arm's must be the first
    arm's, but an arm of ``own`` must repeat its own other turn's: a run
    the options change), its launches of ``solver`` through a LaunchLog (their ms
    summed, the kernel's device time over the run; a tail_shrink
    arm's launches over the prefix beside the same steps' launches over B
    in the first arm's run: ``tail_launches``) and its permutations a lap
    with their ms (``perm_log``). Returns {name: figures}."""
    names = list(arms)
    out = {n: dict(s=[]) for n in names}
    want = {}
    for n in names + names[::-1]:
        rec, perms = LaunchLog(solver, skip_at), []
        solver.launches = 0
        t0 = time.perf_counter()
        res = run(rec, perm_log=perms, **arms[n])
        out[n]["s"].append(time.perf_counter() - t0)
        h = lap_records_hash(res)
        key = n if n in own else names[0]
        want.setdefault(key, h)
        require(h == want[key], f"{tag} {n}: lap records {h} differ from "
                                f"{want[key]}")
        require(solver.launches > 0, f"{tag} {n}: not launched")
        log = rec.launches()
        out[n].setdefault("launch_ms", []).append(
            sum(ms for _, _, ms in log))
        out[n].update(hash=h, launches=solver.launches, log=log,
                      perms=[e["perms"] for e in perms],
                      compacted=[e["compacted"] for e in perms],
                      perm_ms=[sum(e["perm_ms"]) for e in perms])
        del res, rec
    base_log = out[names[0]]["log"]
    for n in names:
        out[n]["tail"] = tail_launches(out[n]["log"], base_log)
    for n in names:
        out[n].pop("log")
    for n in names:
        o = out[n]
        print(f"[{tag} {n}] {json.dumps(arms[n])}: runs "
              f"{[round(t, 3) for t in o['s']]} s, lap records {o['hash']}, "
              f"launches {o['launches']} (ms of the card by CUDA events a "
              f"run {[round(t, 3) for t in o['launch_ms']]}), permutations "
              f"a lap {o['perms']} "
              f"({[round(t, 3) for t in o['perm_ms']]} ms a lap, compacted "
              f"{o['compacted']}); launches over the prefix "
              f"{json.dumps(o['tail'])}; card {card}", flush=True)
    return out


def zero_counts(*kernels):
    for k in kernels:
        k.launches = 0


def check_candidate_steps(tag, captured, step, kernel, skip_at):
    """The per-candidate step (the plain step's glue around ``kernel``)
    against the plain step (glue and plain solve) on captured inputs, on
    the card, f32 as captured and f64 cast up: every output bit for bit.
    ``step(*a, candidate_solver=...)`` is the plain step; ``skip_at`` the
    skip mask's position in the inputs. Returns the f32 lap-2 capture's
    per-candidate step ms, plain step ms and the kernel's inputs there
    (a Recorder's calls)."""
    stats = {}
    for lap, (i, args) in sorted(captured.items()):
        active = args[skip_at] < 0.5
        require(bool(active.any()), f"{tag} capture lap {lap}: no active lane")
        line = f"[{tag} lap {lap} step {i}] active {int(active.sum())}"
        for dtype in (torch.float32, torch.float64):
            a = cast(args, dtype, keep=(skip_at,))
            rec = Recorder(kernel, ())
            got = step(*a, candidate_solver=rec)
            want, plain_ms = timed_call(lambda: step(*a))
            for t in got:
                require(bool(torch.isfinite(t.double()).all()),
                        f"{tag} lap {lap}: non-finite output")
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            line += (f"; {str(dtype)[6:]}: {len(rec.calls)} kernel calls of "
                     f"{[c[1].shape[-1] for c in rec.calls]} lanes, "
                     f"bitwise equal to the plain step {same}")
            require(same, f"{tag} lap {lap} {dtype}: the per-candidate step "
                    f"differs from the plain step")
            if dtype == torch.float32:
                step_ms = cuda_ms(lambda: step(*a, candidate_solver=kernel),
                                  3)
                line += (f" ({step_ms:.3f} ms a step with the kernel, "
                         f"{plain_ms:.3f} ms plain)")
                if lap == 2:
                    stats = dict(step_ms=step_ms, plain_step_ms=plain_ms,
                                 calls=rec.calls)
        print(line, flush=True)
    return stats


class HostCapture:
    """Wraps a host controller's ``k3`` / ``k4`` method: the kernel it
    returns keeps a copy of the inputs of the first call made while the
    controller's safe set holds ``laps`` laps (the seed lap and laps - 1
    learning laps, so the call is in learning lap ``laps``)."""

    def __init__(self, ctrl, method, laps):
        self.ctrl, self.laps, self.captured = ctrl, laps, None
        built = getattr(ctrl, method)
        setattr(ctrl, method, lambda *a: self.wrap(built(*a)))

    def wrap(self, kernel):
        def call(*args):
            if self.captured is None and self.ctrl.iter == self.laps:
                self.captured = (kernel, [a.clone() for a in args])
            return kernel(*args)
        return call


def host_run(tag, run, per_step, card):
    """One closed-loop run of a host controller on the card, ``run()``
    returning its RunResult. The controller builds its own kernels, so
    their launch counts start at 0 with the run. Returns (result, figures):
    laps, wall seconds, the kernels' launches (which must be ``per_step``
    x the steps that solved), ms a solving ``calc_input`` (median, p99;
    host clock, after the outputs reached the host) and the lanes of each
    launch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    ctrl = res.plant.ctrl_policy
    kernels = ctrl._k3 if hasattr(ctrl, "_k3") else ctrl._k4
    launches = sum(k.launches for k in kernels.values())
    solved = len(ctrl.solve_seconds)
    ms = np.asarray(ctrl.solve_seconds) * 1e3
    lanes = np.asarray(ctrl.launch_lanes)
    out = dict(laps=[int(t) for t in res.all_lap_times],
               finished=list(res.lap_finished), wall_s=wall,
               solve_steps=solved, launches=launches,
               ms_per_calc_input={"median": float(np.median(ms)),
                                  "p99": float(np.percentile(ms, 99))},
               lanes_per_launch={"min": int(lanes.min()),
                                 "median": float(np.median(lanes)),
                                 "max": int(lanes.max())})
    print(f"[{tag}] {json.dumps(out)}; card {card}", flush=True)
    require(solved > 0 and launches == per_step * solved,
            f"{tag}: {launches} kernel launches on {solved} solving steps "
            f"({per_step} a step)")
    return res, out


def on_host(obj):
    """A frozen dataclass of tensors (params, limits) with each tensor
    copied to the host, for the operation counts."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).cpu() for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def call_bound(kernel, a, out) -> dict:
    """``bound`` of one K3 or K4 call on the inputs ``a`` (outputs
    ``out``): the plain version's operations on a few host lanes times
    the LM iterations this call's lanes need (the plain solve's trips on
    the card; K4: both starts of the live lanes), at the peak rate of the
    lanes' type; with the mean iterations a lane."""
    from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
        FusedIlqr, fused_ilqr_reference)
    from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
        fused_lm_shooting_reference)
    from ilqr_iterative_tasks_torch.ops.ilqr_soa import ilqr_solve_soa
    from ilqr_iterative_tasks_torch.ops.lm_shooting_soa import (
        lm_feasibility_solve_soa)

    b = a[1].shape[-1]
    if isinstance(kernel, FusedIlqr):
        p, lim = kernel.params, kernel.limits
        trips = ilqr_solve_soa(
            p, lim, a[3], a[0], a[1], a[2], float(p.lamb), kernel.dt,
            num_horizon=kernel.num_horizon, max_iter=kernel.max_iter,
            done0=None if len(a) < 5 else a[4] > 0.5).lane_iters.double()
        live, its = torch.ones(b, dtype=torch.bool), float(trips.sum())
        hp, hl = on_host(p), on_host(lim)
        plain = lambda max_iter: fused_ilqr_reference(
            hp, hl, kernel.dt, *sample, num_horizon=kernel.num_horizon,
            max_iter=max_iter)
        cap_kw = "max_iter"
    else:
        lim, n = kernel.limits, kernel.num_horizon
        live = (a[4] < 0.5).cpu()
        trips = lm_feasibility_solve_soa(
            lim, a[3], a[0], a[1], a[2], kernel.dt, num_horizon=n,
            max_iters=kernel.max_iters,
            m_lanes=torch.clamp(a[5].long(), 2, n),
            done0=a[4] > 0.5).n_iters.double().cpu()
        its = float(trips[live].sum()) / 2
        hl = on_host(lim)
        plain = lambda max_iters: fused_lm_shooting_reference(
            hl, kernel.dt, *sample, num_horizon=n, max_iters=max_iters)
        cap_kw = "max_iters"
    idx = torch.nonzero(live).flatten()[:SAMPLE_LANES]
    sample = lanes_of(a, idx, b)
    peak = PEAK_F64_OPS if a[1].dtype == torch.float64 else PEAK_F32_OPS
    out_b = bound(solve_ops(plain, cap_kw, len(idx), int(live.sum()), its),
                  nbytes(a) + nbytes(out), peak)
    out_b["mean_iters"] = float(trips.cpu()[live].mean())
    return out_b


def max_abs_err(out, ref):
    """The largest absolute difference over a call's outputs."""
    return float(max((g.double() - w.double()).abs().max()
                     for g, w in zip(out, ref)))


def host_capture_check(tag, cap, plain):
    """The captured kernel call against ``plain`` on the same inputs on
    the card, bit for bit; returns the kernel's and the plain version's
    ms a call and the call's bound (``call_bound``)."""
    require(cap.captured is not None, f"{tag}: no call captured")
    kernel, a = cap.captured
    out = kernel(*a)
    ref, plain_ms = timed_call(lambda: plain(*a))
    require(all(torch.equal(g, w) for g, w in zip(out, ref)),
            f"{tag}: the kernel differs from its plain version")
    ms = cuda_ms(lambda: kernel(*a), 5)
    stats = dict(lanes=a[1].shape[-1], ms=ms, plain_ms=plain_ms,
                 max_abs_err=max_abs_err(out, ref),
                 **call_bound(kernel, a, out))
    print(f"[{tag}] {a[1].shape[-1]} lanes, bitwise equal to the plain "
          f"version; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms a call; "
          f"bound {stats['bound_ms']:.5f} ms by {stats['bound_by']} "
          f"({stats['mean_iters']:.2f} LM iterations a lane)", flush=True)
    return stats


def host_tier(card):
    """Phases 26-27: the host controllers on the card through K3 and K4;
    returns the ``host_path`` figures of K3 and K4."""
    from ilqr_iterative_tasks_torch.control.i2lqr import I2LqrController
    from ilqr_iterative_tasks_torch.control.nlmpc import (
        HOST_LM_ITERS, NlmpcController)
    from ilqr_iterative_tasks_torch.experiments import ilqr_test
    from ilqr_iterative_tasks_torch.experiments.runner import (
        default_obstacle, run_closed_loop)
    from ilqr_iterative_tasks_torch.ops.fused_ilqr import fused_ilqr_reference
    from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
        fused_lm_shooting_reference)
    from ilqr_iterative_tasks_torch.sim.plant import InfeasibleStep
    from ilqr_iterative_tasks_torch.utils.params import IlqrParams, LmpcParams

    # ---- 26. the i2LQR host tier on the card through K3 ----
    f64 = torch.float64
    t26 = time.perf_counter()
    host_k3 = {}
    demo = ["--lap-number", "3", "--num-ss-iters", "2", "--num-ss-points",
            "8", "--device", "cuda"]
    with no_plain_solve_on_card():
        ctrl = I2LqrController(IlqrParams.make(dtype=f64),
                               obstacle=default_obstacle(1.0), dtype=f64)
        cap26 = HostCapture(ctrl, "k3", 2)
        res, host_k3["ci_f64"] = host_run(
            "26 i2LQR host f64, CI configuration, 5 laps",
            lambda: run_closed_loop(ctrl, 5, goal_fixup="append"), 3, card)
        require(all(res.lap_finished) and res.seed_time == 120.0
                and host_k3["ci_f64"]["laps"][1:] == HOST_I2LQR_F64_LAPS,
                f"i2LQR host f64: laps {host_k3['ci_f64']['laps']}, the JAX "
                f"host's {HOST_I2LQR_F64_LAPS}")
        res, host_k3["ci_f32"] = host_run(
            "26 i2LQR host f32, 3 laps",
            lambda: run_closed_loop(
                I2LqrController(IlqrParams.make(),
                                obstacle=default_obstacle(1.0)),
                3, goal_fixup="append"), 3, card)
        require(all(res.lap_finished) and res.lap_times[0] <= 60.0
                and res.lap_times[-1] <= 30.0,
                f"i2LQR host f32: laps {res.lap_times}")
        res, host_k3["demo_cli"] = host_run(
            "26 i2LQR host, experiments/ilqr_test.py " + " ".join(demo),
            lambda: ilqr_test.main(demo), 3, card)
        require(all(res.lap_finished) and all(
            abs(t - w) <= 1 for t, w in zip(res.lap_times, DEMO_LAPS)),
            f"i2LQR demo CLI: laps {res.lap_times}, want {DEMO_LAPS} +- 1")
    host_k3["captured_pass"] = host_capture_check(
        "26 K3 on a captured pass of the f64 run, lap 2", cap26,
        lambda *a: fused_ilqr_reference(
            ctrl.params, ctrl.limits, 1.0, *a, num_horizon=N,
            max_iter=ctrl.params.max_ilqr_iter))
    host_k3["seconds"] = time.perf_counter() - t26
    print(f"[26 i2LQR host tier] {host_k3['seconds']:.1f} s", flush=True)

    # ---- 27. the NLMPC host tier on the card through K4 ----
    t27 = time.perf_counter()
    host_k4 = {}
    modes = {"spaceVarying": (dict(ss_option="spaceVarying"),
                              HOST_NLMPC_LAPS),
             "timeVarying": (dict(ss_option="timeVarying"), HOST_TV_LAPS),
             "all": (dict(all_ss_point=True, all_ss_iter=True),
                     HOST_ALL_LAPS)}
    with no_plain_solve_on_card():
        for mode, (kw, want) in modes.items():
            ctrl = NlmpcController(LmpcParams.make(**kw),
                                   obstacle=default_obstacle(1.0), dtype=f64)
            if mode == "spaceVarying":
                cap27, ctrl27 = HostCapture(ctrl, "k4", 2), ctrl
            res, host_k4[mode] = host_run(
                f"27 NLMPC host f64 {mode}, 3 laps",
                lambda: run_closed_loop(ctrl, 3, goal_fixup=None), 1, card)
            require(all(res.lap_finished)
                    and host_k4[mode]["laps"][1:] == want,
                    f"NLMPC host {mode}: laps {host_k4[mode]['laps']}, the "
                    f"JAX host's {want}")
            zeros = sum(int((f == 0).sum())
                        for f in res.plant.diagnostics["feasibility"])
            errs = res.plant.infeasible_errors
            require(zeros == len(errs) and all(
                isinstance(e, InfeasibleStep) for e in errs),
                f"NLMPC host {mode}: {zeros} infeasible steps, "
                f"{len(errs)} from InfeasibleStep")
            host_k4[mode]["infeasible_steps"] = zeros
    host_k4["captured_call"] = host_capture_check(
        "27 K4 on a captured step of the spaceVarying run, lap 2", cap27,
        lambda *a: fused_lm_shooting_reference(
            ctrl27.limits, 1.0, *a, num_horizon=N, max_iters=HOST_LM_ITERS))
    host_k4["seconds"] = time.perf_counter() - t27
    print(f"[27 NLMPC host tier] {host_k4['seconds']:.1f} s", flush=True)
    return host_k3, host_k4


def scenario_file_check(tag, path, laps):
    """The run's ``ego_*.npz``: JAX's keys for the seed lap and ``laps``
    learning laps, every entry numeric, read with allow_pickle=False."""
    want = {"num_laps", "lap_times", "seed_time", "lap_finished"}
    want |= {f"ss_{c}_{i}" for c in "xu" for i in range(laps + 1)}
    want |= {f"lap_{k}_{i}" for k in ("state", "input", "solver_time",
                                      "feasibility") for i in range(laps)}
    with np.load(path, allow_pickle=False) as z:
        keys = set(z.files)
        numeric = all(z[k].dtype.kind in "biuf" for k in keys)
    require(keys == want and numeric,
            f"{tag}: {os.path.basename(path)} keys {sorted(keys ^ want)} "
            f"differ from the JAX file's, or an entry is not numeric")


def host_scenarios(card, tmp):
    """Phases 28-29: the paper scenarios and the host checkpoint on the
    card; returns the K3 and K4 figures of each."""
    from ilqr_iterative_tasks_torch.control.i2lqr import I2LqrController
    from ilqr_iterative_tasks_torch.control.nlmpc import (
        HOST_LM_ITERS, NlmpcController)
    from ilqr_iterative_tasks_torch.experiments import scenarios as scn
    from ilqr_iterative_tasks_torch.experiments.runner import (
        default_obstacle, run_closed_loop)
    from ilqr_iterative_tasks_torch.ops.fused_ilqr import fused_ilqr_reference
    from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
        fused_lm_shooting_reference)
    from ilqr_iterative_tasks_torch.utils import checkpoint
    from ilqr_iterative_tasks_torch.utils.params import IlqrParams, LmpcParams

    f64 = torch.float64
    inject = scn.INJECT_LAP
    k3_out, k4_out = {}, {}

    # ---- 28. the paper scenarios on the card ----
    t28 = time.perf_counter()
    for kind in ("ilqr", "nlmpc"):
        per_step, figs = (3, k3_out) if kind == "ilqr" else (1, k4_out)
        for scenario, opt in SCENARIO_CASES:
            tag = scn.scenario_tag(kind, scenario, 8, opt)
            with no_plain_solve_on_card():
                res, fig = host_run(
                    f"28 {tag} f32, 8 laps", lambda: scn.run_scenario(
                        kind, scenario, lap_number=8, moving_option=opt,
                        save_dir=tmp, device="cuda"), per_step, card)
            scenario_file_check(tag, os.path.join(tmp, f"ego_{tag}.npz"), 8)
            want, want_done = SCENARIO_F32[tag]
            laps, done = fig["laps"][1:], fig["finished"]
            # the moving obstacle's laps (the injection on) follow the
            # arithmetic's last bits: printed beside JAX's, held step by
            # step in f64 below
            held = inject if scenario == "add_moving_obstacle" else 8
            require(fig["laps"][0] == 120 and done[:held] == want_done[:held]
                    and all(abs(a - b) <= 2 for a, b, f in zip(
                        laps[:held], want[:held], done) if f),
                    f"{tag} f32: laps {laps} finished {done}, the JAX "
                    f"package's {want} {want_done} (+-2, laps 0-{held - 1})")
            print(f"[28 {tag} f32] laps {laps} finished {done}; the JAX "
                  f"package's on XLA:CPU {want} {want_done}", flush=True)
            figs[f"{tag}_f32"] = fig
    # f64, the moving obstacle: the four runs through build_schedule and
    # run_closed_loop, a K3 / K4 call captured in the moving lap
    captures = {}
    for kind in ("ilqr", "nlmpc"):
        for opt in ("up", "left"):
            obstacle, schedule = scn.build_schedule(
                "add_moving_obstacle", 1.0, opt)
            if kind == "ilqr":
                ctrl = I2LqrController(IlqrParams.make(dtype=f64),
                                       obstacle=obstacle, dtype=f64)
                method, fixup, per_step, figs = "k3", "snap", 3, k3_out
            else:
                ctrl = NlmpcController(LmpcParams.make(),
                                       obstacle=obstacle, dtype=f64)
                method, fixup, per_step, figs = "k4", None, 1, k4_out
            captures[kind, opt] = HostCapture(ctrl, method, inject + 1), ctrl
            with no_plain_solve_on_card():
                res, fig = host_run(
                    f"28 {kind} add_moving_obstacle_{opt} f64, 8 laps",
                    lambda: run_closed_loop(ctrl, 8, goal_fixup=fixup,
                                            obstacle_schedule=schedule),
                    per_step, card)
            laps, want = fig["laps"][1:], SCENARIO_F64[kind, opt]
            cpu = SCENARIO_F64_CPU_PORT.get((kind, opt))
            print(f"[28 {kind} moving {opt} f64] laps {laps}, the JAX "
                  f"package's {want}"
                  + (f", the port's CPU route {cpu}" if cpu else ""),
                  flush=True)
            if kind == "nlmpc":
                require(laps == want and all(fig["finished"]),
                        f"NLMPC moving {opt} f64: laps {laps}, JAX {want}")
            else:
                # from the injection on the laps follow last bits (the
                # JAX run's own laps change under a 1e-12 move of the
                # state): held step by step below
                require(laps[:inject] == want[:inject]
                        and fig["finished"][:inject + 1] == [True] * (
                            inject + 1),
                        f"i2LQR moving {opt} f64: laps {laps[:inject + 1]} "
                        f"finished {fig['finished']}, JAX {want}")
            figs[f"moving_{opt}_f64"] = fig
    for (kind, opt), (cap, ctrl) in captures.items():
        kernel, a = cap.captured
        lane = 4 if opt == "up" else 5  # spd * up, spd * left
        require(bool((a[3][lane] != 0).all()),
                f"{kind} moving {opt}: the captured call sees no motion")
        name = "K3" if kind == "ilqr" else "K4"
        if kind == "ilqr":
            plain = lambda *a, c=ctrl: fused_ilqr_reference(
                c.params, c.limits, 1.0, *a, num_horizon=N,
                max_iter=c.params.max_ilqr_iter)
        else:
            plain = lambda *a, c=ctrl: fused_lm_shooting_reference(
                c.limits, 1.0, *a, num_horizon=N, max_iters=HOST_LM_ITERS)
        (k3_out if kind == "ilqr" else k4_out)[f"moving_{opt}_call"] = (
            host_capture_check(f"28 {name} in the moving lap ({opt}, f64)",
                               cap, plain))
    # the i2LQR moving lap and the two after it step by step: the card's
    # controller (K3) in lockstep with the JAX package's recorded f64 run
    # (data/jax_f64/), given its state at every step
    for opt in ("up", "left"):
        obstacle, schedule = scn.build_schedule(
            "add_moving_obstacle", 1.0, opt)
        ctrl = I2LqrController(IlqrParams.make(dtype=f64), obstacle=obstacle,
                               dtype=f64)
        path = os.path.join(HERE, "data", "jax_f64",
                            f"ego_ilqr_ss_8_add_moving_obstacle_{opt}.npz")
        with no_plain_solve_on_card():
            worst = scn.replay_lockstep(ctrl, path, inject, schedule)
        steps = SCENARIO_F64["ilqr", opt][inject:]
        print(f"[28 i2LQR moving {opt} f64 lockstep] laps 5-7 ({steps} "
              f"steps), the card's K3 controller given the JAX package's "
              f"recorded states: max |u - JAX's u| a lap "
              f"{[f'{w:.3e}' for w in worst]}", flush=True)
        require(len(worst) == 3 and max(worst) <= 1e-8,
                f"lockstep {opt}: {worst}")
        k3_out[f"moving_{opt}_lockstep_max_diff"] = worst
    print(f"[28 scenarios] {time.perf_counter() - t28:.1f} s", flush=True)

    # ---- 29. host checkpoint and resume on the card ----
    t29 = time.perf_counter()
    for kind in ("ilqr", "nlmpc"):
        if kind == "ilqr":
            make = lambda: I2LqrController(
                IlqrParams.make(dtype=f64), obstacle=default_obstacle(1.0),
                dtype=f64)
            fixup, per_step, figs = "append", 3, k3_out
        else:
            make = lambda: NlmpcController(
                LmpcParams.make(ss_option="spaceVarying"),
                obstacle=default_obstacle(1.0), dtype=f64)
            fixup, per_step, figs = None, 1, k4_out
        ctrl = make()
        path = os.path.join(tmp, f"resume_{kind}.npz")
        with no_plain_solve_on_card():
            res, first = host_run(
                f"29 {kind} f64, 2 laps", lambda: run_closed_loop(
                    ctrl, 2, goal_fixup=fixup), per_step, card)
            checkpoint.save_run(path, res, ctrl)
            resumed = checkpoint.resume_controller(make(), path)
            require(resumed.iter == 3 and all(
                np.array_equal(a, b) for a, b in zip(
                    resumed.safe_set.ss, ctrl.safe_set.ss)),
                f"{kind}: the resumed safe set differs")
            res2, again = host_run(
                f"29 {kind} f64, 1 lap resumed from the checkpoint",
                lambda: run_closed_loop(resumed, 1, goal_fixup=fixup,
                                        seed_safe_set=False), per_step, card)
        require(first["laps"][1:] == RESUME_FIRST[kind]
                and again["laps"][1:] == RESUME_LAP[kind]
                and res2.lap_finished == [True]
                and res2.lap_times[-1] <= res.lap_times[-1],
                f"{kind} resume: {first['laps']} then {again['laps']}, the "
                f"JAX package's {RESUME_FIRST[kind]} then {RESUME_LAP[kind]}")
        figs["resumed"] = again
    artifact = os.path.join(HERE, "data", "ego_nlmpc_ss_8_no_obstacle.npz")
    ctrl = checkpoint.resume_controller(
        NlmpcController(LmpcParams.make(ss_option="spaceVarying"),
                        dtype=f64), artifact)
    require(ctrl.iter == 9, f"the artifact holds {ctrl.iter} laps, not 9")
    with no_plain_solve_on_card():
        res, fig = host_run(
            "29 NLMPC f64 resumed from data/ego_nlmpc_ss_8_no_obstacle.npz",
            lambda: run_closed_loop(ctrl, 1, goal_fixup=None,
                                    seed_safe_set=False), 1, card)
    require(fig["laps"][1:] == ARTIFACT_RESUMED_LAP and ctrl.iter == 10,
            f"artifact resume: laps {fig['laps']}, the JAX package's "
            f"{ARTIFACT_RESUMED_LAP}")
    k4_out["artifact_resumed"] = fig
    print(f"[29 host resume] {time.perf_counter() - t29:.1f} s", flush=True)
    return k3_out, k4_out


def host_bench(card, tmp):
    """Phases 30-31: the latency bench, profiling and plots on the card;
    returns the K1, K3 and K4 figures."""
    from ilqr_iterative_tasks_torch.control.i2lqr import I2LqrController
    from ilqr_iterative_tasks_torch.experiments import ilqr_test
    from ilqr_iterative_tasks_torch.experiments import latency_bench as lb
    from ilqr_iterative_tasks_torch.experiments.runner import (
        default_obstacle, run_closed_loop)
    from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
        fused_ilqr_reference)
    from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
        i2lqr_step_reference)
    from ilqr_iterative_tasks_torch.utils import profiling
    from ilqr_iterative_tasks_torch.utils.params import IlqrParams

    dev = torch.device("cuda", torch.cuda.current_device())
    k1_out, k3_out, k4_out = {}, {}, {}

    # ---- 30. the latency bench on the card ----
    t30 = time.perf_counter()
    batches = [2048, 32768]
    counts = {}
    with no_plain_solve_on_card():
        report = lb.main(["--device", "cuda"], launches=counts)
    print(f"[30 latency_bench] {json.dumps(report)}; card {card}",
          flush=True)
    for key in ("per_step_latency", "per_step_latency_nlmpc"):
        require(report[key]["lap_completion_rate"] == 1.0,
                f"latency bench {key}: completion "
                f"{report[key]['lap_completion_rate']}")
    print(f"[30 latency_bench launches] {json.dumps(counts)}", flush=True)
    i2c, nlc = counts["per_step_latency"], counts["per_step_latency_nlmpc"]
    require(i2c["k3"] == 3 * i2c["solving_steps"] > 0
            and nlc["k4"] == nlc["solving_steps"] > 0
            and all(counts["soa_solves_per_s"][str(b)] == 4
                    for b in batches)
            and counts["device_fused_step_latency"] > 0
            and counts["lap_sims_per_s_by_devices"]["1"] > 0,
            f"latency bench launches {counts}")
    k3_out["latency_bench_per_step"] = dict(
        launches=i2c["k3"], **report["per_step_latency"])
    k4_out["latency_bench_per_step"] = dict(
        launches=nlc["k4"], **report["per_step_latency_nlmpc"])
    k1_out["latency_bench_scaling"] = dict(
        launches=counts["lap_sims_per_s_by_devices"]["1"],
        lap_sims_per_s=report["lap_sims_per_s_by_devices"])
    # K3's throughput lanes (main's draws, batch after batch) against the
    # plain solve, with the call's bound
    k3 = lb.build_throughput_solver(dev)
    rng = np.random.default_rng(0)
    for b in batches:
        a = lb.solver_throughput_inputs(b, rng, dev)
        out = k3(*a)
        ref, plain_ms = timed_call(lambda: fused_ilqr_reference(
            k3.params, k3.limits, 1.0, *a, num_horizon=N,
            max_iter=k3.max_iter))
        require(all(torch.equal(g, w) for g, w in zip(out, ref)),
                f"K3 throughput B={b}: not bitwise equal to the plain solve")
        st = dict(launches=counts["soa_solves_per_s"][str(b)],
                  ms=cuda_ms(lambda: k3(*a), 5), plain_ms=plain_ms,
                  max_abs_err=max_abs_err(out, ref),
                  solves_per_s=report["soa_solves_per_s"][str(b)],
                  **call_bound(k3, a, out))
        print(f"[30 K3 throughput B={b}] bitwise equal to the plain solve; "
              f"kernel {st['ms']:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{st['bound_ms']:.4f} ms by {st['bound_by']} "
              f"({st['mean_iters']:.2f} LM iterations a lane); "
              f"{st['solves_per_s']} solves/s", flush=True)
        k3_out[f"throughput_{b}"] = st
    # K1 at 1024 lanes (main's) and 1 lane against the plain step
    for b in (1024, 1):
        if b == 1024:
            lat, launches = (report["device_fused_step_latency"],
                             counts["device_fused_step_latency"])
        else:
            one = {}
            lat = lb.bench_device_step_latency(batch=b, device=dev,
                                               launches=one)
            launches = one["device_fused_step_latency"]
        k1, a = lb.device_step_inputs(b, dev)
        host_p, host_l = on_host(k1.params), on_host(k1.limits)
        out = k1(*a)
        trips = []
        ref, plain_ms = timed_call(lambda: i2lqr_step_reference(
            k1.params, k1.limits, 1.0, *a, max_iter=lb.K1_MAX_ITER,
            trips=trips))
        require(all(torch.equal(g, w) for g, w in zip(out, ref)),
                f"K1 B={b}: not bitwise equal to the plain step")
        active = a[8] < 0.5
        idx = torch.nonzero(active).flatten()[:SAMPLE_LANES].cpu()
        sample = lanes_of(a, idx, b)
        iters, mean_trips, _ = step_iters(trips, active)
        st = dict(launches=launches, ms=cuda_ms(lambda: k1(*a), 10),
                  plain_ms=plain_ms, max_abs_err=max_abs_err(out, ref),
                  mean_iters=mean_trips,
                  **{k: lat[k] for k in lat if k.startswith("p")},
                  **bound(solve_ops(
                      lambda max_iter: i2lqr_step_reference(
                          host_p, host_l, 1.0, *sample, max_iter=max_iter),
                      "max_iter", len(idx), int(active.sum()), iters),
                      step_bytes(a, out, (2, 3), k1.nsi)))
        print(f"[30 K1 B={b}] bitwise equal to the plain step; "
              f"{launches} launches; blocking p50 / p99 {lat['p50_ms']} / "
              f"{lat['p99_ms']} ms, pipelined p50 / p99 "
              f"{lat['p50_ms_per_step_pipelined']} / "
              f"{lat['p99_ms_per_step_pipelined']} ms a step; kernel "
              f"{st['ms']:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{st['bound_ms']:.5f} ms by {st['bound_by']} "
              f"({mean_trips:.2f} LM iterations a candidate solve); "
              f"{lat['note']}", flush=True)
        k1_out[f"device_step_{b}"] = st
    print(f"[30 latency bench] {time.perf_counter() - t30:.1f} s", flush=True)

    # ---- 31. profiling and plots on the card ----
    t31 = time.perf_counter()
    trace_dir = os.path.join(tmp, "trace")
    ctrl = I2LqrController(IlqrParams.make(), obstacle=default_obstacle(1.0))
    with no_plain_solve_on_card(), profiling.trace(trace_dir) as prof:
        with profiling.annotate("host_i2lqr_lap"):
            t0 = time.perf_counter()
            res = run_closed_loop(ctrl, 1, goal_fixup="append")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.key_averages()
    # the card's kernels and copies; the span's own range on the card (a
    # user annotation, as long as the lap) is not work
    dev_us = sorted(((getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0)), e.key)
                     for e in events if e.device_type == DeviceType.CUDA
                     and e.key != "host_i2lqr_lap"), reverse=True)
    k3_s = sum(t for t, k in dev_us if "fused_ilqr" in k) / 1e6
    busy_s = sum(t for t, _ in dev_us) / 1e6
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        text = f.read()
    require("host_i2lqr_lap" in {e.key for e in events}
            and "host_i2lqr_lap" in text and "fused_ilqr" in text
            and k3_s > 0 and all(res.lap_finished),
            "the trace lacks the lap's span or K3's kernel")
    prof_fig = dict(lap_steps=int(res.lap_times[0]),
                    solving_steps=len(ctrl.solve_seconds), wall_s=wall,
                    k3_device_s=k3_s, busy_s=busy_s,
                    k3_busy_share=k3_s / wall, busy_share=busy_s / wall,
                    trace_mb=len(text) / 1e6,
                    top_device_s={k[:48]: t / 1e6 for t, k in dev_us[:4]})
    print(f"[31 profiled i2LQR lap f32] {json.dumps(prof_fig)}: the card "
          f"runs K3 {100 * k3_s / wall:.1f} % and any kernel or copy "
          f"{100 * busy_s / wall:.1f} % of the traced lap's wall; card "
          f"{card}", flush=True)
    k3_out["profiled_lap"] = prof_fig
    mem = profiling.device_memory_stats()
    require(f"cuda:{dev.index}" in mem
            and mem[f"cuda:{dev.index}"]["allocated_bytes.all.peak"] > 0,
            f"device_memory_stats: {sorted(mem)}")
    print(f"[31 device_memory_stats] {sorted(mem)}: peak allocated "
          f"{mem[f'cuda:{dev.index}']['allocated_bytes.all.peak'] / 2**20:.1f}"
          f" MiB", flush=True)
    try:
        import matplotlib
    except ImportError:
        print("[31 plots] matplotlib is not installed on this machine: the "
              "demo CLI's --plotting is not run here", flush=True)
    else:
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        before = set(plt.get_fignums())
        with no_plain_solve_on_card():
            res = ilqr_test.main(["--lap-number", "1", "--device", "cuda",
                                  "--plotting"])
        new = sorted(set(plt.get_fignums()) - before)
        sizes = []
        for i, n in enumerate(new):
            path = os.path.join(tmp, f"fig{i}.png")
            plt.figure(n).savefig(path)
            sizes.append(os.path.getsize(path))
        plt.close("all")
        require(len(new) == 2 and min(sizes) > 0 and all(res.lap_finished),
                f"--plotting: {len(new)} figures of {sizes} bytes")
        print(f"[31 plots] ilqr_test --plotting --device cuda rendered "
              f"{len(new)} figures under Agg ({sizes} bytes as png)",
              flush=True)
    print(f"[31 profiling and plots] {time.perf_counter() - t31:.1f} s",
          flush=True)
    return k1_out, k3_out, k4_out


def scale_out(card, scaling):
    """Phase 32: the scale-out paths on the card (parallel/): the i2LQR and
    NLMPC headlines through the ``_sharded`` wrappers on 2 ranks that share
    the card (gloo), hashing as their unsharded runs in this process on the
    same injected noise; a world of one NCCL rank at a small batch; the
    meshed NLMPC controller through K4 on the 2 ranks. ``scaling``: phase
    30's device-count rates. Returns the figures for the kernels line."""
    from ilqr_iterative_tasks_torch.experiments import scale_out as so
    from ilqr_iterative_tasks_torch.parallel.launch import spawn

    t32 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    target = f"{so.__name__}:scale_out_rank"
    want, small = {}, {}
    for which in ("i2lqr", "nlmpc"):
        want[which] = so.headline(which, BATCH, dev)
        small[which] = so.headline(which, so.SMALL_BATCH, dev)["hash"]
        print(f"[32 {which} unsharded] B={BATCH} {json.dumps(want[which])}",
              flush=True)
    for tail in so.TAILS:
        want[tail] = so.headline("i2lqr", so.TAIL_BATCH, dev,
                                 num_laps=so.TAIL_LAPS, tail_shrink=tail)
        print(f"[32 i2lqr tail_shrink={tail} unsharded] B={so.TAIL_BATCH}, "
              f"{so.TAIL_LAPS} laps {json.dumps(want[tail])}", flush=True)
        require(any(want[tail]["compacted"]),
                f"32 tail_shrink={tail}: no lap compacted")
    # two ranks on the one card: NCCL refuses that, gloo stages the
    # gathers through the host; their times are contention, not scaling
    ranks = spawn(target, 2, BATCH, tuple(so.MESHED_LAPS), so.TAILS,
                  backend="gloo", timeout=600)
    out = {}
    for which, kernel in (("i2lqr", "K1"), ("nlmpc", "K2")):
        for r in ranks:
            g = r[which]
            print(f"[32 {which} sharded rank {r['rank']}/2 {r['backend']}] "
                  f"B={BATCH} ({BATCH // 2} lanes a rank) wall "
                  f"{g['wall_s']:.3f} s, simulator {g['run_s']:.3f} s, "
                  f"gather {g['gather_ms']:.1f} ms, {kernel} launches "
                  f"{g['launches']}, completion {g['completion']:.4f}, lap "
                  f"records {g['hash']} (unsharded {want[which]['hash']}); "
                  f"card {card}", flush=True)
            require(g["hash"] == want[which]["hash"],
                    f"sharded {which} on rank {r['rank']}: lap records "
                    f"{g['hash']} != unsharded {want[which]['hash']}")
            require(g["launches"] > 0,
                    f"{kernel} was not launched on rank {r['rank']}")
        out[which] = dict(
            ranks=2, backend="gloo", batch=BATCH,
            launches_per_rank=[r[which]["launches"] for r in ranks],
            wall_s=max(r[which]["wall_s"] for r in ranks),
            gather_ms=max(r[which]["gather_ms"] for r in ranks),
            unsharded_wall_s=want[which]["wall_s"],
            unsharded_launches=want[which]["launches"],
            hash=want[which]["hash"])
    # tail_shrink alone: each rank's lanes in the whole run's order (the
    # global compaction), so every rank's gathered run is the unsharded one
    tails = {}
    for tail in so.TAILS:
        for r in ranks:
            g = r[f"i2lqr_tail{tail}"]
            print(f"[32 i2lqr tail_shrink={tail} sharded rank {r['rank']}/2"
                  f"] B={so.TAIL_BATCH} ({so.TAIL_BATCH // 2} lanes a rank), "
                  f"{so.TAIL_LAPS} laps, compacted {g['compacted']}, wall "
                  f"{g['wall_s']:.3f} s, simulator {g['run_s']:.3f} s, K1 "
                  f"launches {g['launches']}, lap records {g['hash']} "
                  f"(unsharded {want[tail]['hash']}); card {card}",
                  flush=True)
            require(g["hash"] == want[tail]["hash"],
                    f"sharded tail_shrink={tail} on rank {r['rank']}: lap "
                    f"records {g['hash']} != unsharded {want[tail]['hash']}")
            require(g["launches"] > 0,
                    f"K1 was not launched on rank {r['rank']}")
        tails[tail] = dict(
            batch=so.TAIL_BATCH, laps=so.TAIL_LAPS,
            launches_per_rank=[r[f"i2lqr_tail{tail}"]["launches"]
                               for r in ranks],
            wall_s=max(r[f"i2lqr_tail{tail}"]["wall_s"] for r in ranks),
            unsharded_wall_s=want[tail]["wall_s"], hash=want[tail]["hash"])
    out["i2lqr"]["tail_shrink"] = tails
    meshed = {}
    for mode, laps in so.MESHED_LAPS.items():
        for r in ranks:
            g = r[f"controller_{mode}"]
            print(f"[32 meshed NLMPC controller {mode} rank {r['rank']}/2] "
                  f"laps {g['laps']} (JAX pinned {laps}), K4 launches "
                  f"{g['k4_launches']} over {g['solving_steps']} solving "
                  f"steps, lanes a launch {g['lanes']} ({g['lanes_total']} "
                  f"in all), {g['step_ms_median']:.2f} ms a solving step "
                  f"(median), wall {g['wall_s']:.2f} s; card {card}",
                  flush=True)
            require(g["laps"] == laps and all(g["finished"]),
                    f"meshed controller {mode} rank {r['rank']}: laps "
                    f"{g['laps']} != {laps}")
            require(g["k4_launches"] == g["solving_steps"] > 0,
                    f"meshed controller {mode}: K4 launches "
                    f"{g['k4_launches']} != solving steps "
                    f"{g['solving_steps']}")
        meshed[mode] = dict(
            ranks=2, backend="gloo", laps=laps,
            launches_per_rank=[r[f"controller_{mode}"]["k4_launches"]
                               for r in ranks],
            lanes_per_rank=[r[f"controller_{mode}"]["lanes_total"]
                            for r in ranks],
            step_ms_median=max(r[f"controller_{mode}"]["step_ms_median"]
                               for r in ranks),
            gather_probe_ms=ranks[0]["gather_probe_ms"])
    for r in ranks:
        print(f"[32 gather probe rank {r['rank']}/2] ms an all_gather of "
              f"(8, 6) f64 over gloo: "
              f"{json.dumps(r['gather_probe_ms'])}", flush=True)
    nccl = spawn(target, 1, so.SMALL_BATCH, backend="nccl", timeout=600)[0]
    for which in ("i2lqr", "nlmpc"):
        g = nccl[which]
        print(f"[32 {which} NCCL world 1] B={so.SMALL_BATCH} lap records "
              f"{g['hash']} (unsharded {small[which]}), launches "
              f"{g['launches']}, gather {g['gather_ms']:.1f} ms", flush=True)
        require(nccl["backend"] == "nccl" and g["hash"] == small[which],
                f"NCCL world 1 {which}: lap records {g['hash']} != "
                f"{small[which]}")
        require(g["launches"] > 0, f"NCCL world 1 {which}: no launch")
        out[which]["nccl_world_1"] = dict(batch=so.SMALL_BATCH,
                                          launches=g["launches"],
                                          gather_ms=g["gather_ms"])
    print(f"[32 gather probe NCCL world 1] ms an all_gather of (8, 6) f64: "
          f"{json.dumps(nccl['gather_probe_ms'])}", flush=True)
    print(f"[32 bench_device_scaling] {json.dumps(scaling)} lap-sims/s "
          f"(phase 30; counts above the visible cards skipped); card {card}",
          flush=True)
    print(f"[32 scale-out] {time.perf_counter() - t32:.1f} s", flush=True)
    return out["i2lqr"], out["nlmpc"], meshed


# ---- phases 33-37: the vmap tiers, the candidate-sharded sweep and its
# dry run, dedup_passes on the per-candidate path, batch_probe ----
# the JAX tiers' zero-noise laps on XLA:CPU (f64, f32) with x64 on, as
# tests/test_torch_batched_vmap.py's slow tests run and hold them: f64
# exactly, f32 within VMAP_F32_SPREAD. f32 laps follow each platform's
# and each compilation's arithmetic (docs/PARITY.md: the LM accept /
# reject cascade moves a lap by 1-2 steps from lap 2 on): with x64 off,
# which changes no f32 operation of the tiers, XLA:CPU gives [55, 28, 25]
# and [34, 23, 22]. The port's own f32 laps on the CPU are [55, 28, 22]
# and [32, 23, 23] (the tests pin them), on the H100 [55, 28, 22] and
# [36, 27, 22] (PERF.md section 6). Each tier's f32 band has a witness:
# the i2LQR tier's laps equal the SoA per-candidate path's on the card;
# the NLMPC tier's card run replays every solving step of the CPU run
# (JAX's laps) through K4 in lockstep (``nlmpc_f32_lockstep``)
VMAP_LAPS = {"i2lqr": ([55, 28, 23], [55, 28, 24]),
             "nlmpc": ([33, 24, 24], [32, 23, 23])}
VMAP_F32_SPREAD = {"i2lqr": 2, "nlmpc": 4}
VMAP_MAX_LAPS = 16  # the tiers' full width: max_laps 16, B = BATCH
VMAP_ZERO_B = 1024
VMAP_NL_CAP = 60  # the NLMPC tier's max_lm_iters (JAX's default)
VMAP_SAMPLE = 8  # lanes rerun as a batch of their own
VMAP_CAPTURE = (2, 14)  # (learning lap, solving step) of the capture
# the profiled window (a short steady window): these
# solving steps of learning lap 2; a whole run's ~10^5 small launches take
# the profiler minutes to process, the window's seconds
VMAP_WINDOW = (2, 5, 25)
# lap completion bounds of the tiers' full-width runs (B = 49 152, seed 0,
# 3 laps): 3 standard errors under the card's seed-0 figures, i2LQR 0.9970
# (standard error 0.00014) and NLMPC 1.0000 (every lane-lap; the bound
# that of one failed lane-lap, 1 - 4 / 147 456), PERF.md section 6
VMAP_COMPLETION_MIN = {"i2lqr": 0.9966, "nlmpc": 0.99997}
SWEEP_C = 16384  # the candidate-sharded sweep's regime (JAX sharded.py:9-15)
PROBE_BATCHES = (16384, 49152)


class TierTap:
    """K3 or K4 as a vmap tier launches it (every attribute passed
    through): each launch's live lanes (skip < 0.5) kept on the card and
    read after the run and a pair of CUDA events around it, the tier's
    solving steps a lap counted through its ``_solve_step`` (``tapped``),
    the inputs of the first launch of the solving step ``want`` =
    (learning lap, step), and, given ``window`` = (lap, first, end), the
    card's activity over those solving steps under ``torch.profiler``
    (``profiled``: the kernel's, every kernel's and copy's and the host's
    seconds of the window, ``key`` the kernel's name)."""

    def __init__(self, kernel, module, want=VMAP_CAPTURE, window=None,
                 key=""):
        self.kernel, self.module, self.want = kernel, module, want
        self.live, self.steps, self.arm, self.captured = [], {}, False, None
        self.events, self.window, self.key = [], window, key
        self.prof, self.profiled = None, None

    def __getattr__(self, name):
        return getattr(self.kernel, name)

    def __call__(self, *args):
        self.live.append((args[4] < 0.5).sum())
        if self.arm:
            self.captured, self.arm = [a.clone() for a in args], False
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self.kernel(*args)
        end.record()
        self.events.append((start, end))
        return out

    def profile_at(self, lap, i):
        """Start or stop the window's profile at solving step i of lap."""
        w_lap, first, end = self.window
        if (lap, i) not in ((w_lap, first), (w_lap, end)):
            return
        torch.cuda.synchronize()
        if i == first:
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
            return
        host = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        dev = [(e.key, getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)))
               for e in self.prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        self.profiled = dict(
            steps=end - first, kernel_s=sum(
                t for k, t in dev if self.key in k) / 1e6,
            busy_s=sum(t for _, t in dev) / 1e6, host_s=host)
        self.prof = None

    def seconds(self) -> float:
        """The summed CUDA-event spans of the launches."""
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events) / 1e3

    def tapped(self):
        tap, step = self, self.module._solve_step

        class Ctx:
            def __enter__(self):
                def counted(params, kernel, ss, lap, *a, **kw):
                    i = tap.steps.get(lap, 0)
                    tap.steps[lap] = i + 1
                    tap.arm = (lap, i) == tap.want
                    if tap.window is not None:
                        tap.profile_at(lap, i)
                    return step(params, kernel, ss, lap, *a, **kw)
                tap.module._solve_step = counted

            def __exit__(self, *exc):
                tap.module._solve_step = step
        return Ctx()

    def shares(self, lanes) -> dict:
        s = torch.stack(self.live).double().cpu() / lanes
        return dict(min=float(s.min()), median=float(s.median()),
                    mean=float(s.mean()), launches=len(self.live))


def tier_hash(res) -> str:
    """lap_records_hash of a vmap tier's result (the NLMPC one has no
    final states)."""
    return lap_records_hash(SimpleNamespace(
        lap_steps=res.lap_steps, lap_done=res.lap_done,
        final_x=getattr(res, "final_x", res.lap_steps[:0]),
        safe_set=tuple(res.safe_set)))


def k3_row(k3, a, params, limits, host_params, host_limits, cap) -> dict:
    """K3 on the lanes ``a`` against its plain solve: bitwise, the ms of
    both, the live lanes' LM iterations and the bound."""
    from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
        fused_ilqr_reference)
    skip = a[4] if len(a) > 4 else None
    out = k3(*a)
    trips = []
    ref, plain_ms = timed_call(lambda: fused_ilqr_reference(
        params, limits, 1.0, *a, num_horizon=N, max_iter=cap, trips=trips))
    require(all(torch.equal(g, w) for g, w in zip(out, ref)),
            "K3: not bitwise equal to the plain solve")
    b = a[1].shape[-1]
    live = (torch.ones(b, dtype=torch.bool, device=a[1].device)
            if skip is None else skip < 0.5)
    trips = trips[0]
    idx = torch.nonzero(live).flatten()[:SAMPLE_LANES]
    sample = lanes_of(a, idx.cpu(), b)
    return dict(
        ms=cuda_ms(lambda: k3(*a), 5), plain_ms=plain_ms,
        max_abs_err=float((out[0] - ref[0]).abs().max()), lanes=b,
        live_lanes=int(live.sum()),
        mean_iters=float(trips[live].double().mean()),
        **bound(solve_ops(lambda max_iter: fused_ilqr_reference(
            host_params, host_limits, 1.0, *sample, num_horizon=N,
            max_iter=max_iter), "max_iter", len(idx), int(live.sum()),
            float(trips[live].double().sum())), nbytes(a) + nbytes(out)))


def k4_row(k4, a, limits, host_limits, cap) -> dict:
    """K4 on the lanes ``a`` against its plain solve, as ``k3_row``."""
    from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
        fused_lm_shooting_reference)
    out = k4(*a)
    trips = []
    ref, plain_ms = timed_call(lambda: fused_lm_shooting_reference(
        limits, 1.0, *a, num_horizon=N, max_iters=cap, trips=trips))
    require(all(torch.equal(g, w) for g, w in zip(out, ref)),
            "K4: not bitwise equal to the plain solve")
    live = a[4] < 0.5
    trips = trips[0]
    idx = torch.nonzero(live).flatten()[:SAMPLE_LANES]
    b = a[1].shape[-1]
    sample = lanes_of(a, idx.cpu(), b)
    return dict(
        ms=cuda_ms(lambda: k4(*a), 5), plain_ms=plain_ms,
        max_abs_err=float((out[0] - ref[0]).abs().max()), lanes=b,
        live_lanes=int(live.sum()),
        mean_iters=float(trips[live].double().mean()),
        **bound(solve_ops(lambda max_iters: fused_lm_shooting_reference(
            host_limits, 1.0, *sample, num_horizon=N, max_iters=max_iters),
            "max_iters", len(idx), int(live.sum()),
            float(trips[live].double().sum()) / 2), nbytes(a) + nbytes(out)))


def nlmpc_f32_cpu_run():
    """The NLMPC tier's zero-noise f32 run of one scenario on the host's
    CPU (K4's plain version: the run tests/test_torch_batched_vmap.py
    holds to JAX's f32 tier on XLA:CPU), each solving step's inputs and
    outputs recorded: (its laps, the steps). ``main`` runs it beside the
    build; phase 34 replays it on the card (``nlmpc_f32_lockstep``)."""
    from ilqr_iterative_tasks_torch.control import batched, batched_nlmpc
    from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
    from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
        build_fused_lm_shooting)
    from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
    from ilqr_iterative_tasks_torch.utils.params import (
        LmpcParams, SystemLimits)

    f32, cpu = torch.float32, torch.device("cpu")
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((MAX_STEPS, 4)), np.zeros((MAX_STEPS, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    lim = SystemLimits.make(dtype=f32, device=cpu)
    scen = batched.make_batch_scenarios(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0, dtype=f32,
                                            device=cpu),
        1, key=0, noise_on=False, dtype=f32, device=cpu)
    calls, step = [], batched_nlmpc._solve_step

    def recorded(params, solver, ss, lap_count, *rest):
        out = step(params, solver, ss, lap_count, *rest)
        calls.append((ss.map(torch.clone), lap_count, rest, out))
        return out

    batched_nlmpc._solve_step = recorded
    try:
        res = batched_nlmpc.simulate_nlmpc_batch(
            LmpcParams.make(dtype=f32, device=cpu), lim, scen, seed_xs,
            seed_us, 121, 1.0, num_laps=LAPS, max_steps=MAX_STEPS,
            max_laps=VMAP_MAX_LAPS, max_lm_iters=VMAP_NL_CAP,
            candidate_solver=build_fused_lm_shooting(
                lim, 1.0, num_horizon=N, max_iters=VMAP_NL_CAP))
    finally:
        batched_nlmpc._solve_step = step
    return res.lap_steps[0].tolist(), calls


def nlmpc_f32_lockstep(dev, k4, calls):
    """Phase 34's witness of the NLMPC tier's f32 laps: each solving step
    of ``nlmpc_f32_cpu_run`` replayed on ``dev`` through ``k4`` from that
    run's state (its safe set, state, terminal guess and warm start), the
    plain solve refused there. A step's decision is its feasibility and
    its chosen point (the new terminal guess, bit for bit). Returns the
    steps (lap, step) whose decision differs, and (lap, step, |u - the
    CPU's u|) of each of the others."""
    from ilqr_iterative_tasks_torch.control import batched_nlmpc
    from ilqr_iterative_tasks_torch.utils.params import LmpcParams

    to = lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t
    p = LmpcParams.make(dtype=torch.float32, device=dev)
    flips, gaps, at = [], [], {}
    with no_plain_solve_on_card():
        for ss, lap_count, rest, want in calls:
            n = at[lap_count] = at.get(lap_count, -1) + 1
            got = [t.cpu() for t in batched_nlmpc._solve_step(
                p, k4, ss.map(to), lap_count, *map(to, rest))]
            if torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]):
                gaps.append((lap_count, n,
                             float((got[0] - want[0]).abs().max())))
            else:
                flips.append((lap_count, n))
    return flips, gaps


def vmap_tier(card, which, cpu_run=None):
    """Phase 33 (``which`` "i2lqr": the vmap i2LQR tier through K3) or 34
    ("nlmpc": the vmap NLMPC tier through K4; ``cpu_run`` a future of
    ``nlmpc_f32_cpu_run``, else it runs here). Returns the kernels line's
    row of the tier's kernel."""
    from ilqr_iterative_tasks_torch.control import (
        batched, batched_nlmpc, batched_soa)
    from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
    from ilqr_iterative_tasks_torch.ops.fused_ilqr import build_fused_ilqr
    from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
        build_fused_lm_shooting)
    from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
    from ilqr_iterative_tasks_torch.utils.params import (
        IlqrParams, LmpcParams, SystemLimits)

    t_phase = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    i2 = which == "i2lqr"
    tag, kname = ("33", "K3") if i2 else ("34", "K4")
    module = batched if i2 else batched_nlmpc
    xcl, ucl = seed_trajectory(1.0)
    seed_xs, seed_us = np.zeros((MAX_STEPS, 4)), np.zeros((MAX_STEPS, 2))
    seed_xs[:121], seed_us[:120] = xcl, ucl
    passes = 3 if i2 else 1  # kernel launches a solving step
    if not i2:  # before any tap of the module's _solve_step
        cpu_laps, cpu_calls = (nlmpc_f32_cpu_run() if cpu_run is None
                               else cpu_run.result())

    def setup(dtype):
        """(params, limits, the kernel, the simulator) in ``dtype``; the
        NLMPC tier's limits in its dtype, as JAX's tier takes them."""
        lim = SystemLimits.make(dtype=dtype, device=dev)
        if i2:
            p = IlqrParams.make(dtype=dtype, device=dev)
            return p, lim, build_fused_ilqr(
                p, lim, 1.0, num_horizon=N, max_iter=p.max_ilqr_iter), \
                batched.simulate_learning_batch
        return (LmpcParams.make(dtype=dtype, device=dev), lim,
                build_fused_lm_shooting(lim, 1.0, num_horizon=N,
                                        max_iters=VMAP_NL_CAP),
                batched_nlmpc.simulate_nlmpc_batch)

    def scenarios(b, dtype, noise):
        return batched.make_batch_scenarios(
            np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0,
                                                dtype=dtype, device=dev),
            b, key=0, noise_on=noise, dtype=dtype, device=dev)

    def run(p, lim, sim, scen, solver):
        kw = {} if i2 else dict(max_lm_iters=VMAP_NL_CAP)
        with no_plain_solve_on_card():
            res = sim(p, lim, scen, seed_xs, seed_us, 121, 1.0,
                      num_laps=LAPS, max_steps=MAX_STEPS,
                      max_laps=VMAP_MAX_LAPS, candidate_solver=solver, **kw)
        torch.cuda.synchronize(dev)
        return res

    row, marks = {}, {}
    mark = lambda name: marks.__setitem__(
        name, round(time.perf_counter() - t_phase - sum(marks.values()), 2))
    for dtype, want in zip((torch.float64, torch.float32), VMAP_LAPS[which]):
        p, lim, k, sim = setup(dtype)
        tap = TierTap(k, module)
        t0 = time.perf_counter()
        with tap.tapped():
            res = run(p, lim, sim, scenarios(VMAP_ZERO_B, dtype, False), tap)
        secs = time.perf_counter() - t0
        laps = res.lap_steps[0].tolist()
        steps = sum(tap.steps.values())
        print(f"[{tag} {which} vmap tier zero noise {str(dtype)[6:]}] "
              f"{VMAP_ZERO_B} identical lanes: laps {laps} (JAX's {want}), "
              f"{kname} launches {k.launches} over {steps} solving steps, "
              f"{secs:.2f} s; card {card}", flush=True)
        require(bool((res.lap_steps == res.lap_steps[0]).all())
                and bool(res.lap_done.all()),
                f"{tag} zero noise {dtype}: lanes differ or a lap failed")
        require(k.launches == passes * steps > 0,
                f"{tag}: {kname} launches {k.launches} != {passes} x "
                f"{steps} solving steps")
        if dtype == torch.float64:
            require(laps == want, f"{tag} f64 laps {laps} != {want}")
        else:
            require(all(abs(g - w) <= VMAP_F32_SPREAD[which]
                        for g, w in zip(laps, want)),
                    f"{tag} f32 laps {laps} not within "
                    f"{VMAP_F32_SPREAD[which]} of {want}")
        row[f"zero_noise_{str(dtype)[6:]}"] = dict(
            laps=laps, wall_s=secs, launches=k.launches)
        if i2 and dtype == torch.float32:
            # the same solves, kNN and selection as the SoA simulator's
            # per-candidate path at the same cap: the same laps
            soa = batched_soa.SoaScenarios.broadcast(
                np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0,
                                                    device=dev),
                VMAP_ZERO_B, device=dev)
            with no_plain_solve_on_card():
                ref = batched_soa.simulate_learning_runs_soa(
                    p, lim, soa, seed_xs, None, 121, 1.0,
                    candidate_solver=k, num_laps=LAPS, max_steps=MAX_STEPS,
                    max_laps=MAX_LAPS, solver_max_iter=p.max_ilqr_iter)
            soa_laps = ref.lap_steps[:, 0].tolist()
            same_states = bool(torch.equal(
                ref.safe_set[0][1:LAPS + 1, :, :, 0],
                res.safe_set.states[0, 1:LAPS + 1]))
            print(f"[{tag} f32 against the SoA per-candidate path] its laps "
                  f"{soa_laps}, stored states bit for bit {same_states}",
                  flush=True)
            require(soa_laps == laps, f"{tag} f32 laps {laps} != the SoA "
                    f"per-candidate path's {soa_laps}")
            row["zero_noise_float32"]["soa_candidate_path"] = dict(
                laps=soa_laps, states_bitwise=same_states)
        if not i2 and dtype == torch.float32:
            t_lock = time.perf_counter()
            flips, gaps = nlmpc_f32_lockstep(dev, k, cpu_calls)
            worst = max(gaps, key=lambda g: g[2])
            over = [g for g in gaps if g[2] > 1e-3]
            print(f"[{tag} f32 in lockstep with the CPU run] the CPU run's "
                  f"laps {cpu_laps} (JAX's {want}); the card's K4 on its "
                  f"{len(flips) + len(gaps)} solving steps: decisions "
                  f"differ at (lap, step) {flips}; |u - the CPU's u| "
                  f"<= 1e-5 on {sum(g[2] <= 1e-5 for g in gaps)}, <= 1e-3 "
                  f"on {len(gaps) - len(over)}, largest {worst[2]:.3e} at "
                  f"{worst[:2]}, first over 1e-3 "
                  f"{over[0] if over else None}, the steps over 1e-3 "
                  f"{[g[:2] for g in over]}; "
                  f"{time.perf_counter() - t_lock:.1f} s", flush=True)
            require(not flips, f"{tag} f32: the card's decisions differ "
                    f"from the CPU run's at {flips}")
            row["zero_noise_float32"]["cpu_lockstep"] = dict(
                cpu_laps=cpu_laps, flips=flips, u_gaps=gaps)
        del res
    mark("zero_noise")

    # the full width, f32, plant noise on
    p, lim, k, sim = setup(torch.float32)
    scen = scenarios(BATCH, torch.float32, True)
    lanes = BATCH * p.num_ss_iter * p.num_ss_points
    tap = TierTap(k, module, window=VMAP_WINDOW, key="fused_ilqr_kernel"
                  if i2 else "fused_lm_shooting_kernel")
    k.launches = 0
    with tap.tapped():
        res = run(p, lim, sim, scen, tap)
    event_s, prof = tap.seconds(), tap.profiled
    require(prof is not None and prof["kernel_s"] > 0,
            f"{tag}: the profiled window saw no {kname}")
    mark("warm_run")
    launches, steps = k.launches, sum(tap.steps.values())
    require(launches == passes * steps > 0,
            f"{tag}: {kname} launches {launches} != {passes} x {steps} "
            f"solving steps")
    share = tap.shares(lanes)
    done = float(res.lap_done.float().mean())
    se = (done * (1 - done) / res.lap_done.numel()) ** 0.5
    warm_hash = tier_hash(res)
    require(bool(torch.isfinite(res.safe_set.states).all()),
            f"{tag}: non-finite safe set")
    k.launches = 0
    t0 = time.perf_counter()
    res2 = run(p, lim, sim, scen, k)
    secs = time.perf_counter() - t0
    timed_hash = tier_hash(res2)
    del res2
    mark("timed_run")
    rate = BATCH * LAPS / secs
    print(f"[{tag} {which} vmap tier] B={BATCH} f32 noise on, max_laps "
          f"{VMAP_MAX_LAPS}: {rate:.1f} lap-sims/s ({secs:.3f} s), "
          f"completion {done:.4f} (standard error {se:.5f}, required >= "
          f"{VMAP_COMPLETION_MIN[which]}), mean lap steps "
          f"{[round(float(v), 2) for v in res.lap_steps.float().mean(0)]}, "
          f"lap records {warm_hash} (timed run {timed_hash}); {kname} "
          f"launches {launches} over {steps} solving steps, {lanes} lanes "
          f"a launch, live share {json.dumps(share)}; warm run: {kname} "
          f"{event_s:.4f} s by CUDA events; profiled window (lap "
          f"{VMAP_WINDOW[0]}, solving steps {VMAP_WINDOW[1]}-"
          f"{VMAP_WINDOW[2] - 1}): {kname} {prof['kernel_s']:.4f} s of the "
          f"card, busy {prof['busy_s']:.4f} s of {prof['host_s']:.4f} s; "
          f"card {card}", flush=True)
    require(timed_hash == warm_hash, f"{tag}: the timed run's records differ")
    require(done >= VMAP_COMPLETION_MIN[which],
            f"{tag}: completion {done} < {VMAP_COMPLETION_MIN[which]}")
    # 8 sampled lanes as a batch of their own: their records bit for bit
    rows = torch.randperm(BATCH, generator=torch.Generator().manual_seed(0))[
        :VMAP_SAMPLE].sort().values.to(dev)
    few = run(p, lim, sim, scen.map(lambda t: t[rows].contiguous()), k)
    full = [res.lap_steps, res.lap_done, *res.safe_set] + (
        [res.final_x] if i2 else [])
    part = [few.lap_steps, few.lap_done, *few.safe_set] + (
        [few.final_x] if i2 else [])
    require(all(torch.equal(a[rows], b) for a, b in zip(full, part)),
            f"{tag}: {VMAP_SAMPLE} lanes rerun alone differ from their "
            f"full-width records")
    print(f"[{tag} {VMAP_SAMPLE} lanes alone] lanes {rows.tolist()}: lap "
          f"steps {few.lap_steps.tolist()}, bit for bit their full-width "
          f"records", flush=True)
    del res, few
    mark("sample")
    a = tap.captured
    require(a is not None, f"{tag}: no capture at {VMAP_CAPTURE}")
    host_lim = SystemLimits.make(device="cpu")
    if i2:
        kr = k3_row(k, a, p, lim, IlqrParams.make(device="cpu"), host_lim,
                    p.max_ilqr_iter)
    else:
        kr = k4_row(k, a, lim, host_lim, VMAP_NL_CAP)
    mark("capture_check")
    print(f"[{tag} {kname} at the lap-2 capture] {kr['ms']:.3f} ms a call "
          f"of {kr['lanes']} lanes ({kr['live_lanes']} live, "
          f"{kr['mean_iters']:.2f} LM iterations a live lane), plain "
          f"{kr['plain_ms']:.3f} ms, bound {kr['bound_ms']:.4f} ms by "
          f"{kr['bound_by']}, bitwise; card {card}", flush=True)
    row.update(kr, launches=launches, solving_steps=steps,
               lap_sims_per_s=rate, wall_s=secs, completion=done,
               completion_se=se, hash=warm_hash, live_share=share,
               device_s=event_s, profiled_window=prof,
               phase_s=time.perf_counter() - t_phase, phase_parts_s=marks)
    print(f"[{tag} phase] {row['phase_s']:.1f} s ({json.dumps(marks)})",
          flush=True)
    return row


def dryrun_rank(n, candidates):
    """The dry run on one rank of phase 35 (parallel/launch.py's target),
    every plain candidate solve on the card refused."""
    from ilqr_iterative_tasks_torch.parallel import sharded
    with no_plain_solve_on_card():
        return sharded.dryrun_rank(n, candidates=candidates)


def sweep_phase(card):
    """Phase 35: the dry run on one NCCL rank and on 2 gloo ranks that
    share the card, the sweep at C = SWEEP_C; returns the kernels line's
    row of K3 on the sweep."""
    from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
    from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
        build_fused_ilqr, obstacle_to_lanes)
    from ilqr_iterative_tasks_torch.parallel import sharded
    from ilqr_iterative_tasks_torch.parallel.launch import Ranks
    from ilqr_iterative_tasks_torch.utils.params import (
        IlqrParams, SystemLimits)

    t35 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    target = f"{os.path.join(HERE, 'chip_smoke.py')}:dryrun_rank"
    # both worlds at once, each its own group on its own port
    started = {"nccl 1": Ranks(target, 1, 1, SWEEP_C, backend="nccl",
                               timeout=600),
               "gloo 2": Ranks(target, 2, 2, SWEEP_C, backend="gloo",
                               timeout=600)}
    try:
        runs = {name: r.wait() for name, r in started.items()}
    finally:
        for r in started.values():
            r.close()
    params = IlqrParams.make(num_ss_points=sharded.DRY_K, device=dev)
    limits = SystemLimits.make(device=dev)
    obstacle = Obstacle.make(5.0, -2.0, 1.0, 1.0, device=dev)
    cands, qs = (t.to(dev) for t in runs["nccl 1"][0]["sweep_inputs"])
    k3 = build_fused_ilqr(params, limits, 1.0, num_horizon=N,
                          max_iter=params.max_ilqr_iter)
    x0, u0 = torch.zeros(4, device=dev), torch.zeros((N, 2), device=dev)
    local = lambda: sharded.sharded_candidate_sweep(
        params, limits, obstacle, x0, cands, qs, u0, 1.0, 1.0,
        num_horizon=N, mesh=sharded.local_mesh("candidate", dev),
        candidate_solver=k3)
    with no_plain_solve_on_card():
        here = [t.cpu() for t in local()]
        sweep_ms = cuda_ms(local, 5)
    out = {}
    for name, ranks in runs.items():
        for r in ranks:
            require(all(torch.equal(g, w) for g, w in zip(r["sweep"], here)),
                    f"35 {name} rank {r['rank']}: its sweep is not this "
                    f"process's")
            require(r["launches"]["sweep_sharded"] == 1
                    and r["launches"]["vmap_sharded"] > 0
                    and r["launches"]["k1_shardmap"] > 0,
                    f"35 {name} rank {r['rank']}: launches {r['launches']}")
            print(f"[35 dryrun {name} rank {r['rank']}] {r['backend']}: "
                  f"vmap lap steps "
                  f"{r['vmap_lap_steps'].flatten().tolist()}, sweep index "
                  f"{int(r['sweep'][3])} of {SWEEP_C}, launches "
                  f"{json.dumps(r['launches'])}, seconds "
                  f"{json.dumps({k: round(v, 4) for k, v in r['seconds'].items()})}"
                  f"; card {card}", flush=True)
        out[name] = dict(seconds=[r["seconds"] for r in ranks],
                         launches=[r["launches"] for r in ranks])
    # K3 on the sweep's lanes (the local sweep's one launch)
    a = (x0[:, None].expand(4, SWEEP_C).contiguous(), cands.T.contiguous(),
         u0[..., None].expand(N, 2, SWEEP_C).contiguous(),
         obstacle_to_lanes(obstacle, SWEEP_C).contiguous())
    kr = k3_row(k3, a, params, limits, IlqrParams.make(
        num_ss_points=sharded.DRY_K, device="cpu"),
        SystemLimits.make(device="cpu"), params.max_ilqr_iter)
    print(f"[35 sweep] C={SWEEP_C}: index {int(here[3])}, cost "
          f"{float(here[2])}, the sweep on one rank {sweep_ms:.3f} ms; K3 "
          f"on its lanes {kr['ms']:.3f} ms, plain {kr['plain_ms']:.3f} ms, "
          f"bound {kr['bound_ms']:.4f} ms by {kr['bound_by']} "
          f"({kr['mean_iters']:.2f} LM iterations a lane), bitwise; "
          f"{time.perf_counter() - t35:.1f} s; card {card}", flush=True)
    launches = sum(sum(x["sweep_sharded"] for x in v["launches"])
                   for v in out.values())
    return dict(kr, launches=launches, sweep_ms=sweep_ms,
                index=int(here[3]), dryrun=out)


def dedup_phase(card):
    """Phase 36: phase 22's headline through K3 with and without
    dedup_passes in turns; returns the kernels line's row of K3 under
    dedup_passes (the dedup arm's lap-2 pass-1 capture)."""
    from ilqr_iterative_tasks_torch.control import batched_soa
    from ilqr_iterative_tasks_torch.experiments.nlmpc_profile import (
        EventTimed)
    from ilqr_iterative_tasks_torch.ops.fused_ilqr import build_fused_ilqr
    from ilqr_iterative_tasks_torch.utils.params import (
        IlqrParams, SystemLimits)

    t36 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    hl = Headlines(dev)
    k3 = build_fused_ilqr(hl.params, hl.limits, 1.0, num_horizon=N,
                          max_iter=CAP)

    class PassTap(EventTimed):
        """K3 timed by CUDA events, keeping the inputs of the second call
        (pass 1) of the step it is armed at."""
        arm, captured = -1, None

        def __call__(self, *args, **kw):
            if self.arm == 0:
                self.captured = [t.clone() for t in args]
            self.arm -= 1
            return super().__call__(*args, **kw)

    arms, seen = {}, {}
    for dedup in (False, True, True, False):
        timed = PassTap(k3, K3_ATTRS)
        log = [] if dedup else None

        def want(lap, i, _args):
            if (lap, i) == (2, CAPTURES[2]):
                timed.arm = 1
            return False

        k3.launches = 0
        with tap_step(batched_soa, "i2lqr_step_reference", 5, want) as tap:
            t0 = time.perf_counter()
            res = hl.i2lqr(1, None, timed, dedup_passes=dedup,
                           dedup_log=log)
            secs = time.perf_counter() - t0
        steps = sum(tap.calls.values())
        require(k3.launches == 3 * steps > 0,
                f"36: K3 launches {k3.launches} != 3 x {steps} steps")
        h = lap_records_hash(res)
        skipped = int(sum(int(c) for c in log)) if dedup else 0
        arm = arms.setdefault(dedup, dict(wall_s=[], device_s=[], hash=[]))
        arm["wall_s"].append(secs)
        arm["device_s"].append(timed.seconds())
        arm["hash"].append(h)
        arm.update(launches=k3.launches, skipped_solves=skipped,
                   completion=float(res.lap_done.float().mean()))
        seen[dedup] = timed.captured
        print(f"[36 i2LQR through K3, dedup_passes {dedup}] {secs:.3f} s, "
              f"K3 {arm['device_s'][-1]:.4f} s by CUDA events, launches "
              f"{k3.launches} ({steps} steps), solves skipped {skipped}, "
              f"lap records {h}; card {card}", flush=True)
        del res
    hashes = {h for a in arms.values() for h in a["hash"]}
    require(len(hashes) == 1, f"36: dedup_passes changed the records "
            f"{hashes}")
    require(arms[True]["skipped_solves"] > 0, "36: no solve was skipped")
    host = (IlqrParams.make(device="cpu"), SystemLimits.make(device="cpu"))
    rows = {}
    for dedup, a in seen.items():
        require(a is not None, f"36: no lap-2 pass-1 capture ({dedup})")
        rows[dedup] = k3_row(k3, a, hl.params, hl.limits, *host, CAP)
        print(f"[36 K3 at the lap-2 pass-1 capture, dedup_passes {dedup}] "
              f"{rows[dedup]['ms']:.3f} ms ({rows[dedup]['live_lanes']} live "
              f"lanes of {rows[dedup]['lanes']}), plain "
              f"{rows[dedup]['plain_ms']:.3f} ms, bound "
              f"{rows[dedup]['bound_ms']:.4f} ms by "
              f"{rows[dedup]['bound_by']}, bitwise; card {card}", flush=True)
    print(f"[36 phase] {time.perf_counter() - t36:.1f} s", flush=True)
    return dict(rows[True], launches=arms[True]["launches"],
                arms={str(d): a for d, a in arms.items()},
                without_capture=rows[False], hash=hashes.pop())


def probe_phase(card):
    """Phase 37: batch_probe on the card, and precision_islands refused
    on CUDA scenarios."""
    from ilqr_iterative_tasks_torch.control.batched_soa import (
        SoaScenarios, simulate_learning_runs_soa)
    from ilqr_iterative_tasks_torch.experiments import batch_probe
    from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
    from ilqr_iterative_tasks_torch.utils.params import (
        IlqrParams, SystemLimits)

    t37 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    recs = []
    with no_plain_solve_on_card():
        for kw in ([dict(batch=b) for b in PROBE_BATCHES]
                   + [dict(batch=PROBE_BATCHES[0], dedup=True),
                      dict(batch=PROBE_BATCHES[0], nlmpc=True)]):
            rec = batch_probe.run(device=dev, **kw)
            require(rec["launches"] > 0 and rec["completion"] > 0.5,
                    f"37 batch_probe {kw}: {rec}")
            print(f"[37 batch_probe] {json.dumps(rec)}; card {card}",
                  flush=True)
            recs.append(rec)
    xcl = np.zeros(4)
    scen = SoaScenarios.broadcast(xcl, xcl, Obstacle.make(device=dev), 8,
                                  device=dev)
    try:
        simulate_learning_runs_soa(
            IlqrParams.make(device=dev), SystemLimits.make(device=dev), scen,
            np.zeros((MAX_STEPS, 4)), None, 2, 1.0, num_laps=1,
            max_steps=MAX_STEPS, max_laps=4, precision_islands=("trig",))
        raise AssertionError("37: precision_islands ran on CUDA scenarios")
    except ValueError as err:
        require("precision_islands" in str(err), f"37: {err}")
    print(f"[37 precision_islands on CUDA scenarios] refused; "
          f"{time.perf_counter() - t37:.1f} s", flush=True)
    return recs


# ---- phase 38: the round-4 and round-5 probes at a small width ----
ROUND_PROBE_B = 1024
ROUND_PROBES = (("round4", ["stats"]), ("round4", ["reuse"]),
                ("round4", ["cap"]), ("round4", ["stall"]),
                ("round4", ["canary"]), ("round4", ["nlmpc_modes"]),
                ("round5", ["permute"]), ("round5", ["retile"]),
                ("round5", ["retile_nlmpc"]), ("round5", ["prox"]),
                ("round5", ["tail"]), ("round5", ["all_rev"]),
                ("round5", ["all_mc", "1", "1"]), ("round5", ["f32_bisect"]))


def _launch_counts(rec):
    """Every ``launches`` / ``k4_launches`` figure of a probe's record."""
    for key, value in rec.items():
        if isinstance(value, dict):
            yield from _launch_counts(value)
        elif key in ("launches", "k4_launches"):
            yield key, value


def round_probes(card) -> dict:
    """Phase 38: every subcommand of experiments/round4_probe.py and
    round5_probe.py on the card at ROUND_PROBE_B lanes and one learning
    lap (``all_mc``: 1 seed, 1 lap; ``f32_bisect``'s card rows at B = 8),
    a warm run and one timed run, through the kernels under the guard
    (the probes run inside ``no_plain_solve_on_card``): each prints its
    JSON lines; every kernel launch count must be positive and every
    completion a share. Returns each subcommand's seconds."""
    from ilqr_iterative_tasks_torch.experiments import (
        round4_probe, round5_probe)
    mods = dict(round4=round4_probe, round5=round5_probe)
    t38, out = time.perf_counter(), {}
    for mod, argv in ROUND_PROBES:
        size = ["--batch", "8" if argv[0] == "f32_bisect"
                else str(ROUND_PROBE_B)]
        if argv[0] != "all_mc":
            size += ["--laps", "1"]
        t0 = time.perf_counter()
        last = mods[mod].main([*argv, *size, "--reps", "1"]).lines[-1]
        secs = time.perf_counter() - t0
        counts = list(_launch_counts(last))
        require(last["device"].startswith("cuda"),
                f"38 {argv[0]} ran on {last['device']}")
        require(all(n > 0 for _, n in counts),
                f"38 {argv[0]}: a kernel was not launched {counts}")
        shares = [v["completion"] for v in last.values()
                  if isinstance(v, dict) and "completion" in v]
        require(all(0.0 <= c <= 1.0 for c in shares),
                f"38 {argv[0]}: completion {shares}")
        print(f"[38 {mod} {' '.join(argv)}] {secs:.1f} s, launches "
              f"{[n for _, n in counts]}; card {card}", flush=True)
        out[argv[0]] = round(secs, 2)
    print(f"[38 probes] {time.perf_counter() - t38:.1f} s", flush=True)
    return out


def new_paths(card, cpu_run) -> dict:
    """Phases 33-37; returns their rows for the kernels line."""
    return dict(vmap_k3=vmap_tier(card, "i2lqr"),
                vmap_k4=vmap_tier(card, "nlmpc", cpu_run),
                sweep=sweep_phase(card),
                dedup=dedup_phase(card), probe=probe_phase(card))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from ilqr_iterative_tasks_torch.control import (
        batched_nlmpc_soa, batched_soa)
    from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import (
        simulate_nlmpc_runs_soa)
    from ilqr_iterative_tasks_torch.control.batched_soa import (
        SoaScenarios, simulate_learning_runs_soa)
    from ilqr_iterative_tasks_torch.experiments.generic_bench import (
        K5_MODELS, bench_kernel, bench_throughput, candidates, card_line,
        generic_kwargs, k5_task, throughput_inputs, warp_trips)
    from ilqr_iterative_tasks_torch.experiments.nlmpc_profile import (
        EventTimed)
    from ilqr_iterative_tasks_torch.models import (
        double_integrator, kinetic_bicycle, unicycle)
    from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
    from ilqr_iterative_tasks_torch.ops import _build
    from ilqr_iterative_tasks_torch.ops.fused_generic_ilqr import (
        build_fused_generic_ilqr, fused_generic_ilqr_reference, k5_library,
        k5_source)
    from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
        build_fused_ilqr, fused_ilqr_reference, obstacle_to_lanes)
    from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
        build_fused_lm_shooting, fused_lm_shooting_reference)
    from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
        LANE_QUEUE_FROM, build_fused_i2lqr_step, i2lqr_step_reference)
    from ilqr_iterative_tasks_torch.ops.ilqr_soa import ilqr_solve_soa
    from ilqr_iterative_tasks_torch.ops.lm_shooting_soa import (
        lm_feasibility_solve_soa)
    from ilqr_iterative_tasks_torch.ops.nlmpc_step import (
        build_fused_nlmpc_step, nlmpc_step_reference)
    from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
    from ilqr_iterative_tasks_torch.utils.checkpoint import (
        load_soa_run, save_soa_run)
    from ilqr_iterative_tasks_torch.utils.envelope import (
        assert_behavior_envelope, compare_runs)
    from ilqr_iterative_tasks_torch.utils.params import (
        IlqrParams, LmpcParams, SystemLimits)

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # ---- 1. device ----
    card = card_line(dev)
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # phase 34's CPU run (nlmpc_f32_cpu_run) on the host beside the build
    witness = concurrent.futures.ThreadPoolExecutor(1)
    cpu_run = witness.submit(nlmpc_f32_cpu_run)

    # ---- 2. build ----
    # with the counting build of K1 at k = 32 (phase 19) and K5's library
    # of each (model, horizon) of phases 11, 11b and 12, nvcc's at once
    k5_builds = [(K5_MODELS[name], nh) for name, nh in K5_BUILDS]
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        counting = ex.submit(_build.build, _build.CSRC_DIR, K1_COUNT,
                             K1_COUNT_SOURCES)
        generic = ex.submit(_build.build_generic,
                            [k5_source(m, nh) for m, nh in k5_builds])
        path, build_s = _build.build()
        counting_path = counting.result()[0]
        counting = _build.load(counting_path)
        generic = generic.result()
    k5_build_s = max(sec for _, sec in generic)
    print(f"[2 build] {build_s:.1f} s nvcc {' '.join(_build.NVCC_FLAGS)} "
          f"(and {' '.join(K1_COUNT)}); K5's {len(generic)} libraries "
          f"{K5_BUILDS} {k5_build_s:.1f} s wall, one nvcc each", flush=True)
    for log in [path, counting_path] + [p for p, _ in generic]:
        with open(log[:-3] + ".log") as f:
            for line in f:
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line
                        or line.startswith("nvcc seconds")):
                    print("   ", line.strip())
    lib = _build.library()
    # the loaded f32 K1 (k 8 / nsi 1 and k 32 / nsi 4; its lane queue in
    # f64 too), K2 all, K2
    # spaceVarying / timeVarying (qsort_skip, nsi 1), K3, K4 (and its f64)
    # and K5 (N = 6), as the CUDA runtime reports them
    occupancy = dict(
        k1=_build.attributes(lib, "i2lqr_step_attributes", 0, N, 8, 1),
        k1_opts=_build.attributes(lib, "i2lqr_step_opts_attributes", 0, N, 8,
                                  1),
        k1_lanes=_build.attributes(lib, "i2lqr_step_opts_attributes", 0, N,
                                   8, 0),
        k1_lanes_f64=_build.attributes(lib, "i2lqr_step_opts_attributes", 1,
                                       N, 8, 0),
        k1_k32=_build.attributes(lib, "i2lqr_step_attributes", 0, N, 32, 4),
        k1_k32_stats=_build.attributes(
            lib, "i2lqr_step_block_stats_attributes", 0, N, 4),
        k2_all=_build.attributes(lib, "nlmpc_step_all_attributes", 0, N),
        k2_sv=_build.attributes(lib, "nlmpc_step_attributes", 0, N, 8, 1, 0,
                                1),
        k2_tv=_build.attributes(lib, "nlmpc_step_attributes", 0, N, 8, 1, 1,
                                1),
        k3=_build.attributes(lib, "fused_ilqr_attributes", 0, N),
        k4=_build.attributes(lib, "fused_lm_shooting_attributes", 0, N),
        k4_f64=_build.attributes(lib, "fused_lm_shooting_attributes", 1, N),
        k5=_build.attributes(k5_library(double_integrator, N),
                             "k5_attributes", 0),
        k5_bicycle=_build.attributes(k5_library(kinetic_bicycle, N),
                                     "k5_attributes", 0),
        # the variants of the options ported last (phases 4d-21d): the
        # options tile and the lane queue with reuse_extract, the queue
        # with dom_skip, the group kernel, the k = 32 block kernel with
        # reuse_extract, K2's prox_skip walker and zeros_skip builds
        **{f"k1_{key}": _build.attributes(
            lib, "i2lqr_step_opts_variant_attributes", code, N, 8, 1, opts)
           for key, code, opts in (("tile_reuse", 0, 8),
                                   ("lanes_reuse", 0, 12),
                                   ("lanes_dom", 0, 16),
                                   ("lanes_dom_f64", 1, 16))},
        **{f"k1_group{m}{'_nsi2' if nsi == 2 else ''}": _build.attributes(
            lib, "i2lqr_step_group_attributes", 0, N, 8, nsi, m)
           for nsi, m in ((1, 2), (1, 4), (1, 8), (2, 16))},
        k1_k32_reuse=_build.attributes(
            lib, "i2lqr_step_block_reuse_attributes", 0, N, 4),
        **{f"k2_{key}": _build.attributes(
            lib, "nlmpc_step_attributes", 0, N, 8, 1, tv, opts)
           for key, tv, opts in (("prox", 0, 2), ("prox_tv", 1, 2),
                                 ("zskip", 0, 4), ("qsort_zskip", 0, 5),
                                 ("tv_qsort_zskip", 1, 5))},
        k2_all_zskip=_build.attributes(
            lib, "nlmpc_step_all_zskip_attributes", 0, N))
    for key, occ in occupancy.items():
        print(f"[2 {key.removesuffix('_f64')} "
              f"{'f64' if key.endswith('_f64') else 'f32'}] "
              f"{occ['registers']} registers, "
              f"{occ['local_bytes']} bytes of local memory a thread, "
              f"{occ['warps_per_sm']} resident warps an SM", flush=True)
    # the plain builds keep their registers and local memory (f32) with
    # the lane count apart from the lane stride (PERF.md section 6)
    for key, regs, local in PLAIN_RESOURCES:
        occ = occupancy[key]
        require((occ["registers"], occ["local_bytes"]) == (regs, local),
                f"2 {key}: {occ['registers']} registers and "
                f"{occ['local_bytes']} B of local memory, not {regs} / "
                f"{local}")

    params, limits = IlqrParams.make(), SystemLimits.make()
    # the same values on the host, for the operation counts
    host_params = IlqrParams.make(device="cpu")
    host_limits = SystemLimits.make(device="cpu")
    host_nl_params = LmpcParams.make(device="cpu")
    host_nl_limits = SystemLimits.make(dtype=torch.float64, device="cpu")
    xcl = seed_trajectory(1.0)[0]
    rng = np.random.default_rng(0)

    # ---- 3. K3 against the plain solve ----
    b = RANDOM_LANES
    x0, xt = seed_lanes(rng, xcl, b, 1, 9)
    obs = obstacle_to_lanes(lane_obstacle(rng, b, dev), b).contiguous()
    k3 = build_fused_ilqr(params, limits, 1.0, num_horizon=N, max_iter=CAP)
    p3 = {}
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
        # the kernel keeps the plain version's arithmetic: every output
        # equal bit for bit
        require(all(torch.equal(g, w) for g, w in zip(out, ref)),
                f"K3 {dtype}: not bitwise equal to the plain solve")
        if dtype == torch.float64:
            require(us_share >= 0.999, "K3 f64: < 99.9 % of lanes agree")
        else:
            require(cost_share >= 0.99, "K3 f32: < 99 % of lanes agree")
            p3 = dict(ms=cuda_ms(lambda: k3(*a), 5),
                      plain_ms=cuda_ms(lambda: fused_ilqr_reference(
                          params, limits, 1.0, *a, num_horizon=N,
                          max_iter=CAP), 2))
    print(f"[3 K3 f32] kernel {p3['ms']:.3f} ms, plain {p3['plain_ms']:.3f} "
          f"ms per call of {b} lanes", flush=True)

    # ---- 7. K4 against the plain solve ----
    # the NLMPC solve clips at the raw delta_max: keep it exact in f64
    nl_limits = SystemLimits.make(dtype=torch.float64)
    lanes7 = k4_lanes(rng, xcl, np.arange(b) % 16 == 5, dev)
    skip, hzn_t = lanes7[4], lanes7[5]
    k4 = build_fused_lm_shooting(nl_limits, 1.0, num_horizon=N,
                                 max_iters=NL_CAP)
    k4_stats = {}
    live = skip < 0.5
    for dtype in (torch.float64, torch.float32):
        a = cast(lanes7, dtype, keep=(4,))
        out = k4(*a)
        ref = fused_lm_shooting_reference(nl_limits, 1.0, *a, num_horizon=N,
                                          max_iters=NL_CAP)
        torch.cuda.synchronize()
        for t in out:
            require(bool(torch.isfinite(t).all()), "K4: non-finite output")
        require(all(torch.equal(g, w) for g, w in zip(out, ref)),
                f"K4 {dtype}: not bitwise equal to the plain solve")
        same = (out[3] == ref[3])[live]
        dus = (out[0] - ref[0]).abs().amax(dim=(0, 1))[live]
        agree = same & (dus <= 1e-6)
        share, feas_share = (float(agree.double().mean()),
                             float(same.double().mean()))
        print(f"[7 K4 {str(dtype)[6:]}] lanes {b} ({int(live.sum())} not "
              f"skipped, feasible {float(ref[3][live].mean()):.4f}): equal "
              f"verdict {feas_share:.6f}, and max|dus|<=1e-6 {share:.6f}, "
              f"bitwise us {float((dus == 0).double().mean()):.6f}, "
              f"max|dus| {float(dus.max()):.3e}", flush=True)
        if dtype == torch.float64:
            require(share >= 0.999, f"K4 f64: agreement {share} < 0.999")
        else:
            maxd = float(dus[same].max()) if bool(same.any()) else 0.0
            require(feas_share >= 0.99 and maxd <= F32_TOL,
                    f"K4 f32: agreement {feas_share}, {maxd}")
            k4_stats = dict(
                max_abs_err=float(dus.max()),
                ms=cuda_ms(lambda: k4(*a), 5),
                plain_ms=cuda_ms(lambda: fused_lm_shooting_reference(
                    nl_limits, 1.0, *a, num_horizon=N, max_iters=NL_CAP), 2))
            # per-lane iterations summed over the two starts
            trips = lm_feasibility_solve_soa(
                nl_limits, a[3], a[0], a[1], a[2], 1.0, num_horizon=N,
                max_iters=NL_CAP, m_lanes=torch.clamp(hzn_t.long(), 2, N),
                done0=skip > 0.5).n_iters
            sample_idx = torch.nonzero(live).flatten()[:SAMPLE_LANES].cpu()
            sample = lanes_of(a, sample_idx, b)
            k4_stats.update(bound(solve_ops(
                lambda max_iters: fused_lm_shooting_reference(
                    host_nl_limits, 1.0, *sample, num_horizon=N,
                    max_iters=max_iters), "max_iters", len(sample_idx),
                int(live.sum()), float(trips[live].double().sum()) / 2),
                nbytes(a) + nbytes(out)))
            k4_stats["mean_iters"] = float(trips[live].double().mean())
    print(f"[7 K4 f32] kernel {k4_stats['ms']:.3f} ms, plain "
          f"{k4_stats['plain_ms']:.3f} ms per call of {b} lanes; bound "
          f"{k4_stats['bound_ms']:.4f} ms by {k4_stats['bound_by']} "
          f"({k4_stats['mean_iters']:.2f} LM iterations a lane, both "
          f"starts)", flush=True)

    # ---- 6a. i2LQR headline warm run through K1 (captures phase 4) ----
    hl = Headlines(dev)
    seed_xs, seed_us, scen = hl.seed_xs, hl.seed_us, hl.scen
    k1 = build_fused_i2lqr_step(params, limits, 1.0, num_horizon=N,
                                max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                                max_iter=CAP)
    headline = hl.i2lqr
    cap = k1_capture(k1)
    for k in (k1, k3, k4):
        k.launches = 0
    t0 = time.perf_counter()
    warm_run = headline(0, cap)
    warm_s = time.perf_counter() - t0
    k1_launches = k1.launches
    require(k1_launches > 0, "K1 was not launched by the main path")
    completion = float(warm_run.lap_done.float().mean())
    mean_steps = warm_run.lap_steps.float().mean(dim=1).tolist()
    k1_hash = lap_records_hash(warm_run)
    require(bool(torch.isfinite(warm_run.safe_set[0]).all()),
            "non-finite safe set")
    print(f"[6 headline warm] B={BATCH} {warm_s:.2f} s, K1 launches "
          f"{k1_launches}, completion {completion:.4f}, mean lap steps "
          f"{[round(v, 2) for v in mean_steps]}, lap records "
          f"{k1_hash}", flush=True)
    require(completion >= 0.99, "headline lap completion < 0.99")
    k1_warm = warm_run  # phase 22's yardstick

    # ---- 4. K1 against the plain step on the captured safe sets ----
    require(sorted(cap.captured) == sorted(CAPTURES),
            f"captured {sorted(cap.captured)}")
    k1_err, k1_ms, k1_plain_ms, k1_bound = 0.0, None, None, {}
    for lap, (step, args) in sorted(cap.captured.items()):
        active = args[8] < 0.5
        n_act = int(active.sum())
        require(n_act > 0, f"capture lap {lap}: no active lane")
        for dtype in (torch.float32, torch.float64):
            a = cast(args, dtype, keep=(8,))
            out = k1(*a)
            trips = []
            ref, plain = timed_call(lambda: i2lqr_step_reference(
                params, limits, 1.0, *a, max_iter=CAP, trips=trips))
            require(bool(torch.isfinite(out[0]).all()), "K1: non-finite us")
            agree = ((out[1] == ref[1]) & (out[2] == ref[2])
                     & (out[3] == ref[3]))[active]
            dus = (out[0] - ref[0]).abs().amax(dim=(0, 1))[active][agree]
            share = float(agree.double().mean())
            maxd = float(dus.max()) if dus.numel() else 0.0
            line = (f"[4 K1 lap {lap} step {step} "
                    f"{str(dtype)[6:]}] active {n_act}: decisions agree "
                    f"{share:.6f}, max|dus| on them {maxd:.3e}")
            if dtype == torch.float64:
                require(share >= 0.999 and maxd <= 1e-6,
                        f"K1 f64 lap {lap}: agreement {share}, {maxd}")
            else:
                require(share >= 0.99, f"K1 f32 lap {lap}: {share}")
                k1_err = max(k1_err, maxd)
                ms = cuda_ms(lambda: k1(*a), 10)
                line += f"; kernel {ms:.3f} ms, plain {plain:.3f} ms per step"
                if lap == 2:
                    k1_ms, k1_plain_ms = ms, plain
                    b_all = args[0].shape[-1]
                    idx = torch.nonzero(active).flatten()[:SAMPLE_LANES]
                    sample = lanes_of(a, idx.cpu(), b_all)
                    iters, mean_trips, _ = step_iters(trips, active)
                    k1_bound = bound(solve_ops(
                        lambda max_iter: i2lqr_step_reference(
                            host_params, host_limits, 1.0, *sample,
                            max_iter=max_iter), "max_iter", len(idx), n_act,
                        iters), step_bytes(a, out, (2, 3), k1.nsi))
                    k1_bound["mean_iters"] = mean_trips
                    line += (f"; bound {k1_bound['bound_ms']:.4f} ms by "
                             f"{k1_bound['bound_by']} ({mean_trips:.2f} LM "
                             f"iterations a candidate solve)")
            print(line, flush=True)
    # ---- 4b. K1's options on the same captures ----
    k1_opt_stats = check_k1_options(cap.captured, k1, params, limits,
                                    host_params, host_limits)
    # ---- 4c. K1 over a prefix of the lanes (tail_shrink's launch): the
    # tile and the lane queue (with its counts) ----
    k1_lq = k1_with(params, limits, K1_OPTION_SETS["dedup_qsort"],
                    with_stats=True)
    k1_prefix = {}
    for lap, (step, args) in sorted(cap.captured.items()):
        a = cast(args, torch.float32, keep=(8,))
        k1_prefix[f"lap{lap}"] = dict(
            tile=check_prefix(f"4c K1 lap {lap}", k1, a, 8),
            lane_queue=check_prefix(f"4c K1 lane queue lap {lap}", k1_lq, a,
                                    8, skip_outputs=(5,)))
    # ---- 4d. K1's reuse_extract, dom_skip and group on the same
    # captures ----
    k1_var_stats = check_k1_variants(
        "4d", cap.captured, K1_VARIANTS,
        {"plain": k1, "pair": k1_with(params, limits,
                                      K1_OPTION_SETS["dedup_qsort"])},
        params, limits, host_params, host_limits, counting,
        plain_bound=k1_bound)
    del cap
    print(f"[4 K1] lap-2 capture {k1_ms:.3f} ms a step (f32), "
          f"{occupancy['k1']['registers']} registers, "
          f"{occupancy['k1']['warps_per_sm']} warps per SM, "
          f"{k1.nsi * k1.k} threads a lane", flush=True)

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

    # ---- 6b. i2LQR headline timed runs through K1 without options and
    # with the pair the JAX main path ships (dedup + qsort_skip), in turns;
    # the pair must leave every lap record as it was ----
    # the simulator's own K1 (no step_solver): the pair at k = 8 / nsi 1
    k1_pair = batched_soa.default_step_solver(
        params, limits, 1.0, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
        max_iter=CAP)
    require(k1_pair.dedup and k1_pair.qsort_skip
            and k1_pair.lane_queue_runs(BATCH),
            "the simulator's K1 does not run dedup + qsort_skip's lane "
            "queue at the headline's batch")
    runs_at = {bb: "lane queue" if k1_pair.lane_queue_runs(bb)
               else "plain order" for bb in CROSSOVER_BATCHES}
    # a stall_reseed run's own K1 runs the plain order at every batch
    k1_reseeded = batched_soa.default_step_solver(
        params, limits, 1.0, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
        max_iter=CAP, reseeded=True)
    require(not any(k1_reseeded.lane_queue_runs(bb)
                    for bb in CROSSOVER_BATCHES),
            "a stall_reseed run's K1 runs the lane queue")
    print(f"[6 lane queue switch] the simulator's K1 runs the lane queue "
          f"from {LANE_QUEUE_FROM} lanes (LANE_QUEUE_FROM): "
          + ", ".join(f"B={bb} {k}" for bb, k in runs_at.items())
          + "; with stall_reseed the plain order at each", flush=True)
    times, hashes, seed_hash, pair_launches = {"plain": [], "pair": []}, [], \
        {}, {}
    for seed, name in ((1, "plain"), (1, "pair"), (2, "pair"), (2, "plain")):
        solver = k1_pair if name == "pair" else k1
        solver.launches = 0
        t0 = time.perf_counter()
        res = headline(seed, None if name == "pair" else k1)
        times[name].append(time.perf_counter() - t0)
        pair_launches.setdefault(name, solver.launches)
        h = lap_records_hash(res)
        hashes.append(h)
        require(seed_hash.setdefault(seed, h) == h,
                f"headline seed {seed}: dedup + qsort_skip changed the run")
        del res
    require(pair_launches["pair"] > 0, "K1 with dedup + qsort_skip was not "
            "launched by the main path")
    best = min(times["plain"])
    rate = BATCH * LAPS / best
    pair_rate = BATCH * LAPS / min(times["pair"])
    print(f"[6 headline] {rate:.1f} lap-sims/s, {best:.3f} s per batch "
          f"(runs {[round(t, 3) for t in times['plain']]}); with dedup + "
          f"qsort_skip {pair_rate:.1f} lap-sims/s, "
          f"{min(times['pair']):.3f} s per batch (runs "
          f"{[round(t, 3) for t in times['pair']]}), K1 launches "
          f"{pair_launches['pair']} (without {pair_launches['plain']}); lap "
          f"records {hashes}, completion {completion:.4f}, K1 launches "
          f"{k1_launches}, card {card}", flush=True)
    # seed 0 again through K1 that counts, in the plain order and with the
    # pair: each launch's live share, the run's useful, executed and queue
    # floor (the lap records phase 6's warm run's)
    k1_counted = {}
    for name, opts in (("with_stats", {}),
                       ("dedup_qsort", K1_OPTION_SETS["dedup_qsort"])):
        kc = k1_with(params, limits, opts, with_stats=True)
        rec = live_share(kc, 8, BATCH)
        t0 = time.perf_counter()
        res = headline(0, rec)
        run_s = time.perf_counter() - t0
        require(lap_records_hash(res) == k1_hash,
                f"headline through K1 {name}: lap records changed")
        require(kc.launches > 0, f"K1 {name} was not launched")
        k1_counted[name] = dict(launches=kc.launches, run_s=run_s,
                                live_share=rec.shares(),
                                **stats_summary(res.iter_stats))
        c = k1_counted[name]
        print(f"[6 headline counted {name}] {run_s:.3f} s, K1 launches "
              f"{kc.launches}, live share a launch min "
              f"{c['live_share']['min']:.4f} median "
              f"{c['live_share']['median']:.4f} mean "
              f"{c['live_share']['mean']:.4f}; useful {c['useful']}, "
              f"executed {c['executed']} thread-trips: waste "
              f"{c['waste']:.4f}; queue floor (32 lanes) {c['queue_floor']}"
              f", / executed {c['floor_over_executed']:.4f}", flush=True)
        del res

    # ---- 6d. the i2LQR headline through K1's variants and the
    # simulator's own K1, in turns: the lap records phase 6b's; then K1's
    # device seconds a run with and without reuse_extract (the pair's
    # lane queue), in turns, from profiler traces ----
    k1_var = {name: k1_with(params, limits, o)
              for name, (o, _) in K1_VARIANTS.items()}
    k1_var_runs = variant_turns(
        "6d i2LQR headline", lambda solver: headline(1, solver),
        {"pair": (k1_pair, k1_pair),
         "pair_reuse_extract": (k1_var["pair_reuse_extract"],) * 2}, card)
    k1_var_runs.update(variant_turns(
        "6d i2LQR headline", lambda solver: headline(1, solver),
        {n: (k, k) for n, k in k1_var.items() if n != "pair_reuse_extract"},
        card, back=False))
    require(all(r["hash"] == seed_hash[1] for r in k1_var_runs.values()),
            "6d: the lap records are not phase 6b's")
    reuse_prof = dict(zip(("k1_device_s", "busy_s", "host_s"),
                          device_seconds(lambda: headline(
                              1, k1_var["pair_reuse_extract"]),
                              "i2lqr_step_lanes_kernel")))
    print(f"[6d headline profiled] the lane queue with reuse_extract "
          f"{reuse_prof['k1_device_s']:.4f} s of the card a run (6b's "
          f"profiled run follows, without it); card {card}", flush=True)

    # K1's device seconds over a headline run through the simulator's own
    # K1 (the lane queue), from a profiler trace
    pair_prof = dict(zip(("k1_device_s", "busy_s", "host_s"),
                         device_seconds(lambda: headline(1, k1_pair),
                                        "i2lqr_step_lanes_kernel")))
    print(f"[6 headline profiled] the lane queue "
          f"{pair_prof['k1_device_s']:.4f} s of the card a run; the card "
          f"busy {pair_prof['busy_s']:.4f} s of {pair_prof['host_s']:.3f} s "
          f"under the profiler; card {card}", flush=True)

    # ---- 6c. the i2LQR headline with tail_shrink at two prefixes, in
    # turns against the run without (the simulator's own K1): tail_shrink
    # alone does not route the noise draws (JAX's simulator does not), so
    # from a lap's compaction on its run is its own, repeated by its
    # other turn ----
    tails = {f"tail_{p}": dict(tail_shrink=p) for p in TAIL_PREFIXES}
    tail6 = option_turns(
        "6c i2LQR headline", lambda solver, **o: headline(1, solver, **o),
        k1_pair, 8, {"none": {}, **tails}, card, own=tuple(tails))
    for p in TAIL_PREFIXES:  # the simulator's K1 a tail launch
        t = tail6[f"tail_{p}"]["tail"]
        # the switch reads the launch's lanes: a prefix below
        # LANE_QUEUE_FROM runs the plain order (the lane queue's own time
        # over a prefix: phase 4c, experiments/kernel_ab.py --k1)
        kern = ("the lane queue" if k1_pair.lane_queue_runs(p) else
                "the plain order (i2lqr_step_kernel)")
        print(f"[6c tail launch {p}] {kern} over the prefix "
              f"{t['prefix_ms_a_launch']:.3f} ms a launch "
              f"({t['prefix_launches']} launches), over B at the same "
              f"steps {t['over_b_ms_a_launch']:.3f}; card {card}",
              flush=True)

    # ---- 22. the i2LQR headline through K3, the per-candidate path ----
    k3p = build_fused_ilqr(params, limits, 1.0, num_horizon=N, max_iter=CAP)
    k3_log = SkipLog(k3p, K3_ATTRS)  # each launch's skip mask
    with tap_step(batched_soa, "i2lqr_step_reference", 5,
                  lambda lap, i, a: CAPTURES.get(lap) == i) as tap3:
        zero_counts(k1, k3, k4, k3p)
        t0 = time.perf_counter()
        k3_run = headline(0, None, k3_log)
        k3_warm_s = time.perf_counter() - t0
        k3_launches = k3p.launches
    k3_steps = sum(tap3.calls.values())
    require(k1.launches == 0 and k3_steps > 0
            and k3_launches == 3 * k3_steps,
            f"K3 launched {k3_launches} times on {k3_steps} steps with "
            f"active lanes (3 passes a step); K1 {k1.launches}")
    k3_hash = lap_records_hash(k3_run)
    k3_completion = float(k3_run.lap_done.float().mean())
    line = (f"[22 i2LQR through K3 warm] B={BATCH} {k3_warm_s:.2f} s, K3 "
            f"launches {k3_launches} ({k3_steps} steps with active lanes), "
            f"completion {k3_completion:.4f}, lap records {k3_hash}, phase "
            f"6's K1 run {k1_hash}")
    if k3_hash != k1_hash:  # the gate the issue of this path sets
        env = assert_behavior_envelope(k1_warm, k3_run)
        require(k3_completion >= 0.99, "K3 path completion < 0.99")
        line += f": differ, within the envelope {json.dumps(env)}"
    print(line, flush=True)
    del k1_warm, k3_run
    k3_caps = check_candidate_steps(
        "22 K3 step", tap3.captured,
        lambda *a, **kw: i2lqr_step_reference(params, limits, 1.0, *a,
                                              max_iter=CAP, **kw), k3p, 8)
    # K3 on the lap-2 capture's pass-0 lanes against its plain version
    a = k3_caps["calls"][0]
    out = k3p(*a)
    ref, plain_ms = timed_call(lambda: fused_ilqr_reference(
        params, limits, 1.0, *a, num_horizon=N, max_iter=CAP))
    require(all(torch.equal(g, w) for g, w in zip(out, ref)),
            "K3 on the path's inputs: not bitwise equal to the plain solve")
    live = a[4] < 0.5
    trips = ilqr_solve_soa(params, limits, a[3], a[0], a[1], a[2],
                           float(params.lamb), 1.0, num_horizon=N,
                           max_iter=CAP, done0=~live).lane_iters
    idx = torch.nonzero(live).flatten()[:SAMPLE_LANES]
    sample = lanes_of(a, idx.cpu(), a[1].shape[-1])
    k3_path = dict(
        launches=k3_launches, ms=cuda_ms(lambda: k3p(*a), 5),
        plain_ms=plain_ms,
        max_abs_err=float((out[0] - ref[0]).abs().max()),
        lanes=a[1].shape[-1], live_lanes=int(live.sum()),
        mean_iters=float(trips[live].double().mean()),
        step_ms=k3_caps["step_ms"], plain_step_ms=k3_caps["plain_step_ms"],
        **bound(solve_ops(lambda max_iter: fused_ilqr_reference(
            host_params, host_limits, 1.0, *sample, num_horizon=N,
            max_iter=max_iter), "max_iter", len(idx), int(live.sum()),
            float(trips[live].double().sum())), nbytes(a) + nbytes(out)))
    # K3 under every launch's skip mask of the run, on the lap-2 capture's
    # pass-0 lanes, as the lanes lie and compacted (the JAX path's)
    k3_path["compaction"] = compaction_replay(
        k3p, a, [m[:BATCH] for m in k3_log.calls], 8)
    del k3_log
    print(f"[22 K3 compaction] {json.dumps(k3_path['compaction'])}",
          flush=True)
    del out, ref, k3_caps
    times, hashes, k3_dev = [], [], []
    for seed in (1, 2):
        timed_k3 = EventTimed(k3p, K3_ATTRS)
        t0 = time.perf_counter()
        res = headline(seed, None, timed_k3)
        times.append(time.perf_counter() - t0)
        k3_dev.append(timed_k3.seconds())
        hashes.append(lap_records_hash(res))
        del res
    k3_path.update(wall_s=min(times), lap_sims_per_s=BATCH * LAPS / min(times),
                   device_s=k3_dev, hash=k3_hash)
    print(f"[22 i2LQR through K3] {k3_path['lap_sims_per_s']:.1f} lap-sims/s, "
          f"{min(times):.3f} s per batch (runs {[round(t, 3) for t in times]},"
          f" K3 device s {[round(t, 3) for t in k3_dev]} by CUDA events, lap "
          f"records {hashes}); lap-2 capture: K3 {k3_path['ms']:.3f} ms a "
          f"call of {k3_path['lanes']} lanes ({k3_path['live_lanes']} live), "
          f"plain {plain_ms:.3f} ms, bound {k3_path['bound_ms']:.4f} ms by "
          f"{k3_path['bound_by']} ({k3_path['mean_iters']:.2f} LM iterations "
          f"a live lane), the step with K3 {k3_path['step_ms']:.3f} ms; card "
          f"{card}", flush=True)

    # ---- 10a. NLMPC headline warm run through K2 (captures phase 8) ----
    nl_params = LmpcParams.make()
    nl_sizes = dict(num_horizon=N, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                    max_iters=NL_CAP)
    k2 = build_fused_nlmpc_step(nl_params, nl_limits, 1.0, **nl_sizes)
    k2q = batched_nlmpc_soa.default_step_solver(
        nl_params, nl_limits, 1.0, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
        max_iters=NL_CAP)
    require(k2q.qsort_skip, "spaceVarying K2 without qsort_skip")
    scen_all = hl.scen_all

    def nl_headline(seed, solver, lp=nl_params, sc=scen, cand=None):
        return hl.nlmpc(seed, lp, sc, solver, cand)

    def plain_of(lp):
        return (lambda *a, trips=None, cands=None: nlmpc_step_reference(
                    lp, nl_limits, 1.0, *a, max_iters=NL_CAP, trips=trips,
                    cands=cands),
                lambda *a, max_iters: nlmpc_step_reference(
                    LmpcParams.make(device="cpu", ss_option=lp.ss_option,
                                    all_ss_point=lp.all_ss_point,
                                    all_ss_iter=lp.all_ss_iter),
                    host_nl_limits, 1.0, *a, max_iters=max_iters))

    def warm_run(tag, lp, sc, solver, counted):
        """The headline's warm run: every kernel count set to 0 before it
        and read after; returns (result, seconds, the K2's launches)."""
        for k in (k1, k2, k2q, k3, k4, *counted):
            k.launches = 0
        t0 = time.perf_counter()
        res = nl_headline(0, solver, lp, sc)
        sec = time.perf_counter() - t0
        k2_count = counted[0].launches
        require(k2_count > 0, f"{tag}: K2 was not launched by the main path")
        require(bool(torch.isfinite(res.safe_set[0]).all())
                and bool(torch.isfinite(res.safe_set[1]).all()),
                f"{tag}: non-finite NLMPC safe set")
        return res, sec, k2_count

    def completion_of(res):
        p_done = float(res.lap_done.float().mean())
        n_lane_laps = res.lap_done.numel()
        return p_done, (p_done * (1 - p_done) / n_lane_laps) ** 0.5

    def timed(tag, lp, sc, solver, b, completion, steps, launches,
              seeds=(1, 2)):
        """Timed runs back to back, one a seed; returns the best rate and
        the rates of all runs."""
        times, k2_s, hashes = [], [], []
        for seed in seeds:
            timed_k2 = EventTimed(solver)
            t0 = time.perf_counter()
            res = nl_headline(seed, timed_k2, lp, sc)
            times.append(time.perf_counter() - t0)
            k2_s.append(timed_k2.seconds())
            hashes.append(lap_records_hash(res))
            del res
        rates = [b * LAPS / t for t in times]
        print(f"[{tag}] {max(rates):.1f} lap-sims/s, {min(times):.3f} s per "
              f"batch (runs {[round(t, 3) for t in times]}: median "
              f"{float(np.median(rates)):.1f}, lowest {min(rates):.1f} "
              f"lap-sims/s; K2 device s {[round(t, 3) for t in k2_s]} by "
              f"CUDA events; lap records {hashes}), completion "
              f"{completion:.4f}, mean lap steps "
              f"{[round(v, 2) for v in steps]}, K2 launches {launches}, "
              f"card {card}", flush=True)
        return max(rates), rates

    cap2 = k2_capture(k2q)
    nl_warm, nl_warm_s, k2_launches = warm_run("NLMPC headline", nl_params,
                                               scen, cap2, (k2q, k2))
    nl_completion = float(nl_warm.lap_done.float().mean())
    k2_hash = lap_records_hash(nl_warm)
    nl_steps = nl_warm.lap_steps.float().mean(dim=1).tolist()
    print(f"[10 NLMPC headline warm] B={BATCH} {nl_warm_s:.2f} s, K2 "
          f"launches {k2_launches}, completion {nl_completion:.4f}, mean lap "
          f"steps {[round(v, 2) for v in nl_steps]}, max lap steps "
          f"{nl_warm.lap_steps.amax(dim=1).tolist()}, lap records "
          f"{k2_hash}", flush=True)
    require(nl_completion >= NL_COMPLETION_MIN,
            f"NLMPC headline lap completion {nl_completion} < "
            f"{NL_COMPLETION_MIN}")
    k2_warm = nl_warm  # phase 23's yardstick
    del nl_warm

    # ---- 8. K2 against the plain step on the captured inputs; 8b. K2 with
    # qsort_skip against K2 bit for bit ----
    require(sorted(cap2.captured) == sorted(NL_CAPTURES),
            f"captured {sorted(cap2.captured)}")
    def nsi2_of(lp):
        """K2 at nsi = 2 in the mode of ``lp`` and its plain step."""
        lp2 = LmpcParams.make(ss_option=lp.ss_option, num_ss_iter=2)
        return (build_fused_nlmpc_step(lp2, nl_limits, 1.0, **nl_sizes),
                plain_of(lp2)[0])

    nl_plain, nl_host_plain = plain_of(nl_params)
    k2qs = build_fused_nlmpc_step(nl_params, nl_limits, 1.0, qsort_skip=True,
                                  with_stats=True, **nl_sizes)
    k2_stats = check_k2("8 K2", k2q, {"no_qsort_skip": k2,
                                      "with_stats": k2qs}, cap2.captured,
                        nl_plain, nl_host_plain, nsi2=nsi2_of(nl_params))
    check_k2_counts("8c K2 with_stats", k2qs, cap2.captured, nl_params,
                    nl_limits)
    # ---- 8d. K2 spaceVarying over a prefix of the lanes, and its
    # counting instantiation ----
    k2_prefix = {}
    for lap, (step, args) in sorted(cap2.captured.items()):
        a = cast(args, torch.float32, keep=(9,))
        k2_prefix[f"lap{lap}"] = dict(
            plain=check_prefix(f"8d K2 lap {lap}", k2, a, 9),
            with_stats=check_prefix(f"8d K2 with_stats lap {lap}", k2qs, a,
                                    9))
    # ---- 8e. K2's prox_skip and zeros_skip on the same captures ----
    k2_var_stats = check_k2_variants("8e", "spaceVarying", cap2.captured,
                                     {"plain": k2, "qsort": k2q}, nl_params,
                                     nl_limits, host_nl_limits, counting)
    del cap2
    print(f"[8 K2] lap-2 capture {k2_stats['ms']:.3f} ms a step with "
          f"qsort_skip, {k2_stats['no_qsort_skip_ms']:.3f} ms without (f32), "
          f"{occupancy['k2_sv']['registers']} registers, "
          f"{occupancy['k2_sv']['local_bytes']} bytes of local memory, "
          f"{occupancy['k2_sv']['warps_per_sm']} warps per SM", flush=True)

    # ---- 9. zero-noise NLMPC closed loop through K2 ----
    def zero_noise(tag, lp, solver, host_laps, f32_within=None):
        for dtype in (torch.float64, torch.float32):
            scen_z = SoaScenarios.broadcast(
                np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0),
                1024, noise_on=False, dtype=dtype, device=dev)
            res_z = simulate_nlmpc_runs_soa(
                lp, nl_limits, scen_z, seed_xs, seed_us, 121, 1.0,
                step_solver=solver, num_laps=LAPS, max_steps=MAX_STEPS,
                max_laps=MAX_LAPS, max_lm_iters=60)
            steps_z = res_z.lap_steps.cpu().numpy()
            laps_z = steps_z[:, 0].tolist()
            same = bool((steps_z == steps_z[:, :1]).all())
            print(f"[{tag} {str(dtype)[6:]}] B=1024 cap 60 lap steps "
                  f"{laps_z}, all lanes identical {same}, all done "
                  f"{bool(res_z.lap_done.all())}", flush=True)
            require(bool(res_z.lap_done.all()), f"{tag}: lanes not done")
            require(same, f"{tag}: zero-noise lanes differ")
            if dtype == torch.float64:
                require(laps_z == host_laps,
                        f"{tag} f64 laps {laps_z} != host {host_laps}")
            elif f32_within is not None:
                require(all(abs(a - b) <= f32_within
                            for a, b in zip(laps_z, host_laps)),
                        f"{tag} f32 laps {laps_z} not within {f32_within} "
                        f"of {host_laps}")

    zero_noise("9 NLMPC zero-noise", nl_params, build_fused_nlmpc_step(
        nl_params, nl_limits, 1.0, **{**nl_sizes, "max_iters": 60}),
        HOST_NLMPC_LAPS, f32_within=2)

    # ---- 10b. NLMPC headline timed runs, with and without qsort_skip in
    # turns; the option must leave every lap record as it was ----
    nl_times = {"plain": [], "qsort_skip": []}
    runs, nl_launches = {}, {}
    for seed, name in ((1, "plain"), (1, "qsort_skip"), (2, "qsort_skip"),
                       (2, "plain")):
        solver = k2q if name == "qsort_skip" else k2
        solver.launches = 0
        t0 = time.perf_counter()
        res = nl_headline(seed, solver)
        nl_times[name].append(time.perf_counter() - t0)
        nl_launches.setdefault(name, solver.launches)  # its seed-1 run
        print(f"[10 NLMPC headline {name} seed {seed}] lap records "
              f"{lap_records_hash(res)}", flush=True)
        if seed in runs:
            require(torch.equal(res.lap_steps, runs[seed].lap_steps)
                    and torch.equal(res.lap_done, runs[seed].lap_done),
                    f"NLMPC headline seed {seed}: qsort_skip changed the run")
        runs[seed] = res
    del runs, res
    # seed 0 again through K2 with qsort_skip that counts: each launch's
    # live share and the run's useful and executed trips (the lap records
    # phase 10's warm run's)
    rec = live_share(k2qs, 9, BATCH)
    k2qs.launches = 0
    t0 = time.perf_counter()
    res = nl_headline(0, rec)
    k2_counted = dict(run_s=time.perf_counter() - t0,
                      launches=k2qs.launches, live_share=rec.shares(),
                      **stats_summary(res.iter_stats))
    require(lap_records_hash(res) == k2_hash,
            "NLMPC headline through K2 with_stats: lap records changed")
    require(k2qs.launches > 0, "K2 with_stats was not launched")
    del res, rec
    c = k2_counted
    print(f"[10 NLMPC headline counted] {c['run_s']:.3f} s, K2 launches "
          f"{c['launches']}, live share a launch min "
          f"{c['live_share']['min']:.4f} median "
          f"{c['live_share']['median']:.4f} mean "
          f"{c['live_share']['mean']:.4f}; useful {c['useful']}, executed "
          f"{c['executed']} thread-trips: waste {c['waste']:.4f}, lap "
          f"records {k2_hash}", flush=True)
    nl_rate = {name: BATCH * LAPS / min(t) for name, t in nl_times.items()}
    for name, label in (("qsort_skip", ""), ("plain", " without qsort_skip")):
        print(f"[10 NLMPC headline{label}] {nl_rate[name]:.1f} lap-sims/s, "
              f"{min(nl_times[name]):.3f} s per batch (runs "
              f"{[round(t, 3) for t in nl_times[name]]}), warm-run "
              f"completion {nl_completion:.4f}, mean lap steps "
              f"{[round(v, 2) for v in nl_steps]}, K2 launches in its "
              f"seed-1 run {nl_launches[name]}, card {card}", flush=True)

    # ---- 10c. the NLMPC headline as bench.py ships it (retile_frac
    # 0.25), and with tail_shrink at two prefixes, in turns against the
    # run without ----
    opts10 = option_turns(
        "10c NLMPC headline",
        lambda solver, **o: hl.nlmpc(1, nl_params, scen, solver, **o), k2q,
        9, {"none": {}, "retile": dict(retile_frac=0.25),
            **{f"tail_{p}": dict(tail_shrink=p) for p in TAIL_PREFIXES}},
        card)

    # ---- 10d. the NLMPC headline through K2 with prox_skip in turns with
    # the simulator's own K2 (qsort_skip): the same lap records, K2's
    # device seconds by CUDA events ----
    k2_prox = build_fused_nlmpc_step(nl_params, nl_limits, 1.0,
                                     prox_skip=True, **nl_sizes)
    timed_q, timed_p = EventTimed(k2q), EventTimed(k2_prox)
    prox10 = variant_turns(
        "10d NLMPC headline", lambda solver: nl_headline(1, solver),
        {"qsort_skip": (timed_q, k2q), "prox_skip": (timed_p, k2_prox)},
        card)
    prox10["qsort_skip"]["k2_device_s"] = timed_q.seconds() / 2
    prox10["prox_skip"]["k2_device_s"] = timed_p.seconds() / 2
    print(f"[10d K2 device seconds a run] qsort_skip "
          f"{prox10['qsort_skip']['k2_device_s']:.4f}, prox_skip "
          f"{prox10['prox_skip']['k2_device_s']:.4f} (CUDA events, the mean "
          f"of two runs each)", flush=True)

    # ---- 10e. zeros_skip at the JAX package's envelope gate
    # (tests/test_behavior_envelope.py:38-70: spaceVarying, f32, B = 128,
    # 2 laps, budget 70, LM cap 12), through K2 on the card with and
    # without it on the same scenarios and draws: the flag changes lanes
    # and utils/envelope.py rejects it ----
    gate_scen = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0,
                                            device=dev), 128, noise_on=True,
        dtype=torch.float32, device=dev)
    gate_runs, zskip_k2 = [], None
    for zs in (False, True):
        kz = build_fused_nlmpc_step(nl_params, nl_limits, 1.0, num_horizon=N,
                                    max_steps=MAX_STEPS, max_laps=8,
                                    max_iters=12, zeros_skip=zs)
        gate_runs.append(simulate_nlmpc_runs_soa(
            nl_params, nl_limits, gate_scen, seed_xs, seed_us, 121, 1.0,
            step_solver=kz, num_laps=2, max_steps=MAX_STEPS, max_laps=8,
            max_lm_iters=12, sim_step_budget=70,
            generator=torch.Generator(device=dev).manual_seed(5)))
        zskip_k2 = kz
    require(zskip_k2.launches > 0, "10e: K2 with zeros_skip not launched")
    zskip_gate = compare_runs(*gate_runs)
    try:
        assert_behavior_envelope(*gate_runs)
        rejected = False
    except AssertionError:
        rejected = True
    zskip_gate.update(rejected=rejected, launches=zskip_k2.launches)
    print(f"[10e zeros_skip envelope gate] {json.dumps(zskip_gate)}; card "
          f"{card}", flush=True)
    require(zskip_gate["frac_lanes_changed"] > 0,
            "10e: zeros_skip changed no lane")
    require(rejected, "10e: the envelope does not reject zeros_skip")

    # ---- 23. the NLMPC headline through K4, the per-candidate path ----
    def nl_path_run(tag, lp, sc, solver, counted, want, all_iter=False):
        """A warm run of the per-candidate path through the candidate
        solver ``solver`` (None: the simulator's default, ``counted``),
        every kernel count set to 0 before it and read after; returns
        (result, seconds, the kernel's launches, steps with active lanes,
        the tap's captures)."""
        with tap_step(batched_nlmpc_soa, "nlmpc_step_reference", 6, want,
                      all_iter=all_iter) as tap:
            zero_counts(k1, k2, k2q, k3, k4, k3p, counted)
            t0 = time.perf_counter()
            res = nl_headline(0, None, lp, sc, solver)
            sec = time.perf_counter() - t0
            launches = counted.launches
        steps = sum(tap.calls.values())
        require(k2.launches == k2q.launches == 0 and steps > 0
                and launches == steps,
                f"{tag}: K4 launched {launches} times on {steps} steps with "
                f"active lanes (one a step)")
        require(bool(torch.isfinite(res.safe_set[0]).all())
                and bool(torch.isfinite(res.safe_set[1]).all()),
                f"{tag}: non-finite NLMPC safe set")
        return res, sec, launches, steps, tap.captured

    k4p = build_fused_lm_shooting(nl_limits, 1.0, num_horizon=N,
                                  max_iters=NL_CAP)
    k4_log = SkipLog(k4p, K4_ATTRS)  # each launch's skip mask
    k4_run, k4_warm_s, k4_launches, k4_steps, k4_captured = nl_path_run(
        "23 NLMPC through K4", nl_params, scen, k4_log, k4p,
        want_capture(NL_CAPTURES))
    k4_hash = lap_records_hash(k4_run)
    k4_completion, k4_se = completion_of(k4_run)
    line = (f"[23 NLMPC through K4 warm] B={BATCH} {k4_warm_s:.2f} s, K4 "
            f"launches {k4_launches} ({k4_steps} steps with active lanes), "
            f"completion {k4_completion:.4f} (standard error {k4_se:.5f}), "
            f"lap records {k4_hash}, phase 10's K2 run {k2_hash}")
    if k4_hash != k2_hash:
        env = assert_behavior_envelope(k2_warm, k4_run)
        require(k4_completion >= NL_COMPLETION_MIN,
                f"K4 path completion {k4_completion} < {NL_COMPLETION_MIN}")
        line += f": differ, within the envelope {json.dumps(env)}"
    print(line, flush=True)
    del k2_warm, k4_run
    require(sorted(k4_captured) == sorted(NL_CAPTURES),
            f"captured {sorted(k4_captured)}")
    k4_caps = check_candidate_steps(
        "23 K4 step", k4_captured,
        lambda *a, **kw: nlmpc_step_reference(nl_params, nl_limits, 1.0, *a,
                                              max_iters=NL_CAP, **kw),
        k4p, 9)
    del k4_captured
    # K4 on the lap-2 capture's candidate lanes against its plain version
    a = k4_caps["calls"][0]
    out = k4p(*a)
    ref, plain_ms = timed_call(lambda: fused_lm_shooting_reference(
        nl_limits, 1.0, *a, num_horizon=N, max_iters=NL_CAP))
    require(all(torch.equal(g, w) for g, w in zip(out, ref)),
            "K4 on the path's inputs: not bitwise equal to the plain solve")
    live = a[4] < 0.5
    trips = lm_feasibility_solve_soa(
        nl_limits, a[3], a[0], a[1], a[2], 1.0, num_horizon=N,
        max_iters=NL_CAP, m_lanes=torch.clamp(a[5].long(), 2, N),
        done0=~live).n_iters
    idx = torch.nonzero(live).flatten()[:SAMPLE_LANES]
    sample = lanes_of(a, idx.cpu(), a[1].shape[-1])
    k4_path = dict(
        launches=k4_launches, ms=cuda_ms(lambda: k4p(*a), 5),
        plain_ms=plain_ms,
        max_abs_err=float((out[0] - ref[0]).abs().max()),
        lanes=a[1].shape[-1], live_lanes=int(live.sum()),
        mean_iters=float(trips[live].double().mean()),
        step_ms=k4_caps["step_ms"], plain_step_ms=k4_caps["plain_step_ms"],
        **bound(solve_ops(lambda max_iters: fused_lm_shooting_reference(
            host_nl_limits, 1.0, *sample, num_horizon=N,
            max_iters=max_iters), "max_iters", len(idx), int(live.sum()),
            float(trips[live].double().sum()) / 2), nbytes(a) + nbytes(out)))
    k4_path["compaction"] = compaction_replay(k4p, a, k4_log.calls, 8)
    del out, ref, k4_caps, k4_log
    print(f"[23 K4 compaction] {json.dumps(k4_path['compaction'])}",
          flush=True)
    times, hashes, k4_dev = [], [], []
    for seed in (1, 2):
        timed_k4 = EventTimed(k4p, K4_ATTRS)
        t0 = time.perf_counter()
        res = nl_headline(seed, None, nl_params, scen, timed_k4)
        times.append(time.perf_counter() - t0)
        k4_dev.append(timed_k4.seconds())
        hashes.append(lap_records_hash(res))
        del res
    k4_path.update(wall_s=min(times), lap_sims_per_s=BATCH * LAPS / min(times),
                   device_s=k4_dev, hash=k4_hash, completion=k4_completion)
    print(f"[23 NLMPC through K4] {k4_path['lap_sims_per_s']:.1f} lap-sims/s, "
          f"{min(times):.3f} s per batch (runs {[round(t, 3) for t in times]},"
          f" K4 device s {[round(t, 3) for t in k4_dev]} by CUDA events, lap "
          f"records {hashes}); lap-2 capture: K4 {k4_path['ms']:.3f} ms a "
          f"call of {k4_path['lanes']} lanes ({k4_path['live_lanes']} live), "
          f"plain {plain_ms:.3f} ms, bound {k4_path['bound_ms']:.4f} ms by "
          f"{k4_path['bound_by']} ({k4_path['mean_iters']:.2f} LM iterations "
          f"a live lane, both starts), the step with K4 "
          f"{k4_path['step_ms']:.3f} ms; {occupancy['k4']['registers']} "
          f"registers, {occupancy['k4']['local_bytes']} bytes of local "
          f"memory, {occupancy['k4']['warps_per_sm']} warps per SM; card "
          f"{card}", flush=True)

    # ---- 15a. timeVarying headline warm run through K2 (captures 13) ----
    tv_params = LmpcParams.make(ss_option="timeVarying")
    k2_tv = batched_nlmpc_soa.default_step_solver(
        tv_params, nl_limits, 1.0, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
        max_iters=NL_CAP)
    require(k2_tv.qsort_skip, "timeVarying K2 without qsort_skip")
    k2_tv_plain = build_fused_nlmpc_step(tv_params, nl_limits, 1.0,
                                         **nl_sizes)
    cap_tv = k2_capture(k2_tv)
    tv_warm, tv_warm_s, tv_launches = warm_run(
        "timeVarying headline", tv_params, scen, cap_tv,
        (k2_tv, k2_tv_plain))
    tv_completion, tv_se = completion_of(tv_warm)
    tv_steps = tv_warm.lap_steps.float().mean(dim=1).tolist()
    print(f"[15 timeVarying headline warm] B={BATCH} {tv_warm_s:.2f} s, K2 "
          f"launches {tv_launches}, completion {tv_completion:.4f} (standard "
          f"error {tv_se:.5f}), mean lap steps "
          f"{[round(v, 2) for v in tv_steps]}, max lap steps "
          f"{tv_warm.lap_steps.amax(dim=1).tolist()}, lap records "
          f"{lap_records_hash(tv_warm)}", flush=True)
    require(tv_completion >= TV_COMPLETION_MIN,
            f"timeVarying lap completion {tv_completion} < "
            f"{TV_COMPLETION_MIN}")
    del tv_warm

    # ---- 13. timeVarying K2 against the plain step, with and without
    # qsort_skip ----
    require(sorted(cap_tv.captured) == sorted(NL_CAPTURES),
            f"captured {sorted(cap_tv.captured)}")
    tv_stats = check_k2("13 K2 timeVarying", k2_tv,
                        {"no_qsort_skip": k2_tv_plain}, cap_tv.captured,
                        *plain_of(tv_params), nsi2=nsi2_of(tv_params))
    tv_prefix = {f"lap{lap}": check_prefix(
        f"13 K2 timeVarying lap {lap}", k2_tv,
        cast(args, torch.float32, keep=(9,)), 9)
        for lap, (step, args) in sorted(cap_tv.captured.items())}
    # ---- 13b. timeVarying K2's prox_skip and zeros_skip on the same
    # captures ----
    tv_var_stats = check_k2_variants(
        "13b", "timeVarying", cap_tv.captured,
        {"plain": k2_tv_plain, "qsort": k2_tv}, tv_params, nl_limits,
        host_nl_limits, counting)
    del cap_tv
    print(f"[13 K2 timeVarying] lap-2 capture {tv_stats['ms']:.3f} ms a step "
          f"with qsort_skip, {tv_stats['no_qsort_skip_ms']:.3f} ms without "
          f"(f32), {occupancy['k2_tv']['registers']} registers, "
          f"{occupancy['k2_tv']['local_bytes']} bytes of local memory, "
          f"{occupancy['k2_tv']['warps_per_sm']} warps per SM", flush=True)

    # ---- 14. zero-noise timeVarying closed loop through K2 ----
    zero_noise("14 timeVarying zero-noise", tv_params, build_fused_nlmpc_step(
        tv_params, nl_limits, 1.0, qsort_skip=True,
        **{**nl_sizes, "max_iters": 60}), HOST_TV_LAPS)

    # ---- 15b. timeVarying headline timed runs ----
    # five runs: the rate of this host-bound run spreads with the host
    tv_rate, tv_rates = timed("15 timeVarying headline", tv_params, scen,
                              k2_tv, BATCH, tv_completion, tv_steps,
                              tv_launches, seeds=(1, 2, 3, 4, 5))
    # ---- 15c. the timeVarying headline through K2 with prox_skip in turns
    # with the simulator's own K2 (qsort_skip), as phase 10d ----
    k2_prox_tv = build_fused_nlmpc_step(tv_params, nl_limits, 1.0,
                                        prox_skip=True, **nl_sizes)
    timed_q, timed_p = EventTimed(k2_tv), EventTimed(k2_prox_tv)
    prox15 = variant_turns(
        "15c timeVarying headline",
        lambda solver: nl_headline(1, solver, tv_params),
        {"qsort_skip": (timed_q, k2_tv), "prox_skip": (timed_p, k2_prox_tv)},
        card)
    prox15["qsort_skip"]["k2_device_s"] = timed_q.seconds() / 2
    prox15["prox_skip"]["k2_device_s"] = timed_p.seconds() / 2
    print(f"[15c K2 device seconds a run] qsort_skip "
          f"{prox15['qsort_skip']['k2_device_s']:.4f}, prox_skip "
          f"{prox15['prox_skip']['k2_device_s']:.4f} (CUDA events, the mean "
          f"of two runs each)", flush=True)

    # ---- 18a. all headline warm run through K2 (captures phase 16) ----
    all_params = LmpcParams.make(all_ss_point=True)
    k2_all = batched_nlmpc_soa.default_step_solver(
        all_params, nl_limits, 1.0, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
        max_iters=NL_CAP)
    require(k2_all.all_rev_skip, "all-mode K2 without all_rev_skip")
    k2_all_fwd = build_fused_nlmpc_step(all_params, nl_limits, 1.0,
                                        **nl_sizes)
    cap_all = k2_capture(k2_all)
    all_warm, all_warm_s, all_launches = warm_run(
        "all headline", all_params, scen_all, cap_all, (k2_all, k2_all_fwd))
    all_completion, all_se = completion_of(all_warm)
    all_steps = all_warm.lap_steps.float().mean(dim=1).tolist()
    print(f"[18 all headline warm] B={ALL_BATCH} {all_warm_s:.2f} s, K2 "
          f"launches {all_launches}, completion {all_completion:.4f} "
          f"(standard error {all_se:.5f}), mean lap steps "
          f"{[round(v, 2) for v in all_steps]}, max lap steps "
          f"{all_warm.lap_steps.amax(dim=1).tolist()}, lap records "
          f"{lap_records_hash(all_warm)}", flush=True)
    require(all_completion >= ALL_COMPLETION_MIN,
            f"all lap completion {all_completion} < {ALL_COMPLETION_MIN}")
    del all_warm

    # ---- 16. K2 all against the plain step; all_rev_skip against the
    # forward scan; then all + all_iter on an all_iter run's inputs ----
    require(sorted(cap_all.captured) == sorted(NL_CAPTURES),
            f"captured {sorted(cap_all.captured)}")
    all_stats = check_k2("16 K2 all", k2_all, {"forward_scan": k2_all_fwd},
                         cap_all.captured, *plain_of(all_params))
    all_prefix = {f"lap{lap}": check_prefix(
        f"16 K2 all lap {lap}", k2_all,
        cast(args, torch.float32, keep=(9,)), 9)
        for lap, (step, args) in sorted(cap_all.captured.items())}
    # ---- 16b. K2 all's zeros_skip builds (with all_rev_skip and the
    # forward scan) on the same captures ----
    all_zskip = check_k2_all_zskip("16b", {
        name: build_fused_nlmpc_step(all_params, nl_limits, 1.0,
                                     zeros_skip=True, **o, **nl_sizes)
        for name, o in (("all_rev_skip", dict(all_rev_skip=True)),
                        ("forward", {}))}, cap_all.captured, all_params,
        nl_limits, counting)
    del cap_all
    print(f"[16 K2 all] lap-2 capture {all_stats['ms']:.3f} ms a step with "
          f"all_rev_skip, {all_stats['forward_scan_ms']:.3f} ms forward "
          f"(f32), {occupancy['k2_all']['registers']} registers, "
          f"{occupancy['k2_all']['warps_per_sm']} warps per SM", flush=True)
    iter_params = LmpcParams.make(all_ss_point=True, all_ss_iter=True)
    k2_iter = batched_nlmpc_soa.default_step_solver(
        iter_params, nl_limits, 1.0, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
        max_iters=NL_CAP)
    cap_iter = k2_capture(k2_iter, all_iter=True)
    iter_run, iter_s, iter_launches = warm_run(
        "all_iter run", iter_params, scen_all, cap_iter, (k2_iter,))
    iter_completion, iter_se = completion_of(iter_run)
    iter_steps = iter_run.lap_steps.float().mean(dim=1).tolist()
    print(f"[16 all_iter run] B={ALL_BATCH} {iter_s:.2f} s "
          f"({ALL_BATCH * LAPS / iter_s:.1f} lap-sims/s), K2 launches "
          f"{iter_launches}, completion {iter_completion:.4f} (standard "
          f"error {iter_se:.5f}), mean lap steps "
          f"{[round(v, 2) for v in iter_steps]}", flush=True)
    del iter_run
    require(sorted(cap_iter.captured) == sorted(NL_CAPTURES),
            f"captured {sorted(cap_iter.captured)}")
    iter_stats = check_k2("16 K2 all_iter", k2_iter, {}, cap_iter.captured,
                          *plain_of(iter_params))
    all_zskip.update(check_k2_all_zskip("16b", {
        "all_iter": build_fused_nlmpc_step(iter_params, nl_limits, 1.0,
                                           zeros_skip=True, **nl_sizes)},
        cap_iter.captured, iter_params, nl_limits, counting))
    del cap_iter

    # ---- 17. zero-noise all + all_iter closed loop through K2 ----
    zero_noise("17 all_iter zero-noise", iter_params, build_fused_nlmpc_step(
        iter_params, nl_limits, 1.0, **{**nl_sizes, "max_iters": 60}),
        HOST_ALL_LAPS)

    # ---- 18b. all headline timed runs ----
    all_rate, _ = timed("18 all headline", all_params, scen_all, k2_all,
                        ALL_BATCH, all_completion, all_steps, all_launches)
    # ---- 18c. as bench.py ships it (retile_frac 0.25), in turns ----
    opts18 = option_turns(
        "18c all headline",
        lambda solver, **o: hl.nlmpc(1, all_params, scen_all, solver, **o),
        k2_all, 9, {"none": {}, "retile": dict(retile_frac=0.25)}, card)

    # ---- 24. the safe set over every stored lap (all_ss_iter without
    # all_ss_point) through K4, the simulator's default backend for it ----
    k4d = batched_nlmpc_soa.default_candidate_solver(
        nl_limits, 1.0, num_horizon=N, max_iters=NL_CAP)
    every = {}
    for mode, host_laps in (("spaceVarying", HOST_NLMPC_LAPS),
                            ("timeVarying", HOST_EVERY_TV_LAPS)):
        tag = f"24 every stored lap {mode}"
        lp = LmpcParams.make(ss_option=mode, all_ss_iter=True)
        log = SkipLog(k4d, K4_ATTRS)  # each launch's skip mask
        res, sec, launches, steps, captured = nl_path_run(
            tag, lp, scen_all, log, k4d,
            lambda lap, i, a: EVERY_CAPTURES.get(lap) == i, all_iter=True)
        p_done, se = completion_of(res)
        live = sum(int((~m).sum()) for m in log.calls)
        rec = dict(launches=launches, steps=steps, warm_s=sec,
                   mean_active_share=live / sum(m.numel() for m in log.calls),
                   completion=p_done, completion_se=se,
                   final_lap_mean=float(res.lap_steps[-1].float().mean()),
                   hash=lap_records_hash(res))
        del res
        t0 = time.perf_counter()
        again = nl_headline(0, None, lp, scen_all)
        rec["wall_s"] = time.perf_counter() - t0
        require(lap_records_hash(again) == rec["hash"],
                f"{tag}: a second seed-0 run differs")
        del again
        print(f"[{tag}] B={ALL_BATCH} completion {p_done:.4f} (standard "
              f"error {se:.5f}), final-lap mean {rec['final_lap_mean']:.2f}, "
              f"wall {rec['wall_s']:.3f} s (warm {sec:.3f} s), K4 launches "
              f"{launches} ({steps} steps with active lanes, "
              f"{rec['mean_active_share']:.4f} of their lanes live), lap "
              f"records {rec['hash']}", flush=True)
        del log
        require(p_done >= EVERY_COMPLETION_MIN[mode],
                f"{tag}: completion {p_done} < {EVERY_COMPLETION_MIN[mode]}")
        require(sorted(captured) == sorted(EVERY_CAPTURES),
                f"{tag}: captured {sorted(captured)}")
        require(int(captured[3][1][7].sum()) >= 3,
                f"{tag}: lap 3 capture with fewer than 3 stored laps")
        caps = check_candidate_steps(
            f"{tag} step", captured,
            lambda *a, lp=lp, **kw: nlmpc_step_reference(
                lp, nl_limits, 1.0, *a, max_iters=NL_CAP, **kw), k4d, 9)
        # K4 on the lap-2 capture's lanes against its plain version
        a = caps["calls"][0]
        require(all(torch.equal(g, w) for g, w in zip(
            k4d(*a), fused_lm_shooting_reference(
                nl_limits, 1.0, *a, num_horizon=N, max_iters=NL_CAP))),
                f"{tag}: K4 on the lap-2 capture's lanes is not bitwise "
                f"equal to the plain solve")
        rec.update(step_ms=caps["step_ms"],
                   plain_step_ms=caps["plain_step_ms"],
                   k4_ms=cuda_ms(lambda: k4d(*a), 5),
                   k4_lanes=a[1].shape[-1],
                   k4_live_lanes=int((a[4] < 0.5).sum()))
        print(f"[{tag} K4] lap-2 capture: {rec['k4_ms']:.3f} ms a call of "
              f"{rec['k4_lanes']} lanes ({rec['k4_live_lanes']} live), "
              f"bitwise equal to the plain solve", flush=True)
        del captured, caps
        with no_plain_solve_on_card():
            zero_noise(f"{tag} zero-noise", lp, None, host_laps)
        every[mode] = rec

    # ---- 21a. the robustness sweep through K1 (captures phases 19) ----
    from ilqr_iterative_tasks_torch.experiments.scenario_sweep import (
        run_sweep)

    def goal_guess(lap, i, a):
        """some active lane's pass-0 guess is not its state: the goal"""
        return bool(((a[1] != a[0]).any(dim=0) & (a[8] < 0.5)).any())

    wants = {"k8_nsi1": lambda lap, i, a: False, "k8_nsi1_sr3": goal_guess}
    sweep, sweep_caps, sweep_k1 = {}, {}, {}
    for tag, k, nsi, sr in SWEEP_CONFIGS:
        wrap = (sweep_capture if tag == "k32_nsi4"
                else lambda kk, w=wants[tag]: Capture(kk, K1_ATTRS, 5, w))
        # the simulator's own K1: at k = 8 / nsi 1 with dedup and
        # qsort_skip, as the JAX sweep builds it
        # (experiments/scenario_sweep.py:78-82), but for a reseeded run,
        # which takes the plain order
        with sweep_step_solver(k, nsi, wrap, device=dev,
                               stall_reseed=sr) as (k1s, cap_s):
            for kk in (k1, k1s, k3, k4):
                kk.launches = 0
            runs = []
            rep = run_sweep(SWEEP_BATCH, SWEEP_LAPS, moving=True,
                            num_ss_points=k, num_ss_iter=nsi,
                            stall_reseed=sr, quiet=True, device=dev,
                            result=runs)
            launches = k1s.launches
        calls = sum(cap_s.calls.values())
        require(launches > 0 and launches == calls,
                f"sweep {tag}: K1 launched {launches} times on {calls} "
                f"steps with active lanes")
        res = runs[0]
        require(bool(torch.isfinite(res.safe_set[0]).all()),
                f"sweep {tag}: non-finite safe set")
        p_done = float(res.lap_done.float().mean())
        se = (p_done * (1 - p_done) / res.lap_done.numel()) ** 0.5
        rep.update(launches=launches, hash=lap_records_hash(res),
                   completion=p_done, completion_se=se)
        sweep[tag], sweep_caps[tag], sweep_k1[tag] = rep, cap_s, k1s
        rep["lane_queue"] = bool(k1s.lane_queue_runs(SWEEP_BATCH))
        rep["kernel"] = (
            "i2lqr_step_lanes_kernel" if rep["lane_queue"] else
            "i2lqr_step_block_kernel" if k == 32 else "i2lqr_step_kernel")
        print(f"[21 sweep {tag}] B={SWEEP_BATCH} K1 {rep['kernel']}, "
              f"completion "
              f"{rep['completion_rate']:.4f} (standard error {se:.5f}), "
              f"final-lap mean {rep['final_lap_mean']}, lap-step p50s "
              f"{rep['lap_steps_p50']}, p95s {rep['lap_steps_p95']}, wall "
              f"{rep['wall_s']} s ({rep['lap_sims_per_s']} lap-sims/s), K1 "
              f"launches {launches}, lap records {rep['hash']}", flush=True)
        del res, runs
    # K1 k32's device seconds over a k32_nsi4 run, from a profiler trace
    k32_prof = dict(zip(("k1_device_s", "busy_s", "host_s"), device_seconds(
        lambda: run_sweep(SWEEP_BATCH, SWEEP_LAPS, moving=True,
                          num_ss_points=32, num_ss_iter=4, quiet=True,
                          device=dev), "i2lqr_step_block_kernel")))
    print(f"[21 sweep k32_nsi4 profiled] K1 k32 {k32_prof['k1_device_s']:.4f}"
          f" s of the card a run; the card busy {k32_prof['busy_s']:.4f} s of "
          f"{k32_prof['host_s']:.3f} s under the profiler", flush=True)
    # the k = 8 sweeps through K1 in the plain order and through the pair's
    # lane queue (a counting build: the queue runs whatever the batch), in
    # turns: the simulator's K1 runs the queue only on a batch that fills
    # the card at one thread a lane, which the sweep's does not
    from ilqr_iterative_tasks_torch.experiments.scenario_sweep import (
        MAX_LAPS as S_LAPS, MAX_STEPS as S_STEPS)
    # ---- 21c. the k32_nsi4 run through K1 at k = 32 that counts (its
    # counting instantiation): the run's waste share; the lap records the
    # run's without counts ----
    k32s = build_fused_i2lqr_step(
        IlqrParams.make(num_ss_points=32, num_ss_iter=4), limits, 1.0,
        num_horizon=N, max_steps=S_STEPS, max_laps=S_LAPS,
        max_iter=SWEEP_CAP, with_stats=True)
    with sweep_step_solver(32, 4, lambda _: k32s, device=dev):
        zero_counts(k1, k3, k4, k32s)
        runs = []
        t0 = time.perf_counter()
        with no_plain_solve_on_card():
            run_sweep(SWEEP_BATCH, SWEEP_LAPS, moving=True, num_ss_points=32,
                      num_ss_iter=4, quiet=True, device=dev, result=runs)
        torch.cuda.synchronize()
        k32_counted = dict(run_s=time.perf_counter() - t0,
                           launches=k32s.launches,
                           **stats_summary(runs[0].iter_stats))
    require(k32_counted["launches"] == sweep["k32_nsi4"]["launches"],
            f"21c: the counting K1 k32 launched {k32_counted['launches']} "
            f"times")
    require(lap_records_hash(runs[0]) == sweep["k32_nsi4"]["hash"],
            "21c: the counting K1 k32 changed the sweep's lap records")
    del runs
    print(f"[21c sweep k32_nsi4 counted] {json.dumps(k32_counted)}: the "
          f"useful trips over the warps' thread-trips "
          f"{k32_counted['useful'] / k32_counted['executed']:.4f}, waste "
          f"share {k32_counted['waste']:.4f}; card {card}", flush=True)
    sweep_ab = {}
    for tag, k, nsi, sr in SWEEP_CONFIGS[:2]:
        p8 = IlqrParams.make(num_ss_points=k, num_ss_iter=nsi)
        arms = {name: build_fused_i2lqr_step(
                    p8, limits, 1.0, num_horizon=N, max_steps=S_STEPS,
                    max_laps=S_LAPS, max_iter=SWEEP_CAP, **opts)
                for name, opts in (("plain", {}), ("lane_queue", dict(
                    dedup=True, qsort_skip=True, with_stats=True)))}
        walls = {name: [] for name in arms}
        for name in ("plain", "lane_queue", "lane_queue", "plain"):
            with sweep_step_solver(k, nsi, lambda _, a=arms[name]: a,
                                   device=dev, stall_reseed=sr):
                runs = []
                t0 = time.perf_counter()
                run_sweep(SWEEP_BATCH, SWEEP_LAPS, moving=True,
                          num_ss_points=k, num_ss_iter=nsi, stall_reseed=sr,
                          quiet=True, device=dev, result=runs)
                torch.cuda.synchronize()
                walls[name].append(time.perf_counter() - t0)
            require(lap_records_hash(runs[0]) == sweep[tag]["hash"],
                    f"sweep {tag} through K1 {name}: lap records changed")
            del runs
        sweep_ab[tag] = walls
        print(f"[21 sweep {tag} A/B] wall s in turns: plain "
              f"{[round(t, 3) for t in walls['plain']]}, dedup + "
              f"qsort_skip in the lane queue "
              f"{[round(t, 3) for t in walls['lane_queue']]} (lap records "
              f"{sweep[tag]['hash']} both)", flush=True)
    base = sweep["k8_nsi1"]
    for tag in ("k8_nsi1_sr3", "k32_nsi4"):
        require(sweep[tag]["completion"] > base["completion"]
                and sweep[tag]["final_lap_mean"] < base["final_lap_mean"],
                f"sweep {tag}: completion {sweep[tag]['completion']} / "
                f"final-lap mean {sweep[tag]['final_lap_mean']} against "
                f"k8_nsi1's {base['completion']} / {base['final_lap_mean']}")
    for tag, rep in sweep.items():
        require(rep["completion"] >= SWEEP_COMPLETION_MIN[tag],
                f"sweep {tag}: completion {rep['completion']} < "
                f"{SWEEP_COMPLETION_MIN[tag]}")

    # ---- 19. K1 at k = 32 against its plain step on the k32_nsi4 run's
    # captures, at nsi 4 and 2; the k = 8 K1 where the guard re-seeds ----
    k32 = sweep_k1["k32_nsi4"]
    p32 = IlqrParams.make(num_ss_points=32, num_ss_iter=4)
    p32_2 = IlqrParams.make(num_ss_points=32, num_ss_iter=2)
    host_p32 = IlqrParams.make(num_ss_points=32, num_ss_iter=4, device="cpu")
    k32_2 = build_fused_i2lqr_step(p32_2, limits, 1.0, num_horizon=N,
                                   max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                                   max_iter=SWEEP_CAP)
    captured = sweep_caps["k32_nsi4"].captured
    require(sorted(captured) == sorted(SWEEP_CAPTURES),
            f"k32 sweep captured {sorted(captured)}")
    k32_stats, k32_solves = dict(max_abs_err=0.0), {}
    for lap, (step, args) in sorted(captured.items()):
        active = args[8] < 0.5
        n_act = int(active.sum())
        require(n_act > 0, f"k32 capture lap {lap}: no active lane")
        last = args[4][int(args[5][-1])]
        short = float((last[active] < 32).double().mean())
        for dtype in (torch.float32, torch.float64):
            a = cast(args, dtype, keep=(8,))
            out = k32(*a)
            trips, cands, cands2 = [], [], []
            ref, plain = timed_call(lambda: i2lqr_step_reference(
                p32, limits, 1.0, *a, max_iter=SWEEP_CAP, trips=trips,
                cands=cands))
            gate, maxd = k1_gate(f"19 K1 k32 lap {lap}", out, ref, active,
                                 dtype)
            a2 = list(a)
            a2[5], a2[6] = a[5][-2:].contiguous(), a[6][-2:].contiguous()
            out2 = k32_2(*a2)
            ref2, plain2 = timed_call(lambda: i2lqr_step_reference(
                p32_2, limits, 1.0, *a2, max_iter=SWEEP_CAP, cands=cands2))
            gate2, maxd2 = k1_gate(f"19 K1 k32 nsi 2 lap {lap}", out2, ref2,
                                   active, dtype)
            line = (f"[19 K1 k32 lap {lap} step {step} {str(dtype)[6:]}] "
                    f"active {n_act} (last stored lap under 32 rows on "
                    f"{short:.3f} of them), lap_ok {a[6].tolist()}: nsi 4 "
                    f"{gate}; nsi 2 {gate2}")
            if dtype == torch.float32:
                # the solves a live lane-step: run on the card (the
                # counting build), and the distinct ones the step needs,
                # each solved once (the final winner at most once more a
                # pass and once at the end)
                solved = k32_distinct(a[5], a[6], cands)
                sol = {}
                for tag, kern, inp, cs in (("nsi4", k32, a, solved), (
                        "nsi2", k32_2, a2, k32_distinct(a2[5], a2[6],
                                                        cands2))):
                    need = sum(int(m.sum()) for m in cs)
                    ran = counted_solves(counting, lambda: kern(*inp))
                    require(need <= ran <= need + 4 * n_act,
                            f"19 K1 k32 {tag} lap {lap}: {ran} solves on "
                            f"the card, {need} needed")
                    sol[tag] = dict(solves=ran / n_act,
                                    distinct=need / n_act)
                k32_solves[f"lap{lap}"] = sol
                k32_stats["max_abs_err"] = max(k32_stats["max_abs_err"],
                                               maxd, maxd2)
                ms = cuda_ms(lambda: k32(*a), 10)
                ms2 = cuda_ms(lambda: k32_2(*a2), 10)
                line += (f"; kernel {ms:.3f} ms (nsi 2 {ms2:.3f}), plain "
                         f"{plain:.3f} ms (nsi 2 {plain2:.3f}) per step; "
                         f"solves a live lane-step on the card "
                         f"{sol['nsi4']['solves']:.2f} (distinct "
                         f"{sol['nsi4']['distinct']:.2f}) against the plain "
                         f"order's {3 * 4 * 32} (nsi 2 "
                         f"{sol['nsi2']['solves']:.2f}, distinct "
                         f"{sol['nsi2']['distinct']:.2f}, of {3 * 2 * 32})")
                if lap == 2:
                    b_all = args[0].shape[-1]
                    idx = torch.nonzero(active).flatten()[:SAMPLE_LANES]
                    sample = lanes_of(a, idx.cpu(), b_all)
                    plain_ops = lambda max_iter: i2lqr_step_reference(
                        host_p32, host_limits, 1.0, *sample,
                        max_iter=max_iter)
                    iters, mean_trips, share = step_iters(trips, active,
                                                          solved)
                    all_iters, _, _ = step_iters(trips, active)
                    bytes_moved = step_bytes(a, out, (2, 3), k32.nsi)
                    every_bound = bound(solve_ops(
                        plain_ops, "max_iter", len(idx), n_act, all_iters),
                        bytes_moved)["bound_ms"]
                    k32_stats.update(ms=ms, plain_ms=plain, nsi2_ms=ms2,
                                     nsi2_plain_ms=plain2,
                                     mean_iters=mean_trips,
                                     **bound(solve_ops(
                                         plain_ops, "max_iter", len(idx),
                                         n_act, iters, share), bytes_moved))
                    line += (f"; bound {k32_stats['bound_ms']:.4f} ms by "
                             f"{k32_stats['bound_by']} over the distinct "
                             f"solves ({share:.4f} of the candidates, "
                             f"{mean_trips:.2f} LM iterations a solve; "
                             f"every candidate {every_bound:.4f})")
            print(line, flush=True)
    # ---- 19b. the counting instantiation at k = 32 against the plain
    # step's counts, integer for integer; both builds over a prefix ----
    k32_count_stats, k32_prefix = dict(max_abs_err=0.0), {}
    for lap, (step, args) in sorted(captured.items()):
        a = cast(args, torch.float32, keep=(8,))
        active = a[8] < 0.5
        out = k32s(*a)
        require(all(torch.equal(g, w) for g, w in zip(out[:4], k32(*a))),
                f"19b K1 k32 lap {lap}: the counting build's outputs differ")
        ref, plain_ms = timed_call(lambda: i2lqr_step_reference(
            p32, limits, 1.0, *a, max_iter=SWEEP_CAP, with_stats=True))
        for g, w, what in zip(out[4:], ref[4:],
                              ("useful", "executed", "queue_floor")):
            require(torch.equal(g, w), f"19b K1 k32 lap {lap}: {what} is "
                    f"not the plain step's")
        ms = cuda_ms(lambda: k32s(*a), 10)
        useful, executed = (float(t.double().sum()) for t in out[4:6])
        n_act = int(active.sum())
        if lap == 2:
            k32_count_stats.update(ms=ms, plain_ms=plain_ms,
                                   k32_ms=k32_stats["ms"])
        k32_count_stats["max_abs_err"] = max(
            k32_count_stats["max_abs_err"], max_abs_err(out[:4], ref[:4]))
        k32_count_stats[f"lap{lap}"] = dict(
            useful_a_live_lane=useful / n_act,
            executed_a_live_lane=executed / n_act,
            useful_over_executed=useful / executed)
        k32_prefix[f"lap{lap}"] = dict(
            plain=check_prefix(f"19b K1 k32 lap {lap}", k32, a, 8, (1024,)),
            with_stats=check_prefix(f"19b K1 k32 with_stats lap {lap}", k32s,
                                    a, 8, (1024,)))
        print(f"[19b K1 k32 with_stats lap {lap} step {step} f32] active "
              f"{n_act}: outputs the plain build's, counts integer for "
              f"integer the plain step's; useful {useful / n_act:.2f}, "
              f"executed {executed / n_act:.2f} thread-trips a live lane "
              f"(useful / executed {useful / executed:.4f}); {ms:.3f} ms a "
              f"step (plain build {cuda_ms(lambda: k32(*a), 10):.3f}, plain "
              f"step {plain_ms:.3f})", flush=True)
    # ---- 19c. K1 at k = 32 with reuse_extract (its REUSE instantiation)
    # on the same captures; 21d. the k32_nsi4 sweep run through it: the
    # lap records phase 21a's ----
    k32_var_stats = check_k1_variants(
        "19c", captured, {"reuse_extract": (dict(reuse_extract=True),
                                            "plain")}, {"plain": k32}, p32,
        limits, host_p32, host_limits, counting, cap=SWEEP_CAP)
    k32_reuse = k1_with(p32, limits, dict(reuse_extract=True),
                        max_iter=SWEEP_CAP)
    with sweep_step_solver(32, 4, lambda kk: k32_reuse, device=dev):
        k32_reuse.launches = 0
        runs = []
        rep_k32 = run_sweep(SWEEP_BATCH, SWEEP_LAPS, moving=True,
                            num_ss_points=32, num_ss_iter=4, quiet=True,
                            device=dev, result=runs)
    k32_reuse_run = dict(launches=k32_reuse.launches,
                         wall_s=rep_k32["wall_s"],
                         hash=lap_records_hash(runs[0]))
    del runs
    require(k32_reuse_run["hash"] == sweep["k32_nsi4"]["hash"],
            "21d: reuse_extract changed the k32_nsi4 run")
    require(k32_reuse.launches > 0, "21d: K1 k32 with reuse_extract was not "
            "launched")
    print(f"[21d sweep k32_nsi4 with reuse_extract] "
          f"{json.dumps(k32_reuse_run)} (phase 21a's {sweep['k32_nsi4']['wall_s']} s, lap records "
          f"{sweep['k32_nsi4']['hash']}); card {card}", flush=True)
    del captured
    print(f"[19 K1 k32] lap-2 capture {k32_stats['ms']:.3f} ms a step at nsi "
          f"4, {k32_stats['nsi2_ms']:.3f} at nsi 2 (f32), "
          f"{occupancy['k1_k32']['registers']} registers, "
          f"{occupancy['k1_k32']['local_bytes']} bytes of local memory, "
          f"{occupancy['k1_k32']['warps_per_sm']} warps per SM, one lane a "
          f"warp; solves a live lane-step on the card and distinct "
          f"{json.dumps(k32_solves)}", flush=True)
    sr_caps = sweep_caps["k8_nsi1_sr3"].captured
    require(len(sr_caps) > 0, "k8_nsi1_sr3: the guard never re-seeded")
    k8s = sweep_k1["k8_nsi1_sr3"]
    for lap, (step, args) in sorted(sr_caps.items()):
        active = args[8] < 0.5
        reseeded = int(((args[1] != args[0]).any(dim=0) & active).sum())
        for dtype in (torch.float32, torch.float64):
            a = cast(args, dtype, keep=(8,))
            gate, _ = k1_gate(f"19 K1 k8 re-seeded lap {lap}", k8s(*a),
                              i2lqr_step_reference(params, limits, 1.0, *a,
                                                   max_iter=SWEEP_CAP),
                              active, dtype)
            print(f"[19 K1 k8 sr3 lap {lap} step {step} {str(dtype)[6:]}] "
                  f"active {int(active.sum())}, guess at the goal "
                  f"{reseeded}: {gate}", flush=True)
    del sr_caps

    # ---- 20. zero-noise closed loop through K1 at k = 32 / nsi = 2 ----
    p20 = IlqrParams.make(num_ss_points=32, num_ss_iter=2,
                          dtype=torch.float64)
    lim20 = SystemLimits.make(dtype=torch.float64)
    scen20 = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0,
                                            dtype=torch.float64), 1024,
        noise_on=False, dtype=torch.float64, device=dev)
    k1_20 = build_fused_i2lqr_step(p20, lim20, 1.0, num_horizon=N,
                                   max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                                   max_iter=150)
    res20 = simulate_learning_runs_soa(
        p20, lim20, scen20, seed_xs, None, 121, 1.0, step_solver=k1_20,
        num_laps=4, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
        solver_max_iter=150)
    steps20 = res20.lap_steps.cpu().numpy()
    laps20 = steps20[:, 0].tolist()
    same20 = bool((steps20 == steps20[:, :1]).all())
    print(f"[20 zero-noise k32 nsi2 f64] B=1024 cap 150 lap steps {laps20}, "
          f"all lanes identical {same20}, all done "
          f"{bool(res20.lap_done.all())}, K1 launches {k1_20.launches}",
          flush=True)
    require(same20 and bool(res20.lap_done.all()),
            "k32 zero-noise lanes differ or not done")
    require(laps20 == HOST_K32_LAPS,
            f"k32 zero-noise laps {laps20} != host {HOST_K32_LAPS}")
    del res20

    # ---- 21b. the guard on the nominal i2LQR headline scenario ----
    scen_nom = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0),
        SWEEP_BATCH, noise_on=True, device=dev)
    nominal = {}
    for sr in (None, 3):
        nominal[sr] = simulate_learning_runs_soa(
            params, limits, scen_nom, seed_xs, None, 121, 1.0,
            generator=torch.Generator(dev).manual_seed(0), num_laps=LAPS,
            max_steps=MAX_STEPS, max_laps=MAX_LAPS, solver_max_iter=CAP,
            stall_reseed=sr)
    env = assert_behavior_envelope(nominal[None], nominal[3])
    print(f"[21 nominal stall_reseed=3] B={SWEEP_BATCH} within the behaviour "
          f"envelope of the run without it: {json.dumps(env)}", flush=True)
    del nominal

    # ---- 25. exact resume on the card: 2 laps, a checkpoint, 2 more ----
    def records(a, b):
        """The lap records of run ``a`` continued by run ``b``."""
        return SimpleNamespace(
            lap_steps=torch.cat([torch.as_tensor(a[0], device=dev),
                                 b.lap_steps]),
            lap_done=torch.cat([torch.as_tensor(a[1], device=dev),
                                b.lap_done]),
            final_x=b.final_x, safe_set=b.safe_set)

    scen_r = SoaScenarios.broadcast(
        np.zeros(4), xcl[-1], Obstacle.make(31.0, -2.0, 8.0, 6.0),
        RESUME_BATCH, noise_on=True, device=dev)
    runs_r = {
        "i2LQR through K1": lambda laps, **kw: simulate_learning_runs_soa(
            params, limits, scen_r, seed_xs, None, 121, 1.0, num_laps=laps,
            max_steps=MAX_STEPS, max_laps=MAX_LAPS, solver_max_iter=CAP,
            **kw),
        "NLMPC through K2": lambda laps, **kw: simulate_nlmpc_runs_soa(
            nl_params, nl_limits, scen_r, seed_xs, seed_us, 121, 1.0,
            num_laps=laps, max_steps=MAX_STEPS, max_laps=MAX_LAPS,
            max_lm_iters=NL_CAP, infeasible_retire=NL_RETIRE, **kw)}
    with tempfile.TemporaryDirectory() as tmp, no_plain_solve_on_card():
        for name, run in runs_r.items():
            gen = lambda seed: torch.Generator(dev).manual_seed(seed)
            whole = run(4, generator=gen(0))
            part = run(2, generator=gen(0))
            path = os.path.join(tmp, "run.npz")
            save_soa_run(path, part)
            ck, steps_r, done_r = load_soa_run(path, device=dev)
            rest = run(2, generator=gen(7), resume_from=ck)
            h_whole = lap_records_hash(whole)
            h_resumed = lap_records_hash(records((steps_r, done_r), rest))
            print(f"[25 resume {name}] B={RESUME_BATCH}: 4 laps "
                  f"{h_whole}, 2 + 2 from a checkpoint {h_resumed}, lap "
                  f"steps {whole.lap_steps.float().mean(dim=1).tolist()}",
                  flush=True)
            require(h_whole == h_resumed and torch.equal(
                rest.final_key, whole.final_key),
                f"resume {name}: the resumed run differs")
            del whole, part, rest

    # ---- 11. K5 against its plain version ----
    di_kw = generic_kwargs(params, limits, max_iter=G_CAP,
                           matrix_Q=np.zeros((4, 4)))
    uni_kw = dict(n=3, m=2, matrix_Q=np.zeros((3, 3)),
                  matrix_R=0.01 * np.eye(2), matrix_Qterminal=30.0 * np.eye(3),
                  u_lower=-1.5 * np.ones(2), u_upper=1.5 * np.ones(2), dt=0.5,
                  num_horizon=8, max_iter=60)
    uni_xt = torch.tensor([2.0, 1.0, 0.5], device=dev)[:, None]
    x0_bike = torch.tensor([0.0, 0.0, 1.0, 0.0], device=dev)[:, None]
    # the lanes of generic_bench --kernel, for K5 and for K3
    kernel_lanes = (x0_bike.expand(4, G_KERNEL_LANES).contiguous(),
                    candidates(G_KERNEL_LANES, np.random.default_rng(0), dev),
                    torch.zeros((6, 2, G_KERNEL_LANES), device=dev))
    bench_kw = generic_kwargs(params, limits, max_iter=G_CAP)
    cases = [
        ("double_integrator", double_integrator, di_kw,
         throughput_inputs(G_LANES, dev)),
        ("unicycle", unicycle, uni_kw,
         (torch.zeros((3, G_LANES), device=dev),
          uni_xt.expand(3, G_LANES).contiguous(),
          torch.full((8, 2, G_LANES), 0.1, device=dev))),
        ("bicycle", kinetic_bicycle, bench_kw, kernel_lanes),
        ("double_integrator --kernel", double_integrator, bench_kw,
         kernel_lanes),
    ]
    k5_stats = {}
    for name, model, kw, inputs in cases:
        k5 = build_fused_generic_ilqr(model, **kw)
        for dtype in (torch.float64, torch.float32):
            a = tuple(t.to(dtype) for t in inputs)
            if dtype == torch.float64:
                a = tuple(t[..., :G_F64_LANES].contiguous() for t in a)
            b = a[1].shape[-1]
            out = k5(*a)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            ref = fused_generic_ilqr_reference(model, *a, **kw)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            for t in out:
                require(bool(torch.isfinite(t.double()).all()),
                        f"K5 {name}: non-finite output")
            dus = (out[0] - ref[0]).abs().amax(dim=(0, 1))
            same_it = out[3] == ref[3]
            tol = 1e-8 if dtype == torch.float64 else 1e-4
            share = float((same_it & (dus <= tol)).double().mean())
            bitwise = float(((dus == 0) & (out[2] == ref[2])
                             & same_it).double().mean())
            err = torch.linalg.norm((out[1] - a[1]).double(), dim=0)
            line = (f"[11 K5 {name} {str(dtype)[6:]}] lanes {b}: equal "
                    f"n_iters and max|dus|<={tol:g} {share:.6f}, equal "
                    f"n_iters {float(same_it.double().mean()):.6f}, bitwise "
                    f"{bitwise:.6f}, max|dus| {float(dus.max()):.3e}, mean "
                    f"n_iters {float(out[3].double().mean()):.2f} (max "
                    f"{int(out[3].max())}), max|x_N - x_term| "
                    f"{float(err.max()):.3e}; plain {plain_ms:.1f} ms")
            require(share >= (0.999 if dtype == torch.float64 else 0.99),
                    f"K5 {name} {dtype}: agreement {share}")
            require(all(torch.equal(g, w) for g, w in zip(out, ref)),
                    f"K5 {name} {dtype}: not bitwise equal to the plain "
                    f"version")
            if name == "unicycle":
                require(float(err.max()) < 0.05,
                        f"K5 unicycle: a lane ends {float(err.max())} away")
            ms = cuda_ms(lambda: k5(*a), 5)
            line += (f", kernel {ms:.3f} ms per call; trips "
                     f"{json.dumps(warp_trips(out[3], kw['max_iter']))}")
            # the --throughput shapes give the kernels line its K5 entry
            if dtype == torch.float32 and name == "double_integrator":
                sample = lanes_of(a, torch.arange(SAMPLE_LANES), b)
                k5_stats = dict(
                    max_abs_err=float(dus[same_it].max()), ms=ms,
                    plain_ms=plain_ms,
                    mean_iters=float(out[3].double().mean()),
                    warp_trips=warp_trips(out[3], G_CAP),
                    **bound(solve_ops(
                        lambda max_iter: fused_generic_ilqr_reference(
                            model, *sample, **{**kw, "max_iter": max_iter}),
                        "max_iter", SAMPLE_LANES, b,
                        float(out[3].double().sum())),
                        nbytes(a) + nbytes(out)))
                line += (f"; bound {k5_stats['bound_ms']:.4f} ms by "
                         f"{k5_stats['bound_by']}")
            print(line, flush=True)
            del out, ref

    # K3 as generic_bench --kernel runs it (cap 150, absent obstacle), on
    # its lanes: the kernels line takes K3's figures from here
    k3g = build_fused_ilqr(params, limits, 1.0, num_horizon=N,
                           max_iter=G_CAP)
    obs_absent = obstacle_to_lanes(Obstacle.absent(device=dev),
                                   G_KERNEL_LANES).contiguous()
    k3_stats = {}
    for dtype in (torch.float64, torch.float32):
        a = tuple(t.to(dtype) for t in (*kernel_lanes, obs_absent))
        if dtype == torch.float64:
            a = tuple(t[..., :G_F64_LANES].contiguous() for t in a)
        b = a[1].shape[-1]
        out = k3g(*a)
        ref, k3_plain_ms = timed_call(lambda: fused_ilqr_reference(
            params, limits, 1.0, *a, num_horizon=N, max_iter=G_CAP))
        for t in out:
            require(bool(torch.isfinite(t).all()), "K3 --kernel: non-finite")
        dus = (out[0] - ref[0]).abs().amax(dim=(0, 1))
        dcost = (out[2] - ref[2]).abs()
        us_share = float((dus <= 1e-6).double().mean())
        cost_share = float((dcost <= 1e-3 * ref[2].abs()).double().mean())
        line = (f"[11 K3 --kernel {str(dtype)[6:]}] lanes {b}: "
                f"max|dus|<=1e-6 {us_share:.6f}, |dcost|<=1e-3|cost| "
                f"{cost_share:.6f}, bitwise us "
                f"{float((dus == 0).double().mean()):.6f}, max|dus| "
                f"{float(dus.max()):.3e}")
        require(all(torch.equal(g, w) for g, w in zip(out, ref)),
                f"K3 --kernel {dtype}: not bitwise equal to the plain solve")
        if dtype == torch.float64:
            require(us_share >= 0.999, "K3 --kernel f64: < 99.9 % agree")
        else:
            require(cost_share >= 0.99, "K3 --kernel f32: < 99 % agree")
            trips = ilqr_solve_soa(params, limits, a[3], a[0], a[1], a[2],
                                   float(params.lamb), 1.0, num_horizon=N,
                                   max_iter=G_CAP).lane_iters
            sample = lanes_of(a, torch.arange(SAMPLE_LANES), b)
            k3_stats = dict(
                max_abs_err=float(dus.max()), ms=cuda_ms(lambda: k3g(*a), 5),
                plain_ms=k3_plain_ms,
                mean_iters=float(trips.double().mean()),
                warp_trips=warp_trips(trips, G_CAP),
                **bound(solve_ops(
                    lambda max_iter: fused_ilqr_reference(
                        host_params, host_limits, 1.0, *sample,
                        num_horizon=N, max_iter=max_iter), "max_iter",
                    SAMPLE_LANES, b, float(trips.double().sum())),
                    nbytes(a) + nbytes(out)))
            line += (f"; kernel {k3_stats['ms']:.3f} ms, plain "
                     f"{k3_stats['plain_ms']:.3f} ms per call; bound "
                     f"{k3_stats['bound_ms']:.4f} ms by "
                     f"{k3_stats['bound_by']} ({k3_stats['mean_iters']:.2f} "
                     f"LM iterations a lane, max {int(trips.max())}; "
                     f"trips {json.dumps(k3_stats['warp_trips'])})")
        print(line, flush=True)
        del out, ref

    # ---- 11b. K5 for a caller's models with three inputs ----
    k5_m3 = {}
    for name, nh in K5_CALLER:
        model, kw, inputs = k5_task(name, nh, G_LANES, dev)
        k5 = build_fused_generic_ilqr(model, **kw)
        for dtype in (torch.float64, torch.float32):
            a = tuple(t.to(dtype) for t in inputs)
            tag = f"11b K5 {name} N{nh} {str(dtype)[6:]}"
            out = k5(*a)
            ref, plain_ms = timed_call(lambda: k5.plain(*a))
            for t in out:
                require(bool(torch.isfinite(t.double()).all()),
                        f"{tag}: non-finite output")
            require(all(torch.equal(g, w) for g, w in zip(out, ref)),
                    f"{tag}: not bitwise equal to the plain version")
            code = 0 if dtype == torch.float32 else 1
            sample = lanes_of(a, torch.arange(SAMPLE_LANES), G_LANES)
            row = dict(
                max_abs_err=max_abs_err(out, ref),
                ms=cuda_ms(lambda: k5(*a), 5), plain_ms=plain_ms,
                mean_iters=float(out[3].double().mean()),
                warp_trips=warp_trips(out[3], kw["max_iter"]),
                **bound(solve_ops(
                    lambda max_iter: fused_generic_ilqr_reference(
                        model, *sample, **{**kw, "max_iter": max_iter}),
                    "max_iter", SAMPLE_LANES, G_LANES,
                    float(out[3].double().sum())), nbytes(a) + nbytes(out),
                    PEAK_F32_OPS if code == 0 else PEAK_F64_OPS),
                **_build.attributes(k5_library(model, nh), "k5_attributes",
                                    code))
            k5_m3[f"{name}_N{nh}_{str(dtype)[6:]}"] = row
            err = torch.linalg.norm((out[1] - a[1]).double(), dim=0)
            print(f"[{tag}] lanes {G_LANES}: bitwise equal to the plain "
                  f"version; kernel {row['ms']:.3f} ms, plain "
                  f"{plain_ms:.1f} ms per call; bound {row['bound_ms']:.4f} "
                  f"ms by {row['bound_by']}; {row['registers']} registers, "
                  f"{row['local_bytes']} B local, {row['warps_per_sm']} "
                  f"warps / SM; mean n_iters {row['mean_iters']:.2f} (max "
                  f"{int(out[3].max())}), max|x_N - x_term| "
                  f"{float(err.max()):.3e}; trips "
                  f"{json.dumps(row['warp_trips'])}", flush=True)
            del out, ref
    # the caller's path: each model's K5 through a wrapper counted from 0,
    # five f32 calls on those lanes
    k5_m3_launches = 0
    for name, nh in K5_CALLER:
        model, kw, inputs = k5_task(name, nh, G_LANES, dev)
        k5 = build_fused_generic_ilqr(model, **kw)
        a = tuple(t.to(torch.float32) for t in inputs)
        for _ in range(5):
            k5(*a)
        torch.cuda.synchronize()
        require(k5.launches == 5, f"11b K5 {name} N{nh}: {k5.launches} "
                                  f"launches, not 5")
        k5_m3_launches += k5.launches
    print(f"[11b K5 m = 3 path] {k5_m3_launches} launches", flush=True)

    # ---- 12. the generic headline through K5 ----
    # each bench builds its own wrappers: their counts start at 0
    thr = bench_throughput(G_LANES, G_CAP, device=dev)
    ker = bench_kernel(G_KERNEL_LANES, G_CAP, device=dev)
    k5_launches = thr["k5_launches"] + ker["k5_launches"]
    k3_path_launches = ker["k3_launches"]
    require(k5_launches > 0, "K5 was not launched by the generic benches")
    print(f"[12 generic --throughput] {json.dumps(thr)}", flush=True)
    print(f"[12 generic --kernel] {json.dumps(ker)}", flush=True)
    print(f"[12 generic headline] double integrator "
          f"{thr['double_integrator_k5_solves_per_s']:.1f} solves/s "
          f"(B={G_LANES}); --kernel: bicycle K5 "
          f"{ker['bicycle_k5_solves_per_s']:.1f}, double integrator K5 "
          f"{ker['double_integrator_k5_solves_per_s']:.1f}, bicycle K3 "
          f"{ker['bicycle_k3_solves_per_s']:.1f} solves/s (B="
          f"{G_KERNEL_LANES}, K5/K3 time {ker['k5_vs_k3_time_ratio']}); K5 "
          f"launches {k5_launches}, card {card}", flush=True)

    host_k3, host_k4 = host_tier(card)
    with tempfile.TemporaryDirectory() as tmp:
        scen_k3, scen_k4 = host_scenarios(card, tmp)
        bench_k1, bench_k3, bench_k4 = host_bench(card, tmp)
    sharded_k1, sharded_k2, meshed_k4 = scale_out(
        card, bench_k1["latency_bench_scaling"]["lap_sims_per_s"])
    new = new_paths(card, cpu_run)
    probes38 = round_probes(card)
    witness.shutdown()
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)

    csrc, tpu = "ilqr_iterative_tasks_torch/csrc/", "ilqr_iterative_tasks_tpu/ops/"
    kernels = [
        dict(name="i2lqr_step (K1)", route="cuda",
             source=csrc + "i2lqr_step.cu",
             replaces=tpu + "pallas_i2lqr_step.py:221",
             launches=k1_launches, max_abs_err=k1_err, ms=k1_ms,
             plain_ms=k1_plain_ms, **k1_bound, **occupancy["k1"],
             latency_bench=bench_k1, sharded=sharded_k1, prefix=k1_prefix,
             tail_shrink=tail6, round_probes_s=probes38),
        # K1 at k = 8 with its options (csrc/i2lqr_step_opts.cu): ms,
        # bound and counts at phase 4b's lap-2 capture, launches in the runs
        # that went through it (phase 6b's counted run in the plain order;
        # the simulator's own K1, the pair, in its timed seed-1 run)
        dict(name="i2lqr_step (K1, with_stats)", route="cuda",
             source=csrc + "i2lqr_step_opts.cu",
             replaces=tpu + "pallas_i2lqr_step.py:221",
             launches=k1_counted["with_stats"]["launches"],
             **k1_opt_stats["with_stats"], **occupancy["k1_opts"],
             headline=k1_counted["with_stats"]),
        dict(name="i2lqr_step (K1, dedup + qsort_skip)", route="cuda",
             source=csrc + "i2lqr_step_opts.cu",
             replaces=tpu + "pallas_i2lqr_step.py:221",
             launches=pair_launches["pair"], **k1_opt_stats["dedup_qsort"],
             **occupancy["k1_lanes"], lap_sims_per_s=pair_rate,
             no_options_lap_sims_per_s=rate,
             headline_counted=k1_counted["dedup_qsort"],
             profiled_run=pair_prof,
             resources_f64=occupancy["k1_lanes_f64"],
             qsort_skip_alone=k1_opt_stats["qsort_skip"],
             dedup_alone=k1_opt_stats["dedup"], sweep_wall_s=sweep_ab),
        dict(name="i2lqr_step (K1, k32 nsi4)", route="cuda",
             source=csrc + "i2lqr_step.cu",
             replaces=tpu + "pallas_i2lqr_step.py:221",
             launches=sweep["k32_nsi4"]["launches"], **k32_stats,
             **occupancy["k1_k32"], profiled_run=k32_prof,
             sweep={tag: {kk: r[kk] for kk in (
                 "completion", "completion_se", "final_lap_mean",
                 "lap_steps_p50", "wall_s", "launches", "hash")}
                 for tag, r in sweep.items()}),
        # K1 at k = 32 that counts (its STATS instantiation): ms and counts
        # at phase 19b's captures, launches in phase 21c's counted run, its
        # bound the plain build's (the same solves)
        dict(name="i2lqr_step (K1, k32 nsi4, with_stats)", route="cuda",
             source=csrc + "i2lqr_step.cu",
             replaces=tpu + "pallas_i2lqr_step.py:221",
             launches=k32_counted["launches"], **k32_count_stats,
             bound_ms=k32_stats["bound_ms"], bound_by=k32_stats["bound_by"],
             library_ms=None, **occupancy["k1_k32_stats"],
             sweep_counted=k32_counted, prefix=k32_prefix),
        # the variants of the options ported last: ms, bound and the
        # counting build's events at the lap-2 capture (phases 4d, 19c),
        # launches in the headline run through each (6d, 21d)
        *[dict(name=f"i2lqr_step (K1, {name})", route="cuda",
               source=csrc + ("i2lqr_step_group.cu" if name.startswith(
                   "group") else "i2lqr_step_opts.cu"),
               replaces=tpu + "pallas_i2lqr_step.py:221",
               launches=k1_var_runs[name]["launches"],
               **k1_var_stats[name], headline=k1_var_runs[name],
               **occupancy[res_key], **extra)
          for name, res_key, extra in (
              ("reuse_extract", "k1_tile_reuse", {}),
              ("pair_reuse_extract", "k1_lanes_reuse",
               dict(profiled_runs=reuse_prof)),
              ("dom_skip", "k1_lanes_dom",
               dict(resources_f64=occupancy["k1_lanes_dom_f64"])),
              ("group2_dedup", "k1_group2", {}),
              ("group4", "k1_group4", {}),
              ("group8", "k1_group8",
               dict(resources_group16_nsi2=occupancy["k1_group16_nsi2"])))],
        dict(name="i2lqr_step (K1, k32 nsi4, reuse_extract)", route="cuda",
             source=csrc + "i2lqr_step.cu",
             replaces=tpu + "pallas_i2lqr_step.py:221",
             launches=k32_reuse_run["launches"],
             **k32_var_stats["reuse_extract"], sweep=k32_reuse_run,
             **occupancy["k1_k32_reuse"]),
        dict(name="nlmpc_step (K2)", route="cuda",
             source=csrc + "nlmpc_step.cu",
             replaces=tpu + "pallas_nlmpc_step.py:245",
             launches=k2_launches, **k2_stats, **occupancy["k2_sv"],
             lap_sims_per_s=nl_rate["qsort_skip"],
             no_qsort_skip_lap_sims_per_s=nl_rate["plain"],
             sharded=sharded_k2, prefix=k2_prefix, options=opts10),
        # K2 spaceVarying with qsort_skip and with_stats: the same solves
        # as K2's (its bound), ms at phase 8's lap-2 capture, launches in
        # phase 10b's counted run
        dict(name="nlmpc_step (K2, with_stats)", route="cuda",
             source=csrc + "nlmpc_step.cu",
             replaces=tpu + "pallas_nlmpc_step.py:245",
             launches=k2_counted["launches"],
             max_abs_err=k2_stats["max_abs_err"],
             ms=k2_stats["with_stats_ms"], plain_ms=k2_stats["plain_ms"],
             bound_ms=k2_stats["bound_ms"], bound_by=k2_stats["bound_by"],
             library_ms=None, headline=k2_counted),
        # K2's prox_skip walker (phases 8e / 10d, 13b / 15c) and zeros_skip
        # (8e, 13b; launches in phase 10e's gate run), its other builds'
        # capture figures beside it
        dict(name="nlmpc_step (K2, prox_skip)", route="cuda",
             source=csrc + "nlmpc_step.cu",
             replaces=tpu + "pallas_nlmpc_step.py:245",
             launches=prox10["prox_skip"]["launches"],
             **k2_var_stats["prox_skip"], headline=prox10,
             **occupancy["k2_prox"]),
        dict(name="nlmpc_step (K2, timeVarying, prox_skip)", route="cuda",
             source=csrc + "nlmpc_step.cu",
             replaces=tpu + "pallas_nlmpc_step.py:245",
             launches=prox15["prox_skip"]["launches"],
             **tv_var_stats["prox_skip"], headline=prox15,
             **occupancy["k2_prox_tv"]),
        dict(name="nlmpc_step (K2, zeros_skip)", route="cuda",
             source=csrc + "nlmpc_step.cu",
             replaces=tpu + "pallas_nlmpc_step.py:245",
             launches=zskip_gate["launches"], **k2_var_stats["zeros_skip"],
             envelope_gate=zskip_gate, **occupancy["k2_zskip"],
             with_qsort_skip=k2_var_stats["qsort_zeros_skip"],
             with_prox_skip=k2_var_stats["prox_zeros_skip"],
             time_varying_qsort_skip=tv_var_stats["qsort_zeros_skip"],
             resources_qsort=occupancy["k2_qsort_zskip"],
             resources_time_varying=occupancy["k2_tv_qsort_zskip"],
             resources_all=occupancy["k2_all_zskip"], mode_all=all_zskip),
        dict(name="nlmpc_step (K2, timeVarying)", route="cuda",
             source=csrc + "nlmpc_step.cu",
             replaces=tpu + "pallas_nlmpc_step.py:245",
             launches=tv_launches, **tv_stats, **occupancy["k2_tv"],
             lap_sims_per_s=tv_rate,
             lap_sims_per_s_runs=tv_rates, prefix=tv_prefix),
        dict(name="nlmpc_step (K2, all)", route="cuda",
             source=csrc + "nlmpc_step_all.cu",
             replaces=tpu + "pallas_nlmpc_step.py:245",
             launches=all_launches, **all_stats, **occupancy["k2_all"],
             lap_sims_per_s=all_rate, prefix=all_prefix, options=opts18,
             all_iter={kk: iter_stats[kk] for kk in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
             | dict(launches=iter_launches)),
        # K3 runs on the generic tier's --kernel path as its yardstick (its
        # figures phase 11's on those lanes) and on the i2LQR simulator's
        # per-candidate path (phase 22: the launches of its run, the rest
        # on the lap-2 capture's pass-0 lanes)
        dict(name="fused_ilqr (K3)", route="cuda",
             source=csrc + "fused_ilqr.cu",
             replaces=tpu + "pallas_ilqr.py:87",
             launches=k3_path_launches, **k3_stats, **occupancy["k3"],
             i2lqr_path=k3_path, host_path=host_k3, scenarios=scen_k3,
             latency_bench=bench_k3),
        # K4's figures are the NLMPC headline's through it (phase 23: the
        # launches of its run, the rest on the lap-2 capture's lanes);
        # phase 7's random lanes and phase 24's every-lap runs beside them
        dict(name="fused_lm_shooting (K4)", route="cuda",
             source=csrc + "fused_lm_shooting.cu",
             replaces=tpu + "pallas_lm_shooting.py:97",
             on_main_path=True, **k4_path, **occupancy["k4"],
             random_lanes=k4_stats, every_stored_lap=every,
             host_path=host_k4, scenarios=scen_k4, latency_bench=bench_k4,
             meshed_controller=meshed_k4),
        # K3 / K4 on the vmap tiers (phases 33-34), the candidate-sharded
        # sweep (35) and under dedup_passes (36)
        dict(name="fused_ilqr (K3, vmap i2LQR tier)", route="cuda",
             source=csrc + "fused_ilqr.cu",
             replaces=tpu + "pallas_ilqr.py:87", **new["vmap_k3"]),
        dict(name="fused_lm_shooting (K4, vmap NLMPC tier)", route="cuda",
             source=csrc + "fused_lm_shooting.cu",
             replaces=tpu + "pallas_lm_shooting.py:97", **new["vmap_k4"]),
        dict(name="fused_ilqr (K3, candidate-sharded sweep)", route="cuda",
             source=csrc + "fused_ilqr.cu",
             replaces=tpu + "pallas_ilqr.py:87", **new["sweep"]),
        dict(name="fused_ilqr (K3, dedup_passes)", route="cuda",
             source=csrc + "fused_ilqr.cu",
             replaces=tpu + "pallas_ilqr.py:87", **new["dedup"],
             batch_probe=new["probe"]),
        dict(name="generic_ilqr (K5)", route="cuda",
             source=csrc + "generic_ilqr.cuh",
             replaces=tpu + "pallas_generic_ilqr.py:64",
             launches=k5_launches, **k5_stats, **occupancy["k5"],
             bicycle=occupancy["k5_bicycle"], build_s=k5_build_s),
        # K5 at m = 3 (phase 11b): the holonomic vehicle's f32 figures at
        # N = 6, every caller run's beside them
        dict(name="generic_ilqr (K5, m = 3)", route="cuda",
             source=csrc + "generic_ilqr.cuh",
             replaces=tpu + "pallas_generic_ilqr.py:64",
             launches=k5_m3_launches, **k5_m3["holonomic_N6_float32"],
             runs=k5_m3),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
