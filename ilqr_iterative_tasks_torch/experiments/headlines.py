"""The headline runs of ``chip_smoke.py`` and what its card checks share
with ``experiments/kernel_ab.py``: the headlines' sizes, the runs
themselves (through the whole-step kernels K1 / K2 or, with a
``candidate_solver``, through the per-candidate path of K3 / K4), the step
solver that captures a kernel's inputs and its rule, the tap that captures
the plain step's inputs on the per-candidate path, the guard that no plain
candidate solve sees a CUDA tensor, K4's random lanes and edge cases,
K1's k = 32 edge-case lanes, the solves a step needs and those its
counting build runs, the library the wrappers launch from,
CUDA-event timing, device seconds from a profiler trace and a hash of a
run's lap records.

The i2LQR headline is bench.py:44-62 (B = 49 152, seed lap + 3 learning
laps, f32, plant noise on, LM cap 16); the NLMPC headlines are
bench.py:109-148 and 207-221 (LM cap 12, ``infeasible_retire`` 8; the
`all` tier at B = 8 192); the robustness sweep is bench.py:250-270 (its
canary's three configurations at B = 4 096, 4 laps, moving obstacle).
Nothing touches the card at import.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ilqr_iterative_tasks_torch.control import batched_soa
from ilqr_iterative_tasks_torch.control.batched_nlmpc_soa import (
    simulate_nlmpc_runs_soa)
from ilqr_iterative_tasks_torch.control.batched_soa import (
    SoaScenarios, _step_solver_inputs, simulate_learning_runs_soa)
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops import _build, fused_generic_ilqr
from ilqr_iterative_tasks_torch.ops.fused_ilqr import obstacle_to_lanes
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits

BATCH, LAPS, MAX_STEPS, MAX_LAPS, CAP, N = 49152, 3, 128, 8, 16, 6
# (learning lap, control step within it) where K1's inputs are captured
CAPTURES = {1: 5, 2: 14, 3: 18}
NL_CAP = 12  # the NLMPC headline's LM cap (bench.py:131)
NL_RETIRE = 8  # infeasible_retire of the NLMPC headline (bench.py:132)
# (learning lap, control step) where K2's inputs are captured; lap 3 is
# taken at its first step with shrunk horizons on >= 1 % of active lanes
# and at least one active lane at horizon 1 (the reach check)
NL_CAPTURES = {1: 5, 2: 14, 3: None}
ALL_BATCH = 8192  # the all tier's batch (bench.py:218-221)
# (learning lap, control step) where the per-candidate step over every
# stored lap (all_ss_iter) is captured: lap 1 early, lap 2 mid, lap 3
# (three stored laps)
EVERY_CAPTURES = {1: 5, 2: 14, 3: 10}
# the robustness canary (bench.py:250-270): batch, laps, LM cap and its
# (tag, k, nsi, stall_reseed) configurations
SWEEP_BATCH, SWEEP_LAPS, SWEEP_CAP = 4096, 4, 16
SWEEP_CONFIGS = (("k8_nsi1", 8, 1, None), ("k8_nsi1_sr3", 8, 1, 3),
                 ("k32_nsi4", 32, 4, None))
# (learning lap, control step) where the k32_nsi4 sweep's K1 inputs are
# captured: by lap 4 most lanes' stored laps are shorter than 32 rows
SWEEP_CAPTURES = {1: 5, 2: 14, 4: 10}
K1_ATTRS = ("k", "nsi", "num_horizon", "max_steps", "max_laps", "max_iter")
K2_ATTRS = ("k", "nsi", "num_horizon", "max_steps", "max_laps", "max_iters",
            "mode", "all_iter")
K3_ATTRS = ("max_iter", "with_skip")  # what the i2LQR simulator reads
K4_ATTRS = ("max_iters", "with_skip", "with_hzn")  # and the NLMPC one
# phase 3's K3 and phase 7's K4 random lanes (chip_smoke.py)
RANDOM_LANES = 8 * BATCH
# K4's edge cases: lanes, the share of them skipped (scattered), the
# horizons hzn drawn from [lo, hi) (clipped to [2, N] by the solve), and
# n: every n-th chunk of 32 lanes all live (0: none), so that a warp's
# queue of live lanes fills past 32
K4_EDGE_CASES = {
    "skip_74": (300, 0.74, (2, N + 1), 0),
    "all_skipped": (300, 1.0, (2, N + 1), 0),
    "none_skipped": (300, 0.0, (2, N + 1), 0),
    "b1": (1, 0.0, (2, N + 1), 0),
    "b33": (33, 0.74, (2, N + 1), 0),
    "b4097": (4097, 0.74, (2, N + 1), 0),
    "hzn_1_to_7": (300, 0.74, (1, N + 2), 0),
    "live_chunks": (600, 0.74, (2, N + 1), 3),
}


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


def lap_records_hash(res) -> str:
    """16 hex digits of a sha256 over a run's lap records: lap steps, done
    flags, final states and the safe set, each float tensor by its bit
    patterns (summed over the stored rows, per lap and lane)."""
    h = hashlib.sha256()
    for t in (res.lap_steps, res.lap_done, res.final_x, *res.safe_set):
        t = t.contiguous()
        if t.is_floating_point():
            t = t.view(torch.int32 if t.element_size() == 4 else torch.int64)
        t = t.to(torch.int64)
        if t.dim() >= 3:
            t = t.sum(dim=1)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def seed_lanes(rng, xcl, b, lo, hi, extra=0):
    """Random candidate lanes near the seed lap: x0 near a seed state and
    x_term extra + [lo, hi) seed rows further on, both jittered; (4, b)."""
    rows = rng.integers(0, 100, b)
    x0 = (xcl[rows] + rng.normal(size=(b, 4)) * [0.5, 0.5, 0.2, 0.05]).T
    xt = (xcl[rows + extra + rng.integers(lo, hi, b)]
          + rng.normal(size=(b, 4)) * [0.3, 0.3, 0.1, 0.02]).T
    return np.ascontiguousarray(x0), np.ascontiguousarray(xt)


def lane_obstacle(rng, b, dev):
    """Per-lane obstacles around (31, -2): static, moving +y, moving -x;
    every 8th absent."""
    opt = np.arange(b) % 3
    return Obstacle(
        x=31.0 + rng.normal(size=b) * 4, y=-2.0 + rng.normal(size=b) * 4,
        width=np.full(b, 8.0), height=np.full(b, 6.0),
        spd=np.where(opt == 0, 0.0, 0.5 + rng.random(b)),
        moving_option=opt.astype(float),
        present=(np.arange(b) % 8 != 7).astype(float)).map(
            lambda a: torch.tensor(a, dtype=torch.float64, device=dev))


def k4_lanes(rng, xcl, skip, dev, hzn_range=(1, N + 1)):
    """K4's inputs (x0, x_term, u_warm, obs, skip, hzn) for the lanes of the
    0/1 numpy mask ``skip``, drawn from ``rng`` in f64: x0 near a seed
    state, x_term hzn + 0..2 seed rows on, hzn from ``hzn_range``, warm
    starts past the input bounds and per-lane obstacles."""
    from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
        obstacle_to_lanes_nlmpc)
    b = len(skip)
    hzn = rng.integers(*hzn_range, b)
    x0, xt = seed_lanes(rng, xcl, b, 0, 3, extra=np.clip(hzn, 0, N))
    obs = obstacle_to_lanes_nlmpc(lane_obstacle(rng, b, dev), b)
    warm = rng.normal(size=(N, 2, b)) * np.array([1.5, 1.0])[None, :, None]
    f = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
    return (f(x0), f(xt), f(warm), obs.contiguous(),
            torch.tensor(skip, dtype=torch.float32, device=dev),
            torch.tensor(hzn, dtype=torch.int32, device=dev))


def random_k4_lanes(dev):
    """Phase 7's K4 lanes (chip_smoke.py): RANDOM_LANES, horizons 1-6, 1/16
    skipped, drawn from numpy's generator of seed 0 after phase 3's K3
    lanes."""
    rng, b = np.random.default_rng(0), RANDOM_LANES
    xcl = seed_trajectory(1.0)[0]
    seed_lanes(rng, xcl, b, 1, 9)  # phase 3's draws
    lane_obstacle(rng, b, dev)
    return k4_lanes(rng, xcl, np.arange(b) % 16 == 5, dev)


def k4_edge_lanes(case, dev, b=None):
    """K4's inputs for ``K4_EDGE_CASES[case]`` (f64; ``b`` lanes in place
    of the case's), from numpy's generator of seed 4."""
    lanes, share, hzn_range, every = K4_EDGE_CASES[case]
    b = lanes if b is None else b
    rng = np.random.default_rng(4)
    skip = np.zeros(b)
    skip[rng.permutation(b)[:round(share * b)]] = 1.0
    if every:
        skip[np.arange(b) // 32 % every == every - 1] = 0.0
    return k4_lanes(rng, seed_trajectory(1.0)[0], skip, dev, hzn_range)


def k1_block_lanes(nsi, lap_count, dev, b=517, t_rows=MAX_STEPS,
                   max_laps=MAX_LAPS):
    """K1's inputs at k = 32 (f64) with every edge case of its schedule:
    four stored laps on a 0.5 grid, x on it too: lap 0 the seed lap, lap 1
    its first 60 rows each stored twice (tied distances), lap 2 every other
    row, lap 3 a lap shorter than k = 32 (the last 24-30 rows of the seed
    lap; every 11th lane 1-7 rows); with lap_count < nsi laps not yet
    stored (lap_ok = 0, their ids clipped to lap 0). Every 7th lane
    skipped; b is not a multiple of anything the kernel holds."""
    rng = np.random.default_rng(40 + nsi + lap_count)
    xcl, _ = seed_trajectory(1.0)
    states = np.zeros((max_laps, t_rows, 4, b))
    states[0, :121] = xcl[:, :, None]
    states[1, :120] = np.repeat(xcl[:60], 2, axis=0)[:, :, None]
    states[2, :61] = xcl[::2, :, None]
    lap_len = np.zeros((max_laps, b), np.int32)
    lap_len[0], lap_len[1], lap_len[2] = 121, 120, 61
    lap_len[3] = rng.integers(24, 31, b)
    lap_len[3, ::11] = rng.integers(1, 8, lap_len[3, ::11].shape)
    for lane in range(b):
        n3 = lap_len[3, lane]
        states[3, :n3, :, lane] = xcl[121 - n3:]
    states = np.round(states * 2) / 2
    t = np.arange(t_rows)[None, :, None]
    qfun = np.maximum(lap_len[:, None, :] - 1.0 - t, 0.0)
    rows = rng.integers(0, 121, b)
    x = np.round((xcl[rows] + rng.normal(size=(b, 4))
                  * [1.0, 1.0, 0.3, 0.05]) * 2) / 2
    f = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
    lap_ids, lap_ok, _ = _step_solver_inputs(lap_count, nsi, max_laps, None,
                                             b, dev)
    skip = (torch.arange(b, device=dev) % 7 == 0).float()
    obs = obstacle_to_lanes(
        Obstacle.make(31.0, -2.0, 8.0, 6.0, spd=0.5, moving_option=1,
                      dtype=torch.float64, device=dev).map(
            lambda v: v.expand(b)), b).contiguous()
    return (f(x.T).contiguous(), f(x.T).contiguous(), f(states), f(qfun),
            torch.tensor(lap_len, device=dev), lap_ids, lap_ok, obs, skip)


def k1_option_lanes(nsi, lap_count, dev, b=128, dtype=torch.float64,
                    t_rows=MAX_STEPS, max_laps=MAX_LAPS):
    """K1's inputs at k = 8 with the edge cases of its schedules (dedup,
    qsort_skip): three stored laps on a 0.5 grid, x on it too: lap 0 the
    seed lap, lap 1 its first 60 rows each stored twice (tied distances),
    lap 2 the last 3-30 rows of the seed lap (every 9th lane 1-7 rows:
    fewer rows than k), Qfun halved and floored on laps 1 and 2 (ties
    within a row of candidates); with lap_count < nsi laps not yet
    stored. Every 7th lane skipped, every 13th far from every stored point
    (nothing within reach in any pass: the slot-0 fallback)."""
    rng = np.random.default_rng(70 + nsi + lap_count)
    xcl, _ = seed_trajectory(1.0)
    states = np.zeros((max_laps, t_rows, 4, b))
    states[0, :121] = xcl[:, :, None]
    states[1, :120] = np.repeat(xcl[:60], 2, axis=0)[:, :, None]
    lap_len = np.zeros((max_laps, b), np.int32)
    lap_len[0], lap_len[1] = 121, 120
    lap_len[2] = rng.integers(3, 31, b)
    lap_len[2, ::9] = rng.integers(1, 8, lap_len[2, ::9].shape)
    for lane in range(b):
        n2 = lap_len[2, lane]
        states[2, :n2, :, lane] = xcl[121 - n2:]
    states = np.round(states * 2) / 2
    t = np.arange(t_rows)[None, :, None]
    qfun = np.maximum(lap_len[:, None, :] - 1.0 - t, 0.0)
    qfun[1:] = np.floor(qfun[1:] / 2)  # ties in Qfun within a lap
    rows = rng.integers(0, 121, b)
    x = np.round((xcl[rows] + rng.normal(size=(b, 4))
                  * [1.0, 1.0, 0.3, 0.05]) * 2) / 2
    x[::13, :2] += 500.0
    f = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    lap_ids, lap_ok, _ = _step_solver_inputs(lap_count, nsi, max_laps, None,
                                             b, dev)
    skip = (torch.arange(b, device=dev) % 7 == 3).float()
    obs = obstacle_to_lanes(
        Obstacle.make(31.0, -2.0, 8.0, 6.0, spd=0.5, moving_option=1,
                      dtype=dtype, device=dev).map(
            lambda v: v.expand(b)), b).contiguous()
    return (f(x.T).contiguous(), f(x.T).contiguous(), f(states), f(qfun),
            torch.tensor(lap_len, device=dev), lap_ids, lap_ok, obs, skip)


def k2_option_lanes(nsi, lap_count, dev, b=128, dtype=torch.float64,
                    t_rows=40, max_laps=4):
    """K2's block-mode inputs (spaceVarying and timeVarying read the same)
    with the edge cases of its schedules and counts: lap_count stored laps
    of the seed lap, the oldest from its start, the others from a row near
    each lane's x0 and 4-40 rows long (some shorter than k = 8); the guess
    row n and the warm start the first n inputs of the newest lap; every
    5th lane a shrunk horizon 1-5, every 7th skipped, the last 8 far off
    (nothing feasible); t 0-7, min_cost the least stored lap length - 1.
    Returns (x, guess, u_warm, states, qfun, lap_len, lap_ids, lap_ok, obs
    (7, B), skip, hzn, t, min_cost)."""
    from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
        obstacle_to_lanes_nlmpc)
    rng = np.random.default_rng(90 + nsi + lap_count)
    xcl, ucl = seed_trajectory(1.0)
    start = rng.integers(0, 80, b)
    length = rng.integers(4, t_rows + 1, b)
    states = np.zeros((max_laps, t_rows, 4, b))
    inputs = np.zeros((max_laps, t_rows, 2, b))
    lap_len = np.zeros((max_laps, b), np.int32)
    for lap in range(lap_count):
        for lane in range(b):
            r = 0 if lap == 0 else start[lane]
            rows = min(length[lane], 120 - r)
            states[lap, :rows, :, lane] = xcl[r:r + rows]
            inputs[lap, :rows, :, lane] = ucl[r:r + rows]
            lap_len[lap, lane] = rows
    t = np.arange(t_rows)[None, :, None]
    qfun = np.maximum(lap_len[:, None, :] - 1.0 - t, 0.0)
    x = (xcl[start] + rng.normal(size=(b, 4)) * [0.2, 0.2, 0.05, 0.02]).T
    x[1, -8:] += 60.0
    lanes = np.arange(b)
    new = lap_count - 1
    guess = states[new, np.minimum(N, lap_len[new] - 1), :, lanes].T
    u_warm = inputs[new, :N].copy()  # (N, 2, B)
    hzn = np.full(b, N, np.int32)
    hzn[::5] = rng.integers(1, N, hzn[::5].shape)
    f = lambda a: torch.tensor(a, dtype=dtype, device=dev).contiguous()
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    lap_ids, lap_ok, _ = _step_solver_inputs(lap_count, nsi, max_laps, None,
                                             b, dev)
    obs = obstacle_to_lanes_nlmpc(
        Obstacle.make(31.0, -2.0, 8.0, 6.0, spd=0.5, moving_option=1,
                      dtype=dtype, device=dev).map(
            lambda v: v.expand(b)), b).contiguous()
    skip = (torch.arange(b, device=dev) % 7 == 3).float()
    min_cost = np.full(b, (lap_len[:lap_count] - 1).min(axis=0), np.int32)
    return (f(x), f(guess), f(u_warm), f(states), f(qfun),
            torch.tensor(lap_len, device=dev), lap_ids, lap_ok, obs, skip,
            i32(hzn), i32(rng.integers(0, 8, b)), i32(min_cost))


def k32_distinct(lap_ids, lap_ok, cands):
    """The candidates whose solves a step at k = 32 needs, from what its
    plain version gave in ``cands`` (``i2lqr_step_reference``'s list: each
    pass's kNN rows, slots that hold a row, winner): per pass a (nsi*k, B)
    bool mask of the slots that hold a row of a lap some stored lap row
    names, at the first lap row of that id, whose (lap, row) no earlier
    pass gave. A solve is a pure function of (x0, row, obstacle), so these
    are every solve the step's costs read (K1 solves each once, and its
    final winner at most once more each pass and once at the end)."""
    ids, oks = [int(v) for v in lap_ids.tolist()], lap_ok.tolist()
    nsi = len(ids)
    first = [ids.index(i) for i in ids]
    need = [any(oks[r] and first[r] == u for r in range(nsi))
            for u in range(nsi)]
    rows = 1 + max(int(idx.max()) for idx, _, _ in cands)
    b = cands[0][0].shape[-1]
    seen = torch.zeros((nsi, rows + 1, b), dtype=torch.bool,
                       device=cands[0][0].device)  # row `rows`: none
    masks = []
    for idx, fin, _ in cands:
        idx, fin = idx.view(nsi, -1, b).long(), fin.view(nsi, -1, b)
        mask = torch.zeros_like(fin)
        for u in range(nsi):
            if first[u] == u and need[u]:
                # a pass's valid slots of a lap hold distinct rows
                mask[u] = fin[u] & ~seen[u].gather(0, idx[u])
                seen[u].scatter_(0, torch.where(mask[u], idx[u], rows),
                                 True)
        masks.append(mask.view(-1, b))
    return masks


# _build.build's defines of a counting library (K1_COUNT_SOLVES,
# csrc/i2lqr_step.cu): K1 at k = 32 counts the solves it runs
K1_COUNT = ("-DK1_COUNT_SOLVES",)


@contextlib.contextmanager
def launching(lib, k5=None):
    """The wrappers launch from ``lib`` inside the block, and K5 from
    ``k5(model, horizon)``'s library where it is given
    (ops/fused_generic_ilqr.py ``k5_library``)."""
    keep, keep_k5 = _build.library, fused_generic_ilqr.k5_library
    _build.library = lambda: lib
    if k5 is not None:
        fused_generic_ilqr.k5_library = k5
    try:
        yield
    finally:
        _build.library, fused_generic_ilqr.k5_library = keep, keep_k5


def counted_solves(lib, fn) -> int:
    """The solves K1 at k = 32 runs on the card in ``fn()``, whose
    wrappers launch from ``lib``, a library built with ``K1_COUNT``."""
    count = lib.i2lqr_step_solves
    count.argtypes, count.restype = [ctypes.c_void_p], ctypes.c_int
    n = ctypes.c_ulonglong()
    torch.cuda.synchronize()
    require(count(ctypes.byref(n)) == 0, "i2lqr_step_solves failed")
    with launching(lib):
        fn()
    torch.cuda.synchronize()
    require(count(ctypes.byref(n)) == 0, "i2lqr_step_solves failed")
    return n.value


class Capture:
    """Step solver that delegates to a whole-step kernel and keeps a copy of
    its inputs where ``want(lap, step, args)`` says so (the simulators only
    see the kernel's attributes). ``lap_arg`` is the position of lap_ids;
    ``all_iter``: lap_ids names every slot, and lap_ok the stored ones."""

    def __init__(self, kernel, attrs, lap_arg, want, all_iter=False):
        self.kernel = kernel
        for a in attrs:
            setattr(self, a, getattr(kernel, a))
        self.lap_arg, self.want, self.iter_rows = lap_arg, want, all_iter
        self.calls = {}
        self.captured = {}

    def __call__(self, *args, **kw):
        if self.iter_rows:  # laps stored - 1
            lap = int(args[self.lap_arg + 1].sum())
        else:
            lap = int(args[self.lap_arg][-1]) + 1  # lap_ids[-1] = laps stored - 1
        i = self.calls.get(lap, 0)
        self.calls[lap] = i + 1
        if lap not in self.captured and self.want(lap, i, args):
            self.captured[lap] = (i, [a.clone() for a in args])
        return self.kernel(*args, **kw)


class LiveShare:
    """A step solver that delegates to a whole-step kernel (K1 or K2,
    every attribute a simulator reads passed through) and keeps each
    launch's live lanes (skip < 0.5, the argument at ``skip_arg``: 8 for
    K1, 9 for K2) as a device tensor, read only by ``shares`` after the
    run, so it adds no host sync inside it."""

    def __init__(self, kernel, skip_arg):
        self.kernel, self.skip_arg, self.live = kernel, skip_arg, []

    def __getattr__(self, name):
        return getattr(self.kernel, name)

    def __call__(self, *args, **kw):
        self.live.append((args[self.skip_arg] < 0.5).sum())
        return self.kernel(*args, **kw)

    def shares(self) -> dict:
        """Each launch's live share (live lanes / B): min, median, mean and
        the launches."""
        b = self.kernel_lanes
        s = torch.stack(self.live).double().cpu() / b
        return dict(min=float(s.min()), median=float(s.median()),
                    mean=float(s.mean()), launches=len(self.live))


def live_share(kernel, skip_arg, lanes):
    """``LiveShare`` of ``kernel`` for launches of ``lanes`` lanes."""
    rec = LiveShare(kernel, skip_arg)
    rec.__dict__["kernel_lanes"] = lanes
    return rec


def stats_summary(iter_stats) -> dict:
    """A run's ``iter_stats`` read as PERF.md reads them: the sums of
    useful and executed trips, the waste share 1 - useful / executed and,
    for K1, the queue floor against the trips executed."""
    sums = [int(t.sum()) for t in iter_stats]
    out = dict(useful=sums[0], executed=sums[1],
               waste=1.0 - sums[0] / max(sums[1], 1))
    if len(sums) > 2:
        out.update(queue_floor=sums[2], floor_over_executed=sums[2]
                   / max(sums[1], 1))
    return out


class Recorder:
    """A candidate solver that delegates to ``kernel`` and keeps the inputs
    of each call."""

    def __init__(self, kernel, attrs):
        self.kernel, self.calls = kernel, []
        for a in attrs:
            setattr(self, a, getattr(kernel, a))

    def __call__(self, *args, **kw):
        self.calls.append(args)
        return self.kernel(*args, **kw)


class LaunchLog:
    """A step solver that delegates to a whole-step kernel (K1 or K2,
    every attribute passed through) and keeps each launch's lanes (B, or
    the prefix a ``tail_shrink`` run launches over), its live lanes (the
    skip mask at ``skip_arg``) and a pair of CUDA events around it; read
    after the run by ``launches``, so it adds no host sync inside it."""

    def __init__(self, kernel, skip_arg):
        self.kernel, self.skip_arg, self.log = kernel, skip_arg, []

    def __getattr__(self, name):
        return getattr(self.kernel, name)

    def __call__(self, *args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self.kernel(*args, **kw)
        end.record()
        b = args[0].shape[-1]
        self.log.append((kw.get("lanes") or b,
                         (args[self.skip_arg] < 0.5).sum(), start, end))
        return out

    def launches(self) -> list:
        """(lanes, live lanes, ms) of each launch, in order."""
        torch.cuda.synchronize()
        return [(n, int(live), s.elapsed_time(e))
                for n, live, s, e in self.log]


def tail_launches(log, base_log) -> dict:
    """A ``tail_shrink`` run's launches over a prefix (LaunchLog.launches)
    beside the launches of the run without it at the same steps (over B;
    where the option changes the run, as the i2LQR simulator's noise,
    steps of the same index, as far as that run has them): their count,
    live lanes, and ms summed and a launch."""
    pre = [i for i, (n, _, _) in enumerate(log[:len(base_log)])
           if n < base_log[i][0]]
    ms = sum(log[i][2] for i in pre)
    ms_b = sum(base_log[i][2] for i in pre)
    return dict(launches=len(log), prefix_launches=len(pre),
                prefix=log[pre[0]][0] if pre else None,
                live_lanes=sum(log[i][1] for i in pre),
                prefix_ms=ms, over_b_ms=ms_b,
                prefix_ms_a_launch=ms / max(len(pre), 1),
                over_b_ms_a_launch=ms_b / max(len(pre), 1))


@contextlib.contextmanager
def tap_step(module, name, lap_arg, want, all_iter=False):
    """Inside the block, the plain step ``module.name`` that a simulator
    calls (the per-candidate path: ``batched_soa.i2lqr_step_reference``,
    lap_ids at ``lap_arg`` 5, or ``batched_nlmpc_soa.nlmpc_step_reference``,
    6) runs through a Capture by the rule ``want``: it counts the steps a
    lap and keeps a copy of the inputs (without params, limits and dt)
    where ``want`` says so. Yields the Capture."""
    step = getattr(module, name)
    cap = Capture(None, (), lap_arg, want, all_iter=all_iter)

    def tapped(params, limits, dt, *args, **kw):
        cap.kernel = lambda *a: step(params, limits, dt, *a, **kw)
        return cap(*args)

    setattr(module, name, tapped)
    try:
        yield cap
    finally:
        setattr(module, name, step)


@contextlib.contextmanager
def no_plain_solve_on_card():
    """Inside the block, the plain candidate solves (``ilqr_solve_soa``,
    ``lm_feasibility_solve_soa``), as the plain steps, the kernels' CPU
    routes and ops/ilqr.py call them, and the host tier's own solves
    (ops/ilqr.py ``ilqr_solve``, ops/lm_shooting.py, ops/al_ilqr.py) raise
    on a CUDA tensor: on the card a simulator's or a host controller's
    candidate solves are K3's or K4's, never a plain version's."""
    from ilqr_iterative_tasks_torch.ops import (
        al_ilqr, fused_ilqr, fused_lm_shooting, i2lqr_step, ilqr,
        lm_shooting, nlmpc_step)
    sites = [(m, "ilqr_solve_soa") for m in (i2lqr_step, fused_ilqr, ilqr)] + [
        (m, "lm_feasibility_solve_soa") for m in (nlmpc_step,
                                                  fused_lm_shooting)] + [
        (ilqr, "ilqr_solve"), (lm_shooting, "_solve_batch"),
        (al_ilqr, "al_ilqr_solve")]
    saved = [getattr(m, name) for m, name in sites]

    def guard(fn, name):
        def guarded(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda
                   for a in (*args, *kw.values())):
                raise AssertionError(f"the plain {name} ran on the card")
            return fn(*args, **kw)
        return guarded

    for (m, name), fn in zip(sites, saved):
        setattr(m, name, guard(fn, name))
    try:
        yield
    finally:
        for (m, name), fn in zip(sites, saved):
            setattr(m, name, fn)


def k1_capture(k1) -> Capture:
    """K1 capturing its inputs at the steps of CAPTURES."""
    return Capture(k1, K1_ATTRS, 5,
                   lambda lap, i, args: CAPTURES.get(lap) == i)


def want_capture(sched):
    """The capture rule of K2's checks: at control step ``sched[lap]`` of a
    lap, or, where that is None, at the lap's first step with shrunk
    horizons on >= 1 % of active lanes and at least one active lane at
    horizon 1 (the reach check)."""
    def want(lap, i, args):
        if sched[lap] is not None:
            return sched[lap] == i
        act = args[9] < 0.5
        shrunk = int((act & (args[10] < N)).sum())
        return (shrunk >= 0.01 * int(act.sum())
                and bool((act & (args[10] <= 1)).any()))
    return want


def k2_capture(k2, all_iter=False) -> Capture:
    """K2 capturing its inputs by the rule of NL_CAPTURES."""
    return Capture(k2, K2_ATTRS, 6, want_capture(NL_CAPTURES),
                   all_iter=all_iter)


def sweep_capture(k1) -> Capture:
    """K1 capturing its inputs at the steps of SWEEP_CAPTURES."""
    return Capture(k1, K1_ATTRS, 5,
                   lambda lap, i, args: SWEEP_CAPTURES.get(lap) == i)


@contextlib.contextmanager
def sweep_step_solver(k, nsi, wrap, device=None):
    """Inside the block, the K1 that ``run_sweep``'s simulator takes for
    (k, nsi) (``default_step_solver``'s) is ``wrap(k1)``, a step solver
    that delegates to it (a Capture); yields (k1, the wrapper)."""
    from ilqr_iterative_tasks_torch.experiments.scenario_sweep import (
        MAX_LAPS as S_LAPS, MAX_STEPS as S_STEPS)
    params = IlqrParams.make(num_ss_points=k, num_ss_iter=nsi, device=device)
    k1 = batched_soa.default_step_solver(
        params, SystemLimits.make(device=device), 1.0, max_steps=S_STEPS,
        max_laps=S_LAPS, max_iter=SWEEP_CAP)
    key = next(kk for kk, v in batched_soa._K1_CACHE.items() if v is k1)
    wrapper = wrap(k1)
    batched_soa._K1_CACHE[key] = wrapper
    try:
        yield k1, wrapper
    finally:
        batched_soa._K1_CACHE[key] = k1


class Headlines:
    """The headline runs on ``dev``: the seed lap, one static obstacle at
    (31, -2, 8, 6), plant noise on; ``scen`` holds BATCH lanes and
    ``scen_all`` ALL_BATCH. Each run ends in a synchronize."""

    def __init__(self, dev):
        self.dev = dev
        self.xcl, ucl = seed_trajectory(1.0)
        self.seed_xs = np.zeros((MAX_STEPS, 4))
        self.seed_xs[:121] = self.xcl
        self.seed_us = np.zeros((MAX_STEPS, 2))
        self.seed_us[:120] = ucl
        self.params, self.limits = (IlqrParams.make(device=dev),
                                    SystemLimits.make(device=dev))
        # the NLMPC solve clips at the raw delta_max: keep it exact in f64
        self.nl_limits = SystemLimits.make(dtype=torch.float64, device=dev)
        self.scen, self.scen_all = (
            SoaScenarios.broadcast(np.zeros(4), self.xcl[-1],
                                   Obstacle.make(31.0, -2.0, 8.0, 6.0,
                                                 device=dev),
                                   b, noise_on=True, device=dev)
            for b in (BATCH, ALL_BATCH))

    def i2lqr(self, seed, solver, candidate_solver=None, **opts):
        """The i2LQR headline through ``solver`` (K1 or one wrapping it) or,
        with ``candidate_solver`` (K3 built with max_iter CAP) and no
        solver, through the per-candidate path; ``opts``: more of the
        simulator's options (``retile_frac``, ``tail_shrink``,
        ``perm_log``)."""
        g = torch.Generator(device=self.dev).manual_seed(seed)
        with no_plain_solve_on_card():
            res = simulate_learning_runs_soa(
                self.params, self.limits, self.scen, self.seed_xs, None, 121,
                1.0, step_solver=solver, candidate_solver=candidate_solver,
                generator=g, num_laps=LAPS, max_steps=MAX_STEPS,
                max_laps=MAX_LAPS, solver_max_iter=CAP, **opts)
        torch.cuda.synchronize(self.dev)
        return res

    def nlmpc(self, seed, lp, sc, solver, candidate_solver=None, **opts):
        """An NLMPC headline of the parameters ``lp`` on the scenarios
        ``sc`` through ``solver`` (K2 or one wrapping it) or, with
        ``candidate_solver`` (K4 built with max_iters NL_CAP) and no solver,
        through the per-candidate path; with neither, through the
        simulator's default backend; ``opts`` as ``i2lqr``'s."""
        g = torch.Generator(device=self.dev).manual_seed(seed)
        with no_plain_solve_on_card():
            res = simulate_nlmpc_runs_soa(
                lp, self.nl_limits, sc, self.seed_xs, self.seed_us, 121, 1.0,
                step_solver=solver, candidate_solver=candidate_solver,
                generator=g, num_laps=LAPS, max_steps=MAX_STEPS,
                max_laps=MAX_LAPS, max_lm_iters=NL_CAP,
                infeasible_retire=NL_RETIRE, **opts)
        torch.cuda.synchronize(self.dev)
        return res
