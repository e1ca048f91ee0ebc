"""The K1, K3, K4 and K5 kernel sources (csrc/i2lqr_step.cu,
csrc/fused_ilqr.cu, csrc/fused_lm_shooting.cu, and csrc/generic_ilqr.cuh
in the translation unit ops/fused_generic_ilqr.py::k5_source writes for
each (model, horizon)) run on the host: g++ builds them against tests/host_cuda/cuda_runtime.h, which
runs every CUDA thread of a launch as a host thread (the lane counter as a
host atomic, a warp's ballots, shuffles and __syncwarp through a barrier
of its 32 threads, a block's shared memory as static storage with one
block at a time), so the lanes refilled from the counter by a grid of one
block of 128 threads are held bit for bit against the plain versions
without a card. The host's
libm stands in for CUDA's, and torch's CPU sin / cos / exp differ from it
in the last bit, so only the double integrator and the 3-D point mass (no
transcendental; the point mass has three inputs, K5's damped-Cholesky
branch) are held against their plain versions; the bicycle, the unicycle,
the holonomic vehicle (three inputs), K3 and K4 are held
against a second build of the same sources on a card of 33 SMs, whose grid
takes every lane of these tests by its index (K4: every chunk of 32
lanes), which shares the host's libm, and K4 against its plain version
where no LM trip runs (a skipped lane's solution is its clipped warm start
or zeros) and by its verdicts. The options ported last (K1
reuse_extract, dom_skip and group, K2 prox_skip and zeros_skip) run each
of their instantiations here too: against their plain versions in f64,
and bit for bit against the same build without the option where the
option is neutral.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from _k5_caller_model import DragCar, task as drag_task

from ilqr_iterative_tasks_torch.experiments.generic_bench import (
    K5_MODELS, generic_kwargs, k5_task, throughput_inputs)
from ilqr_iterative_tasks_torch.experiments.headlines import (
    K4_EDGE_CASES, MAX_LAPS, MAX_STEPS, k1_block_lanes, k1_option_lanes,
    k2_option_lanes, k32_distinct, k4_edge_lanes)
from ilqr_iterative_tasks_torch.models import double_integrator
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops import _build
from ilqr_iterative_tasks_torch.ops.fused_generic_ilqr import (
    build_fused_generic_ilqr, k5_source)
from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
    DTYPE_CODES, build_fused_ilqr, fused_ilqr_reference, obstacle_to_lanes)
from ilqr_iterative_tasks_torch.ops.fused_lm_shooting import (
    build_fused_lm_shooting, fused_lm_shooting_reference)
from ilqr_iterative_tasks_torch.ops.i2lqr_step import (
    build_fused_i2lqr_step, i2lqr_step_reference, queue_floor)
from ilqr_iterative_tasks_torch.ops.nlmpc_step import (
    build_fused_nlmpc_step, nlmpc_step_reference)
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, LmpcParams, SystemLimits)

torch.set_num_threads(1)
SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "host_cuda")
SOURCES = ("fused_ilqr.cu", "fused_lm_shooting.cu")
LAUNCHERS = ("fused_ilqr_launch", "fused_lm_shooting_launch")
# K5's (model, horizon) libraries: those held against a grid of every lane
# (models with an angle), and on one SM also those held against the plain
# version (the double integrator at the horizons of the --throughput and
# k5_task lanes and at N = 5, the point mass)
K5_ANGLE = (("bicycle", 6), ("unicycle", 6), ("unicycle", 8),
            ("holonomic", 3))
K5_PLAIN = (("double_integrator", 5), ("double_integrator", 6),
            ("double_integrator", 10), ("point_mass", 6))
# models of these tests beside generic_bench's (tests/_k5_caller_model.py),
# built on both cards
TEST_MODELS = {"drag_car": DragCar}
K5_CALLER = (("drag_car", 6),)


def _k5_model(name):
    return TEST_MODELS.get(name) or K5_MODELS[name]
MANY_SMS = 33  # 4 224 threads: every lane of these tests by its index
# K1, its blocks one at a time (shared memory), counting each lane's solves
K1_SOURCES = ("i2lqr_step.cu",)
K1_LAUNCHERS = (("i2lqr_step_launch", "i2lqr_step_block_stats_launch",
                 "i2lqr_step_block_reuse_launch"),)
K1_FLAGS = ("-DEMU_SHARED", "-DK1_ON_SOLVE(lane)=emu::count(lane)")
K1_LANES = 33  # lanes of the K1 tests: blocks of 4 or 2, a ragged edge
# K1 at k = 8 with its options and K2 with its counts (with_stats), a
# build of their own
OPT_SOURCES = ("i2lqr_step_opts.cu", "nlmpc_step.cu", "nlmpc_step_all.cu",
               "i2lqr_step_group.cu")
OPT_LAUNCHERS = ("i2lqr_step_opts_launch",
                 ("nlmpc_step_stats_launch", "nlmpc_step_launch"),
                 "nlmpc_step_all_launch", "i2lqr_step_group_launch")
OPT_LANES = 40  # 10 warps of K1 at k = 8, 3 blocks, a ragged edge


def host_source(text: str) -> str:
    """``kernel<<<grid, block, ...>>>(args)`` as a call of the shim's
    ``emu::launcher(kernel, grid, block, ...)(args)``."""
    out, i = [], 0
    while (j := text.find("<<<", i)) >= 0:
        k, depth = j - 1, 0  # back over blanks, the kernel's name and <...>
        while text[k].isspace():
            k -= 1
        while k >= 0 and (depth or text[k].isalnum() or text[k] in "_:<>"):
            depth += {">": 1, "<": -1}.get(text[k], 0)
            k -= 1
        end = text.index(">>>", j)
        out += [text[i:k + 1],
                f"emu::launcher({text[k + 1:j]}, {text[j + 3:end]})"]
        i = end + 3
    return "".join(out + [text[i:]])


def _start_host_build(d, sms, sources=SOURCES, flags=(), k5=()):
    """g++ of ``sources`` and of K5's generated translation unit of each
    (model name, horizon) of ``k5``, as host code, into directory d for a
    card of ``sms`` SMs, one compiler a source, with the extra ``flags``;
    returns (the compilers' processes, the libraries' paths: ``sources``',
    then ``k5``'s)."""
    d.mkdir()
    for name in os.listdir(_build.CSRC_DIR):
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            (d / name).write_text(host_source(f.read()))
    sources = list(sources)
    for name, nh in k5:
        sources.append(f"k5_{name}_{nh}.cu")
        (d / sources[-1]).write_text(k5_source(_k5_model(name), nh))
    procs, sos = [], []
    for src in sources:
        sos.append(str(d / (src + ".so")))
        procs.append(subprocess.Popen(
            ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
             "-fno-gnu-unique", "-shared", "-pthread", "-w",
             f"-DEMU_SMS={sms}", *flags, "-x", "c++", "-I", SHIM, "-o",
             sos[-1], str(d / src)]))
    return procs, sos


class _Lib:
    """The launchers of one build's libraries, by name; ``k5``: K5's
    launcher of each (model, horizon) built."""

    def __init__(self, procs, sos, launchers=LAUNCHERS, k5=()):
        assert all(p.wait() == 0 for p in procs)
        for names, so in zip(launchers, sos):  # a name or names a library
            dll = ctypes.CDLL(so)
            for name in (names,) if isinstance(names, str) else names:
                fn = getattr(dll, name)
                fn.argtypes = _build._ARGTYPES[name]
                setattr(self, name, fn)
        self.emu_count_into = dll.emu_count_into
        self.k5 = {}
        for (name, nh), so in zip(k5, sos[len(launchers):]):
            fn = ctypes.CDLL(so).k5_launch
            fn.argtypes = _build._ARGTYPES["k5_launch"]
            self.k5[_k5_model(name), nh] = fn


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """(the sources on a card of one SM, one block of 128 threads that
    refills; on a card of MANY_SMS, whose grid holds every lane of these
    tests; K1, counting its solves; K1's options kernel and K2 in each
    mode), host builds made at once (the static lane grid of each build is
    its own: -fno-gnu-unique)"""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("host_kernels")
    k5_one, k5_many = K5_PLAIN + K5_ANGLE + K5_CALLER, K5_ANGLE + K5_CALLER
    builds = [_start_host_build(d / "one_sm", 1, k5=k5_one),
              _start_host_build(d / "many_sms", MANY_SMS, k5=k5_many),
              _start_host_build(d / "k1", 1, K1_SOURCES, K1_FLAGS),
              _start_host_build(d / "opts", 1, OPT_SOURCES)]
    return (_Lib(*builds[0], k5=k5_one),
            _Lib(*builds[1], k5=k5_many),
            _Lib(*builds[2], launchers=K1_LAUNCHERS),
            _Lib(*builds[3], launchers=OPT_LAUNCHERS))


@pytest.fixture(scope="module")
def lib(libs):
    return libs[0]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _k3(lib, k3, x0, xt, u, obs, skip=None):
    n, b, dt = k3.num_horizon, xt.shape[-1], xt.dtype
    out = (torch.empty((n, 2, b), dtype=dt), torch.empty((4, b), dtype=dt),
           torch.empty(b, dtype=dt), torch.empty(b, dtype=dt))
    counter = torch.empty(1, dtype=torch.int32)
    assert lib.fused_ilqr_launch(
        DTYPE_CODES[dt], n, k3._consts, k3.max_iter, b, *map(_ptr, (
            x0, xt, u, obs, skip, *out)), None, counter.data_ptr()) == 0
    return out


def _k5(lib, k5, x0, xt, u):
    b, dt = xt.shape[-1], xt.dtype
    out = (torch.empty((k5.num_horizon, k5.m, b), dtype=dt),
           torch.empty((k5.n, b), dtype=dt), torch.empty(b, dtype=dt),
           torch.empty(b, dtype=torch.int32))
    counter = torch.empty(1, dtype=torch.int32)
    assert lib.k5[k5.model, k5.num_horizon](
        DTYPE_CODES[dt], k5._consts, k5.max_iter, b,
        *map(_ptr, (x0, xt, u, *out)), None, counter.data_ptr()) == 0
    return out


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nh", [5, 6, 10])
def test_k5_double_integrator_matches_plain_bitwise(lib, nh, dtype):
    # 300 lanes on one block of 128 threads: threads take several lanes; N
    # = 5 is a horizon no fixed instantiation had
    model, kw, a = k5_task("double_integrator", nh, 300, "cpu")
    a = tuple(t.to(dtype) for t in a)
    k5 = build_fused_generic_ilqr(model, **kw)
    got = _k5(lib, k5, *a)
    _equal(got, k5.plain(*a))
    assert int(got[3].max()) > 2 * int(got[3].min())  # lanes refill unevenly


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_throughput_lanes_match_plain_bitwise(lib, dtype):
    p, lim = IlqrParams.make(device="cpu"), SystemLimits.make(device="cpu")
    k5 = build_fused_generic_ilqr(double_integrator, **generic_kwargs(
        p, lim, max_iter=150, matrix_Q=np.zeros((4, 4))))
    a = tuple(t.to(dtype) for t in throughput_inputs(260, "cpu"))
    got = _k5(lib, k5, *a)
    _equal(got, k5.plain(*a))
    assert int(got[3].min()) == 1 and int(got[3].max()) >= 100


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_point_mass_matches_plain_bitwise(lib, dtype):
    """A caller's model with three inputs (K5's damped-Cholesky solve of
    Quu) and no transcendental, 300 lanes on one block of 128 threads."""
    model, kw, a = k5_task("point_mass", 6, 300, "cpu")
    a = tuple(t.to(dtype) for t in a)
    k5 = build_fused_generic_ilqr(model, **kw)
    got = _k5(lib, k5, *a)
    _equal(got, k5.plain(*a))
    assert int(got[3].max()) > 2 * int(got[3].min())  # lanes refill unevenly


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_caller_model_matches_plain(libs, dtype):
    """The repair pass's caller model (tests/_k5_caller_model.py: a state
    times itself, an input in the angle's row), its generated CUDA_STEP
    unit on 3 lanes: in f64 bit for bit the plain version; in f32, where
    torch's CPU sin / cos (vectorised even on 3 lanes) differ from the
    host libm in the last bit, bit for bit the build on a card of 33 SMs
    and the plain version's trips, with us within 1e-4."""
    lib, many = libs[:2]
    kw, x0, xt, u0 = drag_task(3, 6)
    a = tuple(torch.tensor(v, dtype=dtype) for v in (x0, xt, u0))
    k5 = build_fused_generic_ilqr(DragCar, **kw)
    got, want = _k5(lib, k5, *a), k5.plain(*a)
    assert int(got[3].min()) > 1
    if dtype == torch.float64:
        _equal(got, want)
        return
    _equal(got, _k5(many, k5, *a))
    assert torch.equal(got[3], want[3])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,nh", list(K5_ANGLE))
def test_k5_models_with_an_angle_match_a_grid_of_every_lane(libs, name, nh,
                                                            dtype):
    model, kw, a = k5_task(name, nh, 300, "cpu")
    a = tuple(t.to(dtype) for t in a)
    k5 = build_fused_generic_ilqr(model, **kw)
    _equal(_k5(libs[0], k5, *a), _k5(libs[1], k5, *a))


def _k3_lanes(b, dtype):
    rng = np.random.default_rng(b)
    xcl, _ = seed_trajectory(1.0)
    rows = rng.integers(0, 100, b)
    x0 = (xcl[rows] + rng.normal(size=(b, 4)) * [0.5, 0.5, 0.2, 0.05]).T
    xt = (xcl[rows + rng.integers(1, 9, b)] + rng.normal(size=(b, 4)) * 0.3).T
    obs = obstacle_to_lanes(
        Obstacle.make(31.0, -2.0, 8.0, 6.0, spd=0.5, moving_option=1,
                      dtype=dtype, device="cpu").map(lambda v: v.expand(b)),
        b)
    f = lambda v: torch.tensor(v, dtype=dtype).contiguous()
    return f(x0), f(xt), torch.zeros((6, 2, b), dtype=dtype), obs.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cap", [16, 150])
def test_k3_matches_a_grid_of_every_lane(libs, cap, dtype):
    p, lim = IlqrParams.make(device="cpu"), SystemLimits.make(device="cpu")
    k3 = build_fused_ilqr(p, lim, 1.0, num_horizon=6, max_iter=cap)
    a = _k3_lanes(300, dtype)
    for skip in (None, (torch.arange(300) % 3 == 1).float(), torch.ones(300)):
        _equal(_k3(libs[0], k3, *a, skip), _k3(libs[1], k3, *a, skip))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_every_lane_skipped_matches_plain_bitwise(lib, dtype):
    # no LM trip: the rollout of the initial inputs (its sin and cos are
    # the only transcendentals, and a lane or two take torch's scalar path)
    p, lim = IlqrParams.make(device="cpu"), SystemLimits.make(device="cpu")
    k3 = build_fused_ilqr(p, lim, 1.0, num_horizon=6, max_iter=150)
    a = _k3_lanes(2, dtype)
    a = (a[0], a[1], torch.full_like(a[2], 0.3), a[3])
    skip = torch.ones(2)
    got = _k3(lib, k3, *a, skip)
    _equal(got, fused_ilqr_reference(p, lim, 1.0, *a, skip, num_horizon=6,
                                     max_iter=150))
    assert torch.equal(got[0], a[2])


def _k4(lib, k4, a):
    n, b, dt = k4.num_horizon, a[1].shape[-1], a[1].dtype
    out = (torch.full((n, 2, b), torch.nan, dtype=dt),
           torch.full((4, b), torch.nan, dtype=dt),
           torch.full((b,), torch.nan, dtype=dt),
           torch.full((b,), torch.nan, dtype=dt))
    counter = torch.empty(1, dtype=torch.int32)
    assert lib.fused_lm_shooting_launch(
        DTYPE_CODES[dt], n, k4._consts, k4.max_iters, b, *map(_ptr, (
            *a, *out)), None, counter.data_ptr()) == 0
    for t in out:  # every lane written
        assert bool(torch.isfinite(t).all())
    return out


def _k4_case(case, dtype):
    """K4_EDGE_CASES' lanes, and ``straddle``: 2 x 128 + 19 lanes, those
    from 256 on live, so that the one-block build's last chunk of 32 lanes
    holds live lanes and crosses the end of the lanes"""
    if case == "straddle":
        a = k4_edge_lanes("skip_74", "cpu", b=275)
        a[4][256:] = 0.0
    else:
        a = k4_edge_lanes(case, "cpu")
    return tuple(t.to(dtype) if t.is_floating_point() and i != 4 else t
                 for i, t in enumerate(a))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", [*K4_EDGE_CASES, "straddle"])
def test_k4_lane_queue_matches_a_grid_of_every_lane(libs, case, dtype):
    # one block of 4 warps, live lanes queued from the counter, against
    # warps that each take one chunk by its index
    lim = SystemLimits.make(dtype=torch.float64, device="cpu")
    k4 = build_fused_lm_shooting(lim, 1.0, num_horizon=6, max_iters=12)
    a = _k4_case(case, dtype)
    got = _k4(libs[0], k4, a)
    _equal(got, _k4(libs[1], k4, a))
    want = fused_lm_shooting_reference(lim, 1.0, *a, num_horizon=6,
                                       max_iters=12)
    skipped = a[4] > 0.5
    # a skipped lane runs no LM trip: its clipped warm start or zeros
    assert float((got[0] == want[0]).all(dim=(0, 1))[skipped].double()
                 .mean().nan_to_num(1.0)) >= 0.99
    assert float((got[3] == want[3]).double().mean()) >= 0.97


@pytest.mark.parametrize("nsi,lap_count", [(2, 4), (4, 4), (4, 2), (4, 1)])
def test_k1_at_32_candidates_matches_plain_solving_each_once(libs, nsi,
                                                            lap_count):
    # tied distances, laps of 1-7 and of fewer than 32 rows, laps not yet
    # stored (lap_count < nsi; at 1 every lap id clips to the seed lap),
    # skipped lanes
    k1_lib = libs[2]
    p = IlqrParams.make(num_ss_points=32, num_ss_iter=nsi, device="cpu")
    lim = SystemLimits.make(device="cpu")
    k1 = build_fused_i2lqr_step(p, lim, 1.0, num_horizon=6,
                                max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                                max_iter=16)
    a = k1_block_lanes(nsi, lap_count, "cpu", b=K1_LANES)
    b, dt = K1_LANES, torch.float64
    out = (torch.full((6, 2, b), torch.nan, dtype=dt),
           torch.full((b,), torch.nan, dtype=dt),
           torch.full((b,), -1, dtype=torch.int32),
           torch.full((b,), -1, dtype=torch.int32))
    counts = torch.zeros(b, dtype=torch.int32)
    k1_lib.emu_count_into(ctypes.c_void_p(counts.data_ptr()))
    assert k1_lib.i2lqr_step_launch(
        DTYPE_CODES[dt], 6, 32, nsi, k1._consts, 16, b, MAX_STEPS, MAX_LAPS,
        *map(_ptr, (*a, *out)), None, b) == 0
    k1_lib.emu_count_into(None)
    cands = []
    want = i2lqr_step_reference(p, lim, 1.0, *a, max_iter=16, cands=cands)
    for g, w in zip(out[1:], want[1:]):
        assert torch.equal(g, w)
    # the host's libm stands in for CUDA's: us to the last bits
    torch.testing.assert_close(out[0], want[0], rtol=0, atol=1e-9)
    # each distinct candidate the step needs solved once, the final
    # winner at most once more a pass and once at the end
    active = a[8] < 0.5
    need = sum(m.long().sum(0) for m in k32_distinct(a[5], a[6], cands))
    got = counts.long()
    assert bool(((need <= got) & (got <= need + 4))[active].all())
    assert int(got[~active].abs().sum()) == 0
    assert int(got[active].max()) < 3 * nsi * 32


def _nan_outs(shapes, dt):
    return tuple(torch.full(sh, torch.nan, dtype=dt) if d is None
                 else torch.full(sh, -7, dtype=d) for sh, d in shapes)


@pytest.mark.parametrize("nsi,lap_count,opts,b", [
    (1, 3, 0, OPT_LANES), (1, 3, 1, OPT_LANES), (1, 3, 3, OPT_LANES),
    (1, 3, 4, OPT_LANES), (1, 3, 5, OPT_LANES), (1, 3, 7, OPT_LANES),
    (1, 1, 7, OPT_LANES), (1, 3, 6, OPT_LANES), (2, 3, 1, OPT_LANES),
    (2, 3, 3, OPT_LANES), (2, 1, 3, OPT_LANES), (1, 3, 7, 300)])
def test_k1_options_match_plain(libs, nsi, lap_count, opts, b):
    """K1 at k = 8 with its options (opts: 1 with_stats, 2 dedup, 4
    qsort_skip, the lane queue: one block of 128 threads that takes the
    lanes from the counter, 300 of them refilling) on
    headlines.k1_option_lanes, f64, 40 lanes: the outputs
    are the plain step's (us to the host libm's last bits), the counts
    integer for integer (queue_floor over upass at 32 lanes); without
    options the tile kernel of i2lqr_step.cu gives the same bits."""
    dt = torch.float64
    p = IlqrParams.make(num_ss_iter=nsi, device="cpu", dtype=dt)
    lim = SystemLimits.make(device="cpu", dtype=dt)
    k1 = build_fused_i2lqr_step(p, lim, 1.0, num_horizon=6,
                                max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                                max_iter=8)
    a = k1_option_lanes(nsi, lap_count, "cpu", b=b, dtype=dt)
    out = _nan_outs([((6, 2, b), None), ((b,), None), ((b,), torch.int32),
                     ((b,), torch.int32), ((5, b), torch.int32)], dt)
    counter = torch.empty(1, dtype=torch.int32)
    assert libs[3].i2lqr_step_opts_launch(
        DTYPE_CODES[dt], 6, 8, nsi, opts, k1._consts, 8, b, MAX_STEPS,
        MAX_LAPS, *map(_ptr, (*a, *out[:4])), *map(_ptr, out[4][:3]),
        counter.data_ptr(), None, b) == 0
    want = i2lqr_step_reference(p, lim, 1.0, *a, max_iter=8,
                                dedup=bool(opts & 2),
                                qsort_skip=bool(opts & 4), with_stats=True)
    for g, w in zip(out[1:4], want[1:4]):
        assert torch.equal(g, w)
    torch.testing.assert_close(out[0], want[0], rtol=0, atol=1e-9)
    if opts & 1:
        assert torch.equal(out[4][0], want[4])
        assert torch.equal(queue_floor(out[4][2:], 32), want[6])
        if opts & 4:  # the lane queue's executed: its own invariants
            live = a[8] < 0.5
            assert bool((out[4][1] >= out[4][0]).all())
            assert int(out[4][1][~live].abs().sum()) == 0
        else:
            assert torch.equal(out[4][1], want[5])
    if opts == 0:  # the tile kernel without options
        tile = _nan_outs([((6, 2, b), None), ((b,), None),
                          ((b,), torch.int32), ((b,), torch.int32)], dt)
        assert libs[2].i2lqr_step_launch(
            DTYPE_CODES[dt], 6, 8, nsi, k1._consts, 8, b, MAX_STEPS,
            MAX_LAPS, *map(_ptr, (*a, *tile)), None, b) == 0
        _equal(tile, out[:4])


# The lane queue's schedules: (batch, live share, lanes launched): a batch
# of 19 chunks of 32 on a grid of 4 warps (the counter hands out chunks,
# and a warp's ring fills past 32), a tail with about 1 % of its lanes
# live, scattered over 47 chunks, and a prefix of the first case
K1_QUEUE_CASES = {"chunks": (600, None, 600), "tail": (1500, 0.01, 1500),
                  "prefix": (600, None, 333)}


@pytest.mark.parametrize("case", list(K1_QUEUE_CASES))
def test_k1_lane_queue_matches_plain(libs, case):
    """K1's lane queue (dedup + qsort_skip + with_stats, one block of 128
    threads whose warps take chunks of 32 lanes from the counter) on
    headlines.k1_option_lanes, f64, in K1_QUEUE_CASES: the outputs are the
    plain step's (us to the host libm's last bits), iters_useful and the
    queue floor integer for integer, iters_executed at least useful and 0
    on skipped lanes, and nothing written past the lanes launched."""
    b, live_share, lanes = K1_QUEUE_CASES[case]
    dt = torch.float64
    p = IlqrParams.make(device="cpu", dtype=dt)
    lim = SystemLimits.make(device="cpu", dtype=dt)
    k1 = build_fused_i2lqr_step(p, lim, 1.0, num_horizon=6,
                                max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                                max_iter=8)
    a = list(k1_option_lanes(1, 3, "cpu", b=b, dtype=dt))
    if live_share is not None:
        rng = np.random.default_rng(18)
        a[8] = torch.tensor(rng.random(b) >= live_share, dtype=torch.float32)
    out = _nan_outs([((6, 2, b), None), ((b,), None), ((b,), torch.int32),
                     ((b,), torch.int32), ((5, b), torch.int32)], dt)
    counter = torch.empty(1, dtype=torch.int32)
    assert libs[3].i2lqr_step_opts_launch(
        DTYPE_CODES[dt], 6, 8, 1, 7, k1._consts, 8, b, MAX_STEPS, MAX_LAPS,
        *map(_ptr, (*a, *out[:4])), *map(_ptr, out[4][:3]),
        counter.data_ptr(), None, lanes) == 0
    cut = [t[..., :lanes] if t.dim() and t.shape[-1] == b else t for t in a]
    want = i2lqr_step_reference(p, lim, 1.0, *cut, max_iter=8, dedup=True,
                                qsort_skip=True, with_stats=True)
    got = [t[..., :lanes] for t in out]
    for g, w in zip(got[1:4], want[1:4]):
        assert torch.equal(g, w)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-9)
    live = cut[8] < 0.5
    assert 0 < int(live.sum()) < lanes
    assert torch.equal(got[4][0], want[4])
    assert torch.equal(queue_floor(got[4][2:], 32), want[6])
    assert bool((got[4][1] >= got[4][0]).all())
    assert int(got[4][1][~live].abs().sum()) == 0
    for t in out:  # nothing past the lanes launched
        assert bool(t[..., lanes:].nan_to_num(-7).eq(-7).all())


@pytest.mark.parametrize("mode,nsi,lap_count,qsort", [
    ("spaceVarying", 1, 2, 0), ("spaceVarying", 1, 2, 1),
    ("timeVarying", 1, 2, 0), ("timeVarying", 1, 2, 1),
    ("timeVarying", 1, 1, 1), ("spaceVarying", 2, 2, 0),
    ("spaceVarying", 2, 1, 0), ("timeVarying", 2, 1, 0)])
def test_k2_counts_match_plain(libs, mode, nsi, lap_count, qsort):
    """K2's with_stats build on headlines.k2_option_lanes, f64, 40 lanes:
    iters_useful and iters_executed integer for integer the plain step's;
    the decisions the plain step's, and every output the same build
    without counts gives (the host libm stands in for CUDA's, so the
    solutions are held against the kernel itself)."""
    b, dt, tv = OPT_LANES, torch.float64, int(mode == "timeVarying")
    p = LmpcParams.make(num_ss_iter=nsi, ss_option=mode, device="cpu",
                        dtype=dt)
    lim = SystemLimits.make(device="cpu", dtype=torch.float64)
    a = k2_option_lanes(nsi, lap_count, "cpu", b=b, dtype=dt)
    k2 = build_fused_nlmpc_step(p, lim, 1.0, num_horizon=6,
                                max_steps=a[3].shape[1],
                                max_laps=a[3].shape[0], max_iters=12,
                                qsort_skip=bool(qsort))
    shapes = [((6, 2, b), None), ((b,), None), ((4, b), None),
              ((b,), torch.int32), ((b,), torch.int32), ((b,), None)]
    runs = []
    for stats in (True, False):
        out = _nan_outs(shapes + ([((b,), torch.int32)] * 2 if stats
                                  else []), dt)
        head = (DTYPE_CODES[dt], 6, 8, nsi, tv, qsort, k2._consts, 12, b,
                a[3].shape[1], *map(_ptr, a[:11]),
                _ptr(a[11]) if tv else None, _ptr(a[12]) if tv else None)
        launch = (libs[3].nlmpc_step_stats_launch if stats
                  else libs[3].nlmpc_step_launch)
        assert launch(*head, *map(_ptr, out), None, b) == 0
        runs.append(out)
    _equal(runs[0][:6], runs[1])
    want = nlmpc_step_reference(p, lim, 1.0, *a[:11],
                                *(a[11:] if tv else (None, None)),
                                max_iters=12, qsort_skip=bool(qsort),
                                with_stats=True)
    for i in (1, 3, 4, 5):
        assert torch.equal(runs[0][i], want[i])
    assert torch.equal(runs[0][6], want[6])
    assert torch.equal(runs[0][7], want[7])


@pytest.mark.parametrize("nsi,lap_count,dedup,lanes", [
    (4, 4, 0, K1_LANES), (4, 2, 2, K1_LANES), (2, 4, 2, 30),
    (2, 1, 0, 29)])
def test_k1_at_32_counts_match_plain(libs, nsi, lap_count, dedup, lanes):
    """The counting instantiation of K1 at k = 32 (f64, 33 lanes, of them
    the first ``lanes``; dedup 2 counts as the plain step with dedup):
    its outputs those of the plain instantiation, iters_useful and
    queue_floor (over its upass) the plain step's integer for integer,
    iters_executed the host replay of its schedule
    (``i2lqr_step.block_executed``); past the lanes, nothing written."""
    k1_lib, b, dt = libs[2], K1_LANES, torch.float64
    p = IlqrParams.make(num_ss_points=32, num_ss_iter=nsi, device="cpu")
    lim = SystemLimits.make(device="cpu")
    k1 = build_fused_i2lqr_step(p, lim, 1.0, num_horizon=6,
                                max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                                max_iter=16, dedup=bool(dedup),
                                with_stats=True)
    a = k1_block_lanes(nsi, lap_count, "cpu", b=b)
    shapes = [((6, 2, b), None), ((b,), None), ((b,), torch.int32),
              ((b,), torch.int32)]
    plain_out, out = _nan_outs(shapes, dt), _nan_outs(shapes, dt)
    stats = torch.full((5, b), -7, dtype=torch.int32)
    assert k1_lib.i2lqr_step_launch(
        DTYPE_CODES[dt], 6, 32, nsi, k1._consts, 16, b, MAX_STEPS, MAX_LAPS,
        *map(_ptr, (*a, *plain_out)), None, lanes) == 0
    assert k1_lib.i2lqr_step_block_stats_launch(
        DTYPE_CODES[dt], 6, nsi, dedup, k1._consts, 16, b, MAX_STEPS,
        MAX_LAPS, *map(_ptr, (*a, *out)), *map(_ptr, stats[:3]), None,
        lanes) == 0
    for g, w in zip(out, plain_out):
        assert torch.equal(g.nan_to_num(-7), w.nan_to_num(-7))
        assert bool((g[..., lanes:].nan_to_num(-7) == -7).all())
    want = k1(*a, lanes=lanes)  # the plain step on the first lanes
    for g, w in zip(out[1:], want[1:4]):
        assert torch.equal(g[..., :lanes], w[..., :lanes])
    got = stats[:, :lanes]
    assert torch.equal(got[0], want[4][:lanes])
    assert torch.equal(got[1], want[5][:lanes])
    assert torch.equal(queue_floor(got[2:], 32), want[6][:lanes])
    assert bool((stats[:, lanes:] == -7).all())
    live = a[8][:lanes] < 0.5
    assert int(got[1][~live].abs().sum()) > 0  # a skipped lane's warp solves
    assert int(got[0].sum()) > 0 and int(got[1].sum()) > 0


PREFIX = 21  # lanes of a prefix launch: not a multiple of a tile or warp


def _skip_past(a, at, lanes):
    """The inputs ``a`` with the lanes past ``lanes`` skipped (the skip
    mask at position ``at``): a tail step's, whose lanes past the prefix
    are done."""
    a = list(a)
    a[at] = a[at].clone()
    a[at][lanes:] = 1.0
    return a


def _k1_prefix(libs, kernel, lanes):
    """K1 at k = 8 on headlines.k1_option_lanes (f64, OPT_LANES lanes,
    those past PREFIX skipped): the tile kernel (i2lqr_step.cu), the
    options tile (with_stats and dedup) or the lane queue (with_stats,
    dedup and qsort_skip), launched over the first ``lanes``."""
    b, dt = OPT_LANES, torch.float64
    p = IlqrParams.make(device="cpu", dtype=dt)
    lim = SystemLimits.make(device="cpu", dtype=dt)
    k1 = build_fused_i2lqr_step(p, lim, 1.0, num_horizon=6,
                                max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                                max_iter=8)
    a = _skip_past(k1_option_lanes(1, 3, "cpu", b=b, dtype=dt), 8, PREFIX)
    out = _nan_outs([((6, 2, b), None), ((b,), None), ((b,), torch.int32),
                     ((b,), torch.int32), ((5, b), torch.int32)], dt)
    head = (DTYPE_CODES[dt], 6, 8, 1)
    tail = (k1._consts, 8, b, MAX_STEPS, MAX_LAPS,
            *map(_ptr, (*a, *out[:4])))
    if kernel == "tile":
        rc = libs[2].i2lqr_step_launch(*head, *tail, None, lanes)
    else:
        counter = torch.empty(1, dtype=torch.int32)
        rc = libs[3].i2lqr_step_opts_launch(
            *head, 3 if kernel == "opts" else 7, *tail,
            *map(_ptr, out[4][:3]), counter.data_ptr(), None, lanes)
    assert rc == 0
    return out


def _k2_prefix(libs, kernel, lanes):
    """K2 on headlines.k2_option_lanes (f64, OPT_LANES lanes, nsi 1, two
    stored laps): spaceVarying, timeVarying with qsort_skip, its with_stats
    instantiation, and mode all (all_rev_skip), over the first ``lanes``."""
    b, dt = OPT_LANES, torch.float64
    tv = int(kernel in ("time", "stats"))
    p = LmpcParams.make(ss_option="timeVarying" if tv else "spaceVarying",
                        all_ss_point=kernel == "all", device="cpu", dtype=dt)
    lim = SystemLimits.make(device="cpu", dtype=torch.float64)
    a = _skip_past(k2_option_lanes(1, 2, "cpu", b=b, dtype=dt), 9, PREFIX)
    k2 = build_fused_nlmpc_step(p, lim, 1.0, num_horizon=6,
                                max_steps=a[3].shape[1],
                                max_laps=a[3].shape[0], max_iters=12)
    shapes = [((6, 2, b), None), ((b,), None), ((4, b), None),
              ((b,), torch.int32), ((b,), torch.int32), ((b,), None)]
    if kernel == "all":
        out = _nan_outs(shapes, dt)
        x, _, uw, st, qf, ll, ids, ok, obs, skip, hzn = a[:11]
        assert libs[3].nlmpc_step_all_launch(
            DTYPE_CODES[dt], 6, 1, 1, k2._consts, 12, b, a[3].shape[1],
            *map(_ptr, (x, uw, st, qf, ll, ids, ok, obs, skip, hzn)), None,
            *map(_ptr, out), None, lanes) == 0
        return out
    out = _nan_outs(shapes + ([((b,), torch.int32)] * 2
                              if kernel == "stats" else []), dt)
    head = (DTYPE_CODES[dt], 6, 8, 1, tv, tv, k2._consts, 12, b,
            a[3].shape[1], *map(_ptr, a[:11]), _ptr(a[11]) if tv else None,
            _ptr(a[12]) if tv else None)
    launch = (libs[3].nlmpc_step_stats_launch if kernel == "stats"
              else libs[3].nlmpc_step_launch)
    assert launch(*head, *map(_ptr, out), None, lanes) == 0
    return out


@pytest.mark.parametrize("kernel", ["k1_tile", "k1_opts", "k1_queue",
                                    "k2_space", "k2_time", "k2_stats",
                                    "k2_all"])
def test_prefix_launch_is_the_full_launch_s_first_lanes(libs, kernel):
    """Every K1 and K2 build launched over the first PREFIX lanes of
    full-width arrays (no copy), the lanes past them skipped as in a tail
    step, writes those lanes as a launch over every lane does, bit for
    bit, the warps' counts included, and nothing past them (the wrappers
    give those lanes zeros, as a skipped lane's)."""
    name, which = kernel.split("_")
    run = _k1_prefix if name == "k1" else _k2_prefix
    full, part = run(libs, which, OPT_LANES), run(libs, which, PREFIX)
    for f, g in zip(full, part):
        head = (slice(None),) * (f.dim() - 1) + (slice(0, PREFIX),)
        rest = (slice(None),) * (f.dim() - 1) + (slice(PREFIX, None),)
        if kernel == "k1_queue" and f.dim() == 2 and f.shape[0] == 5:
            # the lane queue's executed: its warps' lanes come from a
            # counter, so only the lanes' own counts hold
            f, g = f[[0, 2, 3, 4]], g[[0, 2, 3, 4]]
        assert torch.equal(f[head].nan_to_num(-7), g[head].nan_to_num(-7))
        assert bool((g[rest].nan_to_num(-7) == -7).all())


# K1's options of the TPU kernel ported last, each kernel variant on
# headlines.k1_option_lanes: (nsi, lap_count, the opts bits of
# i2lqr_step_opts_launch, group)
K1_VARIANTS = {
    "reuse_tile": (1, 3, 8, 1), "reuse_dedup_stats_tile": (2, 3, 11, 1),
    "reuse_queue": (1, 3, 15, 1), "dom_queue": (1, 3, 17, 1),
    "dom_dedup_reuse_queue": (1, 3, 27, 1), "dom_dedup_one_lap": (1, 1, 19, 1),
    "group2_dedup": (1, 3, 2, 2), "group4": (1, 3, 0, 4),
    "group8_dedup_reuse": (1, 3, 10, 8), "group2_nsi2": (2, 3, 0, 2),
    "group8_nsi2_reuse": (2, 3, 8, 8), "group16_nsi2_dedup": (2, 1, 2, 16)}


def _k1_variant(libs, a, nsi, opts, group, b, dt):
    """One launch of a K1 variant (the group kernel where group > 1, else
    the options launcher) on the host: (us, shrink, idx, row, counts)."""
    p = IlqrParams.make(num_ss_iter=nsi, device="cpu", dtype=dt)
    lim = SystemLimits.make(device="cpu", dtype=dt)
    k1 = build_fused_i2lqr_step(p, lim, 1.0, num_horizon=6,
                                max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                                max_iter=8)
    out = _nan_outs([((6, 2, b), None), ((b,), None), ((b,), torch.int32),
                     ((b,), torch.int32), ((5, b), torch.int32)], dt)
    tail = (k1._consts, 8, b, MAX_STEPS, MAX_LAPS,
            *map(_ptr, (*a, *out[:4])))
    if group > 1:
        rc = libs[3].i2lqr_step_group_launch(DTYPE_CODES[dt], 6, 8, nsi,
                                             group, opts, *tail, None, b)
    else:
        counter = torch.empty(1, dtype=torch.int32)
        rc = libs[3].i2lqr_step_opts_launch(
            DTYPE_CODES[dt], 6, 8, nsi, opts, *tail,
            *map(_ptr, out[4][:3]), counter.data_ptr(), None, b)
    assert rc == 0
    return out


@pytest.mark.parametrize("case", list(K1_VARIANTS))
def test_k1_variants_match_plain(libs, case):
    """K1's reuse_extract (opts 8; the tile and the lane queue), dom_skip
    (16, the lane queue in slot order) and group (the group kernel), alone
    and with dedup (2), with_stats (1) and qsort_skip (4), f64, 40 lanes:
    the outputs are the plain version's with the same options (us to the
    host libm's last bits) and the counts integer for integer (the lane
    queue's iters_executed by its invariants); and every output is, bit
    for bit, what the same build gives without the new option: the options
    tile or the lane queue without reuse_extract, the options tile without
    dom_skip's queue, and the tile kernel of i2lqr_step.cu for group."""
    nsi, lap_count, opts, group = K1_VARIANTS[case]
    b, dt = OPT_LANES, torch.float64
    p = IlqrParams.make(num_ss_iter=nsi, device="cpu", dtype=dt)
    lim = SystemLimits.make(device="cpu", dtype=dt)
    a = k1_option_lanes(nsi, lap_count, "cpu", b=b, dtype=dt)
    out = _k1_variant(libs, a, nsi, opts, group, b, dt)
    kw = dict(dedup=bool(opts & 2), qsort_skip=bool(opts & 4),
              reuse_extract=bool(opts & 8), dom_skip=bool(opts & 16),
              group=group)
    want = i2lqr_step_reference(p, lim, 1.0, *a, max_iter=8,
                                with_stats=group == 1, **kw)
    for g, w in zip(out[1:4], want[1:4]):
        assert torch.equal(g, w)
    torch.testing.assert_close(out[0], want[0], rtol=0, atol=1e-9)
    if opts & 1:
        assert torch.equal(out[4][0], want[4])
        assert torch.equal(queue_floor(out[4][2:], 32), want[6])
        if opts & 20:  # the lane queue's executed: its own invariants
            live = a[8] < 0.5
            assert bool((out[4][1] >= out[4][0]).all())
            assert int(out[4][1][~live].abs().sum()) == 0
        else:
            assert torch.equal(out[4][1], want[5])
    if group > 1:  # the tile kernel without options
        off = _nan_outs([((6, 2, b), None), ((b,), None),
                         ((b,), torch.int32), ((b,), torch.int32)], dt)
        k1 = build_fused_i2lqr_step(p, lim, 1.0, num_horizon=6,
                                    max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                                    max_iter=8)
        assert libs[2].i2lqr_step_launch(
            DTYPE_CODES[dt], 6, 8, nsi, k1._consts, 8, b, MAX_STEPS,
            MAX_LAPS, *map(_ptr, (*a, *off)), None, b) == 0
        _equal(out[:4], off)
    else:  # the option off: reuse_extract's bit cleared, dom_skip's queue
        # the options tile (the same bits, other counts)
        off = _k1_variant(libs, a, nsi, opts & ~8 if opts & 8 else
                          opts & ~16, 1, b, dt)
        _equal(out[:4], off[:4])
        if opts & 8 and opts & 1:  # reuse_extract keeps the counts
            assert torch.equal(out[4][0], off[4][0])
            assert torch.equal(out[4][2:], off[4][2:])


@pytest.mark.parametrize("nsi,lap_count", [(4, 4), (2, 1)])
def test_k1_at_32_reuse_matches_plain(libs, nsi, lap_count):
    """The k = 32 block kernel's reuse_extract instantiations (f64, 33
    lanes), with and without counts: every output bit for bit the kernel's
    without it, the counts integer for integer, and the decisions the
    plain version's."""
    k1_lib, dt, b = libs[2], torch.float64, K1_LANES
    p = IlqrParams.make(num_ss_points=32, num_ss_iter=nsi, device="cpu")
    lim = SystemLimits.make(device="cpu")
    k1 = build_fused_i2lqr_step(p, lim, 1.0, num_horizon=6,
                                max_steps=MAX_STEPS, max_laps=MAX_LAPS,
                                max_iter=16)
    a = k1_block_lanes(nsi, lap_count, "cpu", b=b)
    shapes = [((6, 2, b), None), ((b,), None), ((b,), torch.int32),
              ((b,), torch.int32)]
    runs = []
    for launch in (k1_lib.i2lqr_step_launch,
                   k1_lib.i2lqr_step_block_reuse_launch):
        out = _nan_outs(shapes, dt)
        head = (DTYPE_CODES[dt], 6, 32, nsi)
        if launch is k1_lib.i2lqr_step_block_reuse_launch:
            head = (DTYPE_CODES[dt], 6, nsi)
        assert launch(*head, k1._consts, 16, b, MAX_STEPS, MAX_LAPS,
                      *map(_ptr, (*a, *out)), None, b) == 0
        runs.append(out)
    _equal(runs[1], runs[0])
    counted = []
    for opts in (2, 10):
        out = _nan_outs(shapes + [((5, b), torch.int32)], dt)
        assert k1_lib.i2lqr_step_block_stats_launch(
            DTYPE_CODES[dt], 6, nsi, opts, k1._consts, 16, b, MAX_STEPS,
            MAX_LAPS, *map(_ptr, (*a, *out[:4])), *map(_ptr, out[4][:3]),
            None, b) == 0
        counted.append(out)
    _equal(counted[1], counted[0])
    _equal(counted[1][:4], runs[0])
    want = i2lqr_step_reference(p, lim, 1.0, *a, max_iter=16,
                                reuse_extract=True)
    for g, w in zip(runs[1][1:], want[1:]):
        assert torch.equal(g, w)


# K2's options of the TPU kernel ported last, each kernel variant on
# headlines.k2_option_lanes: (mode, lap_count, the opts bits of
# nlmpc_step_launch: 1 qsort_skip, 2 prox_skip, 4 zeros_skip; with_stats)
K2_VARIANTS = {
    "prox_space": ("spaceVarying", 2, 2, False),
    "prox_time": ("timeVarying", 2, 2, False),
    "prox_space_one_lap": ("spaceVarying", 1, 2, False),
    "zskip_space": ("spaceVarying", 2, 4, False),
    "zskip_time_qsort_stats": ("timeVarying", 2, 5, True),
    "zskip_prox_space": ("spaceVarying", 2, 6, False),
    "zskip_all_rev": ("all", 2, 4 | 1, False)}


def _k2_variant(libs, mode, a, opts, stats, b, dt):
    """One launch of a K2 variant on the host: its outputs (and counts)."""
    tv = int(mode == "timeVarying")
    p = LmpcParams.make(ss_option=mode, all_ss_point=mode == "all",
                        device="cpu", dtype=dt)
    lim = SystemLimits.make(device="cpu", dtype=torch.float64)
    k2 = build_fused_nlmpc_step(p, lim, 1.0, num_horizon=6,
                                max_steps=a[3].shape[1],
                                max_laps=a[3].shape[0], max_iters=12)
    shapes = [((6, 2, b), None), ((b,), None), ((4, b), None),
              ((b,), torch.int32), ((b,), torch.int32), ((b,), None)]
    out = _nan_outs(shapes + ([((b,), torch.int32)] * 2 if stats else []),
                    dt)
    if mode == "all":
        x, _, uw, st, qf, ll, ids, ok, obs, skip, hzn = a[:11]
        assert libs[3].nlmpc_step_all_launch(
            DTYPE_CODES[dt], 6, 1, opts, k2._consts, 12, b, a[3].shape[1],
            *map(_ptr, (x, uw, st, qf, ll, ids, ok, obs, skip, hzn)), None,
            *map(_ptr, out), None, b) == 0
        return out
    head = (DTYPE_CODES[dt], 6, 8, 1, tv, opts, k2._consts, 12, b,
            a[3].shape[1], *map(_ptr, a[:11]), _ptr(a[11]) if tv else None,
            _ptr(a[12]) if tv else None)
    launch = (libs[3].nlmpc_step_stats_launch if stats
              else libs[3].nlmpc_step_launch)
    assert launch(*head, *map(_ptr, out), None, b) == 0
    return out


@pytest.mark.parametrize("case", list(K2_VARIANTS))
def test_k2_variants_match_plain(libs, case):
    """K2's prox_skip (its one-thread walker, spaceVarying and
    timeVarying) and zeros_skip (the ZSKIP instantiations: the plain
    order, timeVarying's qsort_skip with counts, the walker, mode all's
    all_rev_skip) on headlines.k2_option_lanes, f64, 40 lanes: the
    decisions (feasible_any, idx_sel, row_sel, succ) are the plain step's
    with the same options, the counts integer for integer, and prox_skip's
    every output bit for bit the same build's without it (the host libm
    stands in for CUDA's, so the solutions are held against the kernel
    itself)."""
    mode, lap_count, opts, stats = K2_VARIANTS[case]
    b, dt = OPT_LANES, torch.float64
    a = k2_option_lanes(1, lap_count, "cpu", b=b, dtype=dt)
    out = _k2_variant(libs, mode, a, opts, stats, b, dt)
    p = LmpcParams.make(ss_option=mode, all_ss_point=mode == "all",
                        device="cpu", dtype=dt)
    lim = SystemLimits.make(device="cpu", dtype=torch.float64)
    tv = mode == "timeVarying"
    want = nlmpc_step_reference(
        p, lim, 1.0, *a[:11], *(a[11:] if tv else (None, None)),
        max_iters=12, qsort_skip=bool(opts & 1) and mode != "all",
        prox_skip=bool(opts & 2), zeros_skip=bool(opts & 4),
        with_stats=stats)
    for i in (1, 3, 4, 5):
        assert torch.equal(out[i], want[i])
    if stats:
        assert torch.equal(out[6], want[6])
        assert torch.equal(out[7], want[7])
    if opts & 2:  # prox_skip against the option off: every bit
        _equal(out, _k2_variant(libs, mode, a, opts & ~2, stats, b, dt))
