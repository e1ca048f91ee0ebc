"""The K3 and K5 kernel sources (csrc/fused_ilqr.cu, csrc/generic_ilqr.cu)
run on the host: g++ builds them against tests/host_cuda/cuda_runtime.h,
which runs every CUDA thread of a launch as a host thread (the lane counter
as a host atomic), so the lanes refilled from the counter by a grid of one
block of 128 threads are held bit for bit against the plain versions
without a card. The host's libm stands in for CUDA's, and torch's CPU sin /
cos / exp differ from it in the last bit, so only the double integrator (no
transcendental) is held against its plain version; the bicycle, the
unicycle and K3 are held against a second build of the same sources on a
card of 4 SMs, whose grid takes every lane by its index, which shares the
host's libm.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_torch.experiments.generic_bench import (
    generic_kwargs, k5_task, throughput_inputs)
from ilqr_iterative_tasks_torch.models import double_integrator
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops import _build
from ilqr_iterative_tasks_torch.ops.fused_generic_ilqr import (
    MODEL_CODES, build_fused_generic_ilqr)
from ilqr_iterative_tasks_torch.ops.fused_ilqr import (
    DTYPE_CODES, build_fused_ilqr, fused_ilqr_reference, obstacle_to_lanes)
from ilqr_iterative_tasks_torch.sim.seed import seed_trajectory
from ilqr_iterative_tasks_torch.utils.params import IlqrParams, SystemLimits

torch.set_num_threads(1)
SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "host_cuda")
SOURCES = ("fused_ilqr.cu", "generic_ilqr.cu")


def host_source(text: str) -> str:
    """``kernel<<<grid, block, ...>>>(args)`` as a call of the shim's
    ``emu::launcher(kernel, grid, block, ...)(args)``."""
    out, i = [], 0
    while (j := text.find("<<<", i)) >= 0:
        k, depth = j - 1, 0  # back over the kernel's name and <...>
        while k >= 0 and (depth or text[k].isalnum() or text[k] in "_:<>"):
            depth += {">": 1, "<": -1}.get(text[k], 0)
            k -= 1
        end = text.index(">>>", j)
        out += [text[i:k + 1],
                f"emu::launcher({text[k + 1:j]}, {text[j + 3:end]})"]
        i = end + 3
    return "".join(out + [text[i:]])


def _start_host_build(d, sms):
    """g++ of the sources, as host code, into directory d for a card of
    ``sms`` SMs; returns (the compiler's process, the library's path)."""
    d.mkdir()
    for name in os.listdir(_build.CSRC_DIR):
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            (d / name).write_text(host_source(f.read()))
    so = str(d / "lib.so")
    return subprocess.Popen(
        ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", "-w", f"-DEMU_SMS={sms}", "-x", "c++", "-I", SHIM,
         "-o", so, *(str(d / s) for s in SOURCES)]), so


def _load(proc, so):
    assert proc.wait() == 0
    lib = ctypes.CDLL(so)
    for name in ("fused_ilqr_launch", "generic_ilqr_launch"):
        getattr(lib, name).argtypes = _build._ARGTYPES[name]
    return lib


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """(the sources on a card of one SM, one block of 128 threads that
    refills; on a card of 4, whose grid holds every lane of these tests),
    host builds made at once"""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("host_kernels")
    builds = [_start_host_build(d / "one_sm", 1),
              _start_host_build(d / "four_sms", 4)]
    return tuple(_load(*b) for b in builds)


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
    assert lib.generic_ilqr_launch(
        DTYPE_CODES[dt], MODEL_CODES[k5.model.CUDA_MODEL], k5.num_horizon,
        k5._consts, k5.max_iter, b, *map(_ptr, (x0, xt, u, *out)), None,
        counter.data_ptr()) == 0
    return out


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nh", [6, 10])
def test_k5_double_integrator_matches_plain_bitwise(lib, nh, dtype):
    # 300 lanes on one block of 128 threads: threads take several lanes
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
@pytest.mark.parametrize("name,nh", [("bicycle", 6), ("unicycle", 6),
                                     ("unicycle", 8)])
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
