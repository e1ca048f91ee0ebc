"""ctypes bindings and on-demand build of the native C++ host runner.

The port's own copy of ilqr_iterative_tasks_tpu/native_bindings.py. The
C++ sources are the repository's ``native/*.cpp`` (read in place, as
``data/`` is): a zero-dependency f64 implementation of the bicycle step,
the iLQR solve, the LM-shooting feasibility solve, and whole i2LQR and
NLMPC closed-loop learning runs with no Python in the loop. ``build``
compiles them with ``g++ -O3 -march=native -shared -fPIC -std=c++17`` (no
fast math) into ``build/native/libilqr_native.so`` of the repository,
rebuilt when a source is newer; the committed ``native/libilqr_native.so``
is never written. The bindings take the port's parameters, limits and
obstacle (torch tensors, read as float64 numpy on the host). This is a
host path: it needs no card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO, "native")
SOURCES = tuple(os.path.join(NATIVE_DIR, f) for f in (
    "ilqr_native.cpp", "i2lqr_runner.cpp", "nlmpc_runner.cpp"))
BUILD_DIR = os.path.join(REPO, "build", "native")
LIB = os.path.join(BUILD_DIR, "libilqr_native.so")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


class NativeParams(ctypes.Structure):
    _fields_ = [
        ("q", ctypes.c_double * 16),
        ("r", ctypes.c_double * 4),
        ("qt", ctypes.c_double * 16),
        ("ctrl_q1", ctypes.c_double), ("ctrl_q2", ctypes.c_double),
        ("obs_q1", ctypes.c_double), ("obs_q2", ctypes.c_double),
        ("safety_margin", ctypes.c_double),
        ("eps", ctypes.c_double),
        ("lamb_factor", ctypes.c_double), ("max_lamb", ctypes.c_double),
        ("max_ilqr_iter", ctypes.c_int),
        ("param_horizon", ctypes.c_int),
        ("a_max", ctypes.c_double), ("delta_max_r", ctypes.c_double),
        ("delta_max", ctypes.c_double),
        ("ox", ctypes.c_double), ("oy", ctypes.c_double),
        ("ow", ctypes.c_double), ("oh", ctypes.c_double),
        ("ospd", ctypes.c_double),
        ("omove", ctypes.c_int), ("opresent", ctypes.c_int),
    ]


def build(force: bool = False) -> str:
    """Compile the shared library if it is missing or older than a
    source; returns its path. The library is written to a temporary file
    and moved into place, so a reader never sees a partial one."""
    newest = max(os.path.getmtime(s) for s in SOURCES)
    if not force and os.path.exists(LIB) and os.path.getmtime(LIB) >= newest:
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, *SOURCES, "-o", tmp], check=True,
                       capture_output=True)
        os.chmod(tmp, 0o755)
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIB


_lib = None


def load():
    """The built library with every function's argument and result types
    declared (built first where needed)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        dp = ctypes.POINTER(ctypes.c_double)
        pp = ctypes.POINTER(NativeParams)
        lib.ilqr_solve_native.restype = ctypes.c_int
        lib.ilqr_solve_native.argtypes = [
            pp, dp, dp, ctypes.c_int, ctypes.c_double, dp, dp, dp]
        lib.lm_feasibility_solve_native.restype = ctypes.c_int
        lib.lm_feasibility_solve_native.argtypes = [
            pp, dp, dp, ctypes.c_int, ctypes.c_double, dp, dp, dp, dp]
        lib.bicycle_step_native.restype = None
        lib.bicycle_step_native.argtypes = [dp, dp, ctypes.c_double, dp]
        for name in ("run_i2lqr_closed_loop", "run_nlmpc_closed_loop"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [pp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_double,
                           ctypes.POINTER(ctypes.c_int)]
        _lib = lib
    return _lib


def _f64(v) -> np.ndarray:
    """A tensor, array or number as a contiguous float64 numpy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", torch.float64).numpy()
    return np.ascontiguousarray(np.asarray(v, dtype=np.float64))


def _set_limits_and_obstacle(p: NativeParams, limits, obstacle):
    p.a_max = float(_f64(limits.a_max))
    p.delta_max_r = float(_f64(limits.delta_max_r))
    p.delta_max = float(_f64(limits.delta_max))
    if obstacle is not None and float(_f64(obstacle.present)) > 0:
        p.ox = float(_f64(obstacle.x))
        p.oy = float(_f64(obstacle.y))
        p.ow = float(_f64(obstacle.width))
        p.oh = float(_f64(obstacle.height))
        p.ospd = float(_f64(obstacle.spd))
        p.omove = int(float(_f64(obstacle.moving_option)))
        p.opresent = 1
    else:
        p.ow = p.oh = 1.0
        p.opresent = 0


def make_params(params, limits, obstacle=None) -> NativeParams:
    """NativeParams from the port's IlqrParams, SystemLimits and Obstacle
    (models/obstacle.py; None or absent: no obstacle), in f64."""
    p = NativeParams()
    q, r = _f64(params.matrix_Q).ravel(), _f64(params.matrix_R).ravel()
    qt = _f64(params.matrix_Qterminal).ravel()
    for i in range(16):
        p.q[i] = q[i]
        p.qt[i] = qt[i]
    for i in range(4):
        p.r[i] = r[i]
    for name in ("ctrl_q1", "ctrl_q2", "obs_q1", "obs_q2"):
        setattr(p, name, float(_f64(getattr(params, f"tuning_{name}"))))
    for name in ("safety_margin", "eps", "lamb_factor", "max_lamb"):
        setattr(p, name, float(_f64(getattr(params, name))))
    p.max_ilqr_iter = int(params.max_ilqr_iter)
    p.param_horizon = int(params.num_horizon)
    _set_limits_and_obstacle(p, limits, obstacle)
    return p


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def ilqr_solve_native(params, limits, obstacle, x0, x_terminal, u_init,
                      lamb0: float, dt: float):
    """Native iLQR solve -> (us (N, 2), xs (N+1, 4), lamb, n_iters)."""
    lib = load()
    us = _f64(u_init).copy()
    n = us.shape[0]
    p = make_params(params, limits, obstacle)
    xs = np.zeros((n + 1, 4), np.float64)
    x0, xt = _f64(x0), _f64(x_terminal)
    lamb = ctypes.c_double(float(lamb0))
    it = lib.ilqr_solve_native(ctypes.byref(p), _ptr(x0), _ptr(xt), n,
                               float(dt), _ptr(us), _ptr(xs),
                               ctypes.byref(lamb))
    return us, xs, lamb.value, it


def lm_feasibility_solve_native(limits, obstacle, x0, x_terminal, u_init,
                                dt: float, params=None):
    """Native LM-shooting feasibility solve -> (us, xs, term_err,
    max_viol, feasible). Only the limits and the obstacle are read
    (``params`` defaults to the i2LQR defaults in f64)."""
    from ilqr_iterative_tasks_torch.utils.params import IlqrParams

    lib = load()
    if params is None:
        params = IlqrParams.make(dtype=torch.float64, device="cpu")
    us = _f64(u_init).copy()
    n = us.shape[0]
    p = make_params(params, limits, obstacle)
    xs = np.zeros((n + 1, 4), np.float64)
    x0, xt = _f64(x0), _f64(x_terminal)
    term_err, viol = ctypes.c_double(0.0), ctypes.c_double(0.0)
    feasible = lib.lm_feasibility_solve_native(
        ctypes.byref(p), _ptr(x0), _ptr(xt), n, float(dt), _ptr(us),
        _ptr(xs), ctypes.byref(term_err), ctypes.byref(viol))
    return us, xs, term_err.value, viol.value, bool(feasible == 1)


def bicycle_step_native(x, u, dt: float) -> np.ndarray:
    """One native bicycle step (f64)."""
    lib = load()
    x, u = _f64(x), _f64(u)
    out = np.zeros(4, np.float64)
    lib.bicycle_step_native(_ptr(x), _ptr(u), float(dt), _ptr(out))
    return out


def run_i2lqr_closed_loop_native(params, limits, obstacle, lap_number: int,
                                 dt: float = 1.0):
    """A whole native i2LQR learning run: seed lap + ``lap_number`` laps
    -> (lap steps, laps completed)."""
    lib = load()
    p = make_params(params, limits, obstacle)
    steps = (ctypes.c_int * lap_number)()
    completed = lib.run_i2lqr_closed_loop(
        ctypes.byref(p), lap_number, int(params.num_ss_points),
        int(params.num_ss_iter), int(params.num_horizon), float(dt), steps)
    return list(steps), int(completed)


def run_nlmpc_closed_loop_native(lmpc_params, limits, obstacle,
                                 lap_number: int, dt: float = 1.0):
    """A whole native NLMPC learning run: seed lap + ``lap_number`` laps
    -> (lap steps, laps completed). Only the limits and the obstacle of
    NativeParams are read."""
    lib = load()
    p = NativeParams()
    _set_limits_and_obstacle(p, limits, obstacle)
    steps = (ctypes.c_int * lap_number)()
    completed = lib.run_nlmpc_closed_loop(
        ctypes.byref(p), lap_number, int(lmpc_params.num_ss_points),
        int(lmpc_params.num_ss_iter), int(lmpc_params.num_horizon),
        float(dt), steps)
    return list(steps), int(completed)
