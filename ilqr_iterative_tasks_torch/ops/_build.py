"""Build the CUDA kernels of csrc/ into one shared library, on first use.

Each ``.cu`` source is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ctypes. The library's file name carries a hash of
every source (headers included) and the flags, so an edited source builds
anew and an unchanged one is reused. Output goes to ``build/torch_kernels/`` beside the package (git
ignores ``build/``). Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
SOURCES = ("tile.cuh", "lm_core.cuh", "nlmpc_core.cuh", "dual.cuh",
           "fused_ilqr.cu", "i2lqr_step.cu", "fused_lm_shooting.cu",
           "nlmpc_step.cu", "nlmpc_step_all.cu", "generic_ilqr.cu")
# Precise sin/cos/exp, IEEE division and sqrt (no --use_fast_math), and no
# FMA contraction (-fmad=false): the kernels then round operation by
# operation as the plain torch version does, which the LM accept/reject
# tests need to take the same decisions. -Xptxas -v reports registers and
# spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # dtype, n, consts, max_iter, B, x0, x_term, u_init, obs, skip,
    # us, x_last, cost, dist, stream, counter (one int32 the launch takes
    # its lanes from)
    "fused_ilqr_launch": [_I, _I, _P, _I, _I] + [_P] * 11,
    # dtype, n, k, nsi, consts, max_iter, B, T, max_laps, x, g0, states,
    # qfun, lap_len, lap_ids, lap_ok, obs, skip, us, shrink, idx, row,
    # stream
    "i2lqr_step_launch": [_I] * 4 + [_P] + [_I] * 4 + [_P] * 14,
    # dtype, n, consts, max_iters, B, x0, x_term, u_warm, obs, skip, hzn,
    # us, x_last, term_err, feasible, stream
    "fused_lm_shooting_launch": [_I, _I, _P, _I, _I] + [_P] * 11,
    # dtype, n, k, nsi, time_varying, qsort, consts, max_iters, B, T, x,
    # guess, u_warm, states, qfun, lap_len, lap_ids, lap_ok, obs, skip, hzn,
    # t, min_cost, us, feasible_any, new_guess, idx, row, succ, stream
    "nlmpc_step_launch": [_I] * 6 + [_P] + [_I] * 3 + [_P] * 20,
    # dtype, n, rows, rev, consts, max_iters, B, T, x, u_warm, states, qfun,
    # lap_len, lap_ids, lap_ok, obs, skip, hzn, scratch, us, feasible_any,
    # new_guess, idx, row, succ, stream
    "nlmpc_step_all_launch": [_I] * 4 + [_P] + [_I] * 3 + [_P] * 18,
    # dtype, model, n, consts, max_iter, B, x0, x_term, u_init, us, x_last,
    # cost, n_iters, stream, counter
    "generic_ilqr_launch": [_I, _I, _I, _P, _I, _I] + [_P] * 9,
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(csrc_dir: str = CSRC_DIR) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        if not os.path.exists(os.path.join(csrc_dir, name)):
            continue  # a header an earlier checkout does not have
        with open(os.path.join(csrc_dir, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR,
                        f"libilqr_torch_kernels_{h.hexdigest()[:16]}.so")


def build(csrc_dir: str = CSRC_DIR) -> tuple[str, float]:
    """Compile the library unless it exists. Returns (path, seconds spent).
    The package's kernels by default; a measurement may build another
    checkout's ``csrc_dir`` into a library of its own."""
    path = library_path(csrc_dir)
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", os.path.join(tmp, s + ".o"),
                 os.path.join(csrc_dir, s)]
                for s in SOURCES if s.endswith(".cu")]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]  # one nvcc per source, all at once
        outs = [p.communicate()[0] for p in procs]
        lib = os.path.join(tmp, "lib.so")
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib,
                *(c[c.index("-o") + 1] for c in cmds)]
        if all(p.returncode == 0 for p in procs):
            outs.append(subprocess.run(link, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT,
                                       text=True).stdout)
        with open(path[:-3] + ".log", "w") as f:
            for c, o in zip(cmds + [link], outs):
                f.write(" ".join(c) + "\n" + o)
        if not os.path.exists(lib):
            raise RuntimeError("nvcc failed:\n" + "\n".join(outs)[-8000:])
        os.replace(lib, path)  # atomic: a concurrent build never sees a partial .so
    return path, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library with argument types declared (built on first call)."""
    return load(build()[0])


def load(path: str) -> ctypes.CDLL:
    """A built library with its launchers' argument types declared."""
    lib = ctypes.CDLL(path)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def attributes(lib: ctypes.CDLL, entry: str, *sizes: int) -> dict:
    """Registers a thread, local memory bytes a thread and resident warps an
    SM of a loaded kernel, as the CUDA runtime reports them: ``entry`` is
    the library's ``*_attributes`` function (i2lqr_step_attributes: dtype,
    n, k, nsi; nlmpc_step_all_attributes: dtype, n; nlmpc_step_attributes:
    dtype, n, k, nsi, time_varying, qsort; fused_ilqr_attributes and
    fused_lm_shooting_attributes: dtype, n;
    generic_ilqr_attributes: dtype, model, n), ``sizes`` its arguments
    before the output."""
    out = (ctypes.c_int * 3)()
    check_launch(getattr(lib, entry)(*(ctypes.c_int(s) for s in sizes), out),
                 entry)
    return dict(registers=out[0], local_bytes=out[1], warps_per_sm=out[2])


def consts_array(C) -> ctypes.Array:
    """Pack utils.params.solver_consts into the 50 doubles ``make_consts``
    of csrc/lm_core.cuh reads: qt (4x4), q (4x4), r (2x2) row-major, then
    q1c, q2c, q1o, q2o, margin, eps, lamb0, lamb_factor, max_lamb,
    max_relax_iter, a_max, d_max, param_horizon, dt."""
    vals = ([C.qt_m[i, j] for i in range(4) for j in range(4)]
            + [C.q_m[i, j] for i in range(4) for j in range(4)]
            + [C.r_m[i, j] for i in range(2) for j in range(2)]
            + [C.q1c, C.q2c, C.q1o, C.q2o, C.margin, C.eps, C.lamb0,
               C.lamb_factor, C.max_lamb, C.max_relax_iter, C.a_max, C.d_max,
               C.param_horizon, C.dt])
    return (ctypes.c_double * len(vals))(*vals)


def nlmpc_consts_array(C) -> ctypes.Array:
    """Pack utils.params.nlmpc_consts into the 7 doubles
    ``make_nlmpc_consts`` of csrc/nlmpc_core.cuh reads: dt, a_max, d_max
    (raw delta_max), sqrt_w, margin, term_tol, viol_tol."""
    vals = [C.dt, C.a_max, C.d_max, C.sqrt_w, C.margin, C.term_tol,
            C.viol_tol]
    return (ctypes.c_double * len(vals))(*vals)


def generic_consts_array(q, r, qt, u_lo, u_hi, dt, eps, lamb0, lamb_factor,
                         max_lamb) -> ctypes.Array:
    """Pack the generic solver's constants into the doubles
    ``make_generic_consts`` of csrc/generic_ilqr.cu reads: the symmetrized
    q (n x n), r (m x m) and qt (n x n) row-major, u_lo (m), u_hi (m), then
    dt, eps, lamb0, lamb_factor, max_lamb."""
    vals = [float(v) for a in (q, r, qt, u_lo, u_hi) for v in a.reshape(-1)]
    vals += [float(dt), float(eps), float(lamb0), float(lamb_factor),
             float(max_lamb)]
    return (ctypes.c_double * len(vals))(*vals)


def check_launch(rc: int, name: str) -> None:
    """Raise unless a launcher returned cudaSuccess (0)."""
    if rc == -1:
        raise ValueError(f"{name}: no kernel instantiated for these sizes")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
