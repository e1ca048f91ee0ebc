"""Build the CUDA kernels of csrc/ into shared libraries, on first use.

Each ``.cu`` source is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ctypes. K5 (csrc/generic_ilqr.cuh) is built for the
caller's model instead: each (model, horizon) is a generated translation
unit (ops/fused_generic_ilqr.py::k5_source), compiled by nvcc into a
library of its own (``build_generic``, ``generic_library``). A library's
file name carries a hash of its sources (headers included) and the flags,
so an edited source builds anew and an unchanged one is reused. Output goes
to ``build/torch_kernels/`` beside the package (git ignores ``build/``).
Nothing is built at import time.
"""

from __future__ import annotations

import concurrent.futures
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
# The sources of the one library; a checkout lacks some of them (an
# earlier one generic_ilqr.cu, K5 for a table of models, which kernel_ab.py
# still builds and times; this one the later files), and they are skipped.
SOURCES = ("tile.cuh", "lm_core.cuh", "nlmpc_core.cuh", "dual.cuh",
           "fused_ilqr.cu", "i2lqr_step.cu", "i2lqr_step_opts.cu",
           "i2lqr_step_group.cu", "fused_lm_shooting.cu",
           "nlmpc_step.cu", "nlmpc_step_all.cu", "generic_ilqr.cu")
# what a generated K5 translation unit includes
GENERIC_HEADERS = ("generic_ilqr.cuh", "dual.cuh", "tile.cuh")
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
    # stream, lanes (the first lanes of B run; last, so that an earlier
    # checkout's launcher, which takes no lanes, runs every lane)
    "i2lqr_step_launch": [_I] * 4 + [_P] + [_I] * 4 + [_P] * 14 + [_I],
    # dtype, n, k, nsi, opts, consts, max_iter, B, T, max_laps, x, g0,
    # states, qfun, lap_len, lap_ids, lap_ok, obs, skip, us, shrink, idx,
    # row, useful, executed, upass, counter, stream, lanes
    "i2lqr_step_opts_launch": [_I] * 5 + [_P] + [_I] * 4 + [_P] * 18 + [_I],
    # K1 at k = 32 with counts: dtype, n, nsi, opts, consts, max_iter, B,
    # T, max_laps, x, g0, states, qfun, lap_len, lap_ids, lap_ok, obs,
    # skip, us, shrink, idx, row, useful, executed, upass, stream, lanes
    "i2lqr_step_block_stats_launch": ([_I] * 4 + [_P] + [_I] * 4 + [_P] * 17
                                      + [_I]),
    # K1 at k = 32 with reuse_extract: as i2lqr_step_launch without k
    "i2lqr_step_block_reuse_launch": [_I] * 3 + [_P] + [_I] * 4 + [_P] * 14
                                     + [_I],
    # K1 at k = 8 with group > 1: dtype, n, k, nsi, group, opts, then as
    # i2lqr_step_launch from consts on
    "i2lqr_step_group_launch": [_I] * 6 + [_P] + [_I] * 4 + [_P] * 14 + [_I],
    # dtype, n, consts, max_iters, B, x0, x_term, u_warm, obs, skip, hzn,
    # us, x_last, term_err, feasible, stream, counter (one int32 the launch
    # takes its chunks of lanes from)
    "fused_lm_shooting_launch": [_I, _I, _P, _I, _I] + [_P] * 12,
    # dtype, n, k, nsi, time_varying, opts (1 qsort_skip, 2 prox_skip, 4
    # zeros_skip), consts, max_iters, B, T, x,
    # guess, u_warm, states, qfun, lap_len, lap_ids, lap_ok, obs, skip, hzn,
    # t, min_cost, us, feasible_any, new_guess, idx, row, succ, stream,
    # lanes
    "nlmpc_step_launch": [_I] * 6 + [_P] + [_I] * 3 + [_P] * 20 + [_I],
    # as nlmpc_step_launch, with useful and executed (B,) i32 before the
    # stream
    "nlmpc_step_stats_launch": [_I] * 6 + [_P] + [_I] * 3 + [_P] * 22 + [_I],
    # dtype, n, rows, opts (1 all_rev_skip, 4 zeros_skip), consts,
    # max_iters, B, T, x, u_warm, states, qfun,
    # lap_len, lap_ids, lap_ok, obs, skip, hzn, scratch, us, feasible_any,
    # new_guess, idx, row, succ, stream, lanes
    "nlmpc_step_all_launch": [_I] * 4 + [_P] + [_I] * 3 + [_P] * 18 + [_I],
    # K5 of a generated library (csrc/generic_ilqr.cuh ILQR_K5_EXPORT):
    # dtype, consts, max_iter, B, x0, x_term, u_init, us, x_last, cost,
    # n_iters, stream, counter
    "k5_launch": [_I, _P, _I, _I] + [_P] * 9,
    # an earlier checkout's K5, one library for a table of models: dtype,
    # model, n, then as k5_launch
    "generic_ilqr_launch": [_I, _I, _I, _P, _I, _I] + [_P] * 9,
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(csrc_dir: str = CSRC_DIR, defines=(),
                 sources=SOURCES) -> str:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for name in sources:
        if not os.path.exists(os.path.join(csrc_dir, name)):
            continue  # a header an earlier checkout does not have
        with open(os.path.join(csrc_dir, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR,
                        f"libilqr_torch_kernels_{h.hexdigest()[:16]}.so")


def build(csrc_dir: str = CSRC_DIR, defines=(),
          sources=SOURCES) -> tuple[str, float]:
    """Compile the library unless it exists. Returns (path, seconds spent).
    The package's kernels by default; a measurement may build another
    checkout's ``csrc_dir``, or ``sources`` (a part of SOURCES, headers
    included) with the nvcc ``defines`` of a counting build, into a library
    of its own."""
    path = library_path(csrc_dir, defines, sources)
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cmds = [[nvcc, *NVCC_FLAGS, *defines, "-c", "-o",
                 os.path.join(tmp, s + ".o"), os.path.join(csrc_dir, s)]
                for s in sources if s.endswith(".cu")
                and os.path.exists(os.path.join(csrc_dir, s))]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]  # one nvcc per source, all at once
        # each source's output and the seconds until its nvcc ended
        with concurrent.futures.ThreadPoolExecutor(max(1, len(procs))) as ex:
            done = list(ex.map(lambda p: (p.communicate()[0],
                                          time.perf_counter() - t0), procs))
        outs = [out for out, _ in done]
        lib = os.path.join(tmp, "lib.so")
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib,
                *(c[c.index("-o") + 1] for c in cmds)]
        if all(p.returncode == 0 for p in procs):
            outs.append(subprocess.run(link, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT,
                                       text=True).stdout)
        with open(path[:-3] + ".log", "w") as f:
            for c, (o, sec) in zip(cmds, done):
                f.write(" ".join(c) + f"\nnvcc seconds {sec:.1f}\n" + o)
            if len(outs) > len(cmds):
                f.write(" ".join(link) + "\n" + outs[-1])
        if not os.path.exists(lib):
            raise RuntimeError("nvcc failed:\n" + "\n".join(outs)[-8000:])
        os.replace(lib, path)  # atomic: a concurrent build never sees a partial .so
    return path, time.perf_counter() - t0


def generic_library_path(source: str, csrc_dir: str = CSRC_DIR) -> str:
    """The library of a generated K5 translation unit ``source`` compiled
    against ``csrc_dir``'s headers: its name a hash of the flags, the
    source and the headers."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + b"\0"
                       + source.encode())
    for name in GENERIC_HEADERS:
        with open(os.path.join(csrc_dir, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libilqr_k5_{h.hexdigest()[:16]}.so")


def build_generic(sources, csrc_dir: str = CSRC_DIR) -> list:
    """Compile each generated K5 translation unit of ``sources`` into a
    library of its own unless it exists, one nvcc each, all started
    together; the source and nvcc's output are kept beside each library
    (``.cu``, ``.log``). Returns [(path, seconds)] in the order of
    ``sources``: the wall seconds of the build that made the library, 0.0
    where it existed."""
    paths = [generic_library_path(s, csrc_dir) for s in sources]
    todo = {p: s for p, s in zip(paths, sources) if not os.path.exists(p)}
    if not todo:
        return [(p, 0.0) for p in paths]
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for i, (path, src) in enumerate(todo.items()):
            cu, so = (os.path.join(tmp, f"k5_{i}{ext}") for ext in (".cu",
                                                                    ".so"))
            with open(cu, "w") as f:
                f.write(src)
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-I", csrc_dir, "-o", so, cu]
            jobs.append((path, cu, so, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for path, cu, so, cmd, proc in jobs:
            out = proc.communicate()[0]
            shutil.copyfile(cu, path[:-3] + ".cu")
            with open(path[:-3] + ".log", "w") as f:
                f.write(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0 or not os.path.exists(so):
                failed.append(out)
            else:
                os.replace(so, path)  # atomic, as build's
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-8000:])
    sec = time.perf_counter() - t0
    return [(p, sec if p in todo else 0.0) for p in paths]


@functools.lru_cache(maxsize=None)
def generic_library(source: str, csrc_dir: str = CSRC_DIR) -> ctypes.CDLL:
    """The library of a generated K5 translation unit, loaded (built on
    first call)."""
    return load(build_generic([source], csrc_dir)[0][0])


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library with argument types declared (built on first call)."""
    return load(build()[0])


def load(path: str) -> ctypes.CDLL:
    """A built library with its launchers' argument types declared (those
    it has: an earlier checkout's library lacks the later ones)."""
    lib = ctypes.CDLL(path)
    for name, argtypes in _ARGTYPES.items():
        if not hasattr(lib, name):
            continue
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
    fused_lm_shooting_attributes: dtype, n; a generated K5 library's
    k5_attributes: dtype), ``sizes`` its arguments
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
    ``make_generic_consts`` of csrc/generic_ilqr.cuh reads: the symmetrized
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
