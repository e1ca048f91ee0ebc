"""Start the ranks of a multi-process run on this host and collect what
each returns: the spawn helper of the tests, ``chip_smoke.py`` and the
latency bench.

``spawn(target, world, *args, backend=...)`` runs ``target(*args)`` in
``world`` fresh interpreters, each one rank of a process group joined
through the ``env://`` variables that torchrun would set (a free port on
localhost), and returns each rank's return value (picklable: CPU tensors,
numbers, dicts). ``target`` is "package.module:function" or
"path/to/file.py:function". Every run is bounded: the group's rendezvous
and collectives time out (``init_timeout``), the children run under a
wall-clock limit (``timeout``), and where a rank exits non-zero or the
limit passes, every rank still running is killed and the error carries
each rank's output. Each rank leaves the group (``destroy_process_group``)
before it exits. Start with ``Ranks(...)`` to work in the parent while the
ranks run, then ``wait()`` (or ``close()`` to give up on them).

Child:  python -m ilqr_iterative_tasks_torch.parallel.launch <run dir>
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LOG_TAIL = 6000  # bytes of each rank's output in an error


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """``world`` ranks running ``target(*args, **kwargs)``; ``wait()``
    returns their values in rank order. ``threads``: torch's CPU threads a
    rank (None: torch's default)."""

    def __init__(self, target: str, world: int, *args, backend: str,
                 timeout: float = 600.0, init_timeout: float = 120.0,
                 threads=None, **kwargs):
        self.world, self.timeout = world, timeout
        self.dir = tempfile.mkdtemp(prefix="ranks_")
        with open(os.path.join(self.dir, "call.pkl"), "wb") as f:
            pickle.dump((target, args, kwargs, backend, init_timeout,
                         threads), f)
        port = free_port()
        path = os.environ.get("PYTHONPATH")
        # unbuffered: a rank killed in a hang still shows what it printed
        base = dict(os.environ, PYTHONUNBUFFERED="1", MASTER_ADDR="localhost",
                    MASTER_PORT=str(port), WORLD_SIZE=str(world),
                    LOCAL_WORLD_SIZE=str(world),
                    PYTHONPATH=_ROOT + (os.pathsep + path if path else ""))
        self.procs, self.logs = [], []
        for r in range(world):
            log = open(os.path.join(self.dir, f"rank{r}.log"), "wb")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, self.dir],
                env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=log, stderr=subprocess.STDOUT))
        self.deadline = time.monotonic() + timeout

    def _outputs(self):
        out = []
        for r in range(self.world):
            with open(os.path.join(self.dir, f"rank{r}.log"), "rb") as f:
                out.append(f.read().decode(errors="replace"))
        return out

    def _report(self, what):
        tails = "\n".join(f"---- rank {r} ----\n{o[-LOG_TAIL:]}"
                          for r, o in enumerate(self._outputs()))
        return f"{what}\n{tails}"

    def wait(self) -> list:
        try:
            while True:
                rcs = [p.poll() for p in self.procs]
                bad = {r: rc for r, rc in enumerate(rcs)
                       if rc is not None and rc != 0}
                if bad:
                    raise RuntimeError(self._report(
                        f"rank(s) exited non-zero {bad} of {self.world}"))
                if all(rc == 0 for rc in rcs):
                    break
                if time.monotonic() > self.deadline:
                    raise TimeoutError(self._report(
                        f"ranks still running after {self.timeout} s"))
                time.sleep(0.05)
            return [torch.load(os.path.join(self.dir, f"rank{r}.pt"),
                               weights_only=False)
                    for r in range(self.world)]
        finally:
            self.close()

    def close(self) -> None:
        """Kill every rank still running and remove the run's files."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in self.logs:
            log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def spawn(target: str, world: int, *args, backend: str, **kw) -> list:
    """Run ``target(*args)`` on ``world`` ranks; their return values."""
    return Ranks(target, world, *args, backend=backend, **kw).wait()


def resolve_target(target: str):
    """The function "package.module:function" or "file.py:function"."""
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            "_rank_target_" + os.path.basename(where)[:-3], where)
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def main(run_dir: str) -> None:
    import torch.distributed as dist

    from ilqr_iterative_tasks_torch.parallel.distributed import (
        initialize_distributed)

    with open(os.path.join(run_dir, "call.pkl"), "rb") as f:
        target, args, kwargs, backend, init_timeout, threads = pickle.load(f)
    if threads is not None:
        torch.set_num_threads(threads)
    initialize_distributed(backend=backend, timeout=init_timeout)
    try:
        out = resolve_target(target)(*args, **kwargs)
        path = os.path.join(run_dir, f"rank{dist.get_rank()}.pt")
        torch.save(out, path + ".tmp")
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
