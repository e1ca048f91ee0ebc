"""Profiling helpers on ``torch.profiler``.

Port of ilqr_iterative_tasks_tpu/utils/profiling.py. Usage:

    from ilqr_iterative_tasks_torch.utils.profiling import annotate, trace
    with trace("/tmp/trace") as prof:
        with annotate("lap"):
            run_closed_loop(controller, 1)

``trace`` records the host's activity and, on a CUDA device (the current
one unless ``device`` names another), the card's kernels and copies, and
writes a Chrome trace (``trace.json``) into ``log_dir``, readable in
Perfetto or chrome://tracing; the profiler object it yields has
``key_averages()`` for sums by name. ``annotate`` names a region of the
trace (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ilqr_iterative_tasks_torch.utils.device import resolve

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the enclosed block and write ``log_dir/trace.json``. On a
    CUDA ``device`` (the default; raises without a card) the card's
    activity is recorded beside the host's; ``device="cpu"`` records the
    host only."""
    activities = [ProfilerActivity.CPU]
    if resolve(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named region of the trace."""
    return record_function(name)


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` of every visible card, by device name
    (``cuda:0``, ...); empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
