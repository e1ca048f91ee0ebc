"""The port's utils/profiling.py on the CPU: a trace of the host holds
its ``annotate`` span, in the profiler's sums and in the Chrome trace it
writes; the default device is the card, so without one ``trace`` raises;
``device_memory_stats`` reports no card here."""

import json

import pytest
import torch

from ilqr_iterative_tasks_torch.utils import profiling


def test_a_cpu_trace_holds_its_annotate_span(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        with profiling.annotate("host_lap"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    assert "host_lap" in {e.key for e in prof.key_averages()}
    path = tmp_path / profiling.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "host_lap" for e in events)


def test_trace_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace(str(tmp_path)):
            pass


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == {}
