"""With no device named, the port's entry points put their tensors on the
current CUDA device (utils/device.py), and raise where there is none: they
never fall back to the CPU."""

import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_torch.control.batched import make_batch_scenarios
from ilqr_iterative_tasks_torch.control.batched_soa import SoaScenarios
from ilqr_iterative_tasks_torch.control.safe_set import DeviceSafeSet
from ilqr_iterative_tasks_torch.control.i2lqr import I2LqrController
from ilqr_iterative_tasks_torch.control.nlmpc import NlmpcController
from ilqr_iterative_tasks_torch.experiments import latency_bench
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.generic_ilqr import GenericIlqrConfig
from ilqr_iterative_tasks_torch.utils import convert, device
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, LmpcParams, SystemLimits)

# each entry point called with no device -> one of the tensors it made
ENTRY_POINTS = {
    "SystemLimits.make": lambda: SystemLimits.make().a_max,
    "IlqrParams.make": lambda: IlqrParams.make().matrix_Qterminal,
    "LmpcParams.make": lambda: LmpcParams.make().matrix_Q,
    "Obstacle.make": lambda: Obstacle.make(31.0, -2.0, 8.0, 6.0).x,
    "Obstacle.absent": lambda: Obstacle.absent().present,
    "SoaScenarios.broadcast": lambda: SoaScenarios.broadcast(
        np.zeros(4), np.ones(4), Obstacle.absent(device="cpu"), 3).obstacle.y,
    "make_batch_scenarios": lambda: make_batch_scenarios(
        np.zeros(4), np.ones(4), Obstacle.absent(device="cpu"), 3).noise_key,
    "DeviceSafeSet.empty": lambda: DeviceSafeSet.empty(2, 3, 4).states,
    "convert.tensor": lambda: convert.tensor(np.ones(3)),
    "GenericIlqrConfig.make": lambda: GenericIlqrConfig.make(
        np.zeros((2, 2)), np.eye(1), np.eye(2), [-1.0], [1.0]).u_upper,
    "I2LqrController": lambda: I2LqrController(
        IlqrParams.make(device="cpu")).limits.a_max,
    "NlmpcController": lambda: NlmpcController(
        LmpcParams.make(device="cpu")).limits.a_max,
    "latency_bench.solver_throughput_inputs":
        lambda: latency_bench.solver_throughput_inputs(
            4, np.random.default_rng(0))[1],
}


def test_default_device_is_the_current_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert device.default_device() == torch.device("cuda", 0)
    assert device.resolve(None) == torch.device("cuda", 0)
    assert device.resolve("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_takes_the_default_device(name, monkeypatch):
    # "meta" stands in for the card, which this test cannot assume
    monkeypatch.setattr(device, "default_device",
                        lambda: torch.device("meta"))
    assert ENTRY_POINTS[name]().device.type == "meta"


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
