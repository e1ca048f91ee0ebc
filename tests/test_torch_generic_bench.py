"""The generic tier's entry point (experiments/generic_bench.py) at a tiny
size on the CPU: each mode returns its JSON row, and the lanes it builds
are contiguous, as the kernels on the card require."""

import json

import numpy as np
import pytest
import torch

from ilqr_iterative_tasks_torch.experiments import generic_bench as gb

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_bench_inputs_are_contiguous_lanes():
    xts = gb.candidates(5, np.random.default_rng(0), CPU)
    assert xts.shape == (4, 5) and xts.is_contiguous()
    for t, shape in zip(gb.throughput_inputs(5, CPU),
                        ((4, 5), (4, 5), (6, 2, 5))):
        assert t.shape == shape and t.is_contiguous()


def test_bench_modes_return_their_rows():
    thr = gb.bench_throughput(batch=4, max_iter=3, device="cpu")
    assert thr["card"] == "cpu" and thr["k5_launches"] == 0
    assert 1 <= thr["max_iters"] <= 3
    ker = gb.bench_kernel(batch=4, max_iter=3, device="cpu")
    assert ker["k5_launches"] == 0 and ker["k3_launches"] == 0
    assert ker["bicycle_k5_solves_per_s"] > 0
    cro = gb.bench_crossover(batch=3, horizons=(5,), device="cpu")
    assert set(cro["solve_ms_by_horizon"][5]) == {"sequential", "parallel",
                                                  "speedup"}
    for row in (thr, ker, cro):
        json.dumps(row)


def test_card_line_picks_the_device_by_pci_address_or_uuid(monkeypatch):
    props = type("Props", (), dict(pci_domain_id=0, pci_bus_id=0x5D,
                                   pci_device_id=0, uuid="b877-01"))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: props)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device: "Card B")
    listing = []

    def run(cmd, **kw):
        return type("Done", (), {"stdout": "\n".join(listing) + "\n"})

    monkeypatch.setattr(gb.subprocess, "run", run)
    dev = torch.device("cuda", 0)
    # torch's device 0 is nvidia-smi's second row (CUDA_VISIBLE_DEVICES=1)
    listing[:] = ["00000000:19:00.0, GPU-aaaa, Card A, 700.00 W",
                  "00000000:5D:00.0, GPU-cccc, Card B, 500.00 W"]
    assert gb.card_line(dev) == "Card B, 500.00 W"
    listing[:] = ["[N/A], GPU-aaaa, Card A, 700.00 W",
                  "[N/A], GPU-b877-01, Card B, 500.00 W"]
    assert gb.card_line(dev) == "Card B, 500.00 W"
    # nvidia-smi hides both: its only row, else not identified
    listing[:] = ["[N/A], GPU-REDACTED, Card B, 500.00 W"]
    assert gb.card_line(dev) == "Card B, 500.00 W"
    listing[:] = ["[N/A], GPU-REDACTED, Card A, 700.00 W"] * 2
    assert gb.card_line(dev) == ("Card B, power limit not identified "
                                 "(nvidia-smi hides the cards' PCI "
                                 "addresses)")
    assert gb.card_line(CPU) == "cpu"


def test_warp_trips_counts_each_group_to_its_slowest_lane():
    # the plain K5's own trip counts on 70 --throughput lanes: two whole
    # groups of 32 and a ragged one of 6
    p = gb.IlqrParams.make(device="cpu")
    lim = gb.SystemLimits.make(device="cpu")
    k5 = gb.build_fused_generic_ilqr(gb.double_integrator, **gb.generic_kwargs(
        p, lim, max_iter=40, matrix_Q=np.zeros((4, 4))))
    trips = k5.plain(*gb.throughput_inputs(70, CPU))[3]
    t = [int(v) for v in trips]
    assert max(t) > min(t)  # the lanes differ, so the groups waste trips
    executed = sum(len(t[i:i + 32]) * max(t[i:i + 32]) for i in (0, 32, 64))
    got = gb.warp_trips(trips, 40)
    assert got["lanes_at_cap"] == sum(v == 40 for v in t)
    assert got["mean_trips"] == pytest.approx(sum(t) / 70)
    assert got["mean_warp_max"] == pytest.approx(
        (max(t[:32]) + max(t[32:64]) + max(t[64:])) / 3)
    assert got["executed_over_useful"] == pytest.approx(executed / sum(t))
    # one group of one lane each wastes nothing
    assert gb.warp_trips(trips, 40, warp=1)["executed_over_useful"] == 1.0
