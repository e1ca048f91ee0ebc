"""Checkpoint / resume of the host controllers' runs and of the batched
learning runs.

The host half ports ilqr_iterative_tasks_tpu/utils/checkpoint.py
(``save_run`` :18, ``load_run`` :38, ``restore_safe_set`` :75,
``resume_controller`` :85): a host run (experiments/runner.py's
RunResult) and its controller's safe set in a portable .npz under the JAX
file's keys and layouts (``num_laps``, ``lap_times``, ``seed_time``,
``lap_finished``, ``ss_x_i`` (4, T+1), ``ss_u_i`` (2, T), ``lap_state_i``,
``lap_input_i``, ``lap_solver_time_i``, ``lap_feasibility_i``), every
entry a numeric array, so that a file either package writes loads in the
other with ``allow_pickle=False``. The safe set is the learned state:
replaying ``add_trajectory`` over the stored laps re-seeds a fresh
controller exactly.

The SoA half ports ``save_soa_run`` :43 and ``load_soa_run`` :59: a
batched run's safe set, lap count and lap records in a portable .npz
under the JAX file's key names and layout (``lap_count``, ``lap_steps``,
``lap_done``, ``num_ss_tensors``, ``ss_0`` ... ``ss_{n-1}``), enough to
resume it exactly through the simulators' ``resume_from``. In place of JAX's threefry ``key`` a file of
the port stores what continues the port's noise (the result's
``final_key``): ``generator_state``, the torch generator's state, or
``noise_rows``, the count of injected noise rows consumed.

``load_soa_run`` also reads a file that the JAX package's ``save_soa_run``
wrote: its safe set and lap count. Its key drives JAX's noise, not the
port's, so the resumed run takes its noise as the caller gives it (a
generator, or the JAX run's draws injected from row 0).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ilqr_iterative_tasks_torch.utils.device import resolve


def save_run(path: str, result, controller) -> None:
    """Save a host run (RunResult) and its controller's safe set to
    ``path`` (.npz)."""
    ss = controller.safe_set
    payload = {
        "num_laps": np.asarray(ss.num_laps),
        "lap_times": np.asarray(result.lap_times),
        "seed_time": np.asarray(result.seed_time),
        "lap_finished": np.asarray(result.lap_finished),
    }
    for i in range(ss.num_laps):
        payload[f"ss_x_{i}"] = np.asarray(ss.ss[i])
        payload[f"ss_u_{i}"] = np.asarray(ss.u_ss[i])
    data, diag = result.plant.data, result.plant.diagnostics
    for i, states in enumerate(data["state"]):
        payload[f"lap_state_{i}"] = np.asarray(states)
        payload[f"lap_input_{i}"] = np.asarray(data["input"][i])
        payload[f"lap_solver_time_{i}"] = np.asarray(diag["solver_time"][i])
        payload[f"lap_feasibility_{i}"] = np.asarray(diag["feasibility"][i])
    np.savez_compressed(path, **payload)


def load_run(path: str) -> dict:
    """Every entry of a host run's file, as numpy arrays."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def restore_safe_set(path: str) -> List[Tuple[np.ndarray, np.ndarray]]:
    """[(x (T+1, 4) row-major, u (T, 2)), ...] a stored lap, ready to
    replay through ``controller.add_trajectory``."""
    data = load_run(path)
    return [(data[f"ss_x_{i}"].T, data[f"ss_u_{i}"].T)
            for i in range(int(data["num_laps"]))]


def resume_controller(controller, path: str):
    """Re-seed a fresh controller from a checkpoint (its exact safe set);
    run it on with ``run_closed_loop(..., seed_safe_set=False)``."""
    for x, u in restore_safe_set(path):
        controller.add_trajectory(x, u)
    return controller


def save_soa_run(path: str, result) -> None:
    """Checkpoint a batched run (SoaRunResult / NlmpcSoaRunResult): its
    safe-set tensors, lap count, lap records and noise position."""
    payload = {
        "lap_count": np.asarray(result.lap_count),
        "lap_steps": result.lap_steps.cpu().numpy(),
        "lap_done": result.lap_done.cpu().numpy(),
        "num_ss_tensors": np.asarray(len(result.safe_set)),
    }
    for i, t in enumerate(result.safe_set):
        payload[f"ss_{i}"] = t.cpu().numpy()
    key = result.final_key
    if isinstance(key, torch.Tensor):
        payload["generator_state"] = key.cpu().numpy()
    elif key is not None:
        payload["noise_rows"] = np.asarray(int(key))
    np.savez_compressed(path, **payload)


def load_soa_run(path: str, device=None):
    """Returns (resume_from, lap_steps, lap_done): resume_from is
    (safe_set on ``device``, lap_count, key) for the matching simulator
    (key: a generator state, a count of noise rows, or None for a file of
    the JAX package), the lap records numpy arrays. On the current CUDA
    device unless ``device`` is named.

        ck, steps, done = load_soa_run(p)
        res = simulate_learning_runs_soa(..., generator=g, resume_from=ck)
    """
    device = resolve(device)
    with np.load(path, allow_pickle=False) as z:
        ss = tuple(torch.from_numpy(z[f"ss_{i}"]).to(device)
                   for i in range(int(z["num_ss_tensors"])))
        if "generator_state" in z.files:
            key = torch.from_numpy(z["generator_state"])
        elif "noise_rows" in z.files:
            key = int(z["noise_rows"])
        else:
            key = None
        return (ss, int(z["lap_count"]), key), z["lap_steps"], z["lap_done"]
