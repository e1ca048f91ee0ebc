"""Checkpoint / resume of the batched learning runs.

Port of the SoA half of ilqr_iterative_tasks_tpu/utils/checkpoint.py
(``save_soa_run`` :43, ``load_soa_run`` :59): a run's safe set, lap count
and lap records in a portable .npz under the JAX file's key names and
layout (``lap_count``, ``lap_steps``, ``lap_done``, ``num_ss_tensors``,
``ss_0`` ... ``ss_{n-1}``), enough to resume it exactly through the
simulators' ``resume_from``. In place of JAX's threefry ``key`` a file of
the port stores what continues the port's noise (the result's
``final_key``): ``generator_state``, the torch generator's state, or
``noise_rows``, the count of injected noise rows consumed.

``load_soa_run`` also reads a file that the JAX package's ``save_soa_run``
wrote: its safe set and lap count. Its key drives JAX's noise, not the
port's, so the resumed run takes its noise as the caller gives it (a
generator, or the JAX run's draws injected from row 0).
"""

from __future__ import annotations

import numpy as np
import torch

from ilqr_iterative_tasks_torch.utils.device import resolve


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
