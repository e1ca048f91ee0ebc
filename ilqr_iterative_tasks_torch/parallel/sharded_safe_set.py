"""Global L1 kNN over a safe set sharded along its rows: the meshed NLMPC
controller's space-varying candidate selection.

Port of ilqr_iterative_tasks_tpu/parallel/sharded_safe_set.py::sharded_knn.
Each rank takes its block of rows, computes masked L1 distances and a local
top-k, and the ranks ``all_gather`` k tuples of (distance, global row,
point, Qfun) each, from which every rank takes the global top-k: k tuples a
rank cross the group instead of the safe set. Torch ops, no kernel of its
own (the JAX module has none either).

Ties order by (distance, global row), as a stable sort of the whole set
would order them: each local top-k is a stable sort of the rank's rows, the
gathered tuples lie in mesh order (rows ascending by rank), and the global
top-k is a stable sort of them. (``torch.topk`` gives no stable order for
ties on CUDA.) The L1 distance adds the four coordinates' magnitudes left
to right, as numpy's ``norm(..., 1, axis=0)`` over a (4, T) array does
(control/safe_set.py::select_close).
"""

from __future__ import annotations

import torch

from ilqr_iterative_tasks_torch.parallel.mesh import Mesh


def l1_distances(states: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """|states - x|_1 of every row of ``states`` (T, 4), the coordinates
    added left to right."""
    d = (states - x[None, :]).abs()
    return ((d[:, 0] + d[:, 1]) + d[:, 2]) + d[:, 3]


def sharded_knn(states: torch.Tensor, valid: torch.Tensor,
                qfun: torch.Tensor, x_guess: torch.Tensor, k: int,
                mesh: Mesh, axis_name: str | None = None):
    """Global L1 kNN over the rows of a safe set split over the mesh.

    states (T, 4), valid (T,) bool, qfun (T,), x_guess (4,): the whole set,
    alike on every rank, T divisible by the mesh's ``axis_name`` (its
    first axis by default); each rank reads its block of T / n rows.
    Returns (global rows (m,), points (m, 4), qfun (m,), distances (m,)),
    m = min(k, valid rows), nearest first, ties by row. Invalid rows never
    win: where fewer than k rows are valid, fewer come back.
    """
    t, n = states.shape[0], mesh.axis_size(axis_name)
    if t % n:
        raise ValueError(f"{t} rows do not divide over a mesh of {n} ranks")
    shard = t // n
    lo = mesh.axis_index(axis_name) * shard
    rows = slice(lo, lo + shard)
    d = torch.where(valid[rows], l1_distances(states[rows], x_guess),
                    torch.inf)
    local = torch.sort(d, stable=True).indices[:min(k, shard)]
    tuples = torch.cat([d[local, None], states[rows][local],
                        qfun[rows][local, None].to(states.dtype)], dim=1)
    every = torch.cat(mesh.all_gather(tuples, axis_name))
    gidx = torch.cat(mesh.all_gather(local + lo, axis_name))
    sel = torch.sort(every[:, 0], stable=True).indices[:k]
    sel = sel[torch.isfinite(every[sel, 0])]
    return gidx[sel], every[sel, 1:5], every[sel, 5].to(qfun.dtype), \
        every[sel, 0]
