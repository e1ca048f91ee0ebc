"""Rank meshes over the process group.

Port of ilqr_iterative_tasks_tpu/parallel/mesh.py. A mesh is a 1-D or 2-D
grid of ranks with named axes:
- ``scenario``: data parallelism over independent lap simulations, and
- ``candidate`` / ``history``: parallelism over the safe-set candidates of
  one solve (the meshed NLMPC controller, parallel/sharded_safe_set.py).

The mesh is the port's own small object, not
``torch.distributed.device_mesh.DeviceMesh``: that needs a joined group and
takes its backend from the device type, while a sharded run must also work
on one rank with no group at all, and ranks that share one card must hold
a gloo group over CUDA tensors. Each axis keeps the process group of this
rank's line along it; the collectives are those of that group (none
where the line is one rank of a larger world, or no group was joined; a
world of one rank runs them through its backend). Every rank of the world
builds every mesh (forming a group is collective); a rank outside the
mesh gets None.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from ilqr_iterative_tasks_torch.parallel.distributed import rank_device


@dataclass(frozen=True)
class Mesh:
    """``ranks``: global ranks in row-major mesh order, of ``shape``;
    ``axis_names`` name the axes; ``rank`` is this process's rank and
    ``device`` its device; ``groups[axis]`` the process group of this
    rank's line along ``axis`` (None, or absent, where the line is this
    rank alone outside a world of one: no collective runs there)."""

    ranks: tuple
    shape: tuple
    axis_names: tuple
    rank: int
    device: torch.device
    groups: dict = field(default_factory=dict)

    @property
    def size(self) -> int:
        return len(self.ranks)

    def _axis(self, axis: Optional[str]) -> int:
        return 0 if axis is None else self.axis_names.index(axis)

    def axis_size(self, axis: Optional[str] = None) -> int:
        return self.shape[self._axis(axis)]

    def axis_index(self, axis: Optional[str] = None) -> int:
        """This rank's position along ``axis`` (the first by default)."""
        pos, coords = self.ranks.index(self.rank), []
        for n in reversed(self.shape):
            coords.append(pos % n)
            pos //= n
        return coords[::-1][self._axis(axis)]

    def all_gather(self, t: torch.Tensor, axis: Optional[str] = None):
        """``t`` of every rank on this rank's line along ``axis``, in mesh
        order (each rank's ``t`` of one shape and dtype)."""
        group = self.groups.get(self.axis_names[self._axis(axis)])
        if group is None:
            return [t]
        src = t.contiguous()
        if src.dtype == torch.bool:
            src = src.to(torch.uint8)
        out = [torch.empty_like(src) for _ in range(self.axis_size(axis))]
        dist.all_gather(out, src, group=group)
        return [o.to(torch.bool) for o in out] if t.dtype == torch.bool \
            else out

    def barrier(self) -> None:
        """Every rank of the mesh reaches this point."""
        group = self._whole()
        if group is None:
            return
        if dist.get_backend(group) == "nccl":
            dist.barrier(group=group, device_ids=[self.device.index])
        else:
            dist.barrier(group=group)

    def _whole(self):
        if len(self.shape) == 1:
            return self.groups.get(self.axis_names[0])
        return self.groups.get("*")


def _world():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _group(members, world):
    """The group of ``members`` (every rank must call this): the default
    group for the whole world (a world of one rank included, so that its
    collectives run through the backend), None for one rank of a larger
    world or where no group was joined."""
    if not dist.is_initialized():
        return None
    if len(members) == world:
        return dist.group.WORLD
    if len(members) == 1:
        return None
    return dist.new_group(list(members))


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "scenario") -> Optional[Mesh]:
    """1-D mesh over the first ``n_devices`` ranks (all by default)."""
    world, rank = _world()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    ranks = tuple(range(n))
    group = _group(ranks, world)
    if rank not in ranks:
        return None
    return Mesh(ranks=ranks, shape=(n,), axis_names=(axis_name,), rank=rank,
                device=rank_device(), groups={axis_name: group})


def make_mesh_2d(n_scenario: int, n_candidate: int) -> Optional[Mesh]:
    """2-D mesh: scenario-parallel x candidate-parallel over the first
    n_scenario * n_candidate ranks, row-major (a rank's candidate line
    holds consecutive ranks)."""
    world, rank = _world()
    n = n_scenario * n_candidate
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    groups = {"*": _group(tuple(range(n)), world)}
    for axis, lines in (
            ("scenario", [tuple(range(c, n, n_candidate))
                          for c in range(n_candidate)]),
            ("candidate", [tuple(range(s * n_candidate,
                                       (s + 1) * n_candidate))
                           for s in range(n_scenario)])):
        for line in lines:
            g = _group(line, world)
            if rank in line:
                groups[axis] = g
    if rank >= n:
        return None
    return Mesh(ranks=tuple(range(n)), shape=(n_scenario, n_candidate),
                axis_names=("scenario", "candidate"), rank=rank,
                device=rank_device(), groups=groups)
