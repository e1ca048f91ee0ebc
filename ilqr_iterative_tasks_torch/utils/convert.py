"""Build the port's objects from the JAX package's, through numpy.

Each function takes an object with the JAX package's field names whose
leaves convert with ``numpy.asarray`` (JAX arrays do), and returns the
port's counterpart on ``device`` (None: the current CUDA device) in ``dtype``.
Nothing here imports jax;
tests use these so both packages compute from the same inputs.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from ilqr_iterative_tasks_torch.control.batched_soa import SoaScenarios
from ilqr_iterative_tasks_torch.models.obstacle import Obstacle
from ilqr_iterative_tasks_torch.ops.generic_ilqr import GenericIlqrConfig
from ilqr_iterative_tasks_torch.utils.device import resolve
from ilqr_iterative_tasks_torch.utils.params import (
    IlqrParams, LmpcParams, SystemLimits)


def tensor(a, *, dtype=None, device=None) -> torch.Tensor:
    """numpy-convertible array -> tensor (dtype None keeps numpy's)."""
    return torch.as_tensor(np.array(a), dtype=dtype, device=resolve(device))


def _leaves(src, cls, **kw):
    """The tensor fields of dataclass ``cls``, read from ``src``."""
    return {f.name: tensor(getattr(src, f.name), **kw)
            for f in fields(cls) if f.type == "torch.Tensor"}


def ilqr_params(src, *, dtype=torch.float64, device=None) -> IlqrParams:
    static = {f.name: int(getattr(src, f.name)) for f in fields(IlqrParams)
              if f.type == "int"}
    return IlqrParams(**_leaves(src, IlqrParams, dtype=dtype, device=device),
                      **static)


def lmpc_params(src, *, dtype=torch.float64, device=None) -> LmpcParams:
    static = {f.name: getattr(src, f.name) for f in fields(LmpcParams)
              if f.type != "torch.Tensor"}
    return LmpcParams(**_leaves(src, LmpcParams, dtype=dtype, device=device),
                      **static)


def system_limits(src, *, dtype=torch.float64, device=None) -> SystemLimits:
    return SystemLimits(**_leaves(src, SystemLimits, dtype=dtype,
                                  device=device))


def obstacle(src, *, dtype=torch.float64, device=None) -> Obstacle:
    return Obstacle(**_leaves(src, Obstacle, dtype=dtype, device=device))


def scenarios(src, *, dtype=torch.float64, device=None) -> SoaScenarios:
    f = lambda a: tensor(a, dtype=dtype, device=device)
    return SoaScenarios(x0=f(src.x0), goal=f(src.goal),
                        obstacle=obstacle(src.obstacle, dtype=dtype,
                                          device=device),
                        noise_on=f(src.noise_on))


def generic_config(src, *, dtype=torch.float64,
                   device=None) -> GenericIlqrConfig:
    """The JAX package's ``GenericIlqrConfig`` as the port's."""
    f = lambda a: tensor(a, dtype=dtype, device=device)
    return GenericIlqrConfig(*(f(getattr(src, name))
                               for name in GenericIlqrConfig._fields[:-1]),
                             int(src.max_iter))


def safe_set(src, *, dtype=torch.float64, device=None) -> tuple:
    """i2LQR (states, qfun, valid, lap_len) or NLMPC (states, inputs, qfun,
    valid, lap_len) -> tensors (valid bool, lap_len i32)."""
    *real, valid, lap_len = src
    return (*(tensor(a, dtype=dtype, device=device) for a in real),
            tensor(valid, dtype=torch.bool, device=device),
            tensor(lap_len, dtype=torch.int32, device=device))
