"""Where the port's entry points put their tensors when the caller names no
device: on the current CUDA device. There is no fallback to the CPU; a
caller who wants the CPU says ``device="cpu"``."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The current CUDA device; raises where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device=None) -> torch.device:
    """``device`` as a torch.device; None means ``default_device()``."""
    return default_device() if device is None else torch.device(device)
