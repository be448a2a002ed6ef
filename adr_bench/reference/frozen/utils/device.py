# Frozen copy of bayes_sim_ig_tpu_torch/utils/device.py (commit 57f9c0d); see frozen/__init__.py for what changed.
"""The device pick of the port's entry points: the card by default."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch device of an entry point's tensors. ``make_env``, the
    tasks, ``BayesSim`` and the density models default to the card;
    without one that default raises instead of running on the CPU, which a
    caller asks for with ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but "
                           f"torch.cuda.is_available() is False: pass "
                           f"device='cpu' to run on the CPU")
    return device


def env_draw(draw, shape, generator: torch.Generator, env_dim: int = 0,
             **kwargs) -> torch.Tensor:
    """``draw(shape, generator=generator, **kwargs)``: a per-env draw on
    one device (the port's ``parallel/mesh.py::env_draw`` without a
    mesh)."""
    return draw(tuple(shape), generator=generator, **kwargs)
