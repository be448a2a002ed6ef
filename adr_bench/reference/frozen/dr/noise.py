# Frozen copy of bayes_sim_ig_tpu_torch/dr/noise.py (commit 57f9c0d); see frozen/__init__.py for what changed.
"""Observation/action domain-randomization noise with schedules.

Port of ``bayes_sim_ig_tpu/dr/noise.py``: gaussian or uniform noise,
additive or scaling, with 'linear'/'constant' schedules over the global
frame count (a device scalar, as in the JAX package), plus a correlated
component that is drawn once per randomization refresh and held fixed in
the env state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.device import env_draw


class NoiseConfig(NamedTuple):
    """Static config for one noise channel ('observations' or 'actions')."""
    distribution: str          # 'gaussian' | 'uniform'
    operation: str             # 'additive' | 'scaling'
    lo_or_mu: float            # range[0]
    hi_or_var: float           # range[1]
    lo_or_mu_corr: float       # range_correlated[0] (default 0)
    hi_or_var_corr: float      # range_correlated[1] (default 0)
    schedule: Optional[str]    # None | 'linear' | 'constant'
    schedule_steps: int
    has_correlated: bool       # range_correlated was configured


def make_noise_config(cfg: dict) -> NoiseConfig:
    """Parses one 'observations'/'actions' subtree of randomization_params."""
    rc = cfg.get("range_correlated", [0.0, 0.0])
    return NoiseConfig(
        distribution=cfg["distribution"],
        operation=cfg["operation"],
        lo_or_mu=float(cfg["range"][0]),
        hi_or_var=float(cfg["range"][1]),
        lo_or_mu_corr=float(rc[0]),
        hi_or_var_corr=float(rc[1]),
        schedule=cfg.get("schedule"),
        schedule_steps=int(cfg.get("schedule_steps", 0)),
        has_correlated="range_correlated" in cfg)


def schedule_scaling(cfg: NoiseConfig,
                     frame_count: torch.Tensor) -> torch.Tensor:
    """Schedule multiplier at the global frame count, a () int32 tensor on
    the env's device: float32 on that device, as in the JAX package, so a
    captured step reads the count of the step it replays."""
    frame = frame_count.to(torch.float32)
    if cfg.schedule == "linear":
        if cfg.schedule_steps <= 0:
            # 'linear' with no/zero schedule_steps would otherwise pin the
            # multiplier at 0 forever; treat it as fully ramped.
            return torch.ones_like(frame)
        steps = float(cfg.schedule_steps)
        return torch.clamp(frame, max=steps) / steps
    if cfg.schedule == "constant":
        return torch.where(frame < cfg.schedule_steps, 0.0, 1.0)
    return torch.ones_like(frame)


def apply_noise(cfg: NoiseConfig, gen: torch.Generator, tensor: torch.Tensor,
                corr: torch.Tensor, frame_count: torch.Tensor) -> torch.Tensor:
    """Applies scheduled correlated + white noise to ``tensor``.

    ``corr`` is a standard-normal draw with ``tensor``'s shape held fixed
    between randomization refreshes. With 'scaling', the correlated term's
    identity interpolation applies only when range_correlated was
    configured (as in the JAX package)."""
    s = schedule_scaling(cfg, frame_count)
    if cfg.distribution == "gaussian":
        mu, var = cfg.lo_or_mu, cfg.hi_or_var
        mu_c, var_c = cfg.lo_or_mu_corr, cfg.hi_or_var_corr
        if cfg.operation == "additive":
            mu, var, mu_c, var_c = mu * s, var * s, mu_c * s, var_c * s
        elif cfg.operation == "scaling":
            var = var * s
            mu = mu * s + 1.0 * (1.0 - s)
            var_c = var_c * s
            if cfg.has_correlated:
                mu_c = mu_c * s + 1.0 * (1.0 - s)
        corr_term = corr * var_c + mu_c
        noise = corr_term + env_draw(
            torch.randn, tensor.shape, gen, dtype=tensor.dtype,
            device=tensor.device) * var + mu
    elif cfg.distribution == "uniform":
        lo, hi = cfg.lo_or_mu, cfg.hi_or_var
        lo_c, hi_c = cfg.lo_or_mu_corr, cfg.hi_or_var_corr
        if cfg.operation == "additive":
            lo, hi, lo_c, hi_c = lo * s, hi * s, lo_c * s, hi_c * s
        elif cfg.operation == "scaling":
            lo = lo * s + 1.0 * (1.0 - s)
            hi = hi * s + 1.0 * (1.0 - s)
            if cfg.has_correlated:
                lo_c = lo_c * s + 1.0 * (1.0 - s)
                hi_c = hi_c * s + 1.0 * (1.0 - s)
        # The reference feeds a *normal* draw into the correlated uniform
        # range; reproduced.
        corr_term = corr * (hi_c - lo_c) + lo_c
        noise = corr_term + env_draw(
            torch.rand, tensor.shape, gen, dtype=tensor.dtype,
            device=tensor.device) * (hi - lo) + lo
    else:
        raise ValueError(f"Unknown noise distribution {cfg.distribution}")
    if cfg.operation == "additive":
        return tensor + noise
    return tensor * noise
