# Frozen copy of bayes_sim_ig_tpu_torch/distributions/device.py (commit 57f9c0d); see frozen/__init__.py for what changed.
"""Device-side (tensor) forms of the sampling distributions.

The current sampling distribution (uniform prior or MoG posterior) is
converted once per ADR iteration into tensors on the env's device, and the
envs sample whole batches of param vectors there at reset steps. Samples
are clipped to [lows, highs], matching ``ParamsGenerator.sample``
semantics.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from ..utils.device import env_draw


class DeviceUniform(NamedTuple):
    """Box uniform over params; all fields shaped (P,)."""
    lows: torch.Tensor
    highs: torch.Tensor


class DeviceMoG(NamedTuple):
    """Mixture of Gaussians over params, plus clip bounds.

    weights: (K,); means: (K, P); chols: (K, P, P) lower-triangular
    covariance factors (L L' = S); lows/highs: (P,) clip bounds.
    """
    weights: torch.Tensor
    means: torch.Tensor
    chols: torch.Tensor
    lows: torch.Tensor
    highs: torch.Tensor


DeviceDistr = Union[DeviceUniform, DeviceMoG]


def sample_distr(distr: DeviceDistr, gen: torch.Generator,
                 n: int) -> torch.Tensor:
    """Draws ``n`` param vectors (one per env) from a device distribution,
    clipped to the param box. ``gen`` lives on the distribution's device."""
    if isinstance(distr, DeviceUniform):
        u = env_draw(torch.rand, (n, distr.lows.shape[0]), gen,
                     dtype=distr.lows.dtype, device=distr.lows.device)
        return distr.lows + u * (distr.highs - distr.lows)
    comp = env_draw(
        lambda shape, generator: torch.multinomial(
            distr.weights, shape[0], replacement=True, generator=generator),
        (n,), gen)
    z = env_draw(torch.randn, (n, distr.means.shape[1]), gen,
                 dtype=distr.means.dtype, device=distr.means.device)
    smpl = distr.means[comp] + torch.einsum("nij,nj->ni", distr.chols[comp],
                                            z)
    return torch.clamp(smpl, distr.lows, distr.highs)
