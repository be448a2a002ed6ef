"""Device-side (tensor) forms of the sampling distributions.

The current sampling distribution (uniform prior or MoG posterior) is
converted once per ADR iteration into tensors on the env's device, and the
envs sample whole batches of param vectors there at reset steps. Samples
are clipped to [lows, highs], matching ``ParamsGenerator.sample``
semantics.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

from ..parallel.mesh import env_draw
from ..utils.device import resolve_device
from . import pdf


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


def to_device_distr(distr, lows=None, highs=None,
                    device="cuda") -> DeviceDistr:
    """Converts a host ``pdf.Uniform``/``pdf.Gaussian``/``pdf.MoG`` into its
    float32 tensor form on ``device`` (the card by default; without one,
    pass ``device="cpu"``). ``lows``/``highs`` are the param bounds used for
    clipping (default: the Uniform's own bounds; required for
    MoG/Gaussian)."""
    device = resolve_device(device)

    def t(v):
        return torch.as_tensor(np.asarray(v), dtype=torch.float32,
                               device=device)

    if isinstance(distr, pdf.Uniform):
        lo = distr.lb_array if lows is None else lows
        hi = distr.ub_array if highs is None else highs
        return DeviceUniform(t(lo), t(hi))
    if isinstance(distr, pdf.Gaussian):
        distr = pdf.MoG(a=np.ones(1), xs=[distr])
    if isinstance(distr, pdf.MoG):
        assert lows is not None and highs is not None, \
            "MoG device sampling needs clip bounds"
        means = np.stack([g.m for g in distr.xs])
        # g.C is upper triangular with S = C'C, so C' is the lower factor.
        chols = np.stack([g.C.T for g in distr.xs])
        return DeviceMoG(weights=t(distr.a), means=t(means), chols=t(chols),
                         lows=t(lows), highs=t(highs))
    raise TypeError(f"Cannot convert {type(distr)} to a device distribution")


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
