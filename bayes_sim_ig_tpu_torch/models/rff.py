"""Random Fourier Features with RBF / Matern kernel spectral densities.

Port of ``bayes_sim_ig_tpu/models/rff.py``. Frequencies are drawn once at
construction on the host (quasi-random generalized-Halton points pushed
through the kernel's inverse spectral CDF when quasi_random, direct
sampling from numpy's global generator otherwise) and kept as the
``coeff`` buffer on the module's device. The sin/cos feature map runs
through ``ops.rff_features``: the hand-written CUDA kernel on the card,
its plain version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import erfinv
from torch import nn

from ..distributions.halton import halton_sequence
from ..ops import rff_features
from ..utils.device import resolve_device


class RFFKernel:
    """Spectral density of a shift-invariant kernel."""

    def sample_freqs(self, shape):
        raise NotImplementedError

    def inv_cdf(self, x):
        raise NotImplementedError


class RFFKernelRBF(RFFKernel):
    def sample_freqs(self, shape):
        return np.random.normal(0.0, 1.0, shape)

    def inv_cdf(self, x):
        return erfinv(2.0 * x - 1.0) * np.sqrt(2.0)


class RFFKernelMatern12(RFFKernel):
    """Laplace kernel; spectral density is a standard Cauchy."""

    def sample_freqs(self, shape):
        return np.random.normal(0, 1, shape) * np.sqrt(
            1.0 / np.random.chisquare(1, shape))

    def inv_cdf(self, x):
        return np.tan(np.pi * (x - 0.5))


class RFFKernelMatern32(RFFKernel):
    """Spectral density is Student-t with 3 dof (inverse CDF per Shaw 2006)."""

    def sample_freqs(self, shape):
        return np.random.normal(0, 1, shape) * np.sqrt(
            3.0 / np.random.chisquare(3, shape))

    def inv_cdf(self, x):
        return (2.0 * x - 1.0) / np.sqrt(2.0 * x * (1.0 - x))


class RFFKernelMatern52(RFFKernel):
    """Spectral density is Student-t with 5 dof (inverse CDF per Shaw 2006)."""

    def sample_freqs(self, shape):
        return np.random.normal(0, 1, shape) * np.sqrt(
            5.0 / np.random.chisquare(5, shape))

    def inv_cdf(self, x):
        alpha = 4.0 * x * (1.0 - x)
        p = 4.0 * np.cos(np.arccos(np.sqrt(alpha)) / 3.0) / np.sqrt(alpha)
        return np.sign(x - 0.5) * np.sqrt(p - 4.0)


_KERNELS = {
    "RBF": RFFKernelRBF,
    "Laplace": RFFKernelMatern12,
    "Matern12": RFFKernelMatern12,
    "Matern32": RFFKernelMatern32,
    "Matern52": RFFKernelMatern52,
}


class RFF(nn.Module):
    """Random Fourier feature map phi: R^d -> R^n_feat.

    Make sure the input space is roughly normalized (range within ~one order
    of magnitude), as in the reference. ``device`` is the card by default;
    without one, pass ``device="cpu"``.
    """

    def __init__(self, n_feat, d, sigma, cos_only=False, quasi_random=True,
                 kernel="RBF", device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.n_feat = int(n_feat)
        self.d = int(d)
        if isinstance(sigma, (list, tuple, np.ndarray)):
            sigma = np.asarray(sigma, dtype=np.float64)
            assert sigma.shape == (self.d,)
        else:
            sigma = np.full(self.d, float(sigma))
        self.cos_only = cos_only
        if kernel not in _KERNELS:
            raise ValueError(f"Kernel {kernel} is not recognised.")
        rff_kernel = _KERNELS[kernel]()
        if cos_only:
            freqs = self.draw_freqs(rff_kernel, self.n_feat, self.d,
                                    quasi_random)
            offset = 2.0 * np.pi * np.random.rand(1, self.n_feat)
            self.register_buffer("offset", torch.as_tensor(
                offset, dtype=torch.float32, device=device))
            self.a = float(np.sqrt(1.0 / self.n_feat))
        else:
            assert self.n_feat % 2 == 0
            freqs = self.draw_freqs(rff_kernel, self.n_feat // 2, self.d,
                                    quasi_random)
            self.offset = None
            self.a = float(np.sqrt(1.0 / (self.n_feat / 2)))
        # Pre-divide by the lengthscale: phi uses x @ (freqs/sigma)^T.
        coeff = np.ascontiguousarray((freqs / sigma).T,
                                     np.float32)  # (d, m)
        self.register_buffer("coeff", torch.as_tensor(coeff, device=device))

    @staticmethod
    def draw_freqs(rff_kernel, m, d, quasi_random):
        """(m, d) frequency draws from the kernel's spectral density."""
        if quasi_random:
            points = halton_sequence(m, d)
            return rff_kernel.inv_cdf(points)
        return rff_kernel.sample_freqs((m, d))

    def to_features(self, x):
        """Feature map. The cos/sin variant of 2-D inputs goes through
        ``ops.rff_features``; cos-only and other ranks are plain torch."""
        if self.cos_only:
            return self.a * torch.cos(x @ self.coeff + self.offset)
        if x.ndim == 2:
            return rff_features(x.contiguous(), self.coeff, self.a)
        inner = x @ self.coeff
        return self.a * torch.cat([torch.cos(inner), torch.sin(inner)],
                                  dim=-1)

    forward = to_features
