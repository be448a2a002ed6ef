"""Mixture density model over Random Fourier Features: an MDNN with NO
hidden layers whose input is an RFF feature map of the trajectory summary.
Quasi-random frequency draws are used iff input_dim <= 100. Defaults to
the card, as MDNN."""

from __future__ import annotations

from .mdnn import MDNN
from .rff import RFF


class MDRFF(MDNN):
    def __init__(self, input_dim, output_dim, output_lows, output_highs,
                 n_gaussians, lr, activation, full_covariance,
                 n_feat=500, kernel="RBF", sigma=1.0, seed=0, device="cuda",
                 **kwargs):
        super().__init__(
            input_dim=n_feat, output_dim=output_dim,
            output_lows=output_lows, output_highs=output_highs,
            n_gaussians=n_gaussians, hidden_layers=[], lr=lr,
            activation=activation, full_covariance=full_covariance,
            seed=seed, device=device)
        self.rff = RFF(n_feat, input_dim, sigma, cos_only=False,
                       quasi_random=input_dim <= 100, kernel=kernel,
                       device=self.device)

    def _features(self, x):
        return self.rff(x)
