# Frozen copy of bayes_sim_ig_tpu_torch/models/mdnn.py (commit 57f9c0d); see frozen/__init__.py for what changed.
"""Mixture Density Network (MDN) for BayesSim, in PyTorch.

Port of ``bayes_sim_ig_tpu/models/mdnn.py`` with the same learning
semantics:

  * fully-connected trunk (tanh default) -> heads: mixture weights
    (softmax clamped to >= 1e-5 then renormalized), means, exp-diagonal
    scale factors (+ small uniform noise for stability), optional
    lower-triangular Cholesky entries for full covariance;
  * NLL loss: per-component multivariate-normal log-prob, clamped to
    +-1e5, plus log component weight, logsumexp over components, mean
    over the batch;
  * Adam (optax's ``scale_by_adam`` then ``scale(-lr)``) with a FRESH
    optimizer state per ``run_training`` call;
  * targets normalized to [0, 1] by output lows/highs; the first
    (1 - test_frac) of the data is train, the rest test, unshuffled;
    random minibatches with replacement;
  * Linear init U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases.

The trainer is split into ``mdn_train_step`` (one update from explicit
minibatch ids and noise) and the loop in ``MDNN.run_training`` that draws
them from the model's generator. The loop's step (the draws, the update
and its loss) runs on static buffers as a ``Graphed``
(``utils/step_graph.py``): a CUDA graph replayed an update on the card,
the body on the CPU. The weights and the Adam state are written in place
(``reinit`` too), so the graph keeps reading the model's tensors.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


LL_LIMIT = 1.0e5     # limit log likelihood to avoid large gradients
MIN_WEIGHT = 1.0e-5  # minimum component weight to keep updates alive
EPS_NOISE = 1.0e-5   # scale-diagonal stability noise
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "leaky_relu": F.leaky_relu,
}


def _linear_init(layer: nn.Linear, gen: torch.Generator) -> nn.Linear:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias, drawn from
    ``gen``."""
    bound = 1.0 / np.sqrt(max(layer.in_features, 1))
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=gen)
        layer.bias.uniform_(-bound, bound, generator=gen)
    return layer


class MDNNNet(nn.Module):
    """The MDN's layers; ``forward`` is the port of ``mdnn_forward``."""

    def __init__(self, input_dim, output_dim, n_gaussians, hidden_layers,
                 full_covariance, activation="tanh"):
        super().__init__()
        self.output_dim = int(output_dim)
        self.n_gaussians = int(n_gaussians)
        self.activation = activation
        l_size = self.output_dim * (self.output_dim - 1) // 2
        layers, last = [], int(input_dim)
        for h in hidden_layers:
            layers.append(nn.Linear(last, int(h)))
            last = int(h)
        self.trunk = nn.ModuleList(layers)
        self.pi = nn.Linear(last, self.n_gaussians)
        self.mu = nn.Linear(last, self.output_dim * self.n_gaussians)
        self.diag = nn.Linear(last, self.output_dim * self.n_gaussians)
        self.lower = (nn.Linear(last, l_size * self.n_gaussians)
                      if l_size > 0 and full_covariance else None)

    def forward(self, x, noise):
        """Returns (weights, mu, L_d, L): weights (B, K); mu, L_d (B, D, K);
        L (B, L_size, K) or None. ``noise`` is a U[0, 1) draw shaped like
        L_d that scales the stability jitter."""
        act = _ACTIVATIONS[self.activation]
        h = x
        for layer in self.trunk:
            h = act(layer(h))
        weights = torch.softmax(self.pi(h), dim=-1)
        weights = torch.clamp(weights, MIN_WEIGHT, 1.0)
        weights = weights / weights.sum(dim=1, keepdim=True)
        shape = (-1, self.output_dim, self.n_gaussians)
        mu = self.mu(h).reshape(shape)
        l_d = torch.exp(self.diag(h)).reshape(shape)
        eps = EPS_NOISE * l_d.mean()
        l_d = l_d + noise * eps
        lower = None
        if self.lower is not None:
            lower = self.lower(h).reshape(-1, self.lower.out_features
                                          // self.n_gaussians,
                                          self.n_gaussians)
        return weights, mu, l_d, lower


def init_mdnn_params(gen: torch.Generator, input_dim, output_dim,
                     n_gaussians, hidden_layers, full_covariance,
                     activation="tanh") -> MDNNNet:
    """Builds an MDNNNet on the CPU with weights drawn from ``gen`` (a CPU
    generator), in the layer order of the JAX package's init."""
    net = MDNNNet(input_dim, output_dim, n_gaussians, hidden_layers,
                  full_covariance, activation)
    for layer in list(net.trunk) + [net.pi, net.mu, net.diag]:
        _linear_init(layer, gen)
    if net.lower is not None:
        _linear_init(net.lower, gen)
    return net


@functools.lru_cache(maxsize=None)
def _tril_layout(output_dim, device):
    """Gather permutation + mask mapping [diag | packed-lower] -> (D, D),
    built once per width and device: a host-to-device copy per call would
    sync every update (and could not be captured)."""
    perm = np.zeros((output_dim, output_dim), np.int64)
    mask = np.zeros((output_dim, output_dim), np.float32)
    di = np.arange(output_dim)
    perm[di, di] = di
    mask[di, di] = 1.0
    rows, cols = np.tril_indices(output_dim, -1)
    perm[rows, cols] = output_dim + np.arange(len(rows))
    mask[rows, cols] = 1.0
    return (torch.as_tensor(perm.ravel(), device=device),
            torch.as_tensor(mask, device=device))


def _scale_tril(l_d_k, lower_k, output_dim):
    """Builds (B, D, D) lower-triangular scale factors for one component
    from the packed [diag | strict-lower] vector."""
    if lower_k is None:
        return torch.diag_embed(l_d_k)
    perm, mask = _tril_layout(output_dim, l_d_k.device)
    packed = torch.cat([l_d_k, lower_k], dim=1)
    tril = packed[:, perm].reshape(l_d_k.shape[0], output_dim, output_dim)
    return tril * mask


def mdn_loss(weights, mu, l_d, lower, y):
    """Mixture NLL: clamp per-component log-probs to +-1e5, add log
    weights, logsumexp, negate, mean over batch. Diagonal covariance takes
    the O(B*K*D) whitening path; full covariance solves the triangular
    scale factors per component."""
    batch, output_dim, n_gaussians = mu.shape
    log2pi = float(np.log(2.0 * np.pi))
    if lower is None:
        z = (y[:, :, None] - mu) / l_d                    # (B, D, K)
        logdet = torch.log(l_d).sum(dim=1)                # (B, K)
        lp = -0.5 * ((z * z).sum(dim=1) + output_dim * log2pi) - logdet
        lp = torch.clamp(lp, -LL_LIMIT, LL_LIMIT)
        w = torch.clamp(weights, MIN_WEIGHT, 1.0)
        return -torch.logsumexp(lp + torch.log(w), dim=1).mean()
    comp_lps = []
    for k in range(n_gaussians):
        tril = _scale_tril(l_d[:, :, k], lower[:, :, k], output_dim)
        diff = y - mu[:, :, k]
        z = torch.linalg.solve_triangular(tril, diff[..., None],
                                          upper=False)[..., 0]
        logdet = torch.log(l_d[:, :, k]).sum(dim=-1)
        lp = -0.5 * ((z * z).sum(dim=-1) + output_dim * log2pi) - logdet
        lp = torch.clamp(lp, -LL_LIMIT, LL_LIMIT)
        w = torch.clamp(weights[:, k], MIN_WEIGHT, 1.0)
        comp_lps.append(lp + torch.log(w))
    result = torch.stack(comp_lps, dim=1)  # (B, K)
    return -torch.logsumexp(result, dim=1).mean()


@torch.no_grad()
def adam_step(params, grads, mu, nu, count, lr):
    """optax.adam(lr): scale_by_adam then scale(-lr), in place on
    ``params``, the moments ``mu`` and ``nu`` and the () float32 update
    ``count``."""
    count.add_(1.0)
    bc1 = 1.0 - torch.pow(ADAM_B1, count)
    bc2 = 1.0 - torch.pow(ADAM_B2, count)
    for p, g, m, v in zip(params, grads, mu, nu):
        m.copy_((1.0 - ADAM_B1) * g + ADAM_B1 * m)
        v.copy_((1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
        p.copy_(p + (-lr) * upd)


def mdn_train_step(model, x_train, y_train, ids, noise):
    """One update of ``model``'s Adam on the minibatch ``ids`` with jitter
    ``noise``; returns the minibatch loss (a 0-d tensor, not
    synchronized)."""
    loss = mdn_loss(*model(x_train[ids], noise), y_train[ids])
    params = list(model.net.parameters())
    grads = torch.autograd.grad(loss, params)
    adam_step(params, grads, model.adam_mu, model.adam_nu, model.adam_count,
              model.lr)
    return loss.detach()


