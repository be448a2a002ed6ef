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

from ..distributions import pdf
from ..utils.device import resolve_device
from ..utils.step_graph import Graphed

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


class _Fit:
    """The fit's static buffers and its update step for one (n_train,
    width, batch size, n_updates): ``x_train`` and ``y_train`` are copied
    in (``load``); each ``step`` draws the minibatch ids, then the jitter,
    from the model's generator, takes one Adam update, and writes its loss
    at ``losses[t]`` (``t`` a counter on the device). ``step`` is a
    ``Graphed``: a replay on the card."""

    def __init__(self, model: "MDNN", n_train, width, batch_size,
                 n_updates):
        dev = model.device
        self.model = model
        self.batch_size, self.n_updates = int(batch_size), int(n_updates)
        self.x_train = torch.empty((n_train, width), device=dev)
        self.y_train = torch.empty((n_train, model.output_dim), device=dev)
        self.losses = torch.empty(self.n_updates, device=dev)
        self._t = torch.zeros(1, dtype=torch.int64, device=dev)
        self._host_t = 0
        self._program = Graphed("fit", self._step, dev, [model._gen])

    def load(self, x_train, y_train):
        self.x_train.copy_(x_train)
        self.y_train.copy_(y_train)
        self._t.zero_()
        self._host_t = 0

    def step(self):
        if self._host_t >= self.n_updates:
            raise IndexError(f"update {self._host_t} of {self.n_updates}: "
                             f"load the next fit first")
        self._host_t += 1
        self._program()

    def _step(self):
        model = self.model
        ids = torch.randint(0, self.x_train.shape[0], (self.batch_size,),
                            generator=model._gen, device=model.device)
        loss = mdn_train_step(model, self.x_train, self.y_train, ids,
                              model._noise(self.batch_size))
        with torch.no_grad():
            self.losses.index_copy_(0, self._t, loss[None])
            self._t.add_(1)

    def free(self):
        self._program.free()


class MDNN:
    """Stateful wrapper with the reference MDNN surface (run_training /
    predict_MoGs / normalize_samples). ``self.net`` holds the layers on
    ``device``, the card unless the caller asks for the CPU (without a card
    the default raises); ``_features`` maps inputs to the net's input
    (identity here, RFF in MDRFF)."""

    def __init__(self, input_dim, output_dim, output_lows, output_highs,
                 n_gaussians, full_covariance, hidden_layers, activation,
                 lr, seed=0, device="cuda", **kwargs):
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.n_gaussians = int(n_gaussians)
        self.hidden_layers = tuple(hidden_layers)
        self.full_covariance = bool(full_covariance)
        if activation not in _ACTIVATIONS:
            raise ValueError(f"activation {activation!r} is not one of "
                             f"{sorted(_ACTIVATIONS)}")
        self.activation = activation
        self.lr = float(lr)
        self.device = resolve_device(device)
        self.output_lows = None
        self.output_highs = None
        if output_lows is not None:
            self.output_lows = np.asarray(output_lows, np.float32)
            self.output_highs = np.asarray(output_highs, np.float32)
        # Weights are drawn on the CPU, so an init does not depend on the
        # device; minibatch ids and jitter come from the device's own.
        self._init_gen = torch.Generator().manual_seed(int(seed))
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self.net = None
        self.reinit()
        params = list(self.net.parameters())
        self.adam_mu = [torch.zeros_like(p) for p in params]
        self.adam_nu = [torch.zeros_like(p) for p in params]
        self.adam_count = torch.zeros((), device=self.device)
        self._fits = {}

    def reinit(self):
        """Re-draws fresh init weights, into the net's tensors after the
        first init (a captured fit reads them in place)."""
        net = init_mdnn_params(
            self._init_gen, self.input_dim, self.output_dim,
            self.n_gaussians, self.hidden_layers, self.full_covariance,
            self.activation)
        if self.net is None:
            self.net = net.to(self.device)
            return
        with torch.no_grad():
            for p, q in zip(self.net.parameters(), net.parameters()):
                p.copy_(q)

    @torch.no_grad()
    def _reset_adam(self):
        self.adam_count.zero_()
        for m in self.adam_mu + self.adam_nu:
            m.zero_()

    def fit_program(self, n_train, width, batch_size, n_updates) -> _Fit:
        """The fit's buffers and captured step for these shapes, cached
        until ``free_graphs``."""
        key = (int(n_train), int(width), int(batch_size), int(n_updates))
        if key not in self._fits:
            self._fits[key] = _Fit(self, *key)
        return self._fits[key]

    def free_graphs(self):
        """Drops the captured fits and their memory pools."""
        for fit in self._fits.values():
            fit.free()
        self._fits.clear()

    # ------------------------------------------------------------------ #
    def _features(self, x):
        return x

    def forward(self, x, noise):
        return self.net(self._features(x), noise)

    __call__ = forward

    def _noise(self, batch):
        return torch.rand((batch, self.output_dim, self.n_gaussians),
                          generator=self._gen, device=self.device)

    def _loss(self, x, y, noise):
        return mdn_loss(*self.forward(x, noise), y)

    def run_training(self, x_data, y_data, n_updates, batch_size,
                     test_frac=0.2):
        """Trains for ``n_updates`` minibatch steps from a fresh Adam state;
        returns a log dict with train/test losses at the reference's
        checkpoint cadence (every n_updates//5 steps plus the final step).
        The updates run ``fit_program``'s step (a CUDA graph replay on the
        card); the six test losses are evaluated eagerly between them."""
        x_data = torch.as_tensor(x_data, dtype=torch.float32,
                                 device=self.device)
        y_data = torch.as_tensor(y_data, dtype=torch.float32,
                                 device=self.device)
        assert x_data.shape[0] == y_data.shape[0]
        assert x_data.shape[0] > 0, "run_training called with no data"
        if self.output_lows is not None:
            y_data = self.normalize_samples(y_data)
        n_tot = x_data.shape[0]
        n_train = max(int(n_tot * (1.0 - test_frac)), 1)
        # A 1-row chunk leaves an empty test split: evaluate the test loss
        # on the train rows instead (finite, just not held out).
        x_test, y_test = ((x_data[n_train:], y_data[n_train:])
                          if n_train < n_tot
                          else (x_data[:n_train], y_data[:n_train]))
        fit = self.fit_program(n_train, x_data.shape[1], batch_size,
                               n_updates)
        fit.load(x_data[:n_train], y_data[:n_train])
        self._reset_adam()
        n_up = int(n_updates)
        n_evals = min(5, n_up)
        bounds = [i * n_up // n_evals for i in range(n_evals + 1)]
        test_losses = []

        def test_loss():
            with torch.no_grad():
                return self._loss(x_test, y_test,
                                  self._noise(x_test.shape[0]))

        for s in range(n_evals):
            test_losses.append(test_loss())
            for _ in range(bounds[s], bounds[s + 1]):
                fit.step()
        test_losses.append(test_loss())
        train_losses = fit.losses.cpu().numpy()
        test_losses = torch.stack(test_losses).cpu().numpy()
        checkpoints = [s * n_up // n_evals for s in range(n_evals)] \
            + [n_up - 1]
        return {"train_loss": [float(train_losses[i]) for i in checkpoints],
                "test_loss": [float(t) for t in test_losses]}

    def normalize_samples(self, params):
        lows = torch.as_tensor(self.output_lows, device=params.device)
        highs = torch.as_tensor(self.output_highs, device=params.device)
        return (params - lows) / (highs - lows)

    def predict_MoGs(self, xs, noise: Optional[torch.Tensor] = None
                     ) -> List[pdf.MoG]:
        """Conditional mixture at each input row, denormalized to the
        original output range: means m*rng + lows, scale factors
        diag(rng) @ L. ``noise`` defaults to a draw from the model's
        generator."""
        xs = torch.as_tensor(xs, dtype=torch.float32, device=self.device)
        if xs.ndim == 1:
            xs = xs[None]
        if noise is None:
            noise = self._noise(xs.shape[0])
        with torch.no_grad():
            weights, mu, l_d, lower = self.forward(xs, noise)
        weights = weights.cpu().double().numpy()
        mu = mu.cpu().double().numpy()
        l_d = l_d.cpu().double().numpy()
        lower = None if lower is None else lower.cpu().double().numpy()
        normalize = self.output_lows is not None
        rng = None
        if normalize:
            rng = (self.output_highs - self.output_lows).astype(np.float64)
        tril_ids = np.tril_indices(self.output_dim, -1)
        mogs = []
        for pt in range(xs.shape[0]):
            ms, ls = [], []
            for k in range(self.n_gaussians):
                m = mu[pt, :, k]
                lwr = np.diag(l_d[pt, :, k])
                if lower is not None:
                    lwr[tril_ids] = lower[pt, :, k]
                if normalize:
                    m = m * rng + self.output_lows
                    lwr = np.diag(rng) @ lwr
                l_combo = np.diag(lwr)
                if lower is not None:
                    l_combo = np.concatenate([l_combo, lwr[tril_ids]])
                ms.append(m)
                ls.append(l_combo)
            mogs.append(pdf.MoG(a=weights[pt], ms=ms, Ls=ls))
        return mogs
