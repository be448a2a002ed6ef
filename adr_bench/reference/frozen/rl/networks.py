# Frozen copy of bayes_sim_ig_tpu_torch/rl/networks.py (commit 57f9c0d); see frozen/__init__.py for what changed.
"""Actor-critic networks for PPO: an ``nn.Module`` with separate actor and
critic MLPs and a state-independent log-std, plus the functions that apply
it (port of ``bayes_sim_ig_tpu/rl/networks.py``)."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import env_draw

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "elu": F.elu,
    "selu": F.selu,
}


def _orthogonal_linear(fan_in, fan_out, gain, gen):
    layer = nn.Linear(fan_in, fan_out)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, gain=gain, generator=gen)
        layer.bias.zero_()
    return layer


class ActorCritic(nn.Module):
    """The actor reads the observations, the critic the observations or,
    with ``state_dim`` > 0, a privileged state of that width (the
    asymmetric actor-critic); weights are drawn from ``gen``."""

    def __init__(self, gen: torch.Generator, obs_dim: int, act_dim: int,
                 pi_hid_sizes: Sequence[int], vf_hid_sizes: Sequence[int],
                 init_noise_std: float = 1.0, activation: str = "elu",
                 state_dim: int = 0):
        super().__init__()
        self.activation = activation
        actor, last = [], obs_dim
        for h in pi_hid_sizes:
            actor.append(_orthogonal_linear(last, h, np.sqrt(2.0), gen))
            last = h
        actor.append(_orthogonal_linear(last, act_dim, 0.01, gen))
        critic, last = [], (state_dim if state_dim > 0 else obs_dim)
        for h in vf_hid_sizes:
            critic.append(_orthogonal_linear(last, h, np.sqrt(2.0), gen))
            last = h
        critic.append(_orthogonal_linear(last, 1, 1.0, gen))
        self.actor = nn.ModuleList(actor)
        self.critic = nn.ModuleList(critic)
        self.log_std = nn.Parameter(
            torch.full((act_dim,), float(np.log(init_noise_std))))


def _mlp(layers, x, act):
    for layer in layers[:-1]:
        x = act(layer(x))
    return layers[-1](x)


def policy_mean(net: ActorCritic, obs):
    return _mlp(net.actor, obs, _ACTIVATIONS[net.activation])


def value(net: ActorCritic, obs):
    return _mlp(net.critic, obs, _ACTIVATIONS[net.activation])[..., 0]


def sample_action(net: ActorCritic, obs, gen: torch.Generator):
    """Stochastic action + its log-prob under the diagonal Gaussian."""
    mean = policy_mean(net, obs)
    std = torch.exp(net.log_std)
    eps = env_draw(torch.randn, mean.shape, gen, dtype=mean.dtype,
                   device=mean.device)
    action = mean + std * eps
    logp = gaussian_logp(action, mean, net.log_std)
    return action, logp


def gaussian_logp(action, mean, log_std):
    std = torch.exp(log_std)
    z = (action - mean) / std
    return (-0.5 * (z ** 2).sum(dim=-1) - log_std.sum()
            - 0.5 * action.shape[-1] * math.log(2.0 * math.pi))


def entropy(log_std):
    return (log_std + 0.5 * math.log(2.0 * math.pi * math.e)).sum()
