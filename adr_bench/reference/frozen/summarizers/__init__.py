# Frozen copy of bayes_sim_ig_tpu_torch/summarizers/__init__.py (commit 57f9c0d); see frozen/__init__.py for what changed.
"""Trajectory summarizers: compress (states, actions) rollouts to fixed-size
feature vectors for BayesSim inference.

PyTorch port of ``bayes_sim_ig_tpu/summarizers``. Inputs are
``states (N, T, S)`` and ``actions (N, T', A)`` tensors; outputs are
``(N, F)`` on the inputs' device. Behaviour kept from the reference:
  * ``summary_waypts`` first chops/pads trajectories to exactly
    ``n_waypts`` steps, so its waypoints are the first ``n_waypts`` steps;
  * ``cross_correlation`` diffs/drops along the FEATURE dimension, not
    time;
  * std uses ddof=1 and is zeroed when fewer than 2 entries.
"""

from __future__ import annotations

import torch

from .signature import path_signature, signature_depth

__all__ = [
    "pad_states_actions", "summary_start", "summary_waypts",
    "cross_correlation", "summary_corr", "summary_corrdiff",
    "summary_signatory", "signature_depth", "path_signature",
    "get_summarizer",
]


def _pad_or_chop(x: torch.Tensor, tgt_len: int) -> torch.Tensor:
    """Chops ``x (N, T, D)`` to ``tgt_len`` steps, or pads by repeating the
    last frame."""
    t = x.shape[1]
    if t >= tgt_len:
        return x[:, :tgt_len]
    pad = x[:, -1:].expand(-1, tgt_len - t, -1)
    return torch.cat([x, pad], dim=1)


def pad_states_actions(states, actions, tgt_actions_len=None):
    """Makes states and actions the same (target) length by chopping or
    repeat-last-frame padding."""
    assert states.ndim == 3, "Need states: ntraj x n_steps x state_dim"
    assert actions.ndim == 3, "Need actions: ntraj x n_steps x action_dim"
    if tgt_actions_len is None:
        tgt_actions_len = states.shape[1]
    states = _pad_or_chop(states, tgt_actions_len)
    actions = _pad_or_chop(actions, tgt_actions_len)
    return states, actions


def summary_start(states, actions, max_t=10):
    """Flattened initial snippet [s_t || a_t] for t < max_t."""
    states, actions = pad_states_actions(states, actions, max_t)
    feats = torch.cat([states, actions], dim=-1)
    return feats.reshape(feats.shape[0], -1)


def summary_waypts(states, actions, n_waypts=10):
    """States/actions at waypoints; equals ``summary_start`` with
    ``max_t=n_waypts`` (see the module docstring)."""
    states, actions = pad_states_actions(states, actions, n_waypts)
    feats = torch.cat([states, actions], dim=-1)
    return feats.reshape(feats.shape[0], -1)


def cross_correlation(states, actions, use_state_diff=False):
    """Cross-correlation summaries (BayesSim RSS2019 Sec. IV.F): outer
    product of state features and action features plus mean/std
    statistics of the state features."""
    states, actions = pad_states_actions(states, actions)
    ntraj, traj_len, state_dim = states.shape
    assert traj_len > 1, "empty episodes are problematic"
    assert actions.shape[1] == traj_len
    max_traj_len = 10 if state_dim <= 50 else 5
    if traj_len > max_traj_len:
        sa = summary_waypts(states, actions, n_waypts=max_traj_len)
        sa = sa.reshape(ntraj, max_traj_len, -1)
        states = sa[:, :, :state_dim]
        actions = sa[:, :, state_dim:]
    if use_state_diff:  # diff over FEATURE dims (reference behavior)
        state_feats = states[:, :, 1:] - states[:, :, :-1]
    else:
        state_feats = states[:, :, :-1]
    state_feats = state_feats.reshape(ntraj, -1)
    action_feats = actions.reshape(ntraj, -1)
    cross_corr = (state_feats[:, :, None]
                  * action_feats[:, None, :]).reshape(ntraj, -1)
    mu = state_feats.mean(dim=-1, keepdim=True)
    if state_feats.shape[1] < 2:
        std = torch.zeros_like(mu)
    else:
        std = state_feats.std(dim=-1, correction=1, keepdim=True)
    return torch.cat([cross_corr, mu, std], dim=-1)


def summary_corrdiff(states, actions):
    return cross_correlation(states, actions, use_state_diff=True)


def summary_corr(states, actions):
    return cross_correlation(states, actions, use_state_diff=False)


def summary_signatory(states, actions):
    """Truncated path signatures of time-augmented (state, action) paths:
    channels are the time ids 1..L, then the states, then the actions.
    Depth via ``signature_depth``."""
    assert states.ndim == 3, "states should be batch x time x state_dim"
    bsz, path_len, _ = states.shape
    states, actions = pad_states_actions(states, actions, path_len)
    time_ids = torch.arange(1, path_len + 1, dtype=states.dtype,
                            device=states.device)[None, :, None].expand(
                                bsz, path_len, 1)
    paths = torch.cat([time_ids, states, actions], dim=-1)
    depth = signature_depth(paths.shape[-1])
    return path_signature(paths, depth=depth)


_REGISTRY = {
    "summary_start": summary_start,
    "summary_waypts": summary_waypts,
    "summary_corr": summary_corr,
    "summary_corrdiff": summary_corrdiff,
    "summary_signatory": summary_signatory,
}


def get_summarizer(name: str):
    """Resolves a summarizer by config name."""
    if name not in _REGISTRY:
        raise KeyError(f"Unknown summarizer '{name}'. "
                       f"Available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
