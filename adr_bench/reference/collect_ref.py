"""A collection round, plain: its reset, one of its steps under the
collection policy, and the extraction of each env's first episode.

The reset and the step start from the generator states, distribution,
env state and weights copied before the port's programs ran. The
extraction reads the port's raw trajectory buffers and keeps, env by env
in a loop over the steps, the round's first episode, its last step
repeated once it is done, the labels drawn at the reset and the sum of
its rewards.

Faults (for the readings that set the limits): the reset and the step
take ``step_ref``'s; the extraction's ``half`` leaves the second half of
the envs unpadded, ``altered`` adds 1 to env 0's first label, and
``unchanged`` returns the raw buffers as they are.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .frozen.distributions import device as fdevice
from .frozen.rl import networks
from .frozen.sim import env_full_reset, env_step, make_task
from .frozen.utils.device import env_draw
from .step_ref import _generator, actor_critic, env_state, plant


def policy(name: Optional[str], task):
    """The collection policy ``name`` as (act, gen) -> act, plain: each
    ``collectPolicy`` that the port's configurations name, and None for
    the RL policy itself (the evaluation's)."""
    if name in (None, "None", "policy_rl"):
        return lambda act, gen: act
    if name == "policy_rl_randomized":
        def randomized(act, gen, frac_rnd=0.1):
            rnd = torch.rand((), generator=gen, device=act.device)
            random_act = env_draw(torch.rand, act.shape, gen,
                                  dtype=act.dtype, device=act.device)
            return torch.where(rnd < frac_rnd, random_act * 2.0 - 1.0, act)
        return randomized
    if name == "policy_random":
        return lambda act, gen: env_draw(torch.rand, act.shape, gen,
                                         dtype=act.dtype, device=act.device)
    if name == "policy_grasp":
        dims = getattr(task, "grasp_excitation_dims", None)
        if dims is None:
            return lambda act, gen: torch.ones_like(act)
        mask = torch.zeros(task.act_dim, device=task.device)
        mask[list(dims)] = 1.0

        def grasp(act, gen):
            jitter = env_draw(torch.rand, act.shape, gen, dtype=act.dtype,
                              device=act.device) * 0.6 - 0.3
            return torch.clamp(mask + jitter, -1.0, 1.0)
        return grasp
    raise KeyError(f"no plain collection policy {name!r}")


def _distr(snap: dict, device):
    return getattr(fdevice, snap["type"])(**{k: v.to(device) for k, v in
                                             snap["fields"].items()})


def reset(task_name: str, cfg_env: dict, snap: dict, device,
          fault: Optional[str] = None, task=None) -> dict:
    """The round's reset: ``state`` (an EnvState) and ``obs``."""
    device = torch.device(device)
    task = task or make_task(task_name, cfg_env, device)
    with torch.no_grad():
        state, obs = env_full_reset(task, _distr(snap["distr"], device),
                                    _generator(snap["gen"], device), 0)
    if fault == "altered":
        obs = obs.clone()
        obs[0] += 1.0
    return {"state": state, "obs": obs}


def step(task_name: str, cfg_env: dict, cfg_train: dict, net_shape: dict,
         snap: dict, device, fault: Optional[str] = None, task=None) -> dict:
    """The round's step ``snap["j"]``: the RL policy's draw, the
    collection policy, then the env step with the round's episode length.
    Returns ``act``, ``rew``, ``done``, ``state_after``, ``obs_after``."""
    device = torch.device(device)
    task = task or make_task(task_name, cfg_env, device)
    s = snap["step"]
    state = env_state(s["state"], task_name, device)
    obs = s["obs"].to(device)
    net = actor_critic(net_shape, cfg_train.get("policy", {}),
                       snap["weights"], device)
    gen = _generator(s["gen"], device)
    with torch.no_grad():
        act = networks.sample_action(net, obs, gen)[0]
        act = policy(snap["policy"], task)(act, gen)
        new, obs2, rew, done = env_step(
            task, _distr(snap["distr"], device), state, act, gen,
            int(snap["max_episode_length"]))
    new, obs2 = plant(fault, state, obs, new, obs2)
    return {"act": act, "rew": rew, "done": done, "state_after": new,
            "obs_after": obs2}


def extract(raw: Dict[str, torch.Tensor], fault: Optional[str] = None):
    """(labels, states, actions, rewards) of each env's first episode,
    from the round's raw buffers ``obs0`` (N, S), ``obs``, ``act``,
    ``rew``, ``done`` (T, N, ...) and ``labels`` (N, P): states (N, T + 1,
    S) from the reset's observations on, actions (N, T + 1, A) with the
    last repeated, rewards summed over the episode's steps (float64)."""
    obs0, obs, act = raw["obs0"], raw["obs"], raw["act"]
    rew, done = raw["rew"], raw["done"]
    T, n = done.shape
    ended = torch.zeros(n, dtype=torch.bool, device=done.device)
    states, actions = [obs0], []
    last_o, last_a = obs[0], act[0]
    total = torch.zeros(n, dtype=torch.float64, device=done.device)
    for t in range(T):
        o = torch.where(ended[:, None], last_o, obs[t])
        a = torch.where(ended[:, None], last_a, act[t])
        total += torch.where(ended, 0.0, rew[t].double())
        states.append(o)
        actions.append(a)
        last_o, last_a = o, a
        ended = ended | (done[t] > 0)
    actions.append(actions[-1])
    labels = raw["labels"].clone()
    states = torch.stack(states, dim=1)
    actions = torch.stack(actions, dim=1)
    if fault == "unchanged":
        states = torch.cat([obs0[:, None], obs.transpose(0, 1)], dim=1)
        actions = torch.cat([act.transpose(0, 1), act[-1:].transpose(0, 1)],
                            dim=1)
        total = rew.double().sum(dim=0)
    elif fault == "half":
        h = n // 2
        states[h:] = torch.cat([obs0[h:, None], obs[:, h:].transpose(0, 1)],
                               dim=1)
    elif fault == "altered":
        labels[0, 0] += 1.0
    return labels, states, actions, total
