"""One rollout step, plain: the actor's draw and log-probability, the
critic's value, then the env step of the frozen task with the plain tree
solves, from the state, observations, distribution and generator states
copied before the port's step.

Faults (for the readings that set the limits): ``unchanged`` returns the
state as it was; ``half`` leaves the second half of the envs unstepped;
``altered`` adds 1 to each of env 0's next observations.
"""

from __future__ import annotations

from typing import Optional

import torch

from .frozen.distributions import device as fdevice
from .frozen.rl import networks
from .frozen.sim import EnvState, env_step, make_task, task_module


def actor_critic(net_shape: dict, policy_cfg: dict, params, device):
    """The frozen ActorCritic with ``params`` (the port's parameter order)
    copied in."""
    net = networks.ActorCritic(
        torch.Generator().manual_seed(0), net_shape["obs_dim"],
        net_shape["act_dim"], policy_cfg.get("pi_hid_sizes", [64, 64]),
        policy_cfg.get("vf_hid_sizes", [64, 64]),
        float(policy_cfg.get("init_noise_std", 1.0)),
        activation=policy_cfg.get("activation", "elu"),
        state_dim=(net_shape["critic_in"] if net_shape["asymmetric"]
                   else 0)).to(device)
    with torch.no_grad():
        for p, q in zip(net.parameters(), params):
            p.copy_(q.to(device))
    return net


def _generator(state, device):
    gen = torch.Generator(device=device)
    gen.set_state(state)
    return gen


def env_state(snap: dict, task_name: str, device) -> EnvState:
    """The EnvState of a copy taken by the harness (``benchkit.taps``),
    in the frozen task's own state type."""
    fields = dict(snap["fields"])
    ts = fields.pop("task_state")
    state_type = getattr(task_module(task_name), ts["type"])
    task_state = state_type(**{k: v.to(device)
                               for k, v in ts["fields"].items()})
    return EnvState(task_state=task_state,
                    **{k: v.to(device) for k, v in fields.items()})


def plant(fault: Optional[str], state: EnvState, obs, new: EnvState, obs2):
    """The step's next state and observations with ``fault`` planted:
    ``unchanged``, ``half`` or ``altered`` (see above); as they are for
    None."""
    if fault == "unchanged":
        return state, obs
    if fault == "half":
        n = obs.shape[0] // 2

        def keep(a, b):
            return torch.cat([a[:n], b[n:]]) if a.ndim else a
        new = EnvState(
            task_state=type(new.task_state)(*[
                keep(a, b) for a, b in zip(new.task_state,
                                           state.task_state)]),
            **{k: keep(getattr(new, k), getattr(state, k))
               for k in EnvState._fields if k != "task_state"})
        return new, keep(obs2, obs)
    if fault == "altered":
        obs2 = obs2.clone()
        obs2[0] += 1.0
    return new, obs2


def rollout_step(task_name: str, cfg_env: dict, cfg_train: dict,
                 net_shape: dict, weights, snap: dict, device,
                 fault: Optional[str] = None, task=None) -> dict:
    """The step's outputs: ``act``, ``logp``, ``val``, ``rew``, ``done``,
    ``state_after`` (an EnvState) and ``obs_after``."""
    device = torch.device(device)
    task = task or make_task(task_name, cfg_env, device)
    d = snap["distr"]
    distr = getattr(fdevice, d["type"])(**{k: v.to(device)
                                           for k, v in d["fields"].items()})
    state = env_state(snap["state"], task_name, device)
    obs = snap["obs"].to(device)
    net = actor_critic(net_shape, cfg_train.get("policy", {}), weights,
                       device)
    with torch.no_grad():
        act, logp = networks.sample_action(
            net, obs, _generator(snap["policy_gen"], device))
        cin = (task.privileged_state(state.task_state, state.params)
               if net_shape["asymmetric"] else obs)
        val = networks.value(net, cin)
        new, obs2, rew, done = env_step(
            task, distr, state, act, _generator(snap["env_gen"], device))
    new, obs2 = plant(fault, state, obs, new, obs2)
    return {"act": act, "logp": logp, "val": val, "rew": rew, "done": done,
            "state_after": new, "obs_after": obs2}
