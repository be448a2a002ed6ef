"""Vectorized tasks and the env factory."""

import torch

from .task import (
    Task, EnvState, VecEnv, env_step, env_full_reset,
    CLIP_OBSERVATIONS, CLIP_ACTIONS,
)
from ..utils.device import resolve_device
from .ant import Ant
from .anymal import Anymal
from .ball_balance import BallBalance
from .cartpole import Cartpole
from .flyers import Ingenuity, Quadcopter
from .franka_cabinet import FrankaCabinet
from .humanoid import Humanoid
from .pendulum import Pendulum
from .shadow_hand import ShadowHand

_TASK_REGISTRY = {
    "Ant": Ant,
    "Anymal": Anymal,
    "BallBalance": BallBalance,
    "Cartpole": Cartpole,
    "FrankaCabinet": FrankaCabinet,
    "Humanoid": Humanoid,
    "Ingenuity": Ingenuity,
    "Pendulum": Pendulum,
    "Quadcopter": Quadcopter,
    "ShadowHand": ShadowHand,
}

# Tasks of the JAX package that this package does not have yet.
NOT_YET_PORTED = ()


def register_task(name, cls):
    _TASK_REGISTRY[name] = cls


def available_tasks():
    return sorted(_TASK_REGISTRY)


def make_env(task_name: str, cfg: dict, seed: int = 0,
             device="cuda") -> VecEnv:
    """Creates a vectorized env for a task on ``device``: the card unless
    the caller asks for another (without a card the default raises).

    The env config's ``asymmetric_observations`` gives the PPO critic the
    privileged simulator state (``Task.privileged_state``, as wide as the
    task state's leaves per env: ``task.state_dim``) instead of the
    observations."""
    if task_name not in _TASK_REGISTRY:
        raise NotImplementedError(
            f"Task '{task_name}' is not yet ported to "
            f"bayes_sim_ig_tpu_torch. Available: {available_tasks()}")
    task = _TASK_REGISTRY[task_name](cfg, device=resolve_device(device))
    task.asymmetric_observations = bool(
        cfg.get("env", {}).get("asymmetric_observations", False))
    if task.asymmetric_observations:
        # The width from one env's initial state (init_state runs once).
        params = torch.as_tensor(task.params_spec.defaults[None],
                                 dtype=torch.float32, device=task.device)
        state = task.init_state(torch.Generator(device=task.device), params)
        task.state_dim = int(task.privileged_state(state, params).shape[1])
    return VecEnv(task, seed=seed)


__all__ = ["Task", "EnvState", "VecEnv", "env_step", "env_full_reset",
           "resolve_device", "Ant", "Anymal", "BallBalance", "Cartpole",
           "FrankaCabinet", "Humanoid", "Ingenuity", "Pendulum",
           "Quadcopter", "ShadowHand", "make_env", "register_task",
           "available_tasks",
           "NOT_YET_PORTED", "CLIP_OBSERVATIONS", "CLIP_ACTIONS"]
