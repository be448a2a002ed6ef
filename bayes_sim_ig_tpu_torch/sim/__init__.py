"""Vectorized tasks and the env factory."""

from .task import (
    Task, EnvState, VecEnv, env_step, env_full_reset, task_device,
    CLIP_OBSERVATIONS, CLIP_ACTIONS,
)
from .ant import Ant
from .anymal import Anymal
from .ball_balance import BallBalance
from .cartpole import Cartpole
from .flyers import Ingenuity, Quadcopter
from .franka_cabinet import FrankaCabinet
from .humanoid import Humanoid
from .pendulum import Pendulum

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
}

# Tasks of the JAX package that this package does not have yet.
NOT_YET_PORTED = ("ShadowHand",)


def register_task(name, cls):
    _TASK_REGISTRY[name] = cls


def available_tasks():
    return sorted(_TASK_REGISTRY)


def make_env(task_name: str, cfg: dict, seed: int = 0,
             device="cuda") -> VecEnv:
    """Creates a vectorized env for a task on ``device``: the card unless
    the caller asks for another (without a card the default raises)."""
    if task_name not in _TASK_REGISTRY:
        raise NotImplementedError(
            f"Task '{task_name}' is not yet ported to "
            f"bayes_sim_ig_tpu_torch. Available: {available_tasks()}")
    if cfg.get("env", {}).get("asymmetric_observations", False):
        raise NotImplementedError("asymmetric_observations (the privileged "
                                  "critic) is not yet ported")
    return VecEnv(_TASK_REGISTRY[task_name](cfg, device=task_device(device)),
                  seed=seed)


__all__ = ["Task", "EnvState", "VecEnv", "env_step", "env_full_reset",
           "task_device", "Ant", "Anymal", "BallBalance", "Cartpole",
           "FrankaCabinet", "Humanoid", "Ingenuity", "Pendulum",
           "Quadcopter", "make_env", "register_task", "available_tasks",
           "NOT_YET_PORTED", "CLIP_OBSERVATIONS", "CLIP_ACTIONS"]
