"""Vectorized tasks and the env factory."""

from .task import (
    Task, EnvState, VecEnv, env_step, env_full_reset,
    CLIP_OBSERVATIONS, CLIP_ACTIONS,
)
from .ant import Ant
from .cartpole import Cartpole
from .humanoid import Humanoid
from .pendulum import Pendulum

_TASK_REGISTRY = {
    "Ant": Ant,
    "Cartpole": Cartpole,
    "Humanoid": Humanoid,
    "Pendulum": Pendulum,
}

# Tasks of the JAX package that this package does not have yet.
NOT_YET_PORTED = ("Anymal", "BallBalance", "FrankaCabinet", "Ingenuity",
                  "Quadcopter", "ShadowHand")


def register_task(name, cls):
    _TASK_REGISTRY[name] = cls


def available_tasks():
    return sorted(_TASK_REGISTRY)


def make_env(task_name: str, cfg: dict, seed: int = 0,
             device="cpu") -> VecEnv:
    """Creates a vectorized env for a task on ``device``."""
    if task_name not in _TASK_REGISTRY:
        raise NotImplementedError(
            f"Task '{task_name}' is not yet ported to "
            f"bayes_sim_ig_tpu_torch. Available: {available_tasks()}")
    if cfg.get("env", {}).get("asymmetric_observations", False):
        raise NotImplementedError("asymmetric_observations (the privileged "
                                  "critic) is not yet ported")
    return VecEnv(_TASK_REGISTRY[task_name](cfg, device=device), seed=seed)


__all__ = ["Task", "EnvState", "VecEnv", "env_step", "env_full_reset",
           "Ant", "Cartpole", "Humanoid", "Pendulum", "make_env",
           "register_task", "available_tasks",
           "NOT_YET_PORTED", "CLIP_OBSERVATIONS", "CLIP_ACTIONS"]
