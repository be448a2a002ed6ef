"""RL: PPO trainer and actor-critic networks."""

from .ppo import PPO, process_ppo
from . import networks

__all__ = ["PPO", "process_ppo", "networks"]
